"""Readings of a cell's comparison over many seeds, and of its controls, in
one process: what the limits in ``workloads/<cell>.json`` are set from.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ... \\
        [--controls fp8 bf16 half_batch ...] [--seconds S] [--out FILE]

For each seed, the cell's driver sets up as a run does (the seed's weights
and inputs, at the cell's own shapes), runs a short window of ``--seconds``
(one batch or step at 0) through the timed path, and reads the numbers that
its check compares, for the program and for each control: the plain
reference in a lower precision in the program's place, or a planted fault
the driver knows (its ``readings``). Prints one JSON line per seed (and appends it to ``--out``).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def readings(cell_name: str, seeds, controls=(), seconds: float = 0.0, device=None, out=None):
    import torch

    cell = harness.cell(cell_name)
    config = harness.config(cell["config"])
    device = torch.device(device or "cuda")
    drv = harness.driver(cell["driver"])
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        run = drv.Run(config, cell, seed, device)
        run.setup()
        t1 = time.perf_counter()
        window = run.window(seconds)
        t2 = time.perf_counter()
        run.release()
        row = dict(workload=cell_name, seed=seed, setup_s=t1 - t0, window_s=t2 - t1,
                   e2e=window["e2e"], **run.readings(controls))
        row["check_s"] = time.perf_counter() - t2
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    readings(args.workload, args.seeds, args.controls, args.seconds, out=args.out)


if __name__ == "__main__":
    main()
