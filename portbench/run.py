"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the process's start): the cell's traffic
driver builds the port's model with the seed's weights, makes the seed's
inputs and warms up the cell's shapes. Then the window: with ``--trace 0``
for ``--seconds``, giving the cell's end-to-end metrics; with ``--trace 1``
the driver's stretch (a fixed amount of the cell's work) twice, first timed
by the host's clock alone, then under ``torch.profiler`` with the kernel
calls recorded, giving the cell's per-layer metrics (the whole step's share
of the peak from the first, so that the profiler's cost on the host does not
count, the rest from the trace). Then, in both, the peak device
memory is read, the program's state freed, and the plain reference checks
the window's output (``correct``); the numbers compared and their limits
are the last lines of standard error and the last key of the result line,
which is the last line of standard output.

Exits non-zero, printing no result, without a CUDA device (or with fewer than
the cell asks for), or where JAX or the JAX package is loaded once the window
has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")  # no library of the port's may load JAX for it

from portbench import harness  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args, cell, device, config=None, t_start=T0) -> dict:
    """Set-up, window and check of one run; the pieces of its result line.
    ``config`` defaults to the cell's configuration file."""
    import torch

    from portbench import trace

    config = config or harness.config(cell["config"])
    run = harness.driver(cell["driver"]).Run(config, cell, args.seed, device)
    run.setup()
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    analysis = calls = untraced = None
    if args.trace:
        untraced = run.window(args.seconds, traced=True)
        calls = trace.Calls()
        with trace.profile() as prof, calls.active():
            with torch.profiler.record_function("portbench.window"):
                window = run.window(args.seconds, traced=True)
                harness.sync(device)
        analysis = trace.analyse(prof)
        del prof
    else:
        window = run.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.release()
    checks = run.check()
    return dict(config=config, window=window, untraced=untraced, setup_s=setup_s, peak=peak,
                checks=checks, analysis=analysis, calls=calls)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = dict(harness.cell(args.workload), **entry)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(args, cell, device)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    window, ctx = out["window"], dict(out)
    if args.trace:
        metrics = {}
        for m in harness.per_layer(bench, args.workload):
            value = harness.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        a = out["analysis"]
        breakdown = dict(device_ops=a["device_ops"], idle_gaps=a["idle_gaps"])
    else:
        metrics = {}
        for m in harness.end_to_end(bench, args.workload):
            value = out["setup_s"] if m["name"] == "setup_s" else window["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = None
    device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                       memory_peak_bytes=out["peak"], power_limit=power_limit())
    if args.trace:
        device_info.update(busy_s=out["analysis"]["busy_s"], window_s=out["analysis"]["window_s"])
    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(harness.result_line(harness.checks_passed(checks), window["attempted"],
                              window["failed"], metrics, device_info, checks, breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
