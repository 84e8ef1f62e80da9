"""The kernels' first launch from many host threads at once, on the card.

    python -m sgmse_tpu_torch.first_launch [--threads 8]

Run it in a fresh process, where no kernel has been launched yet (the kernel
library may already be built). ``--threads`` threads start together (a
barrier), and each, on a CUDA stream of its own, makes the process's first
launches of K1 (a pair launch, the res-block's down pair) and K2 (with SiLU
and the time-embedding pre-bias), in float32 and in bfloat16, at shapes whose
launches take more than the 48 KB of shared memory a block gets without
opting in. Each result is held against its plain PyTorch version with the
tolerances of ``chip_smoke.py``'s kernel checks, and the launch counters must
read exactly one launch per thread, kernel and dtype. What this checks: the
library loads once under its lock, each kernel's shared-memory opt-in is
finished before any thread launches with it, and no count is lost.

Prints one JSON object; exits non-zero if any check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

import torch

from . import kernels
from .ops import group_norm as gn
from .ops import upfirdn2d as ufd

# Relative to max|plain|: float32 sums in another order; bfloat16 one rounding step.
TOL = {"upfirdn2d": {torch.float32: 1e-5, torch.bfloat16: 2.0**-7},
       "group_norm_act": {torch.float32: 2e-5, torch.bfloat16: 2.0**-7}}
SHAPE = (2, 128, 128, 128)  # B, C, H, W: the flagship's second level at B=2
GROUPS = 32


def _inputs(dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x0, x1 = (rand(*SHAPE).to(dtype).contiguous(memory_format=torch.channels_last)
              for _ in range(2))
    c = SHAPE[1]
    return dict(x0=x0, x1=x1, gamma=1.0 + 0.1 * rand(c), beta=0.1 * rand(c),
                pre_bias=rand(SHAPE[0], c).to(dtype))


def _err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _thread(barrier, dev, index, out):
    stream = torch.cuda.Stream(dev)
    fir = ufd.setup_kernel([1, 3, 3, 1])
    down = dict(down=2, pad=(1, 1))
    rows = []
    with torch.cuda.stream(stream):
        cases = {dt: _inputs(dt, dev, 10 * index + i)
                 for i, dt in enumerate((torch.float32, torch.bfloat16))}
        stream.synchronize()
        barrier.wait()
        for dtype, a in cases.items():
            pair = ufd.upfirdn2d_pair(a["x0"], a["x1"], fir, **down)
            y = gn.group_norm_act(a["x0"], a["gamma"], a["beta"], GROUPS, silu=True,
                                  pre_bias=a["pre_bias"])
            stream.synchronize()
            ref_pair = ufd.upfirdn2d_pair_plain(a["x0"], a["x1"], fir, **down)
            ref_y = gn.group_norm_act_plain(a["x0"], a["gamma"], a["beta"], GROUPS,
                                            silu=True, pre_bias=a["pre_bias"])
            rows.append(dict(kernel="upfirdn2d", dtype=str(dtype)[6:],
                             rel_err=max(_err(g, r) for g, r in zip(pair, ref_pair)),
                             tol=TOL["upfirdn2d"][dtype]))
            rows.append(dict(kernel="group_norm_act", dtype=str(dtype)[6:],
                             rel_err=_err(y, ref_y), tol=TOL["group_norm_act"][dtype]))
        stream.synchronize()
    out[index] = rows


def run(threads: int = 8) -> dict:
    """Start ``threads`` threads at once on the process's first kernel launches;
    return their checks and the counters. Raises if no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("first_launch runs on a CUDA device, and "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()  # the build may take seconds; the load stays for the threads
    if kernels._LIB is not None:
        raise RuntimeError("first_launch: a kernel library is already loaded in this "
                           "process; run it in a fresh one")
    before = (ufd.upfirdn2d_cuda.launches, gn.group_norm_act_cuda.launches)
    barrier = threading.Barrier(threads)
    out, errors = [None] * threads, []

    def body(i):
        try:
            _thread(barrier, dev, i, out)
        except BaseException as e:  # noqa: BLE001 - reported below
            barrier.abort()
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    pool = [threading.Thread(target=body, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    torch.cuda.synchronize()
    launches = {"upfirdn2d": ufd.upfirdn2d_cuda.launches - before[0],
                "group_norm_act": gn.group_norm_act_cuda.launches - before[1]}
    rows = [r for rs in out if rs for r in rs]
    worst = {}
    for r in rows:
        key = f"{r['kernel']} {r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), r["rel_err"])
    expected = {"upfirdn2d": 2 * threads, "group_norm_act": 2 * threads}
    ok = (not errors and len(rows) == 4 * threads and launches == expected
          and all(r["rel_err"] <= r["tol"] for r in rows))
    return dict(ok=ok, threads=threads, shape=list(SHAPE), launches=launches,
                expected_launches=expected, worst_rel_err=worst, errors=errors)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    result = run(ap.parse_args(argv).threads)
    print(json.dumps(result))
    if not result["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
