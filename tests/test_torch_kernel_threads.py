"""The kernel layer under several host threads, on the CPU: the kernel library
is built and loaded once however many threads ask for it at the same time, and
the launch counters lose no count. (The card-side check, the kernels' first
launches from eight threads at once, is ``tests/test_torch_cuda.py``
``test_first_launches_from_many_threads`` and ``chip_smoke.py`` phase 11a.)
"""
import _ctypes
import sys
import threading
import time
from pathlib import Path

import pytest

from sgmse_tpu_torch import kernels
from sgmse_tpu_torch.ops import group_norm as gn
from sgmse_tpu_torch.ops import upfirdn2d as ufd

THREADS = 8


def _together(fn, threads=THREADS):
    """Run fn() on ``threads`` threads released at once; their results."""
    barrier = threading.Barrier(threads)
    out = [None] * threads

    def body(i):
        barrier.wait()
        out[i] = fn()

    pool = [threading.Thread(target=body, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return out


def test_library_builds_and_loads_once_under_threads(monkeypatch):
    builds = []

    def slow_build():
        builds.append(threading.current_thread().name)
        time.sleep(0.2)  # a build takes seconds: every other thread arrives meanwhile
        return Path(_ctypes.__file__)  # any loadable shared object

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels, "_bind", lambda handle: handle)
    handles = _together(kernels.lib)
    assert len(builds) == 1
    assert all(h is handles[0] for h in handles)
    assert kernels.lib() is handles[0] and len(builds) == 1


@pytest.mark.parametrize("fn,name", [(ufd.upfirdn2d_cuda, "launches"),
                                     (ufd.upfirdn2d_cuda, "adjoint_launches"),
                                     (gn.group_norm_act_cuda, "launches"),
                                     (gn.group_norm_act_bwd_cuda, "launches")])
def test_launch_counters_exact_under_threads(monkeypatch, fn, name):
    """8 threads x 10,000 counts, with the interpreter switching threads as
    often as it can, reach exactly 80,000."""
    monkeypatch.setattr(fn, name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(lambda: [kernels.count_launch(fn, name) for _ in range(10_000)])
    finally:
        sys.setswitchinterval(interval)
    assert getattr(fn, name) == THREADS * 10_000
