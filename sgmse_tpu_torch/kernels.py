"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, bound through ``ctypes``. The build happens
on first use, never at import: each source is compiled in its own ``nvcc``
process, all started together, then linked once. The library lands in
``build/sgmse_tpu_torch/`` at the root of the checkout, under a name that hashes
the sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.

Every C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.

Several host threads may launch kernels at once (the serving path's executor
threads do, each on its own stream; ``ctypes`` releases the GIL for the call):
:func:`lib` builds and loads under a lock, so a process builds once (and
:func:`build` under a file lock, so processes build one at a time), each
kernel opts into its shared memory once under a C++11 static initialiser, and
:func:`count_launch` keeps the launch counters exact.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sgmse_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
                           "the sgmse_tpu_torch CUDA kernels")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsgmse_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists. Returns the
    library's path. The compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept in ``build.log`` beside it. Processes
    build one at a time (an exclusive ``flock`` on ``build.lock``): the
    data-parallel ranks and inference workers each load the library on first
    use, and the first one builds it while the others wait, then load it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return so if so.exists() else _build(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build(so: Path) -> Path:
    nvcc = nvcc_path()
    cus, _ = _sources()
    t0 = time.time()
    procs = []
    for src in cus:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append("$ " + " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd[-3])
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append("$ " + " ".join(cmd) + "\n" + res.stdout)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
    os.replace(tmp, so)
    (BUILD_DIR / "build.log").write_text(
        "\n".join(log) + f"\nbuilt {so.name} in {time.time() - t0:.1f} s\n")
    return so


_LIB = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.sgmse_upfirdn2d.argtypes = [p, p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, i, p]
    handle.sgmse_upfirdn2d.restype = i
    handle.sgmse_group_norm_act.argtypes = [p] * 7 + [i] * 5 + [f, i, i, p]
    handle.sgmse_group_norm_act.restype = i
    handle.sgmse_group_norm_act_bwd.argtypes = [p] * 14 + [i] * 11 + [f, i, i, p]
    handle.sgmse_group_norm_act_bwd.restype = i
    handle.sgmse_fir_conv.argtypes = [p] * 4 + [i] * 18 + [p, i, i, p]
    handle.sgmse_fir_conv.restype = i
    handle.sgmse_residual_merge.argtypes = [p] * 4 + [ctypes.c_longlong, i, f, i, p]
    handle.sgmse_residual_merge.restype = i
    handle.sgmse_error_string.argtypes = [i]
    handle.sgmse_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call of the process. The
    first caller builds and loads it under a lock; threads that call at the
    same time wait for it and get the same library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def count_launch(fn, name: str = "launches") -> None:
    """Add one to the launch counter ``fn.<name>`` under a lock, so that
    launches from several threads are all counted."""
    with _COUNT_LOCK:
        setattr(fn, name, getattr(fn, name) + 1)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib().sgmse_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
