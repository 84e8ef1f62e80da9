"""ctypes binding of the native C++ batch WAV loader (``native/wavload.cc``).

The port's copy of ``sgmse_tpu/data/native.py`` (that module cannot be
imported without JAX, because importing ``sgmse_tpu`` imports it), over a
byte-for-byte copy of its C++ source: one native call decodes, crops, pads
and normalizes a whole (clean, noisy) batch with a C++ thread pool, without
the GIL. The crops are the JAX package's native crops (a splitmix64 stream per
item; a crop spans the shorter file of the pair), so one seed gives the JAX
training CLI's batches.

The library is built on first use, never at import, with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``build/sgmse_tpu_torch/``
at the root of the checkout, under a name that hashes the source and the
flags. It is compiled to a temporary name and renamed into place, so
processes that build at once (the test workers) never load a half-written
file. Where g++ is missing or fails, :func:`get_lib` warns and returns None,
and the loader keeps the Python path, as the JAX package does.

``SERVED`` counts the batches each path has handed to a ``WavLoader``'s
consumer in this process, so that a run can show which path served them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "wavload.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgmse_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
SERVED = {"native": 0, "python": 0}
_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libwavload_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"native wav loader build failed to launch: {e}")
        return False
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"native wav loader build failed:\n{res.stderr[:2000]}")
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = library_path()
        try:
            if not so.exists() and not _compile(so):
                _lib_failed = True
                return None
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            warnings.warn(f"native wav loader unavailable: {e}")
            _lib_failed = True
            return None
        lib.sgmse_load_pair_batch.restype = ctypes.c_int
        lib.sgmse_load_pair_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.sgmse_read_wav.restype = ctypes.c_int
        lib.sgmse_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lib
    return _lib


_NORM_MODES = {"not": 0, "none": 0, "noisy": 1, "clean": 2}


def load_pair_batch(clean_paths, noisy_paths, target_len: int,
                    random_crop: bool, seed: int, normalize: str,
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode + crop + normalize a batch of pairs natively.

    Returns (x, y) float32 arrays of shape (n, target_len), or None when the
    native library is unavailable (the caller falls back to Python).
    Raises RuntimeError on decode errors (bad file, unsupported encoding).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(clean_paths)
    if len(noisy_paths) != n:
        raise ValueError(f"{n} clean paths but {len(noisy_paths)} noisy ones")
    x = np.zeros((n, target_len), dtype=np.float32)
    y = np.zeros((n, target_len), dtype=np.float32)
    c_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in clean_paths])
    n_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in noisy_paths])
    err = ctypes.create_string_buffer(1024)
    rc = lib.sgmse_load_pair_batch(
        c_arr, n_arr, n, target_len, int(random_crop), seed,
        _NORM_MODES[normalize],
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        err, len(err))
    if rc != 0:
        raise RuntimeError(f"native wav batch load failed: {err.value.decode()}")
    return x, y


def read_wav_native(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode one WAV (first channel) natively; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_long(0)
    out_sr = ctypes.c_int(0)
    err = ctypes.create_string_buffer(1024)
    # One decode pass: the file size in bytes bounds the sample count (>= 1
    # byte per mono sample for every supported encoding).
    max_len = max(os.path.getsize(path), 1)
    buf = np.zeros((max_len,), dtype=np.float32)
    rc = lib.sgmse_read_wav(os.fsencode(str(path)),
                            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            max_len, ctypes.byref(out_len),
                            ctypes.byref(out_sr), err, len(err))
    if rc != 0:
        raise RuntimeError(f"native wav read failed: {err.value.decode()}")
    return buf[: out_len.value].copy(), out_sr.value
