"""WAV file IO and resampling (numpy/scipy copy of ``sgmse_tpu/data/wav.py``,
which cannot be imported without JAX).

Reads/writes RIFF WAVE via the stdlib ``wave`` module + numpy (PCM16/24/32,
8-bit) and resamples with a polyphase filter (scipy.signal.resample_poly).
"""
from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np
from scipy.signal import resample_poly

PathLike = Union[str, Path]


def _wave_target(path):
    """`wave.open` target: file-like objects pass through (serving reads
    request bodies from BytesIO), paths are normalized to str."""
    return path if hasattr(path, "read") or hasattr(path, "write") else str(path)


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path or binary file-like) -> (float32 array in
    [-1, 1] of shape (channels, n), sr).

    Matches torchaudio.load conventions: channel-major output, float32 scaling
    by the PCM full-scale value.
    """
    with wave.open(_wave_target(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    data = data.reshape(-1, n_channels).T  # (channels, n)
    return np.ascontiguousarray(data), sr


def write_wav(path: PathLike, data: np.ndarray, sr: int) -> None:
    """Write float data in [-1, 1] as a 16-bit PCM WAV (soundfile.write
    default). `path` may be a filesystem path or a binary file-like object."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    clipped = np.clip(data, -1.0, 1.0)
    pcm = (clipped * 32767.0).round().astype("<i2")
    with wave.open(_wave_target(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes())


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replaces librosa.resample in the reference CLIs)."""
    if orig_sr == target_sr:
        return x
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)
