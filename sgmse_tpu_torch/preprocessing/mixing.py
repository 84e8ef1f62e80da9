"""Shared helpers of the corpus scripts. The port's copy of
``preprocessing/mixing.py``.

The mixing logic of the WSJ0 corpus scripts: draw the SNR uniformly, pick a
random noise crop, scale the noise to the target power, add. Seeds and draw
order are those of the JAX package's scripts, so the corpora are the same,
byte for byte, given the same inputs.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.wav import read_wav, resample, write_wav


def load_mono(path, sr=None):
    """Load a wav as mono float at an optional target sample rate."""
    x, file_sr = read_wav(path)
    x = x[0]
    if sr is not None and file_sr != sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x.astype(np.float64), file_sr


def mix_at_random_snr(s: np.ndarray, noises, min_snr: float, max_snr: float):
    """One mixing draw. Returns the noisy mixture.

    Draw order: snr, noise index, crop start.
    """
    snr_dB = np.random.uniform(min_snr, max_snr)
    noise_ind = np.random.randint(len(noises))
    speech_power = 1 / len(s) * np.sum(s**2)

    n = noises[noise_ind]
    start = np.random.randint(len(n) - len(s))
    n = n[start:start + len(s)]

    noise_power = 1 / len(n) * np.sum(n**2)
    noise_power_target = speech_power * np.power(10, -snr_dB / 10)
    k = noise_power_target / noise_power
    n = n * np.sqrt(k)
    return s + n


def make_split_dirs(target: str):
    """Create {target}/{split}/{clean,noisy} directories; return path dict."""
    out = {}
    for split in ("train", "valid", "test"):
        for kind in ("clean", "noisy"):
            p = Path(target) / split / kind
            p.mkdir(parents=True, exist_ok=True)
            out[(split, kind)] = p
    return out


def write_pair(paths, split, file_name, clean, noisy, sr):
    write_wav(paths[(split, "clean")] / file_name, clean.astype(np.float32), sr)
    write_wav(paths[(split, "noisy")] / file_name, noisy.astype(np.float32), sr)
