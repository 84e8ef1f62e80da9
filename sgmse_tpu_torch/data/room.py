"""Minimal shoebox room acoustics: image-source RIR synthesis. The port's
copy of ``sgmse_tpu/data/room.py`` (which cannot be imported without JAX),
unchanged.

Fallback for environments without `pyroomacoustics` (the dereverberation
corpus script, ``preprocessing/create_wsj0_reverb.py``, builds rooms with
pra.ShoeBox + inverse_sabine when it is installed). This module provides a
compatible numpy implementation of the pieces used there:

- inverse_sabine(rt60, room_dim) -> (energy_absorption, max_order)
- shoebox_rir(room_dim, absorption, source, mic, fs, max_order) via the
  image-source method with fractional-delay (linear-interp) taps
- measure_rt60 via Schroeder backward integration
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np

C_SOUND = 343.0  # m/s, pyroomacoustics default


def inverse_sabine(rt60: float, room_dim: Sequence[float]) -> Tuple[float, int]:
    """Absorption + ISM order for a target RT60 (Sabine's formula).

    Matches pyroomacoustics.inverse_sabine: a = 0.1611 V / (S rt60) as the
    *energy* absorption, and max_order such that the image sources span the
    RT60 distance.
    """
    room_dim = np.asarray(room_dim, dtype=np.float64)
    volume = float(np.prod(room_dim))
    surface = 2.0 * (room_dim[0] * room_dim[1] + room_dim[1] * room_dim[2]
                     + room_dim[0] * room_dim[2])
    sab_coeff = 24 * np.log(10) / C_SOUND  # 0.1611 s/m
    e_absorption = sab_coeff * volume / (surface * rt60)
    if e_absorption >= 1.0:
        raise ValueError("rt60 too small for this room (absorption >= 1)")
    max_order = int(np.ceil(C_SOUND * rt60 / np.min(room_dim)))
    return float(e_absorption), max_order


def shoebox_rir(room_dim, e_absorption: float, source, mic, fs: int = 16000,
                max_order: int = 3, extra_taps: int = 256) -> np.ndarray:
    """Image-source RIR for a shoebox room, uniform wall absorption.

    Reflection (amplitude) coefficient per wall hit: sqrt(1 - e_absorption).
    Linear-interpolated fractional delays; 1/(4 pi d) spherical attenuation
    normalized to the direct path like pyroomacoustics' default.
    """
    room_dim = np.asarray(room_dim, dtype=np.float64)
    source = np.asarray(source, dtype=np.float64)
    mic = np.asarray(mic, dtype=np.float64)
    refl = np.sqrt(max(1.0 - e_absorption, 0.0))

    images = []
    orders = range(-max_order, max_order + 1)
    for nx, ny, nz in itertools.product(orders, orders, orders):
        n = (nx, ny, nz)
        if sum(abs(v) for v in n) > max_order:
            continue
        pos = np.empty(3)
        hits = 0
        for d in range(3):
            # image position along axis d for reflection index n[d]
            L = room_dim[d]
            if n[d] % 2 == 0:
                pos[d] = n[d] * L + source[d]
            else:
                pos[d] = (n[d] + 1) * L - source[d]
            hits += abs(n[d])
        dist = float(np.linalg.norm(pos - mic))
        amp = (refl**hits) / max(dist, 1e-3)
        images.append((dist, amp))

    max_dist = max(d for d, _ in images)
    rir_len = int(np.ceil(max_dist / C_SOUND * fs)) + extra_taps
    rir = np.zeros(rir_len, dtype=np.float64)
    for dist, amp in images:
        delay = dist / C_SOUND * fs
        i0 = int(np.floor(delay))
        frac = delay - i0
        rir[i0] += amp * (1.0 - frac)
        rir[i0 + 1] += amp * frac
    return rir / (4.0 * np.pi)


def simulate(room_dim, e_absorption, source, mic, signal, fs: int = 16000,
             max_order: int = 3) -> np.ndarray:
    """Convolve `signal` with the shoebox RIR (full convolution)."""
    from scipy.signal import fftconvolve

    rir = shoebox_rir(room_dim, e_absorption, source, mic, fs=fs,
                      max_order=max_order)
    return fftconvolve(np.asarray(signal, dtype=np.float64), rir)


def measure_rt60(rir: np.ndarray, fs: int = 16000, decay_db: float = 30.0) -> float:
    """RT60 from Schroeder backward integration (T30 extrapolated)."""
    energy = rir**2
    sch = np.cumsum(energy[::-1])[::-1]
    sch_db = 10.0 * np.log10(np.maximum(sch / max(sch[0], 1e-30), 1e-30))
    i5 = int(np.argmax(sch_db <= -5.0))
    i_decay = int(np.argmax(sch_db <= -5.0 - decay_db))
    if i_decay <= i5:
        return float("nan")
    t = (i_decay - i5) / fs
    return float(t * 60.0 / decay_db)
