"""Seeded speech-like corpora: the benchmark's inputs, made from ``--seed``.

The synthesis is a frozen copy of the port's
``preprocessing/create_synthetic_speech.py`` at commit d7fbb27
(``synth_utterance``, ``make_noise``, ``mix``): voiced harmonics through
formant resonators, fricative bursts, a syllabic envelope; white + pink noise
power-matched at an SNR drawn uniformly from the traffic's range. The
lengths are not drawn: every seed gets the same set of lengths (a traffic
file states them), so every seed gives the same amount and shape of work,
and only the signals differ.
"""
from __future__ import annotations

import wave
from pathlib import Path
from typing import List, Tuple

import numpy as np

from . import seeds


def _formant_filter(x, sr, formants, bandwidths):
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    h = np.ones_like(freqs, dtype=np.complex128)
    z = np.exp(2j * np.pi * freqs / sr)
    for fc, bw in zip(formants, bandwidths):
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        h *= (1 - r) / (1 - 2 * r * np.cos(theta) * z ** -1 + (r ** 2) * z ** -2 + 1e-12)
    return np.fft.irfft(spec * h, n=n)


def synth_utterance(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    f0_base = rng.uniform(90.0, 250.0)
    drift = np.cumsum(rng.standard_normal(n)) / sr
    drift = drift / (np.abs(drift).max() + 1e-9) * rng.uniform(10.0, 40.0)
    f0 = np.clip(f0_base + drift, 70.0, 320.0)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = np.zeros(n)
    for h in range(1, 24):
        voiced += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h
    formants = [rng.uniform(300, 900), rng.uniform(900, 2200), rng.uniform(2200, 3400)]
    voiced = _formant_filter(voiced, sr, formants, [80.0, 120.0, 180.0])
    unvoiced_spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    unvoiced = np.fft.irfft(unvoiced_spec * np.clip((freqs - 1500.0) / 2500.0, 0.0, 1.0), n=n)
    syl_rate = rng.uniform(2.0, 5.0)
    env = 0.5 * (1 - np.cos(2 * np.pi * syl_rate * t + rng.uniform(0, 2 * np.pi)))
    env = env ** rng.uniform(1.0, 2.0)
    voicing = (np.sin(2 * np.pi * syl_rate / 2 * t + rng.uniform(0, 2 * np.pi))
               > rng.uniform(-0.6, 0.0))
    x = env * np.where(voicing, voiced, 0.35 * unvoiced)
    return x / (np.abs(x).max() + 1e-9) * rng.uniform(0.3, 0.8)


def make_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    white = rng.standard_normal(n)
    pink_spec = np.fft.rfft(rng.standard_normal(n))
    pink_spec /= np.sqrt(np.maximum(np.fft.rfftfreq(n), 1.0 / n))
    pink = np.fft.irfft(pink_spec, n=n)
    pink /= np.std(pink) + 1e-12
    w = rng.uniform(0.2, 0.8)
    return w * white + (1 - w) * pink


def pair(rng: np.random.Generator, n: int, sr: int, min_snr: float, max_snr: float):
    """(clean, noisy) float32 of ``n`` samples, with common headroom below 0.99."""
    s = synth_utterance(rng, n, sr)
    snr_db = rng.uniform(min_snr, max_snr)
    noise = make_noise(rng, n)
    target = np.mean(s ** 2) * 10 ** (-snr_db / 10)
    y = s + noise * np.sqrt(target / np.mean(noise ** 2))
    peak = max(np.abs(y).max(), np.abs(s).max())
    if peak > 0.99:
        s, y = s * 0.99 / peak, y * 0.99 / peak
    return s.astype(np.float32), y.astype(np.float32)


def lengths(spec: dict) -> List[int]:
    """The traffic's utterance lengths in samples: ``groups`` of
    [count, low seconds, high seconds], each spread evenly over its range
    (stratified, the same for every seed)."""
    sr = spec["sample_rate"]
    out = []
    for count, lo, hi in spec["groups"]:
        out += [int(round((lo + (hi - lo) * (i + 0.5) / count) * sr)) for i in range(count)]
    return out


def make(spec: dict, seed: int, purpose: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(clean, noisy) pairs of ``lengths(spec)``, in a seeded order."""
    rng = seeds.rng(seed, purpose)
    ns = lengths(spec)
    order = rng.permutation(len(ns))
    return [pair(rng, ns[i], spec["sample_rate"], *spec["snr_db"]) for i in order]


def write_pcm16(path: Path, data: np.ndarray, sr: int) -> None:
    """A mono 16-bit PCM wav of ``data`` in [-1, 1]."""
    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).round().astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_pcm16(path: Path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0
