"""Synthesize a self-contained speech-denoising corpus (no external data).
The port's copy of ``preprocessing/create_synthetic_speech.py``: the same
flags, seed and draws, and the same ``write_wav``, so the same corpus, byte
for byte.

The WSJ0 corpus scripts assume WSJ0 + a noise corpus on disk; without
them, this script generates a speech-LIKE
corpus from first principles: voiced harmonic excitation (random f0 contour)
shaped by slowly-moving formant resonators, with unvoiced fricative bursts and
a syllabic amplitude envelope — enough spectro-temporal structure that
denoising it requires learning actual signal structure, not just spectral
subtraction. Noise is a white + pink mixture, power-matched at a uniformly
drawn SNR exactly like the WSJ0 mixing recipe (``mixing.py``).

Used by the learn-then-enhance-better demonstration
(``sgmse_tpu_torch/tools/learn_demo.py``).

Usage:
    python -m sgmse_tpu_torch.preprocessing.create_synthetic_speech <target_dir> \
        [--num_train 256] [--num_valid 16] [--num_test 16] \
        [--seconds 2.2] [--sr 16000] [--min_snr 0] [--max_snr 10] [--seed 0]
"""
from __future__ import annotations

from argparse import ArgumentParser
from typing import List, Optional

import numpy as np

from ..data.wav import write_wav
from .mixing import make_split_dirs


def _formant_filter(x: np.ndarray, sr: int, formants, bandwidths) -> np.ndarray:
    """Cascade of 2nd-order resonators (one per formant), applied via FFT to
    keep this dependency-free (no scipy.signal requirement)."""
    n = len(x)
    X = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    H = np.ones_like(freqs, dtype=np.complex128)
    for fc, bw in zip(formants, bandwidths):
        # resonator magnitude response
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        z = np.exp(2j * np.pi * freqs / sr)
        H *= (1 - r) / (1 - 2 * r * np.cos(theta) * z**-1 + (r**2) * z**-2 + 1e-12)
    return np.fft.irfft(X * H, n=n)


def synth_utterance(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    """One speech-like utterance: voiced harmonics + fricative bursts, syllabic
    envelope, slowly moving formants."""
    n = int(seconds * sr)
    t = np.arange(n) / sr

    # f0 contour: random walk around a speaker-specific base pitch
    f0_base = rng.uniform(90.0, 250.0)
    drift = np.cumsum(rng.standard_normal(n)) / sr
    drift = drift / (np.abs(drift).max() + 1e-9) * rng.uniform(10.0, 40.0)
    f0 = np.clip(f0_base + drift, 70.0, 320.0)
    phase = 2 * np.pi * np.cumsum(f0) / sr

    # voiced source: harmonics with 1/h rolloff + jitter
    voiced = np.zeros(n)
    for h in range(1, 24):
        voiced += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h
    # formant shaping (3 formants, slow random motion handled per-utterance)
    formants = [rng.uniform(300, 900), rng.uniform(900, 2200), rng.uniform(2200, 3400)]
    bandwidths = [80.0, 120.0, 180.0]
    voiced = _formant_filter(voiced, sr, formants, bandwidths)

    # unvoiced source: high-passed noise bursts (fricative-ish)
    unvoiced = rng.standard_normal(n)
    U = np.fft.rfft(unvoiced)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    U *= np.clip((freqs - 1500.0) / 2500.0, 0.0, 1.0)
    unvoiced = np.fft.irfft(U, n=n)

    # syllabic envelope at ~2-5 Hz; voicing flag alternates per syllable
    syl_rate = rng.uniform(2.0, 5.0)
    env = 0.5 * (1 - np.cos(2 * np.pi * syl_rate * t + rng.uniform(0, 2 * np.pi)))
    env = env ** rng.uniform(1.0, 2.0)
    voicing = (np.sin(2 * np.pi * syl_rate / 2 * t + rng.uniform(0, 2 * np.pi)) >
               rng.uniform(-0.6, 0.0))

    x = env * np.where(voicing, voiced, 0.35 * unvoiced)
    x = x / (np.abs(x).max() + 1e-9) * rng.uniform(0.3, 0.8)
    return x.astype(np.float64)


def make_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """White + pink noise mixture."""
    white = rng.standard_normal(n)
    pink_spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n)
    pink_spec /= np.sqrt(np.maximum(freqs, 1.0 / n))
    pink = np.fft.irfft(pink_spec, n=n)
    pink /= np.std(pink) + 1e-12
    w = rng.uniform(0.2, 0.8)
    return w * white + (1 - w) * pink


def mix(rng: np.random.Generator, s: np.ndarray, min_snr: float, max_snr: float
        ) -> np.ndarray:
    """Power-matched mixing at a uniform SNR (same math as mixing.py
    mix_at_random_snr, explicit-rng form)."""
    snr_dB = rng.uniform(min_snr, max_snr)
    n = make_noise(rng, len(s))
    speech_power = np.sum(s**2) / len(s)
    noise_power = np.sum(n**2) / len(n)
    target = speech_power * 10 ** (-snr_dB / 10)
    return s + n * np.sqrt(target / noise_power)


def main(argv: Optional[List[str]] = None):
    parser = ArgumentParser()
    parser.add_argument("target", type=str)
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_valid", type=int, default=16)
    parser.add_argument("--num_test", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=2.2)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--min_snr", type=float, default=0.0)
    parser.add_argument("--max_snr", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    dirs = make_split_dirs(args.target)
    rng = np.random.default_rng(args.seed)
    counts = {"train": args.num_train, "valid": args.num_valid, "test": args.num_test}
    for split, count in counts.items():
        for i in range(count):
            s = synth_utterance(rng, args.seconds, args.sr)
            y = mix(rng, s, args.min_snr, args.max_snr)
            peak = max(np.abs(y).max(), np.abs(s).max())
            if peak > 0.99:  # common headroom so the pair stays clip-free
                s, y = s * 0.99 / peak, y * 0.99 / peak
            name = f"synth_{split}_{i:04d}.wav"
            write_wav(dirs[(split, "clean")] / name, s.astype(np.float32), args.sr)
            write_wav(dirs[(split, "noisy")] / name, y.astype(np.float32), args.sr)
        print(f"{split}: {count} pairs")


if __name__ == "__main__":
    main()
