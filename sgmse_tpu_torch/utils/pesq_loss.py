"""Differentiable PESQ training loss: the Schroedinger-bridge recipe's
``--pesq_weight`` term of the data-prediction loss.

The port's copy of ``sgmse_tpu/utils/pesq_loss.py`` (that module cannot be
imported without JAX, because importing ``sgmse_tpu`` imports it): a
from-scratch differentiable approximation of the ITU-T P.862 perceptual model
(16 kHz level alignment, 512-sample Hann STFT at 50% overlap, 49 Bark bands,
clamped frequency-response and per-frame gain equalisation, Zwicker loudness,
masked symmetric and asymmetric disturbance densities, L6 over syllable
blocks and L2 over time, MOS = 4.5 - 0.1 d_sym - 0.0309 d_asym). There is no
time alignment: training pairs are sample-aligned by construction.

The numpy constants are the JAX module's, copied as they are. The rest is
plain float32 tensor arithmetic on the input's device, differentiable in
``deg``, with the JAX function's conventions: the frames are padded with
zeros, not by reflection; the maximum over frames (``amax``) and ``minimum``
split their gradient evenly between ties, as JAX's do; the ``_EPS`` guards
inside the roots keep the gradient finite at identical and at silent inputs.
The clips are ``clamp``, which passes the whole gradient at a value exactly
on a bound where ``jnp.clip`` passes half; no input of the tests lands on
one. The Bark projection runs in float64 and is rounded to float32, so TF32,
which a caller may allow for float32 products, touches it neither forward
nor backward.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-12

# P.862 operating constants (16 kHz mode).
_SR = 16000
_NFFT = 512
_HOP = 256
_NBARK = 49
_ZWICKER_POWER = 0.23
# Standard listening level target for the level-alignment stage (P.862 scales
# speech to 79 dB SPL; expressed here as a target mean band power).
_TARGET_POWER = 1e7


def _bark_scale(f_hz: np.ndarray) -> np.ndarray:
    """Zwicker Bark warping z(f) = 13 atan(0.00076 f) + 3.5 atan((f/7500)^2)."""
    return 13.0 * np.arctan(0.00076 * f_hz) + 3.5 * np.arctan((f_hz / 7500.0) ** 2)


def _make_filterbank() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rectangular Bark filterbank (F_bins, 49), band widths, band centers (Hz)."""
    freqs = np.fft.rfftfreq(_NFFT, d=1.0 / _SR)  # (257,)
    z = _bark_scale(freqs)
    z_max = _bark_scale(np.array([_SR / 2.0]))[0]
    edges = np.linspace(0.0, z_max, _NBARK + 1)
    fb = np.zeros((freqs.shape[0], _NBARK), dtype=np.float32)
    for b in range(_NBARK):
        in_band = (z >= edges[b]) & (z < edges[b + 1])
        if not in_band.any():  # guarantee every band sees >= 1 bin
            idx = np.argmin(np.abs(z - 0.5 * (edges[b] + edges[b + 1])))
            fb[idx, b] = 1.0
        else:
            fb[in_band, b] = 1.0
    # Normalize so each band reports mean bin power (keeps magnitudes comparable).
    fb = fb / np.maximum(fb.sum(axis=0, keepdims=True), 1.0)
    widths = np.diff(edges).astype(np.float32)  # Bark width per band (uniform here)
    centers_z = 0.5 * (edges[:-1] + edges[1:])
    # Invert z(f) numerically for the band centers.
    fine = np.linspace(0.0, _SR / 2.0, 4096)
    centers_hz = np.interp(centers_z, _bark_scale(fine), fine).astype(np.float32)
    return fb, widths, centers_hz


_FB, _WIDTHS, _CENTERS_HZ = _make_filterbank()


# Absolute hearing threshold per band, diffuse-field approximation (dB SPL ->
# power on the internal scale). Piecewise fit of the ISO 389-7 threshold curve.
def _abs_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    f = np.maximum(f_hz, 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


_P0 = (10.0 ** (_abs_threshold_db(_CENTERS_HZ) / 10.0)).astype(np.float32)
_WINDOW = np.hanning(_NFFT + 1)[:-1].astype(np.float32)


class PesqLoss:
    """Differentiable PESQ-structure loss: ``loss(ref, deg) -> (B,)``.

    Construct with a scale ``factor`` and the ``sample_rate`` (16 kHz only);
    a call returns ``factor * (4.5 - mos)`` per utterance (decreasing in
    quality, ~0 for identical signals); ``mos`` gives the raw quality estimate
    in [1.0, 4.64]. Inputs are ``(L,)`` or ``(B, L)`` float32 waveforms.
    """

    def __init__(self, factor: float, sample_rate: int = 16000):
        if sample_rate != _SR:
            raise ValueError(
                f"PesqLoss operates at 16 kHz (got sr={sample_rate}); resample "
                "the training pairs or disable --pesq_weight for other rates.")
        self.factor = factor
        self._consts: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _const(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The numpy constants as tensors on ``device`` (copied there once)."""
        if device not in self._consts:
            self._consts[device] = dict(
                fb=torch.as_tensor(_FB, dtype=torch.float64, device=device),
                window=torch.as_tensor(_WINDOW, device=device),
                p0=torch.as_tensor(_P0, device=device),
                widths=torch.as_tensor(_WIDTHS, device=device))
        return self._consts[device]

    @staticmethod
    def _stft_power(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
        """Hann STFT power spectrogram, (B, T, F). Frames centred by zero padding."""
        pad = _NFFT // 2
        frames = F.pad(x, (pad, pad)).unfold(-1, _NFFT, _HOP) * window  # (B, T, NFFT)
        return torch.fft.rfft(frames, dim=-1).abs() ** 2

    # -- perceptual model -----------------------------------------------------------
    @staticmethod
    def _loudness(bark_pow: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
        """Zwicker intensity->loudness per band (B, T, 49)."""
        ratio = bark_pow / p0
        sl = (p0 / 0.5) ** _ZWICKER_POWER
        loud = sl * ((0.5 + 0.5 * ratio) ** _ZWICKER_POWER - 1.0)
        return loud.clamp_min(0.0)

    def _disturbance(self, ref: torch.Tensor, deg: torch.Tensor):
        """Bark powers -> (d_sym, d_asym) aggregated per utterance."""
        c = self._const(ref.device)
        # Active-speech weighting from the reference frame power: a smooth gate
        # standing in for P.862's hard silent-frame exclusion.
        frame_pow = torch.sum(ref, dim=-1)  # (B, T)
        peak = torch.amax(frame_pow, dim=-1, keepdim=True)
        active = torch.sigmoid(
            2.0 * (torch.log10(frame_pow + _EPS) - torch.log10(peak * 1e-4 + _EPS)))

        # Frequency-response equalization: per-band mean power ratio, clamped.
        mean_ref = torch.mean(ref, dim=1, keepdim=True)
        mean_deg = torch.mean(deg, dim=1, keepdim=True)
        band_eq = torch.clamp((mean_deg + 1000.0) / (mean_ref + 1000.0), 0.01, 100.0)
        ref_eq = ref * band_eq

        # Per-frame gain equalization of the degraded signal, clamped.
        num = torch.sum(ref_eq, dim=-1, keepdim=True) + 5e3
        den = torch.sum(deg, dim=-1, keepdim=True) + 5e3
        gain = torch.clamp(num / den, 3e-4, 5.0)
        deg_eq = deg * gain

        l_ref = self._loudness(ref_eq, c["p0"])
        l_deg = self._loudness(deg_eq, c["p0"])

        # Masked disturbance density.
        d = l_deg - l_ref
        m = 0.25 * torch.minimum(l_deg, l_ref)
        d = torch.sign(d) * (torch.abs(d) - m).clamp_min(0.0)

        widths = c["widths"]
        # Symmetric disturbance: width-weighted L2 over bands (per frame). _EPS
        # inside the root: d is exactly zero where deg == ref, and the slope of
        # sqrt at 0 would make the gradient NaN.
        d_sym = torch.sqrt(torch.sum((d ** 2) * widths, dim=-1) / torch.sum(widths) + _EPS)

        # Asymmetric disturbance: penalize additive distortions more.
        asym = ((deg_eq + 50.0) / (ref_eq + 50.0)) ** 1.2
        asym = asym.clamp_max(12.0).masked_fill(asym < 3.0, 0.0)
        d_asym = torch.sum(torch.abs(d) * asym * widths, dim=-1) / (torch.sum(widths) + _EPS)

        def aggregate(dens):
            b, t = dens.shape
            # L6 over ~320 ms syllable blocks (20 frames at 16 ms hop), then L2;
            # _EPS inside both roots for the same reason as d_sym's.
            blk = 20
            t_pad = (-t) % blk
            blocks = F.pad(dens, (0, t_pad)).reshape(b, -1, blk)
            wb = F.pad(active, (0, t_pad)).reshape(b, -1, blk)
            l6 = (torch.sum(wb * blocks ** 6, dim=-1)
                  / (torch.sum(wb, dim=-1) + _EPS) + _EPS) ** (1.0 / 6.0)
            return torch.sqrt(torch.mean(l6 ** 2, dim=-1) + _EPS)

        return aggregate(d_sym), aggregate(d_asym)

    def _bark_powers(self, ref: torch.Tensor, deg: torch.Tensor):
        c = self._const(ref.device)
        # Level alignment: scale both signals so the reference band power hits
        # the standard listening level.
        p_ref = torch.mean(ref ** 2, dim=-1, keepdim=True)
        scale = torch.sqrt(_TARGET_POWER / (p_ref * _SR / 2.0 + _EPS))
        ref, deg = ref * scale, deg * scale

        def bark(x):  # float64 product, float32 result: no TF32 either way
            return (self._stft_power(x, c["window"]).double() @ c["fb"]).float()

        return bark(ref), bark(deg)

    def _d(self, ref: torch.Tensor, deg: torch.Tensor):
        ref_bark, deg_bark = self._bark_powers(ref.float(), deg.float())
        return self._disturbance(ref_bark, deg_bark)

    def mos(self, ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
        """Raw PESQ-style MOS per utterance, clipped to [1.0, 4.64]."""
        squeeze = ref.ndim == 1
        if squeeze:
            ref, deg = ref[None], deg[None]
        d_sym, d_asym = self._d(ref, deg)
        raw = torch.clamp(4.5 - 0.1 * d_sym - 0.0309 * d_asym, 1.0, 4.64)
        return raw[0] if squeeze else raw

    def __call__(self, ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
        """Per-utterance loss, factor * (4.5 - mos). Differentiable in ``deg``."""
        squeeze = ref.ndim == 1
        if squeeze:
            ref, deg = ref[None], deg[None]
        d_sym, d_asym = self._d(ref, deg)
        loss = self.factor * (0.1 * d_sym + 0.0309 * d_asym)
        return loss[0] if squeeze else loss
