"""Evaluation metrics of the in-training evaluation: SI-SDR, STOI/ESTOI and
PESQ (gated).

The port's copy of the parts of ``sgmse_tpu/utils/metrics.py`` that training
uses (that module cannot be imported without JAX, because importing
``sgmse_tpu`` imports it), unchanged: ``si_sdr``, the self-contained numpy
STOI / extended STOI (Taal et al. 2011; Jensen & Taal 2016) and ``pesq_wb``,
which takes the ``pesq`` conformance package when it is installed and the
built-in P.862 (``utils/p862.py``) otherwise. Plain numpy, on the host.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..data.wav import resample

EPS = np.finfo(np.float64).eps


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    alpha = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    return float(10 * np.log10(np.linalg.norm(alpha * s) ** 2
                               / np.linalg.norm(alpha * s - s_hat) ** 2))


# ---------------------------------------------------------------------------------------
# STOI / ESTOI (self-contained; Taal et al. 2011, Jensen & Taal 2016)
# ---------------------------------------------------------------------------------------

_STOI_FS = 10000        # internal sample rate
_STOI_FRAME = 256       # analysis frame
_STOI_NFFT = 512
_STOI_NUMBAND = 15      # 1/3-octave bands
_STOI_MINFREQ = 150.0   # lowest band center
_STOI_N = 30            # frames per intermediate segment (384 ms)
_STOI_BETA = -15.0      # SDR clipping bound (classic STOI only)
_STOI_DYN_RANGE = 40.0  # silent frame removal range


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = (2.0 ** (1.0 / 3.0)) ** k * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1
    return obm, cf


def _frames(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - framelen)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    xf = _frames(x, framelen, hop) * w
    yf = _frames(y, framelen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > np.max(energies) - dyn_range
    xf, yf = xf[mask], yf[mask]
    # overlap-add back to signals
    n_out = framelen + hop * (len(xf) - 1)
    x_out = np.zeros(n_out)
    y_out = np.zeros(n_out)
    for i in range(len(xf)):
        x_out[i * hop:i * hop + framelen] += xf[i]
        y_out[i * hop:i * hop + framelen] += yf[i]
    return x_out, y_out


def _stft_mag(x, framelen, hop, nfft):
    w = np.hanning(framelen + 2)[1:-1]
    frames = _frames(x, framelen, hop) * w
    return np.abs(np.fft.rfft(frames, n=nfft, axis=1)).T  # (freq, time)


def _row_col_normalize(x):
    """Per-segment row then column mean/variance normalization (ESTOI)."""
    x = x - np.mean(x, axis=-1, keepdims=True)
    x = x / (np.sqrt(np.sum(x**2, axis=-1, keepdims=True)) + EPS)
    x = x - np.mean(x, axis=-2, keepdims=True)
    x = x / (np.sqrt(np.sum(x**2, axis=-2, keepdims=True)) + EPS)
    return x


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """Short-Time Objective Intelligibility of degraded `y` vs clean `x`.

    Drop-in equivalent of ``pystoi.stoi`` (used at reference model.py:249,
    calc_metrics.py:44). Returns a value in ~[0, 1].
    """
    x = np.asarray(x, dtype=np.float64).squeeze()
    y = np.asarray(y, dtype=np.float64).squeeze()
    assert x.shape == y.shape, "x and y must have the same length"

    if fs_sig != _STOI_FS:
        x = resample(x, fs_sig, _STOI_FS).astype(np.float64)
        y = resample(y, fs_sig, _STOI_FS).astype(np.float64)

    hop = _STOI_FRAME // 2
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_FRAME, hop)

    x_spec = _stft_mag(x, _STOI_FRAME, hop, _STOI_NFFT)
    y_spec = _stft_mag(y, _STOI_FRAME, hop, _STOI_NFFT)

    obm, _ = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NUMBAND, _STOI_MINFREQ)
    x_tob = np.sqrt(obm @ (x_spec**2))  # (bands, frames)
    y_tob = np.sqrt(obm @ (y_spec**2))

    n_frames = x_tob.shape[1]
    if n_frames < _STOI_N:
        warnings.warn("Signal too short for STOI: fewer than 30 frames after VAD")
        return np.nan

    # sliding segments of N frames, hop 1
    segs = [slice(m - _STOI_N, m) for m in range(_STOI_N, n_frames + 1)]
    x_segments = np.stack([x_tob[:, s] for s in segs])  # (M, J, N)
    y_segments = np.stack([y_tob[:, s] for s in segs])

    if extended:
        x_n = _row_col_normalize(x_segments)
        y_n = _row_col_normalize(y_segments)
        return float(np.sum(x_n * y_n / _STOI_N) / x_n.shape[0])
    else:
        # classic STOI: per-row scaling + clipping, then row correlations
        norm_const = (np.linalg.norm(x_segments, axis=2, keepdims=True)
                      / (np.linalg.norm(y_segments, axis=2, keepdims=True) + EPS))
        y_scaled = y_segments * norm_const
        clip_value = 10 ** (-_STOI_BETA / 20)
        y_prime = np.minimum(y_scaled, x_segments * (1 + clip_value))
        xm = x_segments - np.mean(x_segments, axis=-1, keepdims=True)
        ym = y_prime - np.mean(y_prime, axis=-1, keepdims=True)
        corr = np.sum(xm * ym, axis=-1) / (
            np.linalg.norm(xm, axis=-1) * np.linalg.norm(ym, axis=-1) + EPS)
        return float(np.mean(corr))


# ---------------------------------------------------------------------------------------
# PESQ (conformance `pesq` C library when installed, built-in P.862 otherwise)
# ---------------------------------------------------------------------------------------

_PESQ_WARNED = False


def pesq_impl() -> str:
    """Which PESQ implementation `pesq_wb` will use: 'pesq-conformance' (the
    ITU-certified C extension) or 'builtin-p862' (rank-faithful fallback).
    Callers writing metric artifacts should record this so archived scores
    are never mistaken for conformance numbers (cli/calc_metrics.py does)."""
    try:
        import pesq  # noqa: F401
        return "pesq-conformance"
    except ImportError:
        return "builtin-p862"


def pesq_wb(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """PESQ MOS-LQO: conformance `pesq` package if installed, else the
    built-in P.862-structured implementation (`sgmse_tpu_torch.utils.p862`).

    Mirrors `pesq.pesq(16000, x, x_hat, 'wb')` calls (reference model.py:247,
    calc_metrics.py:42). The reference hard-depends on the C extension; here
    the metric is always available, so best-PESQ checkpointing
    (checkpoint.py) and validation logging work in every environment,
    the machine with the card included.
    """
    global _PESQ_WARNED
    try:
        from pesq import pesq as _pesq
    except ImportError:
        _pesq = None
    if _pesq is not None:
        try:
            return float(_pesq(fs, ref, deg, mode))
        except Exception as e:
            # Match the fallback path's error contract: the pesq package
            # raises (e.g. NoUtterancesError on a silent validation clip)
            # where the builtin maps to NaN; a crash mid-validation is worse
            # than a NaN — mean_std and the checkpoint policies are NaN-robust.
            # Warn loudly: downstream means silently skip NaN, so systematic
            # failures would otherwise shrink the averaged set unnoticed.
            # (Python's default filter dedups repeated identical messages.)
            warnings.warn(f"pesq scorer failed ({e!r}) — recording NaN; "
                          "NaN files are excluded from reported means.")
            return float("nan")
    if not _PESQ_WARNED:
        warnings.warn(
            "`pesq` conformance package not installed — falling back to the "
            "built-in P.862-structured implementation (sgmse_tpu_torch.utils.p862). "
            "Scores are rank-faithful with exact identity anchors but not "
            "ITU-conformance-certified; install `pesq` for certified numbers.")
        _PESQ_WARNED = True
    try:
        from .p862 import pesq as _builtin_pesq
        return float(_builtin_pesq(fs, ref, deg, mode))
    except ValueError as e:
        warnings.warn(f"builtin P.862 scorer failed ({e!r}) — recording NaN; "
                      "NaN files are excluded from reported means.")
        return float("nan")  # e.g. signal too short for PESQ
