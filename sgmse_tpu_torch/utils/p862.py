"""From-scratch ITU-T P.862 (PESQ) objective speech-quality metric in numpy.

The port's copy of ``sgmse_tpu/utils/p862.py`` (that module cannot be
imported without JAX, because importing ``sgmse_tpu`` imports it); the
algorithm and its constants are unchanged, and ``tests/test_torch_train.py``
holds the two to the same score.

Why this exists: the reference stack calls the external `pesq` C-extension for
best-checkpoint selection and evaluation (reference train.py:92-97,
calc_metrics.py:42-46, model.py:247). That package is not available in every
deployment environment, and a framework whose checkpoint policy silently goes
inert without it is broken. This module is an independent, from-scratch
implementation of the P.862 algorithm structure so the metric is *always*
available; `sgmse_tpu_torch.utils.metrics.pesq_wb` prefers the external
conformance implementation when installed and falls back to this one.

Scope and fidelity
------------------
Implements the published P.862 (02/2001) pipeline:

  1.  level alignment of both signals to a standard listening level,
      measured in the 350-3250 Hz band,
  2.  input filtering (modified-IRS-receive-shaped bandpass for narrow-band
      mode per P.862 §10.1.2; 100 Hz high-pass for wide-band mode per
      P.862.2 §5),
  3.  time alignment (envelope-based crude delay + cross-correlation fine
      delay, applied globally),
  4.  the perceptual model: 32 ms Hann frames at 50 % overlap, Bark-domain
      warping (uniform-Bark filterbank), absolute-hearing-threshold floor,
      partial frequency-response equalization of the reference, short-term
      gain equalization of the degraded signal, Zwicker intensity->loudness
      with the low-band exponent modification,
  5.  symmetric and asymmetric disturbance densities with the 0.25*min
      masking deadzone, the (+50/+50)^1.2 asymmetry ratio with the 3.0
      threshold and 12.0 cap,
  6.  L6-over-syllables / L2-over-time aggregation with the
      ((E+1e5)/1e7)^0.04 low-energy de-emphasis and the 45.0 clip,
  7.  raw PESQ = 4.5 - 0.1 * D - 0.0309 * DA, mapped to MOS-LQO via
      P.862.1 (narrow-band) or P.862.2 (wide-band).

Deliberate simplifications (documented, structural - not shortcuts in the
perceptual model): no utterance splitting or bad-interval re-alignment (the
framework's use case compares sample-aligned signals where the global
aligner finds delay 0), and the Bark band centres / absolute thresholds are
derived from the Zwicker warping and Terhardt threshold formulas rather than
the ITU lookup tables (with the loudness scale and asymmetric-frame ceiling
refit to compensate — see the constants block). Consequently this is
*P.862-structured*, not ITU-conformance-certified; scores track the
conformance implementation in rank order, land on the exact known anchors
for identical signals (wb 4.644, nb 4.549, the documented P.862.1/.2 mapping
ceilings), and follow published PESQ-vs-SNR behavior for additive noise
within a few tenths of a MOS. Validated in tests/test_p862.py: identity
anchors, SNR monotonicity, distortion sensitivity, range, delay invariance,
and both supported rates.

This is the *metric* (numpy, host-side, non-differentiable); the JAX
package's separate `utils/pesq_loss.py` is the differentiable training-loss
counterpart (C29). Keep them distinct: the loss trades fidelity for gradients.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-20

# --- operating constants (P.862 §10.2) -------------------------------------------------
_TARGET_LEVEL_POWER = 1e7     # standard listening level, internal power units
_ACTIVE_SPEECH_DB = 79.0      # the level-aligned signal is defined as 79 dB SPL
_SYLLABLE_FRAMES = 20         # L6 aggregation window (frames)
_SYLLABLE_HOP = 10            # 50 % overlap between syllable windows
_FRAME_CLIP = 45.0            # per-frame disturbance ceiling
_MASK_FACTOR = 0.25           # deadzone: 0.25 * min(ref, deg) loudness
_ASYM_OFFSET = 50.0           # asymmetry ratio offset (band powers)
_ASYM_EXP = 1.2
_ASYM_CAP = 12.0
_ASYM_THRESH = 3.0
_FREQ_COMP_CLAMP = (0.01, 100.0)   # per-band ratio clamp (frequency compensation)
_GAIN_COMP_CLAMP = (3e-4, 5.0)     # per-frame ratio clamp (gain compensation)
_GAIN_SMOOTH = 0.8                 # first-order smoothing of the gain track
_ZWICKER_POWER = 0.23
# Calibration constants. These two are the only values retuned away from the
# ITU text: because the Bark/threshold tables here are *derived* (Zwicker +
# Terhardt formulas) rather than the ITU lookup tables, the loudness scale and
# the asymmetric-track ceiling were refit so the score-vs-SNR curve matches
# published PESQ behavior on additive noise (see tests/test_p862.py).
_SL = 0.6                          # loudness scale (Sl)
_ASYM_FRAME_CLIP = 35.0            # ceiling on asymmetric frame disturbance


def _bark(f_hz: np.ndarray) -> np.ndarray:
    """Zwicker Bark warp z(f) = 13 atan(0.00076 f) + 3.5 atan((f/7500)^2)."""
    f_hz = np.asarray(f_hz, dtype=np.float64)
    return 13.0 * np.arctan(0.00076 * f_hz) + 3.5 * np.arctan((f_hz / 7500.0) ** 2)


def _terhardt_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Absolute threshold of hearing (dB SPL), Terhardt 1979."""
    f_khz = np.maximum(np.asarray(f_hz, dtype=np.float64), 20.0) / 1000.0
    return (3.64 * f_khz ** -0.8
            - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
            + 1e-3 * f_khz ** 4)


class _Mode:
    """Precomputed tables for one (fs, mode) operating point."""

    def __init__(self, fs: int, mode: str):
        if fs not in (8000, 16000):
            raise ValueError(f"P.862 operates at 8 or 16 kHz, got {fs}")
        if mode not in ("nb", "wb"):
            raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
        if mode == "wb" and fs != 16000:
            raise ValueError("wide-band P.862.2 requires fs=16000")
        self.fs = fs
        self.mode = mode
        # 32 ms frames, 50 % overlap (P.862 §10.2.1)
        self.nfft = 512 if fs == 16000 else 256
        self.hop = self.nfft // 2
        # Band count follows the ITU tables' granularity: 49 bands at 16 kHz,
        # 42 at 8 kHz, uniform in Bark over the analysis range.
        self.n_bands = 49 if fs == 16000 else 42
        self.window = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * np.arange(self.nfft) / self.nfft))

        freqs = np.fft.rfftfreq(self.nfft, d=1.0 / fs)
        z = _bark(freqs)
        # Analysis range: the Bark axis up to Nyquist, skipping the DC bin.
        z_lo, z_hi = _bark(np.array([50.0]))[0], z[-1]
        edges = np.linspace(z_lo, z_hi, self.n_bands + 1)
        # FFT-bin -> Bark-band assignment matrix (sums bin powers per band).
        idx = np.clip(np.searchsorted(edges, z, side="right") - 1, -1, self.n_bands)
        self.binmat = np.zeros((self.n_bands, len(freqs)))
        valid = (idx >= 0) & (idx < self.n_bands)
        self.binmat[idx[valid], np.where(valid)[0]] = 1.0
        counts = self.binmat.sum(axis=1)
        # Guard: every band must own >= 1 bin (true for these nfft/band combos).
        counts = np.maximum(counts, 1.0)
        # Band-power densities: mean bin power per band, scaled by bandwidth so
        # wide high bands are not over-weighted (ITU pow_dens_correction role).
        self.binmat /= counts[:, None]
        centre_bark = 0.5 * (edges[:-1] + edges[1:])
        self.width_bark = np.diff(edges)
        # Invert the warp on the band centres (monotone -> interpolate).
        grid_hz = np.linspace(20.0, fs / 2.0, 4096)
        self.centre_hz = np.interp(centre_bark, _bark(grid_hz), grid_hz)
        # Absolute hearing threshold per band, in internal power units.
        # Calibration: level alignment puts active speech at power 1e7, which
        # P.862 defines as 79 dB SPL => 0 dB SPL corresponds to 1e7*10^-7.9.
        thr_db = _terhardt_threshold_db(self.centre_hz)
        self.abs_thresh = _TARGET_LEVEL_POWER * 10.0 ** (
            (thr_db - _ACTIVE_SPEECH_DB) / 10.0)
        # Low-band Zwicker exponent modification (P.862 intensity warping):
        # h = clamp(6 / (z_c + 2), max 2) ** 0.15.
        h = np.minimum(6.0 / (centre_bark + 2.0), 2.0)
        h = np.maximum(h, 1.0) ** 0.15
        self.zwicker = _ZWICKER_POWER * h
        self.input_filter_gain = self._make_input_filter(freqs)

    def _make_input_filter(self, freqs: np.ndarray) -> np.ndarray:
        """Amplitude response of the input filter, applied in the FFT domain.

        nb: modified-IRS-receive-shaped telephone bandpass (P.862 §10.1.2),
        defined here as a piecewise-linear dB curve with the standard shape —
        steep low cut below 200 Hz, gentle rise to a plateau around 1-3 kHz,
        steep roll-off above 3.6 kHz.
        wb: P.862.2 drops the IRS; only a 100 Hz high-pass remains.
        """
        if self.mode == "wb":
            pts_hz = np.array([0.0, 50.0, 100.0, 150.0, self.fs / 2.0])
            pts_db = np.array([-60.0, -20.0, -3.0, 0.0, 0.0])
        else:
            pts_hz = np.array([0., 50., 100., 125., 160., 200., 250., 300.,
                               350., 400., 500., 600., 800., 1000., 1300.,
                               1600., 2000., 2500., 3000., 3250., 3500.,
                               4000., 5000., 6300., self.fs / 2.0])
            pts_db = np.array([-80., -40., -25., -20., -12., -6., -2., 0.,
                               1., 2., 3., 3., 3., 3., 3.,
                               3., 3., 2., 1., 0., -6.,
                               -25., -70., -90., -100.])
        return 10.0 ** (np.interp(freqs, pts_hz, pts_db) / 20.0)


_MODE_CACHE: dict = {}


def _get_mode(fs: int, mode: str) -> _Mode:
    key = (fs, mode)
    if key not in _MODE_CACHE:
        _MODE_CACHE[key] = _Mode(fs, mode)
    return _MODE_CACHE[key]


# ---------------------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------------------

def _band_limited_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    """Mean power of x restricted to [lo, hi] Hz (level-alignment measure)."""
    n = int(2 ** np.ceil(np.log2(max(len(x), 2))))
    spec = np.fft.rfft(x, n)
    freqs = np.fft.rfftfreq(n, d=1.0 / fs)
    band = (freqs >= lo) & (freqs <= hi)
    # Parseval: sum|X|^2 / n^2 * 2 ~ time-domain mean power of the band.
    return float(2.0 * np.sum(np.abs(spec[band]) ** 2) / (n * max(len(x), 1)))


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    p = _band_limited_power(x, fs, 350.0, 3250.0)
    return x * np.sqrt(_TARGET_LEVEL_POWER / (p + _EPS))


def _apply_fft_filter(x: np.ndarray, gain: np.ndarray, nfft: int) -> np.ndarray:
    """Zero-phase overlap-free filtering: one big FFT over the whole signal."""
    n = len(x)
    m = int(2 ** np.ceil(np.log2(max(n, 2))))
    spec = np.fft.rfft(x, m)
    freqs_sig = np.fft.rfftfreq(m)
    freqs_flt = np.fft.rfftfreq(nfft)
    g = np.interp(freqs_sig, freqs_flt, gain)
    return np.fft.irfft(spec * g, m)[:n]


def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Global delay of deg relative to ref (samples): crude envelope stage
    narrowed by a fine cross-correlation stage, as in P.862 §10.1.3-10.1.4
    but without utterance splitting."""
    hop = fs // 250  # 4 ms envelope resolution
    n = min(len(ref), len(deg)) // hop * hop
    if n == 0:
        return 0
    env_r = np.abs(ref[:n]).reshape(-1, hop).sum(axis=1)
    env_d = np.abs(deg[:n]).reshape(-1, hop).sum(axis=1)
    env_r = env_r - env_r.mean()
    env_d = env_d - env_d.mean()
    corr = np.correlate(env_d, env_r, mode="full")
    crude = (int(np.argmax(corr)) - (len(env_r) - 1)) * hop
    # Fine stage: +-1.5 hop around the crude estimate on raw samples.
    span = int(1.5 * hop)
    best, best_v = crude, -np.inf
    seg = min(n, 8 * fs)  # bound the O(n*span) fine search
    r = ref[:seg]
    for d in range(crude - span, crude + span + 1):
        if d >= 0:
            a, b = r[: seg - d], deg[d: seg]
        else:
            a, b = r[-d: seg], deg[: seg + d]
        m = min(len(a), len(b))
        if m <= 0:
            continue
        v = float(np.dot(a[:m], b[:m]))
        if v > best_v:
            best_v, best = v, d
    return best


def _frame_powers(x: np.ndarray, md: _Mode) -> np.ndarray:
    """(T, n_bands) Bark band power densities of Hann-windowed frames."""
    n_frames = max(1, (len(x) - md.nfft) // md.hop + 1)
    idx = np.arange(md.nfft)[None, :] + md.hop * np.arange(n_frames)[:, None]
    frames = np.zeros((n_frames, md.nfft))
    valid = idx < len(x)
    frames[valid] = x[np.minimum(idx, len(x) - 1)][valid]
    spec = np.fft.rfft(frames * md.window[None, :], axis=1)
    power = (np.abs(spec) ** 2) * (4.0 / md.nfft ** 2)  # Hann coherent-gain^-2 / N^2
    return power @ md.binmat.T


def _pesq_raw(ref: np.ndarray, deg: np.ndarray, md: _Mode) -> float:
    # Stages 1-2: level alignment then input filtering (both signals).
    ref = _level_align(ref.astype(np.float64), md.fs)
    deg = _level_align(deg.astype(np.float64), md.fs)
    ref = _apply_fft_filter(ref, md.input_filter_gain, md.nfft)
    deg = _apply_fft_filter(deg, md.input_filter_gain, md.nfft)

    # Stage 3: global time alignment.
    d = _estimate_delay(ref, deg, md.fs)
    if d > 0:
        deg = deg[d:]
    elif d < 0:
        ref = ref[-d:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    # Stage 4: perceptual model.
    pr = _frame_powers(ref, md)          # (T, B)
    pd = _frame_powers(deg, md)
    # Re-level in the Bark domain so both average to the target band power
    # over speech-active frames (P.862 recalibrates after warping).
    act_thresh = _TARGET_LEVEL_POWER * 1e-4
    for p in (pr, pd):
        tot = p.sum(axis=1)
        act = tot > act_thresh
        if act.any():
            p *= _TARGET_LEVEL_POWER / (tot[act].mean() + _EPS)

    # No speech activity in the reference -> no utterances to score. The
    # conformance package raises NoUtterancesError here; raising ValueError
    # makes metrics.pesq_wb return NaN instead of a silent-pair ceiling
    # score of 4.64 that would inflate validation means and best-PESQ
    # checkpoint selection.
    if not (pr.sum(axis=1) > act_thresh).any():
        raise ValueError("no utterances detected in the reference signal")
    active = (pr.sum(axis=1) > act_thresh) | (pd.sum(axis=1) > act_thresh)

    # Partial frequency-response equalization: equalize the *reference*
    # toward the degraded long-term spectrum (clamped).
    mean_r = pr[active].mean(axis=0)
    mean_d = pd[active].mean(axis=0)
    ratio = np.clip((mean_d + 1000.0) / (mean_r + 1000.0), *_FREQ_COMP_CLAMP)
    pr_eq = pr * ratio[None, :]

    # Short-term gain equalization: equalize the *degraded* frame energies
    # toward the (equalized) reference, smoothed and clamped.
    num = (pr_eq * md.width_bark[None, :]).sum(axis=1) + 5e3
    den = (pd * md.width_bark[None, :]).sum(axis=1) + 5e3
    g = num / den
    for t in range(1, len(g)):  # first-order smoothing along time
        g[t] = _GAIN_SMOOTH * g[t - 1] + (1.0 - _GAIN_SMOOTH) * g[t]
    g = np.clip(g, *_GAIN_COMP_CLAMP)
    pd_eq = pd * g[:, None]

    # Intensity -> loudness (Zwicker law with low-band exponent modification).
    def loudness(p):
        t = md.abs_thresh[None, :]
        zw = md.zwicker[None, :]
        s = ((t / 0.5) ** zw) * ((0.5 + 0.5 * p / t) ** zw - 1.0)
        return np.where(p > t, s, 0.0) * _SL

    lr = loudness(pr_eq)
    ld = loudness(pd_eq)

    # Stage 5: disturbance densities.
    diff = ld - lr
    m = _MASK_FACTOR * np.minimum(ld, lr)
    d_sym = np.where(diff > m, diff - m, np.where(diff < -m, diff + m, 0.0))
    asym = ((pd_eq + _ASYM_OFFSET) / (pr_eq + _ASYM_OFFSET)) ** _ASYM_EXP
    asym = np.where(asym < _ASYM_THRESH, 0.0, np.minimum(asym, _ASYM_CAP))
    w = md.width_bark[None, :]
    # Frame-level aggregation over bands: L2 for symmetric, L1 for asymmetric.
    frame_sym = np.sqrt((d_sym ** 2 * w).sum(axis=1) * (md.n_bands / w.sum()))
    frame_asym = (np.abs(d_sym) * asym * w).sum(axis=1)

    # Stage 6: low-energy de-emphasis, clip, then L6-over-syllables / L2.
    # The 45.0 ceiling applies to the symmetric track only — in P.862 the
    # threshold marks bad intervals for re-alignment, which caps what the
    # symmetric aggregate can see; the asymmetric track is not capped there
    # (additive degradations must be able to dominate the score).
    e = (pr * w).sum(axis=1)
    deemph = ((e + 1e5) / 1e7) ** 0.04
    frame_sym = np.minimum(frame_sym / deemph, _FRAME_CLIP)
    frame_asym = np.minimum(frame_asym / deemph, _ASYM_FRAME_CLIP)

    def lpq(fd, p):
        if len(fd) < _SYLLABLE_FRAMES:
            sylls = np.array([np.mean(fd ** p) ** (1.0 / p)])
        else:
            starts = list(range(0, len(fd) - _SYLLABLE_FRAMES + 1, _SYLLABLE_HOP))
            # Anchor a final window at the end so the last up-to-HOP-1 frames
            # (~150 ms) are never dropped — distortion confined to the tail of
            # an utterance must be able to move the score.
            if starts[-1] + _SYLLABLE_FRAMES < len(fd):
                starts.append(len(fd) - _SYLLABLE_FRAMES)
            sylls = np.array([
                np.mean(fd[s: s + _SYLLABLE_FRAMES] ** p) ** (1.0 / p)
                for s in starts])
        return float(np.sqrt(np.mean(sylls ** 2)))

    d_ind = lpq(frame_sym, 6.0)
    a_ind = lpq(frame_asym, 1.0)

    if _DEBUG is not None:
        _DEBUG.update(d_ind=d_ind, a_ind=a_ind, frame_sym=frame_sym,
                      frame_asym=frame_asym, lr=lr, ld=ld, pr=pr, pd=pd,
                      g=g, ratio=ratio, e=e)

    # Stage 7: raw score.
    return 4.5 - 0.1 * d_ind - 0.0309 * a_ind


_DEBUG = None  # tests/diagnostics may point this at a dict to capture internals


def _mos_lqo(raw: float, mode: str) -> float:
    if mode == "wb":   # P.862.2 mapping
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    # P.862.1 mapping (narrow-band)
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """P.862-structured PESQ MOS-LQO score.

    Drop-in signature match for ``pesq.pesq`` (the conformance C package the
    reference uses, reference calc_metrics.py:42). Returns MOS-LQO in
    [1.02, 4.64] for wb, [1.01, 4.55] for nb.
    """
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    deg = np.asarray(deg, dtype=np.float64).reshape(-1)
    if len(ref) < fs // 4 or len(deg) < fs // 4:
        raise ValueError("signals too short for PESQ (need >= 250 ms)")
    md = _get_mode(fs, mode)
    raw = _pesq_raw(ref, deg, md)
    return float(_mos_lqo(raw, mode))
