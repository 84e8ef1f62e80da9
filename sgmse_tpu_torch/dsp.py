"""Signal-processing core: STFT/iSTFT, spectrogram compression transforms, padding.

Counterpart of ``sgmse_tpu/dsp.py``, which every published SGMSE checkpoint
was trained against:

- STFT/iSTFT with ``center=True`` semantics: periodic Hann window,
  reflect-padding by ``n_fft//2`` on both sides, one-sided rFFT with
  ``n_fft//2 + 1`` bins, iSTFT by overlap-add normalised by the squared-window
  envelope (entries <= 1e-11 are left undivided) and `length` trimming.
  ``torch.istft`` is not used: it raises where the JAX version zero-pads (a
  `length` beyond the samples the frames can reconstruct).
- ``spec_fwd``/``spec_back`` are the magnitude-compression transforms
  ``|z|^e * exp(i angle(z)) * factor`` with defaults e=0.5, factor=0.15.
- ``pad_spec`` pads the time-frame axis to a multiple of 64.

All functions take tensors on any device and batch over leading dimensions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def get_window(window_type: str, window_length: int, device=None) -> torch.Tensor:
    """Periodic window matching ``torch.hann_window(periodic=True)`` (float32)."""
    n = np.arange(window_length)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / window_length))
    if window_type == "hann":
        w = hann
    elif window_type == "sqrthann":
        w = np.sqrt(hann)
    else:
        raise NotImplementedError(f"Window type {window_type} not implemented!")
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
         center: bool = True) -> torch.Tensor:
    """Real signal ``(..., L)`` -> complex64 spectrogram ``(..., n_fft//2 + 1, frames)``."""
    lead = x.shape[:-1]
    x = x.float().reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length) * window.to(x.device)  # (N, T, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1).to(torch.complex64)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Sum (N, T, n_fft) frames at a stride of `hop_length` -> (N, out_len)."""
    n, t, n_fft = frames.shape
    out_len = n_fft + hop_length * (t - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(n, out_len)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
          length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT by least-squares overlap-add; ``(..., F, T)`` -> ``(..., L)``.

    With `length`, the output is trimmed to it, or zero-padded where `length`
    exceeds the samples the frames reconstruct (as the JAX version does).
    """
    lead = spec.shape[:-2]
    window = window.to(spec.device)
    frames_spec = spec.reshape(-1, *spec.shape[-2:]).transpose(-1, -2)  # (N, T, F)
    frames = torch.fft.irfft(frames_spec, n=n_fft, dim=-1).float() * window
    num_frames = frames.shape[-2]
    out = _overlap_add(frames, hop_length)
    env = _overlap_add((window**2).expand(1, num_frames, n_fft), hop_length)[0]
    out = out / torch.where(env > 1e-11, env, torch.ones_like(env))
    out_len = out.shape[-1]
    start = n_fft // 2 if center else 0
    if length is None:
        out = out[:, start:out_len - (n_fft // 2 if center else 0)]
    elif length <= out_len - start:
        out = out[:, start:start + length]
    else:
        out = F.pad(out[:, start:], (0, length - (out_len - start)))
    return out.reshape(*lead, out.shape[-1])


def spec_fwd(spec: torch.Tensor, transform_type: str = "exponent", spec_factor: float = 0.15,
             spec_abs_exponent: float = 0.5) -> torch.Tensor:
    """Forward magnitude-compression transform."""
    if transform_type == "exponent":
        if spec_abs_exponent != 1:
            mag = spec.abs()
            # |z|^e * exp(i*angle(z)) == |z|^(e-1) * z  (and 0 stays 0)
            scale = torch.where(mag > 0, mag ** (spec_abs_exponent - 1.0), torch.zeros_like(mag))
            spec = spec * scale
        return spec * spec_factor
    elif transform_type == "log":
        mag = spec.abs()
        scale = torch.where(mag > 0, torch.log1p(mag) / mag, torch.zeros_like(mag))
        return spec * scale * spec_factor
    elif transform_type == "none":
        return spec
    raise ValueError(f"Unknown transform_type {transform_type}")


def spec_back(spec: torch.Tensor, transform_type: str = "exponent", spec_factor: float = 0.15,
              spec_abs_exponent: float = 0.5) -> torch.Tensor:
    """Inverse of :func:`spec_fwd`."""
    if transform_type == "exponent":
        spec = spec / spec_factor
        if spec_abs_exponent != 1:
            mag = spec.abs()
            scale = torch.where(mag > 0, mag ** (1.0 / spec_abs_exponent - 1.0),
                                torch.zeros_like(mag))
            spec = spec * scale
        return spec
    elif transform_type == "log":
        spec = spec / spec_factor
        mag = spec.abs()
        scale = torch.where(mag > 0, torch.expm1(mag) / mag, torch.zeros_like(mag))
        return spec * scale
    elif transform_type == "none":
        return spec
    raise ValueError(f"Unknown transform_type {transform_type}")


def pad_length(t: int, multiple: int = 64) -> int:
    """The frames :func:`pad_spec` makes of ``t``: ``t`` rounded up to a multiple."""
    return t + (-t) % multiple


def pad_spec(spec: torch.Tensor, mode: str = "zero_pad", multiple: int = 64) -> torch.Tensor:
    """Pad the last (time-frame) axis to a multiple of `multiple`.

    Modes: zero padding, reflection and replication of the T axis. Reflection
    is numpy's ``reflect`` (the JAX package's ``jnp.pad``): a pad longer than
    the spectrogram reflects again at each end, so it takes any T.
    """
    t = spec.shape[-1]
    num_pad = pad_length(t, multiple) - t
    if num_pad == 0:
        return spec
    if mode == "zero_pad":
        return F.pad(spec, (0, num_pad))
    idx = torch.arange(t + num_pad, device=spec.device)
    if mode == "reflection":
        period = max(2 * (t - 1), 1)  # 0 1 .. t-1 .. 1 | 0 1 ..
        idx = idx % period
        idx = torch.where(idx < t, idx, period - idx)
    elif mode == "replication":
        idx = idx.clamp(max=t - 1)
    else:
        raise NotImplementedError(f"pad mode {mode} not implemented")
    return spec.index_select(-1, idx)


class SpecTransform:
    """STFT configuration plus the compression transform (JAX ``SpecTransform``)."""

    def __init__(
        self,
        n_fft: int = 510,
        hop_length: int = 128,
        window: str = "hann",
        transform_type: str = "exponent",
        spec_factor: float = 0.15,
        spec_abs_exponent: float = 0.5,
        num_frames: int = 256,
    ):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.window_type = window
        self.window = get_window(window, n_fft)
        self._windows = {}  # device -> the window there
        self.transform_type = transform_type
        self.spec_factor = spec_factor
        self.spec_abs_exponent = spec_abs_exponent
        self.num_frames = num_frames

    # --- waveform <-> complex spectrogram -------------------------------------------------
    def _window_on(self, device: torch.device) -> torch.Tensor:
        """The window on ``device``, copied there on first use only: a copy from
        the host at every call would make the host wait for the device."""
        w = self._windows.get(device)
        if w is None:
            w = self._windows[device] = self.window.to(device)
        return w

    def stft(self, sig: torch.Tensor) -> torch.Tensor:
        return stft(sig, self.n_fft, self.hop_length, self._window_on(sig.device))

    def frames(self, length: int) -> int:
        """The frames :meth:`stft` gives a signal of ``length`` samples."""
        return (length + 2 * (self.n_fft // 2) - self.n_fft) // self.hop_length + 1

    def istft(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return istft(spec, self.n_fft, self.hop_length, self._window_on(spec.device),
                     length=length)

    # --- compression transform ------------------------------------------------------------
    def spec_fwd(self, spec: torch.Tensor) -> torch.Tensor:
        return spec_fwd(spec, self.transform_type, self.spec_factor, self.spec_abs_exponent)

    def spec_back(self, spec: torch.Tensor) -> torch.Tensor:
        return spec_back(spec, self.transform_type, self.spec_factor, self.spec_abs_exponent)

    # --- convenience ----------------------------------------------------------------------
    def wav_to_spec(self, sig: torch.Tensor) -> torch.Tensor:
        return self.spec_fwd(self.stft(sig))

    def spec_to_wav(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return self.istft(self.spec_back(spec), length=length)

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def target_len(self) -> int:
        """Training crop length in samples."""
        return (self.num_frames - 1) * self.hop_length

    def config_dict(self) -> dict:
        return dict(
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            window=self.window_type,
            transform_type=self.transform_type,
            spec_factor=self.spec_factor,
            spec_abs_exponent=self.spec_abs_exponent,
            num_frames=self.num_frames,
        )
