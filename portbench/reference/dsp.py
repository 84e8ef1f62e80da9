"""Plain STFT, iSTFT, compression transform and time padding, float32.

A frozen copy of the port's ``dsp.py`` (``stft``, ``istft``, ``spec_fwd``,
``spec_back`` with the ``exponent`` transform, ``pad_spec``): periodic Hann
window, reflect-padded centred frames, one-sided rFFT; iSTFT by overlap-add
normalised by the squared-window envelope.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class Spec:
    """The STFT and compression settings of a configuration's ``stft`` block."""

    def __init__(self, n_fft=510, hop_length=128, spec_factor=0.15, spec_abs_exponent=0.5,
                 num_frames=256, window="hann", transform_type="exponent"):
        if window != "hann" or transform_type != "exponent":
            raise NotImplementedError("the plain reference has the hann window and the "
                                      "exponent transform only")
        self.n_fft, self.hop = n_fft, hop_length
        self.factor, self.exponent = spec_factor, spec_abs_exponent
        self.num_frames = num_frames
        n = np.arange(n_fft)
        self.window_np = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)

    @property
    def target_len(self) -> int:
        return (self.num_frames - 1) * self.hop

    def window(self, device):
        return torch.as_tensor(self.window_np, device=device)

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> complex (B, n_fft // 2 + 1, frames)."""
        pad = self.n_fft // 2
        x = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.n_fft, self.hop) * self.window(x.device)
        return torch.fft.rfft(frames, dim=-1).transpose(-1, -2).to(torch.complex64)

    def istft(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        """complex (B, F, T) -> (B, length)."""
        win = self.window(spec.device)
        frames = torch.fft.irfft(spec.transpose(-1, -2), n=self.n_fft, dim=-1).float() * win
        n, t, _ = frames.shape
        out_len = self.n_fft + self.hop * (t - 1)

        def overlap_add(f):
            return F.fold(f.transpose(1, 2), output_size=(1, out_len),
                          kernel_size=(1, self.n_fft), stride=(1, self.hop)).reshape(-1, out_len)

        out = overlap_add(frames)
        env = overlap_add((win ** 2).expand(1, t, self.n_fft))[0]
        out = out / torch.where(env > 1e-11, env, torch.ones_like(env))
        start = self.n_fft // 2
        if length <= out_len - start:
            return out[:, start:start + length]
        return F.pad(out[:, start:], (0, length - (out_len - start)))

    def fwd(self, spec: torch.Tensor) -> torch.Tensor:
        mag = spec.abs()
        scale = torch.where(mag > 0, mag ** (self.exponent - 1.0), torch.zeros_like(mag))
        return spec * scale * self.factor

    def back(self, spec: torch.Tensor) -> torch.Tensor:
        spec = spec / self.factor
        mag = spec.abs()
        scale = torch.where(mag > 0, mag ** (1.0 / self.exponent - 1.0), torch.zeros_like(mag))
        return spec * scale

    def wav_to_spec(self, x: torch.Tensor) -> torch.Tensor:
        return self.fwd(self.stft(x))

    def spec_to_wav(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        return self.istft(self.back(spec), length)


def pad_spec(spec: torch.Tensor, mode: str, multiple: int = 64) -> torch.Tensor:
    """Pad the frame axis to a multiple of ``multiple``: zeros, or numpy's
    ``reflect`` (a pad longer than the spectrogram reflects again)."""
    t = spec.shape[-1]
    extra = (-t) % multiple
    if extra == 0:
        return spec
    if mode == "zero_pad":
        return F.pad(spec, (0, extra))
    if mode != "reflection":
        raise NotImplementedError(f"pad mode {mode!r}")
    idx = np.arange(t + extra) % max(2 * (t - 1), 1)
    idx = np.where(idx < t, idx, 2 * (t - 1) - idx)
    return spec[..., torch.as_tensor(idx, device=spec.device)]
