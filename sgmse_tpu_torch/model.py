"""ScoreModel: owns backbone + SDE + DSP transform; the forward contract and the
one-call ``enhance`` pipeline. Counterpart of the main-path slice of
``sgmse_tpu/model.py`` (ncsnpp backbone, OUVE SDE, PC sampler).

Unlike the JAX package, parameters live in the module (``self.dnn``), as
PyTorch has it; ``init_params(generator)`` draws them from an explicit
generator, and ``convert.params_from_jax`` loads the JAX package's.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from . import sampling
from .dsp import SpecTransform, pad_spec
from .models import BackboneRegistry
from .sdes import SDERegistry

_SPEC_KEYS = ("n_fft", "hop_length", "window", "transform_type", "spec_factor",
              "spec_abs_exponent", "num_frames")


def _accepted(cls) -> set:
    if dataclasses.is_dataclass(cls):
        return {f.name for f in dataclasses.fields(cls)}
    return set(inspect.signature(cls.__init__).parameters) - {"self"}


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs that `cls` declares (lists become tuples)."""
    names = _accepted(cls)
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items() if k in names}


class ScoreModel(nn.Module):
    """Score-based speech enhancement model.

    Construction mirrors the JAX ``ScoreModel``: backbone/sde names select
    registry classes, and the remaining kwargs are routed to whichever of the
    backbone, the SDE and the STFT transform declares them (training-only
    kwargs are accepted and ignored).
    """

    def __init__(self, backbone: str = "ncsnpp", sde: str = "ouve", t_eps: float = 0.03,
                 sr: int = 16000, spec: Optional[SpecTransform] = None, **kwargs):
        super().__init__()
        if backbone != "ncsnpp" or sde != "ouve":
            raise NotImplementedError(f"backbone {backbone!r} with sde {sde!r} is not "
                                      "ported yet (ported: ncsnpp with ouve)")
        self.backbone = backbone
        dnn_cls = BackboneRegistry.get_by_name(backbone)
        self.dnn = dnn_cls(**_filter_kwargs(dnn_cls, kwargs))
        self.sde_name = sde
        sde_cls = SDERegistry.get_by_name(sde)
        self.sde = sde_cls(**_filter_kwargs(sde_cls, kwargs))
        self.t_eps = t_eps
        self.sr = sr
        self.spec = spec if spec is not None else SpecTransform(
            **{k: v for k, v in kwargs.items() if k in _SPEC_KEYS})

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from `generator` with the DDPM init rules."""
        for module in self.dnn.modules():
            if hasattr(module, "init_parameters"):
                module.init_parameters(generator)

    # --- forward contract ------------------------------------------------------------
    def forward(self, x_t, y, t):
        """Legacy contract: score = -dnn(x_t, y, t)."""
        return -self.dnn(x_t, y, t)

    def score_fn(self):
        """score_fn(x, y, t) for the samplers."""
        return self.forward

    def to_audio(self, spec, length: Optional[int] = None):
        return self.spec.spec_to_wav(spec, length=length)

    # --- one-call enhancement ----------------------------------------------------------
    @torch.inference_mode()
    def enhance(self, y_wav, generator: Optional[torch.Generator] = None,
                sampler_type: Optional[str] = None, predictor: str = "reverse_diffusion",
                corrector: str = "ald", N: int = 30, corrector_steps: int = 1,
                snr: float = 0.5, timeit: bool = False, pad_mode: str = "zero_pad",
                prior_noise=None, corrector_noise=None):
        """Enhance noisy waveform(s) ``(L,)`` or ``(B, L)`` end to end.

        Max-abs normalize -> STFT + compression transform -> pad T to a
        multiple of 64 -> PC sampler -> inverse transform + iSTFT ->
        un-normalize. Returns a numpy waveform of the input's shape, or
        ``(x_hat, nfe, rtf)`` with ``timeit``.

        ``generator`` draws the sampler noise (default: seed 0 on the model's
        device, so repeated calls agree). ``prior_noise`` and
        ``corrector_noise`` inject it instead (see :mod:`.sampling`).
        """
        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        stype = sampler_type if sampler_type is not None else self.sde.sampler_type
        if stype != "pc":
            raise NotImplementedError(f"sampler type {stype!r} is not ported yet (ported: pc)")
        start = time.time()
        y = torch.as_tensor(np.asarray(y_wav, dtype=np.float32), device=device)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[None]
        t_orig = y.shape[-1]
        # Floor like the training normalization: silence must not divide by zero.
        norm = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10)
        Y = pad_spec(self.spec.wav_to_spec(y / norm)[:, None], mode=pad_mode)

        def as_device(a):
            return None if a is None else torch.as_tensor(a, device=device)

        sde = dataclasses.replace(self.sde, N=N)
        sample, nfe = sampling.pc_sampler(
            predictor, corrector, sde, self.score_fn(), Y, generator=generator, denoise=True,
            eps=self.t_eps, snr=snr, corrector_steps=corrector_steps,
            noise=as_device(prior_noise), corrector_noise=as_device(corrector_noise))
        x_hat = (self.to_audio(sample[:, 0], t_orig) * norm).cpu().numpy()  # host fence
        end = time.time()
        if squeeze:
            x_hat = x_hat[0]
        if timeit:
            return x_hat, nfe, (end - start) / (x_hat.shape[-1] / self.sr)
        return x_hat
