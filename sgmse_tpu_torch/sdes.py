"""Diffusion-process (SDE) layer, OUVE part. Counterpart of ``sgmse_tpu/sdes.py``.

Conventions, as in the JAX package:
- ``t`` has shape ``(B,)``; states ``x``/``y`` have shape ``(B, C, F, T)``
  (complex64). Coefficients broadcast with three trailing singleton axes.
- The forward SDE is ``dx = f(x, y, t) dt + g(t) dw``.
- ``stepsize`` is a float32 scalar tensor (or a Python float).

The reverse drift and diffusion are plain functions of ``(score, x, y, t)``.
Noise comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .utils.registry import Registry

SDERegistry = Registry("SDE")


def _bcast(coeff: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1) for broadcasting against (B, C, F, T) states."""
    return coeff[:, None, None, None]


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base SDE. Subclasses implement ``sde``, ``marginal_prob``, ``prior_from_noise``."""

    N: int = 30

    @property
    def T(self) -> float:
        return 1.0

    # --- forward process ------------------------------------------------------------------
    def sde(self, x, y, t) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def marginal_prob(self, x0, y, t) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def prior_from_noise(self, z, y) -> torch.Tensor:
        """Prior sample given the standard complex normal draw ``z`` explicitly."""
        raise NotImplementedError

    def prior_sampling(self, y, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.prior_from_noise(crandn(y.shape, generator, y.device), y)

    # --- discretizations ------------------------------------------------------------------
    def discretize(self, x, y, t, stepsize) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euler-Maruyama discretization: x_{i+1} = x_i + f_i + G_i z_i. Returns (f, G)."""
        drift, diffusion = self.sde(x, y, t)
        return drift * stepsize, diffusion * _sqrt(stepsize)

    # --- reverse process ------------------------------------------------------------------
    def reverse_sde(self, score, x, y, t, probability_flow: bool = False):
        """Drift and diffusion of the reverse-time SDE/ODE given the score value."""
        drift, diffusion = self.sde(x, y, t)
        factor = 0.5 if probability_flow else 1.0
        score_drift = -_bcast(diffusion**2) * score * factor
        rev_diffusion = torch.zeros_like(diffusion) if probability_flow else diffusion
        return drift + score_drift, rev_diffusion

    def reverse_discretize(self, score, x, y, t, stepsize, probability_flow: bool = False):
        """Discretized reverse iteration. Returns (rev_f, rev_G)."""
        f, G = self.discretize(x, y, t, stepsize)
        factor = 0.5 if probability_flow else 1.0
        rev_f = f - _bcast(G**2) * score * factor
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G

    def config_dict(self) -> dict:
        return dataclasses.asdict(self)


@SDERegistry.register("ouve")
@dataclasses.dataclass(frozen=True)
class OUVESDE(SDE):
    """Ornstein-Uhlenbeck Variance-Exploding SDE.

    dx = theta (y - x) dt + sigma_min (sigma_max/sigma_min)^t sqrt(2 log(sigma_max/sigma_min)) dw
    """

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 30
    sampler_type: str = "pc"

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def sde(self, x, y, t):
        drift = self.theta * (y - x)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        diffusion = sigma * math.sqrt(2.0 * self.logsig)
        return drift, diffusion

    def _mean(self, x0, y, t):
        exp_interp = _bcast(torch.exp(-self.theta * t))
        return exp_interp * x0 + (1.0 - exp_interp) * y

    def _std(self, t):
        sm, theta, logsig = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (sm**2 * torch.exp(-2.0 * theta * t) * (torch.exp(2.0 * (theta + logsig) * t) - 1.0)
             * logsig) / (theta + logsig)
        )

    def alpha(self, t):
        return torch.exp(-self.theta * t)

    def marginal_prob(self, x0, y, t):
        return self._mean(x0, y, t), self._std(t)

    def prior_from_noise(self, z, y):
        """x_T = y + sigma(T) z."""
        std = self._std(torch.full((y.shape[0],), self.T, dtype=torch.float32, device=y.device))
        return y + z.to(y.dtype) * _bcast(std).to(y.dtype)


def crandn(shape, generator: Optional[torch.Generator] = None, device=None,
           dtype=torch.complex64) -> torch.Tensor:
    """Standard complex normal: real and imaginary parts each ~ N(0, 1/2), so E|z|^2 = 1."""
    if generator is not None and device is None:
        device = generator.device
    scale = 1.0 / math.sqrt(2.0)
    re = torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale
    im = torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale
    return torch.complex(re, im).to(dtype)
