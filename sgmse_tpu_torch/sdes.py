"""Diffusion-process (SDE) layer: OUVE and SBVE. Counterpart of ``sgmse_tpu/sdes.py``.

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

from .parallel.rows import draw
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

    def _std(self, t) -> torch.Tensor:
        raise NotImplementedError

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

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--theta", type=float, default=1.5,
                            help="The constant stiffness of the Ornstein-Uhlenbeck process. "
                                 "1.5 by default.")
        parser.add_argument("--sigma-min", type=float, default=0.05,
                            help="The minimum sigma to use. 0.05 by default.")
        parser.add_argument("--sigma-max", type=float, default=0.5,
                            help="The maximum sigma to use. 0.5 by default.")
        parser.add_argument("--N", type=int, default=30,
                            help="The number of timesteps in the SDE discretization. "
                                 "30 by default.")
        parser.add_argument("--sampler_type", type=str, default="pc",
                            help="Type of sampler to use. 'pc' by default.")
        return parser

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


@SDERegistry.register("sbve")
@dataclasses.dataclass(frozen=True)
class SBVESDE(SDE):
    """Schroedinger-bridge Variance-Exploding SDE (Jukic et al., 2024).

    dx = sqrt(c) k^t dw: no drift; the bridge runs from x0 at t=0 to y at t=T.
    """

    k: float = 2.6
    c: float = 0.4
    N: int = 50
    eps: float = 1e-8
    sampler_type: str = "ode"

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--N", type=int, default=50,
                            help="The number of timesteps in the SDE discretization. "
                                 "50 by default.")
        parser.add_argument("--k", type=float, default=2.6,
                            help="Parameter of the diffusion coefficient. 2.6 by default.")
        parser.add_argument("--c", type=float, default=0.4,
                            help="Parameter of the diffusion coefficient. 0.4 by default.")
        parser.add_argument("--eps", type=float, default=1e-8,
                            help="Small constant to avoid numerical instability. "
                                 "1e-8 by default.")
        parser.add_argument("--sampler_type", type=str, default="ode")
        return parser

    def sde(self, x, y, t):
        drift = torch.zeros_like(x)
        diffusion = math.sqrt(self.c) * self.k**t
        return drift, diffusion * torch.ones_like(t)

    def sigmas_alphas(self, t):
        """The closed-form noise schedule at t: (sigma_t, sigma_T, sigma_bar_t,
        alpha_t, alpha_T, alpha_bar_t), float32 like ``t``.

        sigma_T^2 - sigma_t^2 loses every digit to cancellation as t -> T when
        taken as a difference of squares, so it is taken in closed form:
        c k^{2t} expm1(2 ln k (T - t)) / (2 ln k).
        """
        alpha_t = torch.ones_like(t)
        alpha_T = torch.ones_like(t)
        two_log_k = 2.0 * math.log(self.k)
        sigma_t = torch.sqrt(self.c * torch.expm1(two_log_k * t) / two_log_k)
        # A fill, not a tensor from a Python float: that copy would drain the stream.
        sigma_T = torch.full_like(t, self.c * math.expm1(two_log_k * self.T) / two_log_k).sqrt()
        alpha_bart = alpha_t / (alpha_T + self.eps)
        var_diff = self.c * torch.exp(two_log_k * t) * torch.expm1(two_log_k * (self.T - t)) \
            / two_log_k
        sigma_bart = torch.sqrt(var_diff + self.eps)
        return sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T, alpha_bart

    def _mean(self, x0, y, t):
        sigma_t, sigma_T, sigma_bart, alpha_t, _, alpha_bart = self.sigmas_alphas(t)
        w_xt = alpha_t * sigma_bart**2 / (sigma_T**2 + self.eps)
        w_yt = alpha_bart * sigma_t**2 / (sigma_T**2 + self.eps)
        return _bcast(w_xt) * x0 + _bcast(w_yt) * y

    def _std(self, t):
        sigma_t, sigma_T, sigma_bart, alpha_t, _, _ = self.sigmas_alphas(t)
        return alpha_t * sigma_bart * sigma_t / (sigma_T + self.eps)

    def marginal_prob(self, x0, y, t):
        return self._mean(x0, y, t), self._std(t)

    def prior_sampling(self, y, generator: Optional[torch.Generator] = None):
        """x_T = y: the bridge's prior is noiseless."""
        return y

    def prior_from_noise(self, z, y):
        return y


def crandn(shape, generator: Optional[torch.Generator] = None, device=None,
           dtype=torch.complex64) -> torch.Tensor:
    """Standard complex normal: real and imaginary parts each ~ N(0, 1/2), so E|z|^2 = 1.
    Batch-first: under ``parallel.global_rows`` it is this process's rows of the
    global batch's draw."""
    if generator is not None and device is None:
        device = generator.device
    scale = 1.0 / math.sqrt(2.0)
    re = draw(torch.randn, shape, generator=generator, device=device, dtype=torch.float32) * scale
    im = draw(torch.randn, shape, generator=generator, device=device, dtype=torch.float32) * scale
    return torch.complex(re, im).to(dtype)
