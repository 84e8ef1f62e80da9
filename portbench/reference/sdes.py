"""Plain OUVE and SBVE SDEs (float32 coefficients), and the complex normal.

A frozen copy of the port's ``sdes.py``: ``OUVESDE`` (theta, sigma_min,
sigma_max; its std, drift, diffusion and Euler discretisation) and
``SBVESDE`` (k, c, eps; its closed-form schedule with the ``expm1`` form of
sigma_T^2 - sigma_t^2).
"""
from __future__ import annotations

import math

import torch


def crandn(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard complex normal (real and imaginary parts N(0, 1/2)): two
    ``torch.randn`` draws of ``shape`` from ``generator``, real part first."""
    dev = generator.device
    s = 1.0 / math.sqrt(2.0)
    re = torch.randn(tuple(shape), generator=generator, device=dev) * s
    im = torch.randn(tuple(shape), generator=generator, device=dev) * s
    return torch.complex(re, im)


def bcast(c: torch.Tensor) -> torch.Tensor:
    return c[:, None, None, None]


class OUVE:
    T = 1.0

    def __init__(self, theta=1.5, sigma_min=0.05, sigma_max=0.5, N=30, **_):
        self.theta, self.sigma_min, self.sigma_max, self.N = theta, sigma_min, sigma_max, N
        self.logsig = math.log(sigma_max / sigma_min)

    def std(self, t):
        sm, th, ls = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(sm ** 2 * torch.exp(-2.0 * th * t)
                          * (torch.exp(2.0 * (th + ls) * t) - 1.0) * ls / (th + ls))

    def drift_diffusion(self, x, y, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return self.theta * (y - x), sigma * math.sqrt(2.0 * self.logsig)


class SBVE:
    T = 1.0

    def __init__(self, k=2.6, c=0.4, N=50, eps=1e-8, **_):
        self.k, self.c, self.N, self.eps = k, c, N, eps

    def sigmas_alphas(self, t):
        """(sigma_t, sigma_T, sigma_bar_t, alpha_t, alpha_T, alpha_bar_t) at t."""
        one = torch.ones_like(t)
        tlk = 2.0 * math.log(self.k)
        sigma_t = torch.sqrt(self.c * torch.expm1(tlk * t) / tlk)
        sigma_T = math.sqrt(self.c * math.expm1(tlk * self.T) / tlk) * one
        var_diff = self.c * torch.exp(tlk * t) * torch.expm1(tlk * (self.T - t)) / tlk
        sigma_bar = torch.sqrt(var_diff + self.eps)
        return sigma_t, sigma_T, sigma_bar, one, one, one / (one + self.eps)

    def mean_std(self, x0, y, t):
        sigma_t, sigma_T, sigma_bar, alpha_t, _, alpha_bar = self.sigmas_alphas(t)
        w_x = alpha_t * sigma_bar ** 2 / (sigma_T ** 2 + self.eps)
        w_y = alpha_bar * sigma_t ** 2 / (sigma_T ** 2 + self.eps)
        std = alpha_t * sigma_bar * sigma_t / (sigma_T + self.eps)
        return bcast(w_x) * x0 + bcast(w_y) * y, std


def build(config: dict):
    sde = dict(config["sde_params"])
    return {"ouve": OUVE, "sbve": SBVE}[config["sde"]](**sde)
