"""Reverse-diffusion sampling, predictor-corrector part. Counterpart of the PC
half of ``sgmse_tpu/sampling.py``.

Predictor and corrector algorithms are factories looked up from registries;
each returns an ``update`` step function. The N reverse steps run as a Python
loop (the JAX package compiles them into one ``lax.scan``).

score_fn convention: ``score_fn(x, y, t) -> score`` with complex (B, C, F, T)
states and ``t`` of shape (B,). Noise comes from an explicit
``torch.Generator``, or is injected for verification:

- ``noise`` of y's shape: the prior draw (JAX ``inject_prior``);
- ``noise`` of shape ``(N+1, *y.shape)``: ``noise[0]`` is the prior draw and
  ``noise[1+i]`` the predictor noise of step i (JAX ``inject_steps``);
- ``corrector_noise`` of shape ``(N, corrector_steps, *y.shape)``: the
  corrector noise of every step (the JAX sampler has no such hook).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .sdes import SDE, crandn
from .utils.registry import Registry

PredictorRegistry = Registry("Predictor")
CorrectorRegistry = Registry("Corrector")


def _bcast(c):
    return c[:, None, None, None]


# ---------------------------------------------------------------------------------------
# Predictors
# ---------------------------------------------------------------------------------------

@PredictorRegistry.register("reverse_diffusion")
def reverse_diffusion_predictor(sde: SDE, score_fn, probability_flow: bool = False):
    """x_mean = x - rev_f; x = x_mean + rev_G z."""

    def update(x, y, t, stepsize, generator=None, noise=None):
        score = score_fn(x, y, t)
        rev_f, rev_G = sde.reverse_discretize(score, x, y, t, stepsize,
                                              probability_flow=probability_flow)
        z = crandn(x.shape, generator, x.device) if noise is None else noise
        x_mean = x - rev_f
        x_new = x_mean + _bcast(rev_G) * z
        return x_new, x_mean

    return update


@PredictorRegistry.register("none")
def none_predictor(sde: SDE, score_fn, probability_flow: bool = False):
    def update(x, y, t, stepsize, generator=None, noise=None):
        return x, x

    return update


# ---------------------------------------------------------------------------------------
# Correctors
# ---------------------------------------------------------------------------------------

@CorrectorRegistry.register("ald")
def ald_corrector(sde: SDE, score_fn, snr: float, n_steps: int):
    """Annealed Langevin dynamics: step = 2(snr*sigma(t))^2.

    ``noise``, if given, holds the complex normal draw of each of the
    ``n_steps`` steps: shape ``(n_steps, *x.shape)``.
    """

    def update(x, y, t, generator=None, noise=None):
        std = sde.marginal_prob(x, y, t)[1]
        step_size = (snr * std) ** 2 * 2.0
        x_mean = x
        for i in range(n_steps):
            grad = score_fn(x, y, t)
            z = crandn(x.shape, generator, x.device) if noise is None else noise[i]
            x_mean = x + _bcast(step_size) * grad
            x = x_mean + z * _bcast(torch.sqrt(step_size * 2.0))
        return x, x_mean

    return update


@CorrectorRegistry.register("none")
def none_corrector(sde: SDE, score_fn, snr: float, n_steps: int):
    def update(x, y, t, generator=None, noise=None):
        return x, x

    return update


# ---------------------------------------------------------------------------------------
# Predictor-Corrector sampler
# ---------------------------------------------------------------------------------------

def pc_sampler(
    predictor_name: str,
    corrector_name: str,
    sde: SDE,
    score_fn: Callable,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    denoise: bool = True,
    eps: float = 3e-2,
    snr: float = 0.1,
    corrector_steps: int = 1,
    probability_flow: bool = False,
    noise: Optional[torch.Tensor] = None,
    corrector_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Run the N-step PC sampler on conditioning ``y``. Returns ``(sample, nfe)``.

    The time grid is ``linspace(T, eps, N)`` with a non-uniform last step from
    eps to 0; with ``denoise`` the final predictor step's mean is returned.
    """
    predictor = PredictorRegistry.get_by_name(predictor_name)(
        sde, score_fn, probability_flow=probability_flow)
    corrector = CorrectorRegistry.get_by_name(corrector_name)(
        sde, score_fn, snr=snr, n_steps=corrector_steps)
    actual_corrector_steps = 0 if corrector_name == "none" else corrector_steps

    n = sde.N
    inject_steps = noise is not None and noise.ndim == y.ndim + 1
    if inject_steps and noise.shape[0] != n + 1:
        raise ValueError(f"step noise must have N+1 = {n + 1} entries, got {noise.shape[0]}")
    timesteps = torch.linspace(sde.T, eps, n, dtype=torch.float32, device=y.device)
    # Non-uniform last step: eps -> 0.
    stepsizes = torch.cat([timesteps[:-1] - timesteps[1:], timesteps[-1:]])

    if noise is None:
        xt = sde.prior_sampling(y, generator)
    else:
        xt = sde.prior_from_noise(noise[0] if inject_steps else noise, y)
    batch = y.shape[0]
    xt_mean = xt
    for i in range(n):
        vec_t = timesteps[i].expand(batch)
        xt, _ = corrector(xt, y, vec_t, generator,
                          None if corrector_noise is None else corrector_noise[i])
        xt, xt_mean = predictor(xt, y, vec_t, stepsizes[i], generator,
                                noise[1 + i] if inject_steps else None)
    result = xt_mean if denoise else xt
    return result, n * (actual_corrector_steps + 1)
