"""Reverse-diffusion samplers: predictor-corrector, probability-flow ODE and
Schroedinger bridge. Counterpart of ``sgmse_tpu/sampling.py``.

Predictor and corrector algorithms are factories looked up from registries;
each returns an ``update`` step function. The reverse steps run as a Python
loop (the JAX package compiles them into one ``lax.scan`` or, for the adaptive
ODE solver, one ``lax.while_loop``).

score_fn convention: ``score_fn(x, y, t) -> score`` with complex (B, C, F, T)
states and ``t`` of shape (B,). Noise comes from an explicit
``torch.Generator``, or is injected for verification:

- PC ``noise`` of y's shape: the prior draw (JAX ``inject_prior``);
- PC ``noise`` of shape ``(N+1, *y.shape)``: ``noise[0]`` is the prior draw and
  ``noise[1+i]`` the predictor noise of step i (JAX ``inject_steps``);
- PC ``corrector_noise`` of shape ``(N, corrector_steps, *y.shape)``: the
  corrector noise of every step (the JAX sampler has no such hook);
- ODE ``noise`` of y's shape: the prior draw (JAX ``inject_prior``);
- SB ``sde`` ``noise`` of shape ``(N, B, 1, F, T)``: the noise of every step
  (JAX ``inject_steps``).
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Tuple

import torch

from .parallel.rows import all_sum
from .sdes import SDE, SBVESDE, crandn
from .utils.profiling import span
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


@PredictorRegistry.register("euler_maruyama")
def euler_maruyama_predictor(sde: SDE, score_fn, probability_flow: bool = False):
    """Fixed dt = -1/N Euler-Maruyama step of the reverse SDE."""

    def update(x, y, t, stepsize, generator=None, noise=None):
        dt = -1.0 / sde.N
        z = crandn(x.shape, generator, x.device) if noise is None else noise
        score = score_fn(x, y, t)
        f, g = sde.reverse_sde(score, x, y, t, probability_flow=probability_flow)
        x_mean = x + f * dt
        x_new = x_mean + _bcast(g) * math.sqrt(-dt) * z
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


@CorrectorRegistry.register("langevin")
def langevin_corrector(sde: SDE, score_fn, snr: float, n_steps: int):
    """Langevin dynamics with one step size for the whole batch, from the ratio
    of the batch-mean noise and score norms. ``noise`` as for ``ald``. The
    means are over the global batch where its rows are split over a group
    (``parallel.rows``): the per-row norms' sums and the row count go through
    one all-reduce, in float64, so that a split batch rounds as one does."""

    def update(x, y, t, generator=None, noise=None):
        x_mean = x
        b = x.shape[0]
        for i in range(n_steps):
            grad = score_fn(x, y, t)
            z = crandn(x.shape, generator, x.device) if noise is None else noise[i]
            sums = torch.stack([
                torch.linalg.vector_norm(grad.reshape(b, -1), dim=-1).sum(dtype=torch.float64),
                torch.linalg.vector_norm(z.reshape(b, -1), dim=-1).sum(dtype=torch.float64),
                torch.full((), b, dtype=torch.float64, device=x.device)])
            grad_sum, noise_sum, rows = all_sum(sums)
            grad_norm, noise_norm = (grad_sum / rows).float(), (noise_sum / rows).float()
            step_size = (snr * noise_norm / grad_norm) ** 2 * 2.0
            x_mean = x + step_size * grad
            x = x_mean + z * torch.sqrt(step_size * 2.0)
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
    intermediate: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Run the N-step PC sampler on conditioning ``y``. Returns ``(sample, nfe)``.

    The time grid is ``linspace(T, eps, N)`` with a non-uniform last step from
    eps to 0; with ``denoise`` the final predictor step's mean is returned.
    With ``intermediate`` the sample is ``(sample, trajectory)``, the
    trajectory ``(N, *y.shape)`` the state after each predictor step (its last
    entry the sample before the denoising mean), as in the JAX package.
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
    xt_mean, trajectory = xt, []
    for i in range(n):
        with span("sampler.step"):
            vec_t = timesteps[i].expand(batch)
            xt, _ = corrector(xt, y, vec_t, generator,
                              None if corrector_noise is None else corrector_noise[i])
            xt, xt_mean = predictor(xt, y, vec_t, stepsizes[i], generator,
                                    noise[1 + i] if inject_steps else None)
            if intermediate:
                trajectory.append(xt)
    result = xt_mean if denoise else xt
    if intermediate:
        result = (result, torch.stack(trajectory))
    return result, n * (actual_corrector_steps + 1)


# ---------------------------------------------------------------------------------------
# Probability-flow ODE sampler
# ---------------------------------------------------------------------------------------

# Dormand-Prince 5(4) tableau (the method behind scipy's RK45).
_DP_C = (0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0)
_DP_A = (
    (),
    (1.0 / 5,),
    (3.0 / 40, 9.0 / 40),
    (44.0 / 45, -56.0 / 15, 32.0 / 9),
    (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729),
    (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656),
)
_DP_B5 = (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84, 0.0)
_DP_B4 = (5179.0 / 57600, 0.0, 7571.0 / 16695, 393.0 / 640, -92097.0 / 339200,
          187.0 / 2100, 1.0 / 40)


def _rms(*vs: torch.Tensor):
    """scipy's rms_norm, sqrt(mean |v|^2), of each of ``vs`` (one value, or a
    tuple of them), float32. The sums of |v|^2 and the element counts are
    float64 and, where the batch's rows are split over a group
    (``parallel.rows``), summed over it in one all-reduce: every rank then
    holds the global batch's norms, rounded as one device rounds them, so the
    step control decides alike on every rank."""
    sums = torch.stack([s for v in vs for s in (
        v.abs().square().sum(dtype=torch.float64),
        torch.full((), v.numel(), dtype=torch.float64, device=v.device))])
    sums = all_sum(sums).view(-1, 2)
    norms = torch.sqrt(sums[:, 0] / sums[:, 1]).float()
    return norms[0] if len(vs) == 1 else tuple(norms)


def ode_sampler(
    sde: SDE,
    score_fn: Callable,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    denoise: bool = True,
    eps: float = 3e-2,
    N: Optional[int] = None,
    method: str = "rk45",
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 1000,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Probability-flow ODE sampler from t = T down to ``eps``. Returns
    ``(sample, nfe)``.

    - ``method='rk45'``: adaptive Dormand-Prince 5(4) with FSAL, scipy's
      initial-step selection and step controller (the rejection clamp
      included), on the error norm of the whole batch (the global one where
      the rows are split over a group: :func:`_rms`). The step state (t, h,
      the error norm) is float32 tensors, as in the JAX ``while_loop``, so
      accept/reject decisions and the NFE match it; each step reads ``accept``
      and ``t`` to the host once. NFE = 2 + 6 per step (+1 with ``denoise``).
      Warns if ``max_steps`` runs out before ``eps`` (as the JAX sampler does:
      more than 1e-6 short of it).
    - ``method='rk4'``: classic RK4 over N uniform steps (N defaults to
      ``sde.N``); NFE = 4N (+1 with ``denoise``).

    With ``denoise`` both end with one reverse-diffusion step at ``eps``.
    ``noise`` of y's shape is the prior draw.
    """
    batch = y.shape[0]
    if noise is None:
        x = sde.prior_sampling(y, generator)
    else:
        x = sde.prior_from_noise(noise, y)

    def drift_fn(x, t):
        vec_t = t.expand(batch)
        drift, _ = sde.reverse_sde(score_fn(x, y, vec_t), x, y, vec_t, probability_flow=True)
        return drift

    if method == "rk45":
        x, nfe = _rk45(drift_fn, x, sde.T, eps, rtol, atol, max_steps, y.device)
    elif method == "rk4":
        n = N if N is not None else sde.N
        ts = torch.linspace(sde.T, eps, n + 1, dtype=torch.float32, device=y.device)
        for i in range(n):
            with span("sampler.step"):
                t0, t1 = ts[i], ts[i + 1]
                h = t1 - t0  # negative: reverse time
                k1 = drift_fn(x, t0)
                k2 = drift_fn(x + 0.5 * h * k1, t0 + 0.5 * h)
                k3 = drift_fn(x + 0.5 * h * k2, t0 + 0.5 * h)
                k4 = drift_fn(x + h * k3, t1)
                x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        nfe = 4 * n
    else:
        raise ValueError(f"Unknown ODE method: {method}")
    if denoise:
        vec_eps = torch.full((batch,), eps, dtype=torch.float32, device=y.device)
        rev_f, _ = sde.reverse_discretize(score_fn(x, y, vec_eps), x, y, vec_eps, vec_eps[0])
        x = x - rev_f
        nfe += 1
    return x, nfe


def _rk45(drift_fn, x, t_start: float, eps: float, rtol: float, atol: float, max_steps: int,
          device) -> Tuple[torch.Tensor, int]:
    """Adaptive Dormand-Prince 5(4) from t_start down to eps (see :func:`ode_sampler`)."""
    t = torch.tensor(t_start, dtype=torch.float32, device=device)
    k1 = drift_fn(x, t)
    # scipy.integrate._ivp.common.select_initial_step, direction -1, order 4:
    # one extra evaluation (the Euler probe), as in scipy.
    scale = atol + x.abs() * rtol
    d0, d1 = _rms(x / scale, k1 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = drift_fn(x - h0 * k1, t - h0)
    dm = torch.maximum(d1, _rms((f1 - k1) / scale) / h0)
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6), (0.01 / dm) ** 0.2)
    h = -torch.minimum(100.0 * h0, h1)  # negative: reverse time
    rejected = torch.tensor(False, device=device)
    nfe, steps, running = 2, 0, t_start > eps + 1e-8
    while running and steps < max_steps:
        with span("sampler.step"):  # one attempt, accepted or not
            h = torch.maximum(h, eps - t)  # do not step past eps
            ks = [k1]
            for i in range(1, 6):
                xi = x
                for j, aij in enumerate(_DP_A[i]):
                    xi = xi + h * aij * ks[j]
                ks.append(drift_fn(xi, t + _DP_C[i] * h))
            x5 = x
            for bi, ki in zip(_DP_B5[:6], ks):
                x5 = x5 + h * bi * ki
            k7 = drift_fn(x5, t + h)  # FSAL
            ks.append(k7)
            err = torch.zeros_like(x)
            for b5, b4, ki in zip(_DP_B5, _DP_B4, ks):
                err = err + h * (b5 - b4) * ki
            err_scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
            enorm = _rms(err.abs() / err_scale)
            accept = enorm <= 1.0
            # scipy's controller: SAFETY 0.9, factors in [0.2, 10], exponent -1/5;
            # zero error grows by 10; an acceptance right after a rejection does
            # not grow the step.
            factor = torch.where(enorm == 0.0, 10.0,
                                 torch.clamp(0.9 * enorm ** -0.2, 0.2, 10.0))
            factor = torch.where(accept & rejected, torch.clamp(factor, max=1.0), factor)
            t = torch.where(accept, t + h, t)
            h = h * factor
            rejected = ~accept
            nfe, steps = nfe + 6, steps + 1
            accepted, running = torch.stack([accept, t > eps + 1e-8]).tolist()  # one host read
            if accepted:
                x, k1 = x5, k7
    if running and float(t) > eps + 1e-6:
        warnings.warn(f"ODE sampler hit max_steps={max_steps} at t={float(t):.4f} before "
                      f"reaching t_eps={eps}; result is partially integrated. Raise "
                      "max_steps or loosen rtol/atol.")
    return x, nfe


# ---------------------------------------------------------------------------------------
# Schroedinger-bridge samplers
# ---------------------------------------------------------------------------------------

def sb_sampler(
    sde: SBVESDE,
    model_fn: Callable,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-4,
    sampler_type: str = "ode",
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """First-order Schroedinger-bridge sampler over ``sde.N`` steps of
    ``linspace(T, eps, N+1)``. Returns ``(sample, N)``.

    ``model_fn(x, y, t)`` predicts the clean state (data prediction). The
    ``ode`` variant is noise-free and starts at ``y``; the ``sde`` variant
    starts at ``y[:, :1]`` and adds noise at every step but the last, drawn
    from ``generator`` or given as ``noise`` of shape ``(N, B, 1, F, T)``.
    """
    if sampler_type not in ("ode", "sde"):
        raise ValueError("Invalid type. Choose 'ode' or 'sde'.")
    if noise is not None and sampler_type == "ode":
        raise ValueError("the ode variant is noise-free; noise applies to the sde variant")
    n = sde.N
    if noise is not None and noise.shape[0] != n:
        raise ValueError(f"step noise must have N = {n} entries, got {noise.shape[0]}")
    batch = y.shape[0]
    time_steps = torch.linspace(sde.T, eps, n + 1, dtype=torch.float32, device=y.device)
    # The weights depend on the time grid alone: one (N,) vector each, computed
    # once per call on the device, so a step launches only its update. Step i
    # reads entry i - 1: "t" is grid point i, "prev" grid point i - 1.
    sigma, sigma_T, sigma_bar, alpha, alpha_T, _ = sde.sigmas_alphas(time_steps)
    sigma_prev, sigma_bar_prev, alpha_prev = sigma[:-1], sigma_bar[:-1], alpha[:-1]
    sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T = (
        sigma[1:], sigma_T[1:], sigma_bar[1:], alpha[1:], alpha_T[1:])
    if sampler_type == "sde":
        weight_prev = alpha_t * sigma_t**2 / (alpha_prev * sigma_prev**2 + sde.eps)
        tmp = 1.0 - sigma_t**2 / (sigma_prev**2 + sde.eps)
        weights = (weight_prev, alpha_t * tmp, alpha_t * sigma_t * torch.sqrt(tmp))
    else:
        weight_prev = (alpha_t * sigma_t * sigma_bart
                       / (alpha_prev * sigma_prev * sigma_bar_prev + sde.eps))
        weight_estimate = (alpha_t / (sigma_T**2 + sde.eps)
                           * (sigma_bart**2 - sigma_bar_prev * sigma_t * sigma_bart
                              / (sigma_prev + sde.eps)))
        weight_prior_mean = (alpha_t / (alpha_T * sigma_T**2 + sde.eps)
                             * (sigma_t**2 - sigma_prev * sigma_t * sigma_bart
                                / (sigma_bar_prev + sde.eps)))
        weights = (weight_prev, weight_estimate, weight_prior_mean)
    xt = y[:, :1] if sampler_type == "sde" else y
    for i in range(1, n + 1):
        with span("sampler.step"):
            vec_t = time_steps[i].expand(batch)
            w_prev, w_est, w_last = (_bcast(w[i - 1].expand(batch)) for w in weights)
            est = model_fn(xt, y, vec_t)
            if sampler_type == "sde":
                xt = w_prev * xt + w_est * est
                if i < n:  # the last step adds no noise
                    z = crandn(xt.shape, generator, xt.device) if noise is None else noise[i - 1]
                    xt = xt + w_last * z
            else:
                xt = w_prev * xt + w_est * est + w_last * y
    return xt, n
