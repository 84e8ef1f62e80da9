"""The port's PC sampler (sgmse_tpu_torch.sampling) against the JAX package's.

Both sides get an analytic score (the exact score of the OUVE perturbation
kernel around a known clean state), numpy inputs, and the same noise: the
port is fed the complex normals that JAX's ``crandn`` draws from the keys the
JAX step splits. Tolerance: 1e-5 relative to max|ref| for single steps, 1e-4
for a whole trajectory (float32 time grids rounded in two libraries).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu import sampling as js
from sgmse_tpu import sdes as jsdes
from sgmse_tpu_torch import sampling, sdes


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _cplx(seed, shape=(2, 1, 8, 6), scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
            ).astype(np.complex64)


def _oracle(sde, x0):
    """Exact score of p_t(x | x0, y) = CN(mean(t), std(t)^2) for either framework."""
    def score(x, y, t):
        mean, std = sde.marginal_prob(x0, y, t)
        return -(x - mean) / (std[:, None, None, None] ** 2)
    return score


@pytest.fixture
def problem():
    x0, y = _cplx(0, scale=0.3), _cplx(1, scale=0.3)
    return x0, y, _cplx(2), np.array([0.7, 0.2], np.float32)


def test_registries():
    assert {"reverse_diffusion", "none"} <= set(sampling.PredictorRegistry.get_all_names())
    assert {"ald", "none"} <= set(sampling.CorrectorRegistry.get_all_names())


@pytest.mark.parametrize("n_steps", [1, 2])
def test_ald_step_with_jax_noise(problem, n_steps):
    x0, y, x, t = problem
    jsde, psde = jsdes.OUVESDE(), sdes.OUVESDE()
    key = jax.random.key(11)
    ref = js.ald_corrector(jsde, _oracle(jsde, jnp.asarray(x0)), snr=0.5, n_steps=n_steps)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), key)
    noise, k = [], key
    for _ in range(n_steps):  # the keys the JAX step splits, in its order
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jsdes.crandn(sub, x.shape)))
    got = sampling.ald_corrector(psde, _oracle(psde, torch.from_numpy(x0)), 0.5, n_steps)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
        noise=torch.from_numpy(np.stack(noise)))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_reverse_diffusion_step_with_jax_noise(problem):
    x0, y, x, t = problem
    jsde, psde = jsdes.OUVESDE(), sdes.OUVESDE()
    z = _cplx(3)
    ref = js.reverse_diffusion_predictor(jsde, _oracle(jsde, jnp.asarray(x0)))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), 0.0334, None, noise=jnp.asarray(z))
    got = sampling.reverse_diffusion_predictor(psde, _oracle(psde, torch.from_numpy(x0)))(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
        torch.tensor(0.0334), noise=torch.from_numpy(z))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_pc_trajectory_with_injected_noise(problem):
    """Prior and every predictor step's noise injected on both sides (JAX inject_steps)."""
    x0, y, _, _ = problem
    n = 6
    jsde, psde = jsdes.OUVESDE(N=n), sdes.OUVESDE(N=n)
    z = np.stack([_cplx(10 + i) for i in range(n + 1)])
    program, nfe = js.pc_sampler_program("reverse_diffusion", "none", jsde,
                                         _oracle(jsde, jnp.asarray(x0)), eps=0.03,
                                         inject_steps=True)
    ref = program(jax.random.key(0), jnp.asarray(y), jnp.asarray(z))
    got, pnfe = sampling.pc_sampler("reverse_diffusion", "none", psde,
                                    _oracle(psde, torch.from_numpy(x0)), torch.from_numpy(y),
                                    eps=0.03, noise=torch.from_numpy(z))
    assert pnfe == nfe == n
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("corrector,nfe", [("ald", 60), ("none", 30)])
def test_pc_sampler_inverts_diffusion(corrector, nfe):
    """With the exact score the sampler recovers the clean state (as tests/test_sampling.py)."""
    psde = sdes.OUVESDE(N=30)
    gen = torch.Generator().manual_seed(0)
    x0 = sdes.crandn((2, 1, 16, 16), gen) * 0.3
    y = x0 + sdes.crandn((2, 1, 16, 16), gen) * 0.1
    sample, got_nfe = sampling.pc_sampler("reverse_diffusion", corrector, psde,
                                          _oracle(psde, x0), y, generator=gen, snr=0.5)
    assert got_nfe == nfe
    assert (torch.linalg.norm(sample - x0) / torch.linalg.norm(x0)).item() < 0.15


def test_corrector_noise_hook_makes_runs_repeat(problem):
    x0, y, _, _ = problem
    psde = sdes.OUVESDE(N=4)
    z = torch.from_numpy(np.stack([_cplx(20 + i) for i in range(5)]))
    cz = torch.from_numpy(np.stack([_cplx(30 + i) for i in range(4)])[:, None])
    runs = [sampling.pc_sampler("reverse_diffusion", "ald", psde,
                                _oracle(psde, torch.from_numpy(x0)), torch.from_numpy(y),
                                generator=torch.Generator().manual_seed(seed), snr=0.5,
                                noise=z, corrector_noise=cz)[0] for seed in (1, 2)]
    assert torch.equal(runs[0], runs[1])


def test_euler_maruyama_step(problem):
    x0, y, x, t = problem
    jsde, psde = jsdes.OUVESDE(N=30), sdes.OUVESDE(N=30)
    z = _cplx(4)
    ref = js.euler_maruyama_predictor(jsde, _oracle(jsde, jnp.asarray(x0)))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), None, None, noise=jnp.asarray(z))
    got = sampling.euler_maruyama_predictor(psde, _oracle(psde, torch.from_numpy(x0)))(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t), None,
        noise=torch.from_numpy(z))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_langevin_step_with_jax_noise(problem, n_steps):
    x0, y, x, t = problem
    jsde, psde = jsdes.OUVESDE(), sdes.OUVESDE()
    key = jax.random.key(12)
    ref = js.langevin_corrector(jsde, _oracle(jsde, jnp.asarray(x0)), snr=0.5, n_steps=n_steps)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), key)
    noise, k = [], key
    for _ in range(n_steps):  # the keys the JAX step splits, in its order
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jsdes.crandn(sub, x.shape)))
    got = sampling.langevin_corrector(psde, _oracle(psde, torch.from_numpy(x0)), 0.5, n_steps)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
        noise=torch.from_numpy(np.stack(noise)))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_rk4_with_injected_prior(problem):
    x0, y, _, _ = problem
    jsde, psde = jsdes.OUVESDE(N=5), sdes.OUVESDE(N=5)
    z = _cplx(5)
    program = js.ode_sampler_program(jsde, _oracle(jsde, jnp.asarray(x0)), method="rk4",
                                     inject_prior=True)
    ref, nfe = program(jax.random.key(0), jnp.asarray(y), jnp.asarray(z))
    got, pnfe = sampling.ode_sampler(psde, _oracle(psde, torch.from_numpy(x0)),
                                     torch.from_numpy(y), method="rk4", noise=torch.from_numpy(z))
    assert pnfe == nfe == 4 * 5 + 1
    _close(got, ref, 1e-4)


def _rk45_oracle(sde, x0, sin):
    """The exact OUVE score plus a term oscillating in t: its truncation error
    then outweighs float32 rounding in the step controller's error estimate
    from the first step on, so both frameworks take the same decisions (with
    the plain score the estimate of the smooth early steps is rounding noise)."""
    score = _oracle(sde, x0)
    return lambda x, y, t: score(x, y, t) + 3.0 * sin(30.0 * t)[:, None, None, None] * y


@pytest.mark.parametrize("max_steps", [1000, 3])
def test_rk45_with_injected_prior_takes_jax_steps(problem, max_steps):
    """Same accept/reject decisions, so the same NFE; max_steps cut short warns."""
    x0, y, _, _ = problem
    jsde, psde = jsdes.OUVESDE(), sdes.OUVESDE()
    z = _cplx(6)
    program = js.ode_sampler_program(jsde, _rk45_oracle(jsde, jnp.asarray(x0), jnp.sin),
                                     method="rk45", max_steps=max_steps, inject_prior=True)
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        ref, nfe = program(jax.random.key(0), jnp.asarray(y), jnp.asarray(z))
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got, pnfe = sampling.ode_sampler(psde, _rk45_oracle(psde, torch.from_numpy(x0), torch.sin),
                                         torch.from_numpy(y), max_steps=max_steps,
                                         noise=torch.from_numpy(z))
    cut = max_steps < 10
    assert [("max_steps" in str(w.message)) for w in jax_warned] == [cut] * len(jax_warned)
    assert len(port_warned) == int(cut) and (not cut or "max_steps" in str(port_warned[0].message))
    assert pnfe == nfe and (nfe == 2 + 6 * max_steps + 1 if cut else nfe > 30)
    _close(got, ref, 1e-4)


def _sb_oracle(x0):
    """An analytic data prediction that depends on the state and the time."""
    def model_fn(x, y, t):
        return x0 + 0.1 * t[:, None, None, None] * (x - y)
    return model_fn


@pytest.mark.parametrize("n,rtol", [(1, 1e-5), (12, 1e-4)])
def test_sb_ode_matches_jax(problem, n, rtol):
    """n = 1 is one step; n = 12 a whole run (float32 grids in two libraries)."""
    x0, y, _, _ = problem
    jsde, psde = jsdes.SBVESDE(N=n), sdes.SBVESDE(N=n)
    program, nfe = js.sb_sampler_program(jsde, _sb_oracle(jnp.asarray(x0)), sampler_type="ode")
    ref = program(jax.random.key(0), jnp.asarray(y))
    got, pnfe = sampling.sb_sampler(psde, _sb_oracle(torch.from_numpy(x0)), torch.from_numpy(y),
                                    sampler_type="ode")
    assert pnfe == nfe == n
    _close(got, ref, rtol)


@pytest.mark.parametrize("n,rtol", [(1, 1e-5), (2, 1e-5), (12, 1e-4)])
def test_sb_sde_matches_jax_with_its_noise(problem, n, rtol):
    """JAX's inject_steps noise (N, B, 1, F, T) fed to the port; the last step adds none."""
    x0, y, _, _ = problem
    jsde, psde = jsdes.SBVESDE(N=n), sdes.SBVESDE(N=n)
    z = np.stack([_cplx(40 + i) for i in range(n)])
    program, nfe = js.sb_sampler_program(jsde, _sb_oracle(jnp.asarray(x0)), sampler_type="sde",
                                         inject_steps=True)
    ref = program(jax.random.key(0), jnp.asarray(y), jnp.asarray(z))
    got, pnfe = sampling.sb_sampler(psde, _sb_oracle(torch.from_numpy(x0)), torch.from_numpy(y),
                                    sampler_type="sde", noise=torch.from_numpy(z))
    assert pnfe == nfe == n
    _close(got, ref, rtol)


def _sb_per_step(sde, model_fn, y, eps=1e-4, sampler_type="ode", noise=None):
    """The bridge sampler with its schedule evaluated anew at every step: the
    loop ``sampling.sb_sampler`` ran before it took its weights from one table."""
    n = sde.N
    batch = y.shape[0]
    time_steps = torch.linspace(sde.T, eps, n + 1, dtype=torch.float32, device=y.device)
    sigma_prev, _, sigma_bar_prev, alpha_prev, _, _ = sde.sigmas_alphas(
        time_steps[0].expand(batch))
    xt = y[:, :1] if sampler_type == "sde" else y
    for i in range(1, n + 1):
        vec_t = time_steps[i].expand(batch)
        sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T, _ = sde.sigmas_alphas(vec_t)
        est = model_fn(xt, y, vec_t)
        if sampler_type == "sde":
            weight_prev = alpha_t * sigma_t**2 / (alpha_prev * sigma_prev**2 + sde.eps)
            tmp = 1.0 - sigma_t**2 / (sigma_prev**2 + sde.eps)
            weight_estimate = alpha_t * tmp
            xt = sampling._bcast(weight_prev) * xt + sampling._bcast(weight_estimate) * est
            if i < n:  # the last step adds no noise
                xt = xt + sampling._bcast(alpha_t * sigma_t * torch.sqrt(tmp)) * noise[i - 1]
        else:
            weight_prev = (alpha_t * sigma_t * sigma_bart
                           / (alpha_prev * sigma_prev * sigma_bar_prev + sde.eps))
            weight_estimate = (alpha_t / (sigma_T**2 + sde.eps)
                               * (sigma_bart**2 - sigma_bar_prev * sigma_t * sigma_bart
                                  / (sigma_prev + sde.eps)))
            weight_prior_mean = (alpha_t / (alpha_T * sigma_T**2 + sde.eps)
                                 * (sigma_t**2 - sigma_prev * sigma_t * sigma_bart
                                    / (sigma_bar_prev + sde.eps)))
            xt = (sampling._bcast(weight_prev) * xt + sampling._bcast(weight_estimate) * est
                  + sampling._bcast(weight_prior_mean) * y)
        alpha_prev, sigma_prev, sigma_bar_prev = alpha_t, sigma_t, sigma_bart
    return xt


@pytest.mark.parametrize("n", [7, 50])
@pytest.mark.parametrize("sampler_type", ["ode", "sde"])
def test_sb_schedule_table_matches_per_step_schedule(sampler_type, n):
    """The weights taken from one table per call give the per-step loop's bits."""
    shape = (3, 1, 8, 6)
    x0, y = torch.from_numpy(_cplx(50, shape, 0.3)), torch.from_numpy(_cplx(51, shape, 0.3))
    noise = (torch.from_numpy(np.stack([_cplx(60 + i, shape) for i in range(n)]))
             if sampler_type == "sde" else None)
    sde = sdes.SBVESDE(N=n)
    got, nfe = sampling.sb_sampler(sde, _sb_oracle(x0), y, sampler_type=sampler_type,
                                   noise=noise)
    want = _sb_per_step(sde, _sb_oracle(x0), y, sampler_type=sampler_type, noise=noise)
    assert nfe == n and torch.equal(got, want)


@pytest.mark.parametrize("sampler_type", ["ode", "sde"])
def test_sb_sampler_evaluates_its_schedule_once(monkeypatch, sampler_type):
    """One schedule evaluation per sampler call, whatever N (N + 1 when each step
    evaluated its own)."""
    calls = []
    schedule = sdes.SBVESDE.sigmas_alphas

    def counted(self, t):
        calls.append(t.shape)
        return schedule(self, t)

    monkeypatch.setattr(sdes.SBVESDE, "sigmas_alphas", counted)
    x0, y = torch.from_numpy(_cplx(52, scale=0.3)), torch.from_numpy(_cplx(53, scale=0.3))
    for n in (4, 9):
        calls.clear()
        sampling.sb_sampler(sdes.SBVESDE(N=n), _sb_oracle(x0), y, sampler_type=sampler_type,
                            generator=torch.Generator().manual_seed(0))
        assert calls == [(n + 1,)]
