"""The port's OUVE SDE (sgmse_tpu_torch.sdes) against the JAX package's.

Inputs are numpy, seeded. Tolerance: 1e-5 relative to the reference's max
magnitude (float32 transcendental functions in two libraries).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgmse_tpu import sdes as jsdes
from sgmse_tpu_torch import sdes

RTOL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= RTOL * scale, np.abs(got - ref).max() / scale


def _state(seed, shape=(3, 1, 8, 6)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture
def inputs():
    t = np.array([0.03, 0.4, 1.0], np.float32)
    return _state(0), _state(1), _state(2), t


def test_registry_and_config():
    assert "ouve" in sdes.SDERegistry
    assert sdes.OUVESDE().config_dict() == jsdes.OUVESDE().config_dict()


@pytest.mark.parametrize("probability_flow", [False, True])
def test_ouve_coefficients_and_reverse(inputs, probability_flow):
    x, y, score, t = inputs
    port, ref = sdes.OUVESDE(theta=1.5, sigma_min=0.05, sigma_max=0.5), jsdes.OUVESDE()
    tx, ty, ts, tt = (torch.from_numpy(a) for a in (x, y, score, t))
    jx, jy, js, jt = (jnp.asarray(a) for a in (x, y, score, t))
    for got, want in zip(port.sde(tx, ty, tt), ref.sde(jx, jy, jt)):
        _close(got, want)
    for got, want in zip(port.marginal_prob(tx, ty, tt), ref.marginal_prob(jx, jy, jt)):
        _close(got, want)
    _close(port.alpha(tt), ref.alpha(jt))
    step = torch.tensor(0.0334, dtype=torch.float32)
    for got, want in zip(port.discretize(tx, ty, tt, step), ref.discretize(jx, jy, jt, 0.0334)):
        _close(got, want)
    for got, want in zip(port.reverse_sde(ts, tx, ty, tt, probability_flow),
                         ref.reverse_sde(js, jx, jy, jt, probability_flow)):
        _close(got, want)
    for got, want in zip(port.reverse_discretize(ts, tx, ty, tt, step, probability_flow),
                         ref.reverse_discretize(js, jx, jy, jt, 0.0334, probability_flow)):
        _close(got, want)


def test_prior_from_noise(inputs):
    x, y, z, _ = inputs
    _close(sdes.OUVESDE().prior_from_noise(torch.from_numpy(z), torch.from_numpy(y)),
           jsdes.OUVESDE().prior_from_noise(jnp.asarray(z), jnp.asarray(y)))


def test_crandn_statistics_and_generator():
    """Real and imaginary parts each N(0, 1/2): E|z|^2 = 1; a seeded generator repeats."""
    z = sdes.crandn((200_000,), torch.Generator().manual_seed(0))
    assert z.dtype == torch.complex64
    assert abs(z.real.var().item() - 0.5) < 0.01 and abs(z.imag.var().item() - 0.5) < 0.01
    assert abs((z.abs() ** 2).mean().item() - 1.0) < 0.01
    assert abs(z.mean().real.item()) < 0.01 and abs(torch.corrcoef(
        torch.stack([z.real, z.imag]))[0, 1].item()) < 0.01
    y = torch.from_numpy(_state(5))
    a = sdes.OUVESDE().prior_sampling(y, torch.Generator().manual_seed(7))
    b = sdes.OUVESDE().prior_sampling(y, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    std_T = float(sdes.OUVESDE()._std(torch.ones(1)))
    assert math.isclose(std_T, float(jsdes.OUVESDE()._std(jnp.ones(1))[0]), rel_tol=RTOL)


def test_sbve_registry_defaults_and_config():
    assert "sbve" in sdes.SDERegistry
    port = sdes.SBVESDE()
    assert (port.N, port.sampler_type) == (50, "ode")
    assert port.config_dict() == jsdes.SBVESDE().config_dict()


def test_sbve_tables_mean_std_and_sde():
    """Over t in [1e-4, 1], up to t -> T, where sigma_T^2 - sigma_t^2 cancels
    unless taken in closed form."""
    t = np.array([1e-4, 0.03, 0.4, 0.9, 0.999, 0.99999, 1.0], np.float32)
    shape = (len(t), 1, 4, 3)
    x0, y = _state(3, shape), _state(4, shape)
    port, ref = sdes.SBVESDE(k=2.6, c=0.4), jsdes.SBVESDE()
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    got, want = port.sigmas_alphas(tt), ref.sigmas_alphas(jt)
    assert all(g.dtype == torch.float32 and g.shape == (len(t),) for g in got)
    for g, w in zip(got, want):
        _close(g, w)
    tx0, ty, jx0, jy = torch.from_numpy(x0), torch.from_numpy(y), jnp.asarray(x0), jnp.asarray(y)
    for g, w in zip(port.marginal_prob(tx0, ty, tt), ref.marginal_prob(jx0, jy, jt)):
        _close(g, w)
    _close(port._std(tt), ref._std(jt))
    for g, w in zip(port.sde(tx0, ty, tt), ref.sde(jx0, jy, jt)):
        _close(g, w)


def test_sbve_schedule_on_a_grid_matches_per_element_calls():
    """The samplers' grid, in one call, gives each point's bits alone or repeated
    over a batch, as the per-step calls took it."""
    port = sdes.SBVESDE()
    grid = torch.linspace(port.T, 1e-4, port.N + 1, dtype=torch.float32)
    table = port.sigmas_alphas(grid)
    for i in range(len(grid)):
        for t in (grid[i:i + 1], grid[i].expand(3)):
            for g, w in zip(port.sigmas_alphas(t), table):
                assert torch.equal(g, w[i].expand(len(t))), i


def test_sbve_prior_is_y():
    y = torch.from_numpy(_state(6))
    assert sdes.SBVESDE().prior_sampling(y, torch.Generator().manual_seed(0)) is y
    assert sdes.SBVESDE().prior_from_noise(torch.zeros_like(y), y) is y
