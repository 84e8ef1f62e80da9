"""The NCSN++ branches beyond the flagship's (DDPM res-blocks, residual
pyramids, ``cat`` combine, non-FIR resampling, elu/relu/lrelu) against the
JAX package, at a small size (nf 16, ch_mult 1,2, one res-block per level,
F = T = 32).

Weights: the port's seeded init (init_scale 1, so that no branch is ~zero),
carried to JAX by ``convert.jax_tree_from_state_dict``, whose tree must have
the JAX initialisation's leaves and shapes. Inputs: numpy, seeded.
Tolerances: the float32 forward within 1e-4 of max|out|; the ``step_loss``
value and every leaf's gradient within 1e-4 of the leaf's max|grad|
(convolution sums in another order in the two frameworks); the attention key
bias, whose gradient is exactly zero, within 1e-6 of the largest gradient.
The init leaves every bias at zero, so each forward is also compared with
every bias leaf moved by seeded noise (the port, under ``no_grad``, folds the
res-blocks', attention's, Combine's and the residual pyramids' biases and
merges into its kernels), at the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.sdes import crandn as jax_crandn
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.model import ScoreModel
from test_torch_blocks import move_biases

SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, init_scale=1.0, n_fft=62,
             hop_length=16, num_frames=32)
F = T = 32
CASES = {
    "ddpm": ("ncsnpp", dict(resblock_type="ddpm")),
    "48k residual pyramids": ("ncsnpp_48k", dict(progressive="residual",
                                                 progressive_input="residual")),
    "cat": ("ncsnpp", dict(progressive_combine="cat")),
    "no fir, elu": ("ncsnpp", dict(fir=False, nonlinearity="elu")),
    "ddpm, no fir, relu": ("ncsnpp", dict(resblock_type="ddpm", fir=False, nonlinearity="relu")),
    "residual, no fir, lrelu": ("ncsnpp_v2", dict(progressive="residual",
                                                  progressive_input="residual", fir=False,
                                                  nonlinearity="lrelu")),
}
GRAD_CASES = ("ddpm", "48k residual pyramids")
TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _complex(rng, shape, scale=0.5):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _shapes(tree, prefix=""):
    """{"a/b/c": shape} of a nested dict of arrays or shape structs."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_shapes(value, path) if isinstance(value, dict) else {path: value.shape})
    return out


def _models(case):
    backbone, extra = CASES[case]
    port = ScoreModel(backbone, "ouve", **SMALL, **extra)
    port.init_params(torch.Generator().manual_seed(4))
    port = port.to(memory_format=torch.channels_last)
    jmodel = JaxScoreModel(backbone, "ouve", **SMALL, **extra)
    params = convert.jax_tree_from_state_dict(port.dnn.state_dict())
    x0 = np.zeros((1, 1, F, T), np.complex64)
    init = jax.eval_shape(lambda: jmodel.dnn.init(jax.random.key(0), x0, x0,
                                                  np.full((1,), 0.5, np.float32)))["params"]
    assert _shapes(params) == _shapes(init)
    return port, jmodel, params


@pytest.mark.parametrize("case", sorted(CASES))
def test_branch_matches_jax(case):
    port, jmodel, params = _models(case)
    assert port.config_dict() == jmodel.config_dict()
    rng = np.random.default_rng(1)
    x, y = _complex(rng, (2, 1, F, T)), _complex(rng, (2, 1, F, T))
    t = rng.uniform(0.03, 1.0, 2).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.dnn.apply)({"params": params}, x, y, t))
    with torch.no_grad():
        got = port.dnn.eval()(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 1, F, T)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, err
    if case not in GRAD_CASES:
        return

    key = jax.random.key(5)
    kt, kz, _ = jax.random.split(key, 3)
    tt = np.asarray(jax.random.uniform(kt, (2,), minval=jmodel.t_eps, maxval=jmodel.sde.T))
    z = np.asarray(jax_crandn(kz, (2, 1, F, T)))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: jmodel.step_loss(
        {"params": p}, (jnp.asarray(x), jnp.asarray(y)), key, train=True)))(params)
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_grads))
    port.train()
    loss = port.step_loss(torch.from_numpy(x), torch.from_numpy(y), t=torch.tensor(tt),
                          z=torch.tensor(z))
    named = {n: p for n, p in port.dnn.named_parameters() if p.requires_grad}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(loss.item() - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert set(grads) == set(ref) - {"fourier.W"}
    scale = max(r.abs().max().item() for r in ref.values())
    for name, g in grads.items():
        r = ref[name]
        if name.endswith("NIN_1.b"):  # exactly zero (softmax invariance): rounding noise
            assert max(g.abs().max().item(), r.abs().max().item()) <= 1e-6 * scale, name
            continue
        err = (g - r).abs().max().item()
        assert err <= TOL * r.abs().max().item(), (name, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_branch_with_moved_biases_matches_jax(case):
    port, jmodel, params = _models(case)
    params = move_biases(params, seed=6)
    port.dnn.load_state_dict(convert.state_dict_from_jax(params))
    rng = np.random.default_rng(2)
    x, y = _complex(rng, (2, 1, F, T)), _complex(rng, (2, 1, F, T))
    t = rng.uniform(0.03, 1.0, 2).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.dnn.apply)({"params": params}, x, y, t))
    with torch.no_grad():
        got = port.dnn.eval()(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 1, F, T)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, err
