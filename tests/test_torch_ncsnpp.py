"""The port's NCSN++ against the JAX package's, at the small test config.

Weights: the JAX model's own init (init_scale 1, so no branch is ~zero),
carried over by ``convert.params_from_jax``. Inputs: numpy, seeded.
Tolerance: float32 forward within 1e-4 of max|out| (convolution sums run in
another order in the two frameworks); bfloat16 forward within 5e-2 of
max|out| (both round every layer's output to bf16, at different places).
"""
import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.models import NCSNpp as JaxNCSNpp
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.models import BackboneRegistry, NCSNpp

SMALL = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,),
             image_size=64, init_scale=1.0)


def _inputs(b=2, f=64, t=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 1, f, t)) + 1j * rng.standard_normal((b, 1, f, t)))
    y = (rng.standard_normal((b, 1, f, t)) + 1j * rng.standard_normal((b, 1, f, t)))
    tt = rng.uniform(0.03, 1.0, (b,))
    return x.astype(np.complex64) * 0.5, y.astype(np.complex64) * 0.5, tt.astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    x, y, t = _inputs()
    variables = jax.jit(JaxNCSNpp(**SMALL).init)(jax.random.key(3), x, y, t)
    return jax.tree.map(np.asarray, variables["params"])


def _port(params, **extra):
    model = NCSNpp(**SMALL, **extra)
    model.load_state_dict(convert.params_from_jax(params, **SMALL, **extra))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("precision,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_forward_matches_jax(jax_params, precision, tol):
    x, y, t = _inputs(seed=1)
    ref = np.asarray(jax.jit(JaxNCSNpp(**SMALL, precision=precision).apply)(
        {"params": jax_params}, x, y, t))
    with torch.no_grad():
        got = _port(jax_params, precision=precision)(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 1, 64, 64) and got.dtype == np.complex64
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, f"relative error {err}"


def test_attention_trigger_follows_runtime_height(jax_params):
    """A frequency height that triggers attention at a level without
    parameters raises instead of silently skipping the block."""
    x, y, t = _inputs(f=32, t=64)  # attention would trigger at level 1
    with pytest.raises(RuntimeError, match="triggers attention"):
        _port(jax_params)(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t))


def test_param_names_and_count_match_jax(jax_params):
    model = NCSNpp(**SMALL)
    flat = convert.flatten_tree(jax_params)
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in flat.values())
    assert set(model.state_dict()) == set(convert.state_dict_from_jax(jax_params))


def test_params_from_jax_is_strict(jax_params):
    broken = convert.unflatten_tree(
        {k: v for k, v in convert.flatten_tree(jax_params).items() if "mid_attn" not in k})
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.params_from_jax(broken, **SMALL)
    extra = dict(jax_params, stray={"bias": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        convert.params_from_jax(extra, **SMALL)


def test_npz_round_trip(jax_params, tmp_path):
    sd = convert.params_from_jax(jax_params, **SMALL)
    convert.save_npz(tmp_path / "w.npz", convert.jax_tree_from_state_dict(sd))
    back = convert.flatten_tree(convert.load_npz(tmp_path / "w.npz"))
    for k, v in convert.flatten_tree(jax_params).items():
        np.testing.assert_array_equal(back[k], v)


def test_full_config_param_count():
    """The default config is the 65.59M-param flagship, as in the JAX package."""
    assert "ncsnpp" in BackboneRegistry
    assert sum(p.numel() for p in NCSNpp().parameters()) == 65_590_822


@pytest.mark.parametrize("kwargs", [dict(resblock_type="ddpm"), dict(progressive="residual"),
                                    dict(progressive_combine="cat"), dict(fir=False),
                                    dict(nonlinearity="relu")])
def test_unported_branches_raise(kwargs):
    with pytest.raises(NotImplementedError):
        NCSNpp(**{**SMALL, **kwargs})
