"""The port's NCSN++ (ncsnpp, ncsnpp_v2, ncsnpp_48k) against the JAX
package's, at the small test config.

Weights: the JAX model's own init for ncsnpp, the port's for the variants
(init_scale 1, so no branch is ~zero), carried over by
``convert.params_from_jax`` / ``convert.jax_tree_from_state_dict``. Inputs: numpy, seeded.
Tolerance: float32 forward within 1e-4 of max|out| (convolution sums run in
another order in the two frameworks); bfloat16 forward within 5e-2 of
max|out| (both round every layer's output to bf16, at different places).
Both inits leave every bias at zero, so each forward is also compared with
every bias leaf of the tree moved by seeded noise (the port, under
``no_grad``, folds the res-blocks', attention's and Combine's biases into
its kernels), at the same tolerances.
"""
import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.models import BackboneRegistry as JaxBackbones
from sgmse_tpu.models import NCSNpp as JaxNCSNpp
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.models import BackboneRegistry, NCSNpp, NCSNpp_48k, NCSNpp_v2

from test_torch_blocks import move_biases

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


@pytest.mark.parametrize("kwargs", [dict(resblock_type="vgg"), dict(progressive="pyramid"),
                                    dict(progressive_combine="mul"),
                                    dict(progressive_input="skip"),
                                    dict(nonlinearity="gelu")])
def test_unported_branches_raise(kwargs):
    """Every branch of the JAX network is ported (tests/test_torch_ncsnpp_branches.py);
    a value that neither package has still raises, at construction."""
    with pytest.raises((ValueError, NotImplementedError)):
        NCSNpp(**{**SMALL, **kwargs})


VARIANTS = {"ncsnpp_v2": SMALL, "ncsnpp_48k": {k: v for k, v in SMALL.items()
                                               if k != "attn_resolutions"}}


@pytest.fixture(scope="module")
def variant_params():
    """Port-initialised weights of each variant, as a JAX tree."""
    out = {}
    for name, config in VARIANTS.items():
        net = BackboneRegistry.get_by_name(name)(**config)
        for module in net.modules():
            if hasattr(module, "init_parameters"):
                module.init_parameters(torch.Generator().manual_seed(5))
        out[name] = convert.jax_tree_from_state_dict(net.state_dict())
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_param_tree_matches_jax(name):
    x, y, t = _inputs()
    config = VARIANTS[name]
    shapes = jax.eval_shape(JaxBackbones.get_by_name(name)(**config).init, jax.random.key(0),
                            x, y, t)["params"]
    want = {k: v.shape for k, v in convert.flatten_tree(
        jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    net = BackboneRegistry.get_by_name(name)(**config)
    got = {k: v.shape for k, v in
           convert.flatten_tree(convert.jax_tree_from_state_dict(net.state_dict())).items()}
    assert got == want


@pytest.mark.parametrize("precision,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax(variant_params, name, precision, tol):
    x, y, t = _inputs(seed=2)
    config = dict(VARIANTS[name], precision=precision)
    params = variant_params[name]
    ref = np.asarray(jax.jit(JaxBackbones.get_by_name(name)(**config).apply)(
        {"params": params}, x, y, t))
    net = BackboneRegistry.get_by_name(name)(**config)
    net.load_state_dict(convert.params_from_jax(params, name, **config))
    with torch.no_grad():
        got = net.to(memory_format=torch.channels_last).eval()(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 1, 64, 64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, f"relative error {err}"


def test_variant_defaults():
    v2, k48 = NCSNpp_v2(**SMALL), NCSNpp_48k(**VARIANTS["ncsnpp_48k"])
    assert not v2.scale_by_sigma and (v2.progressive, v2.progressive_input) == (
        "output_skip", "input_skip")
    assert k48.attn_resolutions == () and (k48.progressive, k48.progressive_input) == (
        "none", "none")
    assert k48.output_layer_before_sigma and hasattr(k48, "out_norm")
    assert not any("pyramid" in n or "combine" in n for n, _ in k48.named_modules())


@pytest.mark.parametrize("precision,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", ["ncsnpp"] + sorted(VARIANTS))
def test_forward_with_moved_biases_matches_jax(jax_params, variant_params, name, precision,
                                               tol):
    x, y, t = _inputs(seed=3)
    params = move_biases(jax_params if name == "ncsnpp" else variant_params[name], seed=4)
    config = dict(SMALL if name == "ncsnpp" else VARIANTS[name], precision=precision)
    ref = np.asarray(jax.jit(JaxBackbones.get_by_name(name)(**config).apply)(
        {"params": params}, x, y, t))
    net = BackboneRegistry.get_by_name(name)(**config)
    net.load_state_dict(convert.params_from_jax(params, name, **config))
    with torch.no_grad():
        got = net.to(memory_format=torch.channels_last).eval()(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 1, 64, 64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, f"relative error {err}"
