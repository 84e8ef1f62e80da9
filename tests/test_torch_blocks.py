"""The port's NCSN++ blocks (sgmse_tpu_torch.models.blocks) against the JAX
package's Flax blocks, float32.

Each block gets the JAX module's own init (non-zero init_scale where the
DDPM default would make a branch ~0), carried over by
``convert.state_dict_from_jax`` and strict-loaded. Inputs are numpy, seeded;
NHWC for JAX, the same data as NCHW-indexed channels_last for the port.
Tolerance: 1e-4 relative to max|out| (convolution and reduction sums in
another order).

The DDPM init sets every bias to zero, where a bias dropped, added twice or
added in the wrong place would not show; the port folds the res-blocks',
attention's and Combine's biases into its kernels where no gradient is
recorded. So each block that folds is also run with every bias leaf of the
JAX tree (``bias``, NIN's ``b``, GroupNorm's too) moved by seeded noise, the
port under ``no_grad``, at the same tolerances.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.models import blocks as jb
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.models import blocks as pb

RTOL = 1e-4


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_in(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2) if x.ndim == 4 else torch.from_numpy(x)


def _port_out(t):
    t = t.detach().float()
    return t.permute(0, 2, 3, 1).numpy() if t.ndim == 4 else t.numpy()


def move_biases(params, seed=0, scale=0.3):
    """The JAX params tree with every bias leaf (``bias``, NIN's ``b``) moved
    by seeded noise of std ``scale``."""
    rng = np.random.default_rng(seed)
    flat = convert.flatten_tree(jax.tree.map(np.asarray, params))
    return convert.unflatten_tree({
        k: v + (scale * rng.standard_normal(v.shape)).astype(v.dtype)
        if k.rsplit("/", 1)[-1] in ("bias", "b") else v for k, v in flat.items()})


def _run(jmod, pmod, *inputs, biases=False, **kw):
    """Init jmod on the inputs, load its params into pmod, run both; compare.
    With ``biases``, every bias leaf moved (:func:`move_biases`) first."""
    params = jmod.init(jax.random.key(0), *(jnp.asarray(a) for a in inputs), **kw)["params"]
    if biases:
        params = move_biases(params)
    ref = np.asarray(jmod.apply({"params": params}, *(jnp.asarray(a) for a in inputs), **kw))
    pmod.load_state_dict(convert.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = _port_out(pmod(*(_port_in(a) for a in inputs)))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish"])
def test_get_act(name):
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(pb.get_act(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.get_act(name)(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_conv3x3_and_conv1x1():
    x = _nhwc((2, 6, 5, 4), 0)
    _run(jb.Conv3x3(8), pb.Conv3x3(4, 8), x)
    _run(jb.Conv1x1(8), pb.Conv1x1(4, 8), x)


def test_nin_and_dense():
    _run(jb.NIN(8), pb.NIN(4, 8), _nhwc((2, 3, 5, 4), 1))
    _run(jb.DDPMDense(16), pb.DDPMDense(12, 16), _nhwc((3, 12), 2))


def test_fourier_and_positional_embeddings():
    t = np.log(np.array([0.03, 0.5, 1.0], np.float32))
    _run(jb.GaussianFourierProjection(embedding_size=8), pb.GaussianFourierProjection(8), t)
    for dim in (8, 9):
        np.testing.assert_allclose(
            pb.get_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jb.get_timestep_embedding(jnp.asarray(t), dim)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["sum", "cat"])
def test_combine(method):
    x, y = _nhwc((2, 6, 4, 4), 3), _nhwc((2, 6, 4, 8), 4)
    _run(jb.Combine(dim2=8, method=method), pb.Combine(4, 8, method=method), x, y)


@pytest.mark.parametrize("skip_rescale", [True, False])
def test_attention(skip_rescale):
    x = _nhwc((2, 4, 6, 16), 5)
    _run(jb.AttnBlockpp(skip_rescale=skip_rescale, init_scale=1.0),
         pb.AttnBlockpp(16, skip_rescale=skip_rescale, init_scale=1.0), x)


@pytest.mark.parametrize("in_ch,out_ch,up,down,temb", [
    (16, 16, False, False, True),
    (16, 32, False, False, True),
    (16, 16, True, False, True),
    (16, 16, False, True, True),
    (32, 16, False, True, False),
])
def test_resnet_block_biggan(in_ch, out_ch, up, down, temb):
    x = _nhwc((2, 8, 6, in_ch), 6)
    inputs = (x, _nhwc((2, 24), 7)) if temb else (x,)
    jmod = jb.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=in_ch, out_ch=out_ch, up=up, down=down,
                                  fir=True, init_scale=1.0, temb_dim=24 if temb else None)
    pmod = pb.ResnetBlockBigGANpp(in_ch, out_ch, up=up, down=down, fir=True, init_scale=1.0,
                                  temb_dim=24 if temb else None)
    _run(jmod, pmod, *inputs)


@pytest.mark.parametrize("up,down", [(False, False), (True, False), (False, True)])
def test_resnet_block_biggan_bf16(up, down):
    """bfloat16 block with the temb bias fused into GroupNorm_1 (added in
    float32, where flax adds in bf16 and rounds): within 5e-2 of max|out|, the
    NCSN++ bf16 bound (both round every layer's output, at different places)."""
    x, temb = _nhwc((2, 8, 6, 16), 8), _nhwc((2, 24), 9)
    jmod = jb.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=16, out_ch=16, up=up, down=down,
                                  fir=True, init_scale=1.0, temb_dim=24, dtype=jnp.bfloat16)
    pmod = pb.ResnetBlockBigGANpp(16, 16, up=up, down=down, fir=True, init_scale=1.0,
                                  temb_dim=24, dtype=torch.bfloat16)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(temb))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(temb))).astype(np.float32)
    pmod.load_state_dict(convert.state_dict_from_jax(jax.tree.map(np.asarray,
                                                                  variables["params"])))
    with torch.no_grad():
        got = pmod(_port_in(x).to(torch.bfloat16), _port_in(temb))
    assert got.dtype == torch.bfloat16
    got = _port_out(got)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()


# Blocks whose biases the port folds where no gradient is recorded: (JAX block, port block,
# inputs), built on demand.
FOLDING = {
    "attention": lambda: (jb.AttnBlockpp(skip_rescale=True, init_scale=1.0),
                          pb.AttnBlockpp(16, skip_rescale=True, init_scale=1.0),
                          (_nhwc((2, 4, 6, 16), 5),)),
    "attention, no rescale": lambda: (jb.AttnBlockpp(init_scale=1.0),
                                      pb.AttnBlockpp(16, init_scale=1.0),
                                      (_nhwc((2, 4, 6, 16), 5),)),
    "combine sum": lambda: (jb.Combine(dim2=8, method="sum"), pb.Combine(4, 8, method="sum"),
                            (_nhwc((2, 6, 4, 4), 3), _nhwc((2, 6, 4, 8), 4))),
    **{f"biggan {i}o{o}{' up' if up else ''}{' down' if down else ''}"
       f"{' temb' if temb else ''}": (
        lambda i=i, o=o, up=up, down=down, temb=temb: (
            jb.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=i, out_ch=o, up=up, down=down,
                                   fir=True, init_scale=1.0, temb_dim=24 if temb else None),
            pb.ResnetBlockBigGANpp(i, o, up=up, down=down, fir=True, init_scale=1.0,
                                   temb_dim=24 if temb else None),
            (_nhwc((2, 8, 6, i), 6),) + ((_nhwc((2, 24), 7),) if temb else ())))
       for i, o, up, down, temb in [(16, 16, False, False, True), (16, 32, False, False, True),
                                    (16, 16, True, False, True), (16, 16, False, True, True),
                                    (32, 16, False, True, False)]},
    **{f"ddpm {i}o{o}{' conv_shortcut' if conv else ''}{' temb' if temb else ''}": (
        lambda i=i, o=o, conv=conv, temb=temb: (
            jb.ResnetBlockDDPMpp(act=jax.nn.silu, in_ch=i, out_ch=o, conv_shortcut=conv,
                                 skip_rescale=True, init_scale=1.0,
                                 temb_dim=24 if temb else None),
            pb.ResnetBlockDDPMpp(i, o, conv_shortcut=conv, skip_rescale=True, init_scale=1.0,
                                 temb_dim=24 if temb else None).eval(),  # no dropout
            (_nhwc((2, 8, 6, i), 6),) + ((_nhwc((2, 24), 7),) if temb else ())))
       for i, o, conv, temb in [(16, 16, False, True), (16, 32, False, True),
                                (16, 32, True, True), (16, 32, False, False)]},
}


@pytest.mark.parametrize("case", list(FOLDING))
def test_block_with_moved_biases_matches_jax(case):
    jmod, pmod, inputs = FOLDING[case]()
    _run(jmod, pmod, *inputs, biases=True)


@pytest.mark.parametrize("up,down", [(False, False), (True, False), (False, True)])
def test_resnet_block_biggan_bf16_with_moved_biases(up, down):
    """As ``test_resnet_block_biggan_bf16``, every bias leaf moved: the port
    folds Conv_0's bias into K2's pre-bias and Conv_1's and Conv_2's into the
    merge, where flax adds each in bf16 and rounds."""
    x, temb = _nhwc((2, 8, 6, 16), 8), _nhwc((2, 24), 9)
    jmod = jb.ResnetBlockBigGANpp(act=jax.nn.silu, in_ch=16, out_ch=16, up=up, down=down,
                                  fir=True, init_scale=1.0, temb_dim=24, dtype=jnp.bfloat16)
    pmod = pb.ResnetBlockBigGANpp(16, 16, up=up, down=down, fir=True, init_scale=1.0,
                                  temb_dim=24, dtype=torch.bfloat16)
    params = move_biases(jmod.init(jax.random.key(0), jnp.asarray(x),
                                   jnp.asarray(temb))["params"])
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(temb))).astype(np.float32)
    pmod.load_state_dict(convert.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = pmod(_port_in(x).to(torch.bfloat16), _port_in(temb))
    assert got.dtype == torch.bfloat16
    got = _port_out(got)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()


def test_init_rules():
    """DDPM init: fan_avg uniform with limit sqrt(3 s / fan_avg); scale 0 -> 1e-10."""
    conv = pb.Conv3x3(16, 32, init_scale=1.0)
    conv.Conv_0.init_parameters(torch.Generator().manual_seed(0))
    limit = math.sqrt(3.0 / ((16 * 9 + 32 * 9) / 2))
    w = conv.Conv_0.weight
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    assert not conv.Conv_0.bias.any()
    zero = pb.NIN(8, 8, init_scale=0.0)
    zero.init_parameters(torch.Generator().manual_seed(0))
    assert 0 < zero.W.abs().max() <= math.sqrt(3e-10 / 8)
