"""Gradients of the port's K1 and K2 dispatchers (the autograd Functions of
sgmse_tpu_torch.ops) on their plain routes, against jax.vjp of the JAX
package's functions on the same numpy inputs and cotangents.

- K1: the adjoint upfirdn2d (flipped FIR, up and down swapped, the derived
  pads) against the vjp of ``sgmse_tpu.ops.upfirdn2d.upsample_2d`` /
  ``downsample_2d``, single and pair, with the separable [1, 3, 3, 1] FIR and
  a non-separable one, at the score network's sizes and at odd ones.
- K2: the explicit backward formula (``group_norm_act_bwd_plain``) against
  the vjp of flax ``GroupNorm`` + silu, with and without the pre-bias and the
  SiLU, and in a group where E[x^2] - E[x]^2 is negative, so that the clamp
  at 0 cuts the gradient through the variance.

Tolerance: 1e-5 relative to max|grad| of each gradient, float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.models import blocks as jblocks
from sgmse_tpu.ops import upfirdn2d as jufd
from sgmse_tpu_torch.ops import group_norm as gn
from sgmse_tpu_torch.ops import upfirdn2d as ufd

TOL = 1e-5
FIR = [1, 3, 3, 1]
NON_SEPARABLE = (np.arange(16, dtype=np.float32).reshape(4, 4) % 5 + 1.0) * np.array(
    [1.0, 0.5, 2.0, 1.5], np.float32)


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


def _port(a):  # NHWC numpy -> NCHW-indexed channels_last tensor
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 9, 10, 8), (2, 5, 7, 4), (1, 4, 4, 16)])
@pytest.mark.parametrize("fir", ["separable", "non_separable"])
def test_resampling_gradient_matches_jax(fn, shape, fir):
    k = FIR if fir == "separable" else NON_SEPARABLE
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a: getattr(jufd, fn)(a, k), jnp.asarray(x))
    dy = rng.standard_normal(y.shape).astype(np.float32)
    ref, = vjp(jnp.asarray(dy))
    xt = _port(x).requires_grad_()
    out = getattr(ufd, fn)(xt, k)
    _close(_nhwc(out), y)
    got, = torch.autograd.grad(out, xt, _port(dy))
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(_nhwc(got), ref)


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
def test_pair_gradient_matches_two_jax_vjps(fn):
    rng = np.random.default_rng(7)
    x0, x1 = (rng.standard_normal((2, 6, 8, 8)).astype(np.float32) for _ in range(2))
    refs, dys = [], []
    for x in (x0, x1):
        y, vjp = jax.vjp(lambda a: getattr(jufd, fn)(a, FIR), jnp.asarray(x))
        dys.append(rng.standard_normal(y.shape).astype(np.float32))
        refs.append(vjp(jnp.asarray(dys[-1]))[0])
    xs = [_port(x).requires_grad_() for x in (x0, x1)]
    outs = getattr(ufd, fn + "_pair")(*xs, FIR)
    grads = torch.autograd.grad(outs, xs, [_port(d) for d in dys])
    for g, r in zip(grads, refs):
        _close(_nhwc(g), r)


@pytest.mark.parametrize("in_hw,out_hw,up,down,pad", [
    ((8, 8), (4, 4), 1, 2, (1, 1)),
    ((4, 4), (8, 8), 2, 1, (2, 1)),
    ((9, 10), (5, 5), 1, 2, (1, 1)),  # odd against even: the adjoint is cropped
    ((7, 5), (14, 10), 2, 1, (2, 1)),
])
def test_adjoint_pads_give_back_the_input_size(in_hw, out_hw, up, down, pad):
    k = ufd.setup_kernel(FIR)
    flipped, kw, crop = ufd.adjoint_args(in_hw, out_hw, k, up, down, pad)
    assert (kw["up"], kw["down"]) == (down, up) and kw["pad"][0] == 3 - pad[0]
    np.testing.assert_array_equal(flipped, k[::-1, ::-1])
    sizes = [(o * down + kw["pad"][0] + kw["pad"][1] - 4) // up + 1 for o in out_hw]
    assert (crop is None) == (sizes[0] - in_hw[0] == sizes[1] - in_hw[1] == 0)
    assert all(s >= n for s, n in zip(sizes, in_hw))


def test_backward_runs_the_dispatcher_once_per_call():
    """The adjoint goes through the same dispatcher as the forward (one kernel
    launch on the card, counted as an adjoint launch): a pair's two gradients
    in one call, marked ``adjoint``."""
    seen = []
    orig = ufd.upfirdn2d_pair
    ufd.upfirdn2d_pair = lambda *a, **kw: seen.append(kw) or orig(*a, **kw)
    try:
        xs = [torch.randn(1, 4, 6, 6).contiguous(memory_format=torch.channels_last)
              .requires_grad_() for _ in range(2)]
        outs = orig(*xs, ufd.setup_kernel(FIR), down=2, pad=(1, 1))
        torch.autograd.grad(outs, xs, [torch.ones_like(o) for o in outs])
    finally:
        ufd.upfirdn2d_pair = orig
    assert seen == [dict(up=2, down=1, pad=(2, 1), adjoint=True)]


def _flax_vjp(x, scale, bias, dy, silu, pre_bias=None):
    c = x.shape[-1]
    mod = jblocks.group_norm(c)

    def f(x, s, b, pb):
        h = x if pb is None else x + pb[:, None, None, :]
        out = mod.apply({"params": {"scale": s, "bias": b}}, h)
        return jax.nn.silu(out) if silu else out

    args = [jnp.asarray(a) for a in (x, scale, bias)]
    pb = None if pre_bias is None else jnp.asarray(pre_bias)
    if pb is None:
        y, vjp = jax.vjp(lambda x, s, b: f(x, s, b, None), *args)
    else:
        y, vjp = jax.vjp(f, *args, pb)
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _port_grads(x, scale, bias, dy, silu, pre_bias=None):
    tx = _port(x).requires_grad_()
    ts, tb = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    inputs = [tx, ts, tb]
    tpb = None
    if pre_bias is not None:
        tpb = torch.from_numpy(pre_bias).requires_grad_()
        inputs.append(tpb)
    out = gn.group_norm_act(tx, ts, tb, gn.num_groups_for(x.shape[-1]), 1e-6, silu, tpb)
    grads = torch.autograd.grad(out, inputs, _port(dy))
    return _nhwc(out), [_nhwc(grads[0])] + [g.numpy() for g in grads[1:]]


@pytest.mark.parametrize("c,hw,silu,with_bias", [(16, (8, 6), True, False),
                                                 (48, (4, 4), True, True),
                                                 (128, (6, 4), True, True),
                                                 (32, (8, 8), False, False),
                                                 (64, (2, 2), False, True)])
def test_group_norm_act_gradient_matches_flax(c, hw, silu, with_bias):
    rng = np.random.default_rng(c + hw[0])
    x = (rng.standard_normal((2, *hw, c)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    pre_bias = (0.5 * rng.standard_normal((2, c))).astype(np.float32) if with_bias else None
    dy = rng.standard_normal(x.shape).astype(np.float32)
    y_ref, refs = _flax_vjp(x, scale, bias, dy, silu, pre_bias)
    y, grads = _port_grads(x, scale, bias, dy, silu, pre_bias)
    _close(y, y_ref)
    for got, ref in zip(grads, refs):
        _close(got, ref)


def test_group_norm_gradient_where_the_variance_clamp_is_active():
    """Group 0 of batch row 0 holds four values 1.5 + k 2^-12: E[x^2] - E[x]^2
    rounds below 0, flax clamps it, and JAX's derivative of maximum cuts the
    gradient through the variance. The formula without the cut would be off
    by several percent (checked), so the test sees which one runs."""
    rng = np.random.default_rng(98)
    x = (rng.standard_normal((2, 1, 1, 16)) * 2.0 + 0.5).astype(np.float32)
    x[0, 0, 0, :4] = (1.5 + rng.integers(-2, 3, size=4) * 2.0**-12).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    _, stats = gn.group_norm_act_plain(_port(x), torch.from_numpy(scale),
                                       torch.from_numpy(bias), 4, return_stats=True)
    assert stats[0, 0, 1] < 0  # the clamp is active in this group
    _, refs = _flax_vjp(x, scale, bias, dy, True)
    _, grads = _port_grads(x, scale, bias, dy, True)
    for got, ref in zip(grads, refs):
        _close(got, ref)
    unclamped = stats.clone()
    unclamped[0, 0, 1] = 1e-30
    dx = gn.group_norm_act_bwd_plain(_port(dy), _port(x), torch.from_numpy(scale),
                                     torch.from_numpy(bias), unclamped, 4)[0]
    assert np.abs(_nhwc(dx) - refs[0]).max() > 1e-3 * np.abs(refs[0]).max()


def test_gradients_stop_nowhere_on_the_plain_route():
    """Inference takes no stats and no Function; a tensor that requires grad
    gets the Function, and gradients reach x, gamma, beta and the pre-bias."""
    x = torch.randn(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    gamma, beta = torch.ones(16, requires_grad=True), torch.zeros(16, requires_grad=True)
    pb = torch.randn(2, 16, requires_grad=True)
    with torch.no_grad():
        assert gn.group_norm_act(x, gamma, beta, 4, pre_bias=pb).grad_fn is None
    y = gn.group_norm_act(x.requires_grad_(), gamma, beta, 4, pre_bias=pb)
    assert type(y.grad_fn).__name__.startswith("_GroupNormAct")
    grads = torch.autograd.grad(y.square().sum(), [x, gamma, beta, pb])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    up = ufd.upsample_2d(x, FIR)
    assert type(up.grad_fn).__name__.startswith("_UpFirDn2d")
