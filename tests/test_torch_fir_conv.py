"""K6 of the port, FIR + convolution + bias (``ops.upfirdn2d.upsample_conv_2d``
and ``conv_downsample_2d``: one launch of ``csrc/fir_conv.cu`` on the card,
the composition of the convolution and the FIR on the CPU, where this runs),
with its backward, and the blocks built on it (``FIRConv2d``, ``Upsample`` and
``Downsample`` in every (fir, with_conv) form) against the JAX package.

Weights: the port's seeded init, carried to JAX by
``convert.jax_tree_from_state_dict``; inputs and the output cotangent: numpy,
seeded. Tolerances: the forward within 1e-5 of max|out|, the gradients of
the input and of every parameter (of ``sum(out * cotangent)``) within 1e-4 of
each one's max|ref| (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.models import blocks as jblocks
from sgmse_tpu.ops import upfirdn2d as jufd
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.models import blocks
from sgmse_tpu_torch.ops import upfirdn2d as ufd

B, C_IN, C_OUT, H, W = 2, 4, 8, 10, 6
FIR = (1, 3, 3, 1)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, ref, tol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("c_in,c_out", [(C_IN, C_OUT), (16, 8)])
@pytest.mark.parametrize("name", ["upsample_conv_2d", "conv_downsample_2d"])
def test_fir_conv_functions_match_jax(name, c_in, c_out):
    """The functions with FIRConv2d's bias passed in, against JAX's FIRConv2d
    (its conv, FIR and bias add): the forward and the gradients of x, w and
    the bias. C_in = 4 is the input pyramid's first level (4 -> 128 at full
    width), which the kernel takes on its narrow path."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, c_in)).astype(np.float32)  # NHWC
    w = rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32)  # HWIO
    bias = rng.standard_normal(c_out).astype(np.float32)
    up = name == "upsample_conv_2d"
    jmod = jblocks.FIRConv2d(c_out, up=up, down=not up, resample_kernel=FIR)
    apply = lambda a, b, c: jmod.apply({"params": {"weight": b, "bias": c}}, a)
    ref = np.asarray(apply(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_dx, ref_dw, ref_db = jax.grad(lambda a, b, c: jnp.sum(apply(a, b, c) * cot),
                                      (0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.asarray(bias))

    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)  # OIHW
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = getattr(ufd, name)(xt, wt, k=FIR, bias=bt)
    _close(out.detach().permute(0, 2, 3, 1), ref, FWD_TOL, "forward")
    dx, dw, db = torch.autograd.grad((out * _nchw(cot)).sum(), (xt, wt, bt))
    _close(dx.permute(0, 2, 3, 1), ref_dx, GRAD_TOL, "dx")
    _close(dw.permute(2, 3, 1, 0), ref_dw, GRAD_TOL, "dw")
    _close(db, ref_db, GRAD_TOL, "dbias")


MODULES = {
    "FIRConv2d up": (lambda: blocks.FIRConv2d(C_IN, C_OUT, up=True),
                     lambda: jblocks.FIRConv2d(C_OUT, up=True)),
    "FIRConv2d down": (lambda: blocks.FIRConv2d(C_IN, C_OUT, down=True),
                       lambda: jblocks.FIRConv2d(C_OUT, down=True)),
    "FIRConv2d plain": (lambda: blocks.FIRConv2d(C_IN, C_OUT),
                        lambda: jblocks.FIRConv2d(C_OUT)),
}
for _cls in ("Upsample", "Downsample"):
    for _fir in (True, False):
        for _conv in (True, False):
            MODULES[f"{_cls} fir={_fir} with_conv={_conv}"] = (
                lambda c=_cls, f=_fir, v=_conv: getattr(blocks, c)(
                    C_IN, C_OUT if v else None, with_conv=v, fir=f, fir_kernel=FIR),
                lambda c=_cls, f=_fir, v=_conv: getattr(jblocks, c)(
                    out_ch=C_OUT if v else None, with_conv=v, fir=f, fir_kernel=FIR))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_fir_blocks_match_jax(name):
    make_port, make_jax = MODULES[name]
    port = make_port()
    for m in port.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():  # non-zero biases, so that they are checked too
        for n, p in port.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    params = convert.jax_tree_from_state_dict(port.state_dict())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H, W, C_IN)).astype(np.float32)
    jmod = make_jax()
    if params:
        init = jax.eval_shape(lambda: jmod.init(jax.random.key(0), x))["params"]
        assert jax.tree.map(lambda a: a.shape, init) == jax.tree.map(np.shape, params)
    apply = lambda p, a: jmod.apply({"params": p}, a)
    ref = np.asarray(apply(params, jnp.asarray(x)))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_dp, ref_dx = jax.grad(lambda p, a: jnp.sum(apply(p, a) * cot), (0, 1))(
        params, jnp.asarray(x))

    xt = _nchw(x).requires_grad_(True)
    out = port(xt)
    _close(out.detach().permute(0, 2, 3, 1), ref, FWD_TOL, "forward")
    named = dict(port.named_parameters())
    grads = torch.autograd.grad((out * _nchw(cot)).sum(), [xt, *named.values()])
    _close(grads[0].permute(0, 2, 3, 1), ref_dx, GRAD_TOL, "dx")
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_dp))
    assert set(want) == set(named)
    for (n, _), g in zip(named.items(), grads[1:]):
        _close(g, want[n], GRAD_TOL, n)
