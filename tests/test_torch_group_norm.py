"""The port's GroupNorm+SiLU (sgmse_tpu_torch.ops.group_norm) against flax
``nn.GroupNorm`` (min(C//4, 32) groups, eps 1e-6) followed by ``jax.nn.silu``,
as the JAX package's blocks use it.

Both compute the statistics in float32 with variance E[x^2] - E[x]^2.
Tolerances, relative to max|ref|: float32 1e-5 (reductions in another order);
bfloat16 2^-6, two bf16 rounding steps (flax rounds the normalised value to
bf16 before the SiLU, the port rounds once after it).
"""
import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from sgmse_tpu.models import blocks as jblocks
from sgmse_tpu_torch.ops import group_norm as gn


def _flax_gn(x_nhwc, scale, bias, dtype, silu):
    c = x_nhwc.shape[-1]
    mod = jblocks.group_norm(c, dtype=dtype)
    out = mod.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x_nhwc, dtype))
    return np.asarray((jax.nn.silu(out) if silu else out).astype(jnp.float32))


@pytest.mark.parametrize("c,hw,silu", [(16, (8, 6), True), (48, (4, 4), True),
                                       (128, (16, 8), True), (384, (4, 2), True),
                                       (32, (8, 8), False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_act_matches_flax(c, hw, silu, dtype):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, *hw, c)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = _flax_gn(x, scale, bias, jdt, silu)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = gn.group_norm_act(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                            gn.num_groups_for(c), 1e-6, silu)
    assert got.dtype == tx.dtype and got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = 1e-5 if dtype == "float32" else 2.0**-6
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("c,hw", [(16, (8, 6)), (128, (16, 8)), (384, (4, 2))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_act_pre_bias_matches_flax(c, hw, dtype):
    """pre_bias (the res-block's temb projection, in the compute dtype) against
    flax GroupNorm + silu of x + bias. flax adds in the compute dtype, the port
    in float32: in bfloat16 that is one more rounding on the flax side, inside
    the same 2^-6."""
    rng = np.random.default_rng(c + 1)
    x = (rng.standard_normal((2, *hw, c)) * 2.0 + 0.5).astype(np.float32)
    bias = rng.standard_normal((2, c)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x).to(tdt).float().numpy()  # representable in the compute dtype
    bias = torch.from_numpy(bias).to(tdt).float().numpy()
    xb = jnp.asarray(x, jdt) + jnp.asarray(bias, jdt)[:, None, None, :]
    ref = _flax_gn(xb, scale, beta, jdt, True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    got = gn.group_norm_act(tx, torch.from_numpy(scale), torch.from_numpy(beta),
                            gn.num_groups_for(c), 1e-6, True, torch.from_numpy(bias).to(tdt))
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = 1e-5 if dtype == "float32" else 2.0**-6
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_num_groups_rule():
    assert [gn.num_groups_for(c) for c in (16, 64, 128, 256, 512)] == [4, 16, 32, 32, 32]
    assert nn.GroupNorm(num_groups=gn.num_groups_for(128)).num_groups == 32


def test_kernel_wrapper_refuses_cpu():
    x = torch.zeros(1, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    before = gn.group_norm_act_cuda.launches
    gn.group_norm_act(x, torch.ones(16), torch.zeros(16), 4)
    assert gn.group_norm_act_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        gn.group_norm_act_cuda(x, torch.ones(16), torch.zeros(16), 4)
