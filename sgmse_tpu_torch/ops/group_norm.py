"""GroupNorm with an optional bias added first and an optional SiLU after.

Counterpart of the JAX package's ``blocks.group_norm`` (flax ``nn.GroupNorm``
with min(C//4, 32) groups and eps 1e-6, ``sgmse_tpu/models/blocks.py:157-167``)
followed by ``jax.nn.silu``. With ``pre_bias`` it also takes in the res-block's
time-embedding add before ``GroupNorm_1`` (``blocks.py:416-421``):
y = act(GN(x + pre_bias[:, :, None, None])), with ``pre_bias`` (B, C) in x's
dtype (the Dense_0 output as it is, so no cast runs).

Arithmetic, for both versions below: ``pre_bias`` is added to x in float32
(flax adds in the compute dtype, so in bfloat16 it rounds the sum once more),
the statistics are float32 whatever the input dtype, the variance is
E[x^2] - E[x]^2 clamped at 0 (flax 0.12's ``use_fast_variance``), and
y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, followed by x * sigmoid(x)
when ``silu`` is set, all in float32 and rounded once to the input dtype. The
plain version takes the means with torch's float32 reductions; the kernel sums
in float32 per block of pixels and combines the blocks in float64, in a fixed
order, so its results repeat bit for bit. Against flax in float32 the two agree
to about 1e-6 relative for inputs whose mean is not large against their spread
(the E[x^2] - E[x]^2 form loses digits as mean^2/var grows); in bfloat16 they
differ from flax by up to two bf16 rounding steps, because flax rounds the
normalised value to bf16 before the SiLU and the port rounds once after it.

:func:`group_norm_act` dispatches on the device of its input: a CPU tensor goes
through :func:`group_norm_act_plain`, a CUDA tensor through the hand-written
kernel ``csrc/group_norm_act.cu`` (:func:`group_norm_act_cuda`, one launch per
call), which raises on anything it does not take. The note at the top of the
``.cu`` file says what bounds the kernel on the H100 and what the design does
about it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels


def num_groups_for(channels: int) -> int:
    """The NCSN++ group count: min(C // 4, 32)."""
    return min(channels // 4, 32)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float = 1e-6, silu: bool = True,
                         pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch GroupNorm (+ SiLU) on (B, C, H, W), after adding the
    (B, C) ``pre_bias`` if given; result in x's dtype and channels_last memory."""
    b, c, h, w = x.shape
    cg = c // num_groups
    xf = x.float()
    if pre_bias is not None:
        xf = xf + pre_bias.float()[:, :, None, None]
    xg = xf.reshape(b, num_groups, cg, h * w)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
    var = (mean2 - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * gamma.float().reshape(1, num_groups, cg, 1)
    y = (xg - mean) * mul + beta.float().reshape(1, num_groups, cg, 1)
    y = y.reshape(b, c, h, w)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def group_norm_act_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        num_groups: int, eps: float = 1e-6, silu: bool = True,
                        pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the hand-written kernel once. Takes a CUDA tensor (B, C, H, W) in
    channels_last memory, float32 or bfloat16, with C a multiple of the 16-byte
    vector (4 float32 or 8 bfloat16 channels), at most 512 such vectors, and a
    multiple of num_groups; float32 gamma and beta of shape (C,); and an optional
    ``pre_bias`` of shape (B, C) in x's dtype. Raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm_act_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_act_cuda takes a 4-D tensor in channels_last memory")
    b, c, h, w = x.shape
    vec = 16 // x.element_size()
    if c % vec or c // vec > 512 or c % num_groups:
        raise ValueError(f"group_norm_act_cuda: unsupported C={c}, groups={num_groups} "
                         f"for {x.dtype}")
    params = [("gamma", gamma, (c,), torch.float32), ("beta", beta, (c,), torch.float32)]
    if pre_bias is not None:
        params.append(("pre_bias", pre_bias, (b, c), x.dtype))
    for name, p, shape, dtype in params:
        if (p.device != x.device or p.dtype != dtype or tuple(p.shape) != shape
                or not p.is_contiguous()):
            raise ValueError(f"group_norm_act_cuda: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_act_cuda: input is not 16-byte aligned")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    # Scratch for the per-block partial sums: at most one block per SM.
    blocks = max(b, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((blocks, num_groups, 2), dtype=torch.float32, device=x.device)
    err = kernels.lib().sgmse_group_norm_act(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if pre_bias is None else pre_bias.data_ptr(), partial.data_ptr(), blocks,
        b, h * w, c, num_groups, eps, int(silu), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "group_norm_act kernel")
    group_norm_act_cuda.launches += 1
    return y


group_norm_act_cuda.launches = 0


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float = 1e-6, silu: bool = True,
                   pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over `num_groups` groups of x + pre_bias, then SiLU if `silu`."""
    if x.device.type == "cuda":
        return group_norm_act_cuda(x, gamma, beta, num_groups, eps, silu, pre_bias)
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, num_groups, eps, silu, pre_bias)
    raise ValueError(f"group_norm_act: unsupported device {x.device}")
