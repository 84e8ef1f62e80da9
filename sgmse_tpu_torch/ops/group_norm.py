"""GroupNorm with an optional fused SiLU.

Counterpart of the JAX package's ``blocks.group_norm`` (flax ``nn.GroupNorm``
with min(C//4, 32) groups and eps 1e-6, ``sgmse_tpu/models/blocks.py:157-167``)
followed by ``jax.nn.silu``.

Arithmetic, for both versions below: the statistics are float32 whatever the
input dtype, the variance is E[x^2] - E[x]^2 clamped at 0 (flax 0.12's
``use_fast_variance``), and y = (x - mean) * (rsqrt(var + eps) * gamma) + beta,
followed by x * sigmoid(x) when ``silu`` is set, all in float32 and rounded once
to the input dtype. The plain version takes the means with torch's float32
reductions; the kernel sums in float32 per block of pixels and combines the
blocks in float64. Against flax in float32 the two agree to about 1e-6 relative
for inputs whose mean is not large against their spread (the E[x^2] - E[x]^2
form loses digits as mean^2/var grows); in bfloat16 they differ from flax by up
to two bf16 rounding steps, because flax rounds the normalised value to bf16
before the SiLU and the port rounds once after it.

:func:`group_norm_act` dispatches on the device of its input: a CPU tensor goes
through :func:`group_norm_act_plain`, a CUDA tensor through the hand-written
kernel ``csrc/group_norm_act.cu`` (:func:`group_norm_act_cuda`), which raises on
anything it does not take. The note at the top of the ``.cu`` file says what
bounds the kernel on the H100 and what the design does about it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import kernels

# Pixels per block of the kernel's reduction pass. At the score network's top
# level (256 x 256 pixels) this gives 256 blocks per utterance.
PIX_PER_CHUNK = 256


def num_groups_for(channels: int) -> int:
    """The NCSN++ group count: min(C // 4, 32)."""
    return min(channels // 4, 32)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float = 1e-6, silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm (+ SiLU) on (B, C, H, W); result in x's dtype and
    channels_last memory."""
    b, c, h, w = x.shape
    cg = c // num_groups
    xg = x.float().reshape(b, num_groups, cg, h * w)
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
                        num_groups: int, eps: float = 1e-6, silu: bool = True) -> torch.Tensor:
    """Launch the hand-written kernel. Takes a CUDA tensor (B, C, H, W) in
    channels_last memory, float32 or bfloat16, with C and C / num_groups
    multiples of 4 and C <= 1024, and float32 gamma and beta of shape (C,);
    raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm_act_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_act_cuda takes a 4-D tensor in channels_last memory")
    b, c, h, w = x.shape
    if c % 4 or c % num_groups or (c // num_groups) % 4 or c > 1024:
        raise ValueError(f"group_norm_act_cuda: unsupported C={c}, groups={num_groups}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (c,)
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"group_norm_act_cuda: {name} must be a contiguous, 16-byte "
                             f"aligned float32 ({c},) tensor on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_act_cuda: input is not 16-byte aligned")
    if x.numel() >= 2**31:
        raise ValueError("group_norm_act_cuda: tensor too large for 32-bit indexing")
    hw = h * w
    n_chunks = math.ceil(hw / PIX_PER_CHUNK)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    partial = torch.empty((b, n_chunks, num_groups, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    err = kernels.lib().sgmse_group_norm_act(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(),
        stats.data_ptr(), b, hw, c, num_groups, PIX_PER_CHUNK, n_chunks, eps, int(silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "group_norm_act kernel")
    group_norm_act_cuda.launches += 1
    return y


group_norm_act_cuda.launches = 0


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float = 1e-6, silu: bool = True) -> torch.Tensor:
    """GroupNorm over `num_groups` groups, then SiLU if `silu`."""
    if x.device.type == "cuda":
        return group_norm_act_cuda(x, gamma, beta, num_groups, eps, silu)
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, num_groups, eps, silu)
    raise ValueError(f"group_norm_act: unsupported device {x.device}")
