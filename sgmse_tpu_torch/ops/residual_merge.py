"""The residual merge of the score network's blocks, with the biases of the
convolutions that computed its two terms (K8 of the port):

    h <- ((skip + skip_bias[c]) + (h + bias[c])) * scale

for (B, C, H, W) skip and h of one dtype, float32 (C,) biases (a bias not given
is 0) and a scale of 1/sqrt(2) or 1. Counterpart of XLA's fusion, in the JAX
package, of the epilogue after a block's last convolutions: Conv_1's bias, the
shortcut's bias and the ``(x + h) / sqrt(2)`` merge of the res-blocks
(``sgmse_tpu/models/blocks.py:423-431``, ``:368-377``), NIN_3's bias and the
attention block's merge (``:244-248``), Combine's sum (``:211-216``) and the
residual pyramids' merges (``sgmse_tpu/models/ncsnpp.py:190``, ``:254``). The
blocks call it where no gradient is recorded, with their convolutions run
without biases (``models/blocks.py``, ``residual``).

Arithmetic, for both versions: float32 inside, one rounding to h's dtype at
the end; the result is written over h, which is returned.

:func:`residual_merge` dispatches on the device of h: a CPU tensor goes through
:func:`residual_merge_plain`, a CUDA tensor through the hand-written kernel
``csrc/residual_merge.cu`` (:func:`residual_merge_cuda`, one launch per call),
which raises on anything it does not take. The note at the top of the ``.cu``
file says what bounds the kernel on the H100 and what the design does about it.
It has no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


def residual_merge_plain(h: torch.Tensor, skip: torch.Tensor, scale: float = 1.0,
                         bias: Optional[torch.Tensor] = None,
                         skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K8: ((skip + skip_bias) + (h + bias)) * scale in float32,
    rounded once and written over h."""
    s, t = skip.float(), h.float()
    if skip_bias is not None:
        s = s + skip_bias.float()[:, None, None]
    if bias is not None:
        t = t + bias.float()[:, None, None]
    return h.copy_((s + t) * scale)


def residual_merge_cuda(h: torch.Tensor, skip: torch.Tensor, scale: float = 1.0,
                        bias: Optional[torch.Tensor] = None,
                        skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the hand-written kernel once. Takes CUDA tensors h and skip of one
    shape (B, C, H, W) and dtype (float32 or bfloat16), both in channels_last
    memory and distinct, any C; biases contiguous float32 (C,) on h's device.
    Raises on anything else. (16-byte vectors where C is a multiple of 4
    float32 or 8 bfloat16 channels, at most 256 vectors, and both tensors are
    16-byte aligned; one element per thread otherwise.)"""
    if h.device.type != "cuda":
        raise ValueError(f"residual_merge_cuda takes a CUDA tensor, got {h.device}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"residual_merge_cuda takes float32 or bfloat16, got {h.dtype}")
    for name, t in (("h", h), ("skip", skip)):
        if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"residual_merge_cuda: {name} must be a 4-D tensor in "
                             f"channels_last memory")
        if t.shape != h.shape or t.dtype != h.dtype or t.device != h.device:
            raise ValueError(f"residual_merge_cuda: {name} must have h's shape, dtype and device")
    if skip.data_ptr() == h.data_ptr():
        raise ValueError("residual_merge_cuda: skip and h must be distinct tensors")
    b, c, hh, w = h.shape
    for name, p in (("bias", bias), ("skip_bias", skip_bias)):
        if p is not None and (p.device != h.device or p.dtype != torch.float32
                              or tuple(p.shape) != (c,) or not p.is_contiguous()):
            raise ValueError(f"residual_merge_cuda: {name} must be a contiguous float32 ({c},) "
                             f"tensor on {h.device}")
    err = kernels.lib().sgmse_residual_merge(
        skip.data_ptr(), h.data_ptr(), None if bias is None else bias.data_ptr(),
        None if skip_bias is None else skip_bias.data_ptr(), b * hh * w, c, scale,
        int(h.dtype == torch.bfloat16), torch.cuda.current_stream(h.device).cuda_stream)
    kernels.check(err, "residual_merge kernel")
    kernels.count_launch(residual_merge_cuda)
    return h


residual_merge_cuda.launches = 0


def residual_merge(h: torch.Tensor, skip: torch.Tensor, scale: float = 1.0,
                   bias: Optional[torch.Tensor] = None,
                   skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h <- ((skip + skip_bias) + (h + bias)) * scale: K8 on the card, the
    plain version on the CPU. Not differentiable: raises where a gradient would
    be recorded."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (h, skip, bias, skip_bias)):
        raise RuntimeError("residual_merge has no gradient: call it where none is recorded")
    args = (h, skip, scale, bias, skip_bias)
    if h.device.type == "cuda":
        return residual_merge_cuda(*args)
    if h.device.type == "cpu":
        return residual_merge_plain(*args)
    raise ValueError(f"residual_merge: unsupported device {h.device}")
