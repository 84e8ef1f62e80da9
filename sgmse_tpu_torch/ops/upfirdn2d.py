"""Fused upsample -> FIR filter -> downsample (upfirdn2d) and the StyleGAN2-style
resampling built on it. Counterpart of ``sgmse_tpu/ops/upfirdn2d.py``.

Tensors are NCHW-indexed; on the score network's path they lie in
``torch.channels_last`` memory (physically the JAX package's NHWC).

Semantics, as in the JAX package:

    1. zero-stuff upsample by ``up`` (each sample followed by up-1 zeros),
    2. pad by (pad0, pad1) per spatial axis (negative => crop),
    3. correlate with the *flipped* 2-D FIR kernel,
    4. subsample with stride ``down``.

    out_size = (in*up + pad0 + pad1 - k) // down + 1

:func:`upfirdn2d` dispatches on the device of its input: a CPU tensor goes
through :func:`upfirdn2d_plain`, a CUDA tensor through the hand-written kernel
``csrc/upfirdn2d.cu`` (:func:`upfirdn2d_cuda`), which raises on anything it does
not take. :func:`upfirdn2d_pair` does the same for two tensors of one shape,
such as a res-block's h and skip x, in one launch. The kernel replaces the XLA
depthwise convolution of ``sgmse_tpu/ops/upfirdn2d.py:84-139``; the source note
at the top of the ``.cu`` file says what bounds it on the H100 and what the
design does about it.

Gradients. When its input requires grad, each dispatcher runs as a
``torch.autograd.Function`` whose backward is the adjoint, itself an
upfirdn2d (StyleGAN2's ``Upfirdn2dBackward``): the flipped FIR, ``up`` and
``down`` swapped, pad0' = kh - 1 - pad0 and pad1' = H*up - OH*down + pad0 - up
+ 1, which gives back exactly H rows (:func:`adjoint_args`). The backward
calls the same dispatcher, so on the card it is one more kernel launch (one
pair launch for a pair) and on the CPU the plain version.

FIR + convolution (K6 of the port: :func:`upsample_conv_2d`,
:func:`conv_downsample_2d`, the JAX package's ``sgmse_tpu/ops/upfirdn2d.py:175-224``)
splits as the JAX package splits it: the convolution on cuDNN, the FIR pass
as one :func:`upfirdn2d` at up = down = 1, which is K1 on the card and, with
its adjoint, differentiable as every other call.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

Kernel = Union[Sequence[float], np.ndarray]


def setup_kernel(k: Kernel) -> np.ndarray:
    """Normalize a FIR kernel: 1-D kernels become outer products; sum normalized to 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return k


def _out_size(n: int, k: int, up: int, down: int, pad0: int, pad1: int) -> int:
    return (n * up + pad0 + pad1 - k) // down + 1


def upfirdn2d_plain(x: torch.Tensor, kernel: Kernel, up: int = 1, down: int = 1,
                    pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch upfirdn2d on (B, C, H, W): float32 arithmetic, result in
    x's dtype and in channels_last memory. ``kernel`` may be a tensor already
    on x's device, which saves a host-to-device copy of the taps per call."""
    k = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    assert k.ndim == 2
    pad0, pad1 = pad
    b, c, h, w = x.shape
    out = x.float()
    if up > 1:
        out = out.reshape(b, c, h, 1, w, 1)
        out = F.pad(out, [0, up - 1, 0, 0, 0, up - 1])
        out = out.reshape(b, c, h * up, w * up)
    out = F.pad(out, [max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)])
    out = out[:, :, max(-pad0, 0):out.shape[2] - max(-pad1, 0),
              max(-pad0, 0):out.shape[3] - max(-pad1, 0)]
    weight = torch.flip(k, [0, 1])[None, None].expand(c, 1, *k.shape).contiguous()
    out = F.conv2d(out, weight, stride=down, groups=c)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _launch(xs: Sequence[torch.Tensor], kernel: Kernel, up: int, down: int,
            pad: Tuple[int, int], adjoint: bool = False) -> list:
    """Launch the hand-written kernel once on one tensor or a pair of tensors of
    the same shape, dtype and device; raises on anything it does not take.
    Counts the launch in ``upfirdn2d_cuda.adjoint_launches`` if it computes a
    backward (``adjoint``), else in ``upfirdn2d_cuda.launches``."""
    k = np.ascontiguousarray(kernel, dtype=np.float32)
    pad0, pad1 = pad
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"upfirdn2d_cuda takes float32 or bfloat16, got {x.dtype}")
    for t in xs:
        if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("upfirdn2d_cuda takes 4-D tensors in channels_last memory")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("upfirdn2d_pair_cuda takes two tensors of one shape, dtype and device")
        if t.data_ptr() % 16:
            raise ValueError("upfirdn2d_cuda: input is not 16-byte aligned")
    b, c, h, w = x.shape
    if c % 4 or up not in (1, 2) or down not in (1, 2) or k.ndim != 2 or max(k.shape) > 4:
        raise ValueError(f"upfirdn2d_cuda: unsupported C={c}, up={up}, down={down}, "
                         f"kernel {k.shape}")
    oh = _out_size(h, k.shape[0], up, down, pad0, pad1)
    ow = _out_size(w, k.shape[1], up, down, pad0, pad1)
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d_cuda: empty output {oh}x{ow}")
    if max(x.numel(), b * c * oh * ow) >= 2**31:
        raise ValueError("upfirdn2d_cuda: tensor too large for 32-bit indexing")
    ys = [torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last) for _ in xs]
    err = kernels.lib().sgmse_upfirdn2d(
        x.data_ptr(), xs[-1].data_ptr(), ys[0].data_ptr(), ys[-1].data_ptr(), len(xs),
        k.ctypes.data, k.shape[0], k.shape[1], b, h, w, c, oh, ow, up, down, pad0,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "upfirdn2d kernel")
    kernels.count_launch(upfirdn2d_cuda, "adjoint_launches" if adjoint else "launches")
    return ys


def upfirdn2d_cuda(x: torch.Tensor, kernel: Kernel, up: int = 1, down: int = 1,
                   pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the hand-written kernel. Takes a CUDA tensor (B, C, H, W) in
    channels_last memory, float32 or bfloat16, C a multiple of 4, up and down in
    {1, 2} and an FIR of at most 4x4; raises on anything else. Its ``launches``
    counts the forward launches of this function and of
    :func:`upfirdn2d_pair_cuda`, its ``adjoint_launches`` the launches that
    computed a backward (:func:`_adjoint`)."""
    return _launch([x], kernel, up, down, pad)[0]


upfirdn2d_cuda.launches = 0
upfirdn2d_cuda.adjoint_launches = 0


def upfirdn2d_pair_cuda(x0: torch.Tensor, x1: torch.Tensor, kernel: Kernel, up: int = 1,
                        down: int = 1, pad: Tuple[int, int] = (0, 0)):
    """:func:`upfirdn2d_cuda` on two tensors of the same shape, in one launch."""
    return tuple(_launch([x0, x1], kernel, up, down, pad))


def upfirdn2d_pair_plain(x0: torch.Tensor, x1: torch.Tensor, kernel: Kernel, up: int = 1,
                         down: int = 1, pad: Tuple[int, int] = (0, 0)):
    """The plain version of :func:`upfirdn2d_pair`: two plain calls."""
    return (upfirdn2d_plain(x0, kernel, up, down, pad),
            upfirdn2d_plain(x1, kernel, up, down, pad))


def _forward(xs: Sequence[torch.Tensor], kernel: Kernel, up: int, down: int,
             pad: Tuple[int, int], adjoint: bool = False) -> tuple:
    """upfirdn2d of one tensor or a pair, on the device of the first: the kernel
    on CUDA, the plain version on the CPU. No autograd."""
    x = xs[0]
    if x.device.type == "cuda":
        return tuple(_launch(xs, kernel, up, down, pad, adjoint))
    if x.device.type == "cpu":
        return tuple(upfirdn2d_plain(t, kernel, up, down, pad) for t in xs)
    raise ValueError(f"upfirdn2d: unsupported device {x.device}")


def adjoint_args(in_hw: Tuple[int, int], out_hw: Tuple[int, int], kernel: Kernel, up: int,
                 down: int, pad: Tuple[int, int]):
    """The upfirdn2d whose output is the gradient of an upfirdn2d's input:
    ``(flipped kernel, dict(up=, down=, pad=), crop)``. ``crop`` is None, or
    the (H, W) to cut the adjoint's output to where the two axes need different
    pad1' (their sizes differ in parity under ``down`` = 2)."""
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"upfirdn2d adjoint takes a square 2-D FIR, got {k.shape}")
    pad0, _ = pad
    pad1 = [n * up - o * down + pad0 - up + 1 for n, o in zip(in_hw, out_hw)]
    kw = dict(up=down, down=up, pad=(k.shape[0] - 1 - pad0, max(pad1)))
    crop = None if pad1[0] == pad1[1] else tuple(in_hw)
    return np.ascontiguousarray(k[::-1, ::-1]), kw, crop


def _adjoint(dys: Sequence[torch.Tensor], ctx) -> tuple:
    """Gradients of the inputs of a (pair) upfirdn2d from its outputs' gradients,
    through the dispatcher: one kernel launch on the card, counted as an
    adjoint launch. Gradients arrive in any memory format and are made
    channels_last for the launch."""
    kernel, kw, crop = adjoint_args(ctx.in_hw, ctx.out_hw, ctx.kernel, ctx.up, ctx.down,
                                    ctx.pad)
    dys = [torch.zeros(ctx.out_shape, dtype=ctx.dtype, device=ctx.device) if d is None
           else d.contiguous(memory_format=torch.channels_last) for d in dys]
    if len(dys) == 2:
        dxs = upfirdn2d_pair(dys[0], dys[1], kernel, adjoint=True, **kw)
    else:
        dxs = (upfirdn2d(dys[0], kernel, adjoint=True, **kw),)
    if crop is not None:
        dxs = tuple(d[:, :, :crop[0], :crop[1]].contiguous(memory_format=torch.channels_last)
                    for d in dxs)
    return dxs


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d of one tensor or a pair, with the adjoint as its backward."""

    @staticmethod
    def forward(ctx, kernel, up, down, pad, *xs):
        ys = _forward(xs, kernel, up, down, pad)
        ctx.kernel, ctx.up, ctx.down, ctx.pad = kernel, up, down, pad
        ctx.in_hw, ctx.out_hw = tuple(xs[0].shape[2:]), tuple(ys[0].shape[2:])
        ctx.out_shape, ctx.dtype, ctx.device = ys[0].shape, ys[0].dtype, ys[0].device
        return ys if len(ys) == 2 else ys[0]

    @staticmethod
    def backward(ctx, *dys):
        return (None, None, None, None, *_adjoint(dys, ctx))


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def upfirdn2d(x: torch.Tensor, kernel: Kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0), adjoint: bool = False) -> torch.Tensor:
    """upfirdn2d on (B, C, H, W), same up/down/pad on both spatial axes;
    differentiable in x (the adjoint is one more upfirdn2d). ``adjoint`` marks
    the call of a backward, for the launch counters."""
    if _needs_grad(x):
        return _UpFirDn2d.apply(kernel, up, down, pad, x)
    return _forward([x], kernel, up, down, pad, adjoint)[0]


def upfirdn2d_pair(x0: torch.Tensor, x1: torch.Tensor, kernel: Kernel, up: int = 1,
                   down: int = 1, pad: Tuple[int, int] = (0, 0), adjoint: bool = False):
    """upfirdn2d of two tensors of the same shape (a res-block's h and skip x);
    differentiable in both, with one pair launch for the two gradients."""
    if _needs_grad(x0, x1):
        return _UpFirDn2d.apply(kernel, up, down, pad, x0, x1)
    return _forward([x0, x1], kernel, up, down, pad, adjoint)


def _upsample_args(k: Kernel, factor: int, gain: float):
    assert isinstance(factor, int) and factor >= 1
    k = setup_kernel([1.0] * factor if k is None else k) * (gain * (factor**2))
    p = k.shape[0] - factor
    return k, dict(up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def _downsample_args(k: Kernel, factor: int, gain: float):
    assert isinstance(factor, int) and factor >= 1
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = k.shape[0] - factor
    return k, dict(down=factor, pad=((p + 1) // 2, p // 2))


def upsample_2d(x: torch.Tensor, k: Kernel = None, factor: int = 2, gain: float = 1.0):
    """FIR upsample by `factor` (JAX ``upsample_2d``)."""
    k, kw = _upsample_args(k, factor, gain)
    return upfirdn2d(x, k, **kw)


def downsample_2d(x: torch.Tensor, k: Kernel = None, factor: int = 2, gain: float = 1.0):
    """FIR downsample by `factor` (JAX ``downsample_2d``)."""
    k, kw = _downsample_args(k, factor, gain)
    return upfirdn2d(x, k, **kw)


def upsample_2d_pair(x0: torch.Tensor, x1: torch.Tensor, k: Kernel = None, factor: int = 2,
                     gain: float = 1.0):
    """:func:`upsample_2d` of two tensors of the same shape, one kernel launch."""
    k, kw = _upsample_args(k, factor, gain)
    return upfirdn2d_pair(x0, x1, k, **kw)


def downsample_2d_pair(x0: torch.Tensor, x1: torch.Tensor, k: Kernel = None, factor: int = 2,
                       gain: float = 1.0):
    """:func:`downsample_2d` of two tensors of the same shape, one kernel launch."""
    k, kw = _downsample_args(k, factor, gain)
    return upfirdn2d_pair(x0, x1, k, **kw)


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: Kernel = None, factor: int = 2,
                     gain: float = 1.0):
    """Zero-stuff upsample -> conv(w) -> FIR (JAX ``upsample_conv_2d``); w is
    OIHW (C_out, C_in, kh, kw), square.

    The JAX package correlates ``w`` with the zero-stuffed input under full
    padding; ``F.conv_transpose2d`` at stride ``factor`` computes that same
    sum with the flipped kernel, so it takes ``w`` flipped and permuted to
    (C_in, C_out, kh, kw). It runs on cuDNN; the FIR pass that follows is
    :func:`upfirdn2d` at up = down = 1 (K1 on the card)."""
    assert isinstance(factor, int) and factor >= 1
    conv_h, conv_w = w.shape[2:]
    assert conv_h == conv_w
    k = setup_kernel([1.0] * factor if k is None else k) * (gain * (factor**2))
    p = (k.shape[0] - factor) - (conv_w - 1)
    wt = torch.flip(w, [2, 3]).transpose(0, 1)
    y = F.conv_transpose2d(x, wt.to(x.dtype), stride=factor)
    return upfirdn2d(y.contiguous(memory_format=torch.channels_last), k,
                     pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: Kernel = None, factor: int = 2,
                       gain: float = 1.0):
    """FIR -> conv(w) with stride ``factor`` (JAX ``conv_downsample_2d``); w is
    OIHW, square. The FIR pass is :func:`upfirdn2d` at up = down = 1 (K1 on
    the card), the strided convolution cuDNN's."""
    assert isinstance(factor, int) and factor >= 1
    conv_h, conv_w = w.shape[2:]
    assert conv_h == conv_w
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (conv_w - 1)
    x = upfirdn2d(x.contiguous(memory_format=torch.channels_last), k,
                  pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w.to(x.dtype), stride=factor)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2):
    """Nearest-neighbour upsample (JAX ``naive_upsample_2d``)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor)
    return x.reshape(b, c, h * factor, w * factor).contiguous(memory_format=torch.channels_last)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2):
    """Mean-pool downsample (JAX ``naive_downsample_2d``)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    return x.mean(dim=(3, 5)).contiguous(memory_format=torch.channels_last)
