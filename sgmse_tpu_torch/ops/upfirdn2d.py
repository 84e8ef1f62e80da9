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

FIR + convolution + bias (K6 of the port: :func:`upsample_conv_2d`,
:func:`conv_downsample_2d`, the JAX package's ``sgmse_tpu/ops/upfirdn2d.py:175-224``
followed by ``FIRConv2d``'s bias add) dispatches the same way through
:func:`fir_conv`: on a CUDA tensor one launch of the hand-written kernel
``csrc/fir_conv.cu`` (:func:`fir_conv_cuda`, planned on the host by
:func:`fir_conv_plan`), which keeps the intermediate on chip and raises on
anything it does not take; on a CPU tensor its plain version
:func:`fir_conv_plain`, the composition the JAX package writes (the
convolution, then the FIR as one :func:`upfirdn2d_plain` at up = down = 1,
then the bias). Its gradient (:class:`_FirConv`) is the composition's: the
FIR's adjoint (one K1 adjoint launch on the card), cuDNN's input and weight
gradients, and the bias's sum; the down direction's weight gradient needs
FIR(x), which the backward recomputes with one K1 launch rather than keep.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple, Union

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


# K6 (FIR + 3x3 convolution + bias) on the card: the kernel's tiles and shared memory.
FIR_CONV_SMEM_LIMIT = 232_448  # bytes a block may opt into on an H100
FIR_CONV_SMS = 132             # an H100 SXM's SMs
_ROW_WORDS, _FIR_WORDS = 12, 10  # csrc/fir_conv.cu's kRowWords, kFirWords
_DOWN_TILE, _DOWN_NB, _NARROW_NB = (8, 16), 128, 128
_UP_NBS, _UP_TILES, _UP_MAX_MTILES = (64, 32, 16), ((16, 16), (8, 16), (8, 8)), 8
FIR_CONV_VARIANTS = ("down", "down_narrow", "up")


class FirConvPlan(NamedTuple):
    """The kernel's launch: ``variant`` (an index of FIR_CONV_VARIANTS), the
    output tile (th, tw) and the tiles of an image, ``nb`` output channels a
    block in ``nblocks`` channel blocks, the grid, the output size and the
    dynamic shared memory of a block. Down: ``ksplit`` blocks (a cluster) a
    (tile, channel block, batch row), each taking a share of C_in. Up:
    ``grid[0]`` persistent blocks a channel block, block i taking the (batch
    row, tile) items i, i + grid[0], ..."""
    variant: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    nb: int
    nblocks: int
    ksplit: int
    grid: Tuple[int, int, int]
    oh: int
    ow: int
    smem: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def fir_conv_smem(variant: str, th: int, tw: int, cin: int, element_size: int,
                  nb: int = 64) -> int:
    """Dynamic shared memory of one block, in bytes, as ``csrc/fir_conv.cu`` lays it out."""
    if variant == "up":  # all the weights of nb channels, the input tile, the conv tile
        xps = cin * element_size // 4 + 4
        yps = nb * element_size // 4 + 4
        return (9 * cin * nb * element_size
                + 4 * ((th // 2 + 2) * (tw // 2 + 2) * xps + (th + 3) * (tw + 3) * yps))
    in_px = (2 * th + 4) * (2 * tw + 4)
    f_px = (2 * th + 1) * (2 * tw + 1)
    if variant == "down":
        return 4 * (2 * in_px * _ROW_WORDS + 2 * _round4(f_px * _FIR_WORDS)
                    + 2 * 9 * _DOWN_NB * _ROW_WORDS)
    return 4 * (in_px * cin + _round4(f_px * (cin + 1)) + cin * 9 * _NARROW_NB)


@lru_cache(maxsize=None)
def fir_conv_plan(up: bool, b: int, cin: int, cout: int, h: int, w: int, element_size: int,
                  smem_limit: int = FIR_CONV_SMEM_LIMIT,
                  sms: int = FIR_CONV_SMS) -> FirConvPlan:
    """K6's launch for x of (b, cin, h, w) and 3x3 weights to ``cout`` channels,
    factor 2. Down: 8x16 output tiles x 128 channels (on the narrow path, cin <
    16, too), a block each; a cluster of ksplit blocks (1, 2, 4 or 8, the
    least waves on ``sms`` SMs times the slices of C_in a block plus one)
    splits each tile's C_in. Up: the most output channels of _UP_NBS and then
    the largest tile of _UP_TILES whose block (those channels' weights, the
    input tile, the conv tile) fits ``smem_limit`` and whose conv-output
    classes fit the block's 8 row tiles of 16; about one block an SM on a card
    of ``sms``. Raises on what the kernel does not take."""
    if cout % 8 or cout < 8:
        raise ValueError(f"fir_conv: C_out={cout} must be a positive multiple of 8")
    if up:
        if cin % 16:
            raise ValueError(f"fir_conv: up takes C_in a multiple of 16, got {cin}")
        oh, ow = 2 * h, 2 * w
        fits = [(nb, th, tw) for nb in _UP_NBS for th, tw in _UP_TILES
                if fir_conv_smem("up", th, tw, cin, element_size, nb) <= smem_limit
                and (th // 2 + 2) * (tw // 2 + 2) <= 16 * _UP_MAX_MTILES]
        if not fits:
            raise ValueError(f"fir_conv: C_in={cin} does not fit a block's shared memory")
        nb, th, tw = fits[0]
        variant = FIR_CONV_VARIANTS.index("up")
        smem = fir_conv_smem("up", th, tw, cin, element_size, nb)
    else:
        narrow = cin < 16
        if (narrow and cin % 4) or (not narrow and cin % 16):
            raise ValueError(f"fir_conv: down takes C_in a multiple of 16, or 4, 8 or 12; "
                             f"got {cin}")
        oh, ow = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        (th, tw), nb = _DOWN_TILE, _NARROW_NB if narrow else _DOWN_NB
        variant = FIR_CONV_VARIANTS.index("down_narrow" if narrow else "down")
        smem = fir_conv_smem(FIR_CONV_VARIANTS[variant], th, tw, cin, element_size)
        if smem > smem_limit:
            raise ValueError(f"fir_conv: {smem} bytes of shared memory, above {smem_limit}")
    if oh < 1 or ow < 1:
        raise ValueError(f"fir_conv: empty output {oh}x{ow} from {h}x{w}")
    tiles_h, tiles_w, nblocks = -(-oh // th), -(-ow // tw), -(-cout // nb)
    ksplit = 1
    if up:
        grid = (min(b * tiles_h * tiles_w, max(1, sms // nblocks)), nblocks, 1)
    else:
        blocks, slices = tiles_h * tiles_w * nblocks * b, cin * element_size // 32
        if variant == 0:  # waves x (slices a block + one for its prologue and epilogue)
            ksplit = min((k for k in (1, 2, 4, 8) if k <= slices),
                         key=lambda k: (-(-blocks * k // sms) * (-(-slices // k) + 1), k))
        grid = (tiles_h * tiles_w, nblocks * ksplit, b)
    if max(grid[1:]) > 65535:
        raise ValueError(f"fir_conv: grid {grid} too large")
    return FirConvPlan(variant=variant, th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, nb=nb,
                       nblocks=nblocks, ksplit=ksplit, grid=grid, oh=oh, ow=ow, smem=smem)


def fir_taps(k: Kernel, up: bool) -> np.ndarray:
    """The kernel's four 1-D taps for a 1-D FIR ``k`` of 4: normalised to sum 1,
    flipped (the FIR is a correlation with the flipped kernel), times the
    factor 2 for up (setup_kernel's gain * factor**2, per axis)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim != 1 or k.shape[0] != 4:
        raise ValueError(f"fir_conv_cuda takes a 1-D FIR of 4 taps, got shape {k.shape}")
    k = k[::-1] / np.sum(k)
    return np.ascontiguousarray(k * (2.0 if up else 1.0), dtype=np.float32)


def _fir_args(w: torch.Tensor, k: Kernel, factor: int, gain: float, up: bool):
    """The composition's FIR (2-D taps) and its pad."""
    assert isinstance(factor, int) and factor >= 1
    conv_h, conv_w = w.shape[2:]
    assert conv_h == conv_w
    if up:
        k = setup_kernel([1.0] * factor if k is None else k) * (gain * (factor**2))
        p = (k.shape[0] - factor) - (conv_w - 1)
        return k, ((p + 1) // 2 + factor - 1, p // 2 + 1)
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (conv_w - 1)
    return k, ((p + 1) // 2, p // 2)


def fir_conv_composition(x: torch.Tensor, w: torch.Tensor, k: Kernel, factor: int, gain: float,
                         bias: Optional[torch.Tensor], up: bool, fir=None) -> torch.Tensor:
    """K6 as the JAX package composes it, with ``fir`` (default
    :func:`upfirdn2d_plain`) as its FIR pass. Up: the JAX package correlates
    ``w`` with the zero-stuffed input under full padding; ``F.conv_transpose2d``
    at stride ``factor`` computes that sum with the flipped kernel, so it takes
    ``w`` flipped and permuted to (C_in, C_out, kh, kw); then the FIR. Down:
    the FIR, then the strided convolution. Then the bias, in x's dtype."""
    fir = fir or upfirdn2d_plain
    k2, pad = _fir_args(w, k, factor, gain, up)
    if up:
        wt = torch.flip(w, [2, 3]).transpose(0, 1)
        y = F.conv_transpose2d(x, wt.to(x.dtype), stride=factor)
        y = fir(y.contiguous(memory_format=torch.channels_last), k2, pad=pad)
    else:
        y = fir(x.contiguous(memory_format=torch.channels_last), k2, pad=pad)
        y = F.conv2d(y, w.to(y.dtype), stride=factor)
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    return y


def fir_conv_plain(x: torch.Tensor, w: torch.Tensor, k: Kernel, factor: int = 2,
                   gain: float = 1.0, bias: Optional[torch.Tensor] = None,
                   up: bool = False) -> torch.Tensor:
    """The plain version of K6: :func:`fir_conv_composition` with the plain FIR."""
    return fir_conv_composition(x, w, k, factor, gain, bias, up)


def fir_conv_cuda(x: torch.Tensor, w: torch.Tensor, k: Kernel, factor: int = 2,
                  gain: float = 1.0, bias: Optional[torch.Tensor] = None,
                  up: bool = False) -> torch.Tensor:
    """Launch the hand-written kernel once: FIR + 3x3 convolution + bias,
    factor 2, gain 1, ``k`` a 1-D FIR of 4 taps. Takes x (B, C_in, H, W) on the
    card in channels_last memory, float32 or bfloat16; w (C_out, C_in, 3, 3)
    of x's dtype (made channels_last, as the network holds it); bias None or
    (C_out,) (added in float32). float32 products run in TF32 when
    ``torch.backends.cudnn.allow_tf32`` is set, else in three TF32 products
    each. Raises on anything else. Counts its launches in ``launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"fir_conv_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"fir_conv_cuda takes float32 or bfloat16 x and w of one dtype, got "
                         f"{x.dtype} and {w.dtype}")
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fir_conv_cuda takes a 4-D x in channels_last memory")
    if w.ndim != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3) or w.device != x.device:
        raise ValueError(f"fir_conv_cuda takes 3x3 weights of ({x.shape[1]}) input channels on "
                         f"{x.device}, got {tuple(w.shape)} on {w.device}")
    if factor != 2 or gain != 1.0:
        raise ValueError(f"fir_conv_cuda takes factor 2 and gain 1, got {factor} and {gain}")
    taps = fir_taps(k, up)
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    w = w.contiguous(memory_format=torch.channels_last)
    if bias is not None:
        if tuple(bias.shape) != (cout,) or bias.device != x.device:
            raise ValueError(f"fir_conv_cuda takes a bias of ({cout},) on {x.device}")
        bias = bias.float().contiguous()
    props = torch.cuda.get_device_properties(x.device)
    plan = fir_conv_plan(up, b, cin, cout, h, wd, x.element_size(),
                         getattr(props, "shared_memory_per_block_optin", FIR_CONV_SMEM_LIMIT),
                         props.multi_processor_count)
    if max(x.numel(), w.numel(), b * cout * plan.oh * plan.ow) >= 2**31:
        raise ValueError("fir_conv_cuda: tensor too large for 32-bit indexing")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fir_conv_cuda: {name} is not 16-byte aligned")
    y = torch.empty((b, cout, plan.oh, plan.ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    bf16 = x.dtype == torch.bfloat16
    mode = 0 if bf16 else (1 if torch.backends.cudnn.allow_tf32 else 3)
    err = kernels.lib().sgmse_fir_conv(
        x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(), y.data_ptr(),
        plan.variant, b, h, wd, cin, cout, plan.oh, plan.ow, plan.th, plan.tw, plan.tiles_h,
        plan.tiles_w, *plan.grid, plan.nb, plan.ksplit, plan.smem, taps.ctypes.data,
        int(bf16), mode,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "fir_conv kernel")
    kernels.count_launch(fir_conv_cuda)
    return y


fir_conv_cuda.launches = 0


def fir_conv(x: torch.Tensor, w: torch.Tensor, k: Kernel, factor: int, gain: float,
             bias: Optional[torch.Tensor], up: bool) -> torch.Tensor:
    """K6 on the device of x: the kernel on CUDA, the plain version on the CPU.
    No autograd."""
    if x.device.type == "cuda":
        return fir_conv_cuda(x, w, k, factor, gain, bias, up)
    if x.device.type == "cpu":
        return fir_conv_plain(x, w, k, factor, gain, bias, up)
    raise ValueError(f"fir_conv: unsupported device {x.device}")


def _fir_adjoint(dy: torch.Tensor, in_hw, kernel, pad) -> torch.Tensor:
    """The gradient of the input of ``upfirdn2d(x, kernel, pad=pad)`` (x of
    ``in_hw``) from its output's gradient: one K1 adjoint launch on the card."""
    kernel, kw, crop = adjoint_args(in_hw, tuple(dy.shape[2:]), kernel, 1, 1, pad)
    dx = upfirdn2d(dy.contiguous(memory_format=torch.channels_last), kernel, adjoint=True, **kw)
    if crop is not None:
        dx = dx[:, :, :crop[0], :crop[1]]
    return dx


class _FirConv(torch.autograd.Function):
    """K6 with the composition's gradient as its backward."""

    @staticmethod
    def forward(ctx, x, w, bias, k, factor, gain, up):
        ctx.save_for_backward(x, w)
        ctx.k, ctx.factor, ctx.gain, ctx.up = k, factor, gain, up
        ctx.bias_dtype = None if bias is None else bias.dtype
        return fir_conv(x, w, k, factor, gain, bias, up)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        k2, pad = _fir_args(w, ctx.k, ctx.factor, ctx.gain, ctx.up)
        dy = dy.contiguous(memory_format=torch.channels_last)
        stride = [ctx.factor] * 2
        dx = dw = db = None
        if need_b:
            db = dy.sum((0, 2, 3), dtype=torch.float32).to(ctx.bias_dtype)
        if ctx.up:  # y = FIR(conv_transpose(x, wt)): the FIR's adjoint, then cuDNN's
            conv_hw = tuple((n - 1) * ctx.factor + w.shape[2] for n in x.shape[2:])
            dconv = _fir_adjoint(dy, conv_hw, k2, pad)
            wt = torch.flip(w, [2, 3]).transpose(0, 1).to(x.dtype)
            dx, dwt, _ = torch.ops.aten.convolution_backward(
                dconv, x, wt, None, stride, [0, 0], [1, 1], True, [0, 0], 1,
                [need_x, need_w, False])
            if need_w:
                dw = torch.flip(dwt.transpose(0, 1), [2, 3]).to(w.dtype)
        else:  # y = conv(FIR(x), w): cuDNN's, on FIR(x) recomputed, then the FIR's adjoint
            xf = upfirdn2d(x.contiguous(memory_format=torch.channels_last), k2, pad=pad) \
                if need_w else x.new_empty((*x.shape[:2], *(n + sum(pad) - k2.shape[0] + 1
                                                            for n in x.shape[2:])))
            dxf, dw, _ = torch.ops.aten.convolution_backward(
                dy, xf, w.to(x.dtype), None, stride, [0, 0], [1, 1], False, [0, 0], 1,
                [need_x, need_w, False])
            if need_w:
                dw = dw.to(w.dtype)
            if need_x:
                dx = _fir_adjoint(dxf, tuple(x.shape[2:]), k2, pad)
        return dx, dw, db, None, None, None, None


def _fir_conv(x, w, k, factor, gain, bias, up):
    x = x.contiguous(memory_format=torch.channels_last)
    if _needs_grad(x, w, *([] if bias is None else [bias])):
        return _FirConv.apply(x, w, bias, k, factor, gain, up)
    return fir_conv(x, w, k, factor, gain, bias, up)


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: Kernel = None, factor: int = 2,
                     gain: float = 1.0, bias: Optional[torch.Tensor] = None):
    """Zero-stuff upsample -> conv(w) -> FIR (JAX ``upsample_conv_2d``), then
    ``bias`` (FIRConv2d's); w is OIHW (C_out, C_in, kh, kw), square. K6: one
    kernel launch on the card (:func:`fir_conv`)."""
    return _fir_conv(x, w, k, factor, gain, bias, up=True)


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: Kernel = None, factor: int = 2,
                       gain: float = 1.0, bias: Optional[torch.Tensor] = None):
    """FIR -> conv(w) with stride ``factor`` (JAX ``conv_downsample_2d``), then
    ``bias``; w is OIHW, square. K6: one kernel launch on the card."""
    return _fir_conv(x, w, k, factor, gain, bias, up=False)


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
