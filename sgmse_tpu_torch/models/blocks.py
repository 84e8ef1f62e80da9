"""NN layer library for the NCSN++ backbone. Counterpart of the flagship's
layers in ``sgmse_tpu/models/blocks.py``.

Tensors are NCHW-indexed and lie in ``torch.channels_last`` memory, which is
physically the JAX package's NHWC. Submodules carry the names of the Flax
parameter tree (``Conv_0``, ``GroupNorm_1``, ``NIN_3``, ...), so that
``convert.params_from_jax`` is a mechanical walk.

Precision follows the JAX package: parameters are float32, ``dtype`` (None for
float32 or ``torch.bfloat16``) is the compute dtype each layer casts its input
and parameters to; GroupNorm statistics and the attention softmax stay float32.

Initializers follow the DDPM convention: variance scaling (fan_avg, uniform)
with scale 1e-10 when init_scale == 0. ``init_parameters(generator)`` on each
leaf module draws its parameters from an explicit generator.

Where no gradient is recorded (:func:`folding`: ``ScoreModel.enhance``,
``enhance_long`` and its CUDA graphs, serving, evaluation under ``no_grad``),
the blocks fold their convolutions' biases into the hand-written kernel that
reads the output next, instead of a broadcast add of their own: each
res-block's Conv_0 bias joins the (B, C) pre-bias that K2 adds before
GroupNorm_1, and Conv_1's, the shortcut's (Conv_2, NIN_0), NIN_3's and a sum
Combine's go into K8, the residual merge (:func:`residual`,
``ops/residual_merge.py``). Every bias is still added, in float32. With
autograd on, each convolution adds its own bias, as before. ``BIAS_ADDS``
counts, where no gradient is recorded, the biased convolutions and
projections by where their bias went (with autograd on it counts nothing).
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import group_norm as gn
from ..ops import residual_merge as rm
from ..ops import upfirdn2d as ufd
from ..parallel.rows import draw

CL = torch.channels_last

# Calls of biased convolutions (Conv2d) and projections (NIN) where no gradient is
# recorded, all threads: those whose bias was "folded" into the next kernel (K2's
# pre-bias, K8) and those that added it in a "separate" op.
BIAS_ADDS = {"folded": 0, "separate": 0}
_bias_lock = threading.Lock()


def _tally(folded: bool) -> None:
    with _bias_lock:
        BIAS_ADDS["folded" if folded else "separate"] += 1


def folding() -> bool:
    """Whether the blocks fold their convolutions' biases into the next
    kernel: where no gradient is recorded."""
    return not torch.is_grad_enabled()


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry."""
    if name == "elu":
        return F.elu
    elif name == "relu":
        return F.relu
    elif name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    elif name == "swish":
        return F.silu
    raise NotImplementedError(f"activation function {name} does not exist!")


def _uniform_(p: torch.Tensor, limit: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * limit)


def ddpm_init_(p: torch.Tensor, scale: float, fan_in: int, fan_out: int,
               generator: torch.Generator) -> None:
    """DDPM default init: fan_avg uniform variance scaling; scale 0 means 1e-10."""
    scale = 1e-10 if scale == 0 else scale
    _uniform_(p, math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0)), generator)


def _cast(t: Optional[torch.Tensor], dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Module):
    """Flax ``nn.Conv`` counterpart: OIHW float32 weight, computes in ``dtype``.

    ``init`` is "ddpm" (DDPM rule with ``init_scale``, zero bias) or "torch"
    (torch's default: U(+-1/sqrt(fan_in)) for weight and bias).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True, dtype=None,
                 init: str = "ddpm", init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.init, self.init_scale = dtype, init, init_scale

    def init_parameters(self, generator: torch.Generator) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        if self.init == "torch":
            bound = 1.0 / math.sqrt(in_ch * kh * kw)
            _uniform_(self.weight, bound, generator)
            if self.bias is not None:
                _uniform_(self.bias, bound, generator)
            return
        ddpm_init_(self.weight, self.init_scale, in_ch * kh * kw, out_ch * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, with_bias: bool = True):
        """The convolution in ``dtype``; without ``with_bias`` its bias is left
        to the caller, which folds it into the kernel that reads the output."""
        dt = self.dtype or torch.float32
        if self.bias is not None and folding():
            _tally(not with_bias)
        bias = _cast(self.bias, dt) if with_bias else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation)


class Dense(nn.Module):
    """Flax ``nn.Dense`` counterpart with DDPM init: (out, in) float32 weight."""

    def __init__(self, in_features: int, out_features: int, init_scale: float = 1.0, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.init_scale, self.dtype = init_scale, dtype

    def init_parameters(self, generator: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        ddpm_init_(self.weight, self.init_scale, in_f, out_f, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype or torch.float32
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv3x3(nn.Module):
    """3x3 conv with DDPM init."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0, padding: int = 1, dtype=None):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch, 3, stride, padding, dilation, bias, dtype,
                             init_scale=init_scale)

    def forward(self, x, with_bias: bool = True):
        return self.Conv_0(x, with_bias)


class Conv1x1(nn.Module):
    """1x1 conv with DDPM init."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bias: bool = True,
                 init_scale: float = 1.0, dtype=None):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch, 1, stride, 0, 1, bias, dtype, init_scale=init_scale)

    def forward(self, x, with_bias: bool = True):
        return self.Conv_0(x, with_bias)


class NIN(nn.Module):
    """Network-in-network 1x1 projection via channel contraction: W is (in, out)."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1, dtype=None):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_scale, self.dtype = init_scale, dtype

    def init_parameters(self, generator: torch.Generator) -> None:
        in_dim, units = self.W.shape
        ddpm_init_(self.W, self.init_scale, in_dim, units, generator)
        nn.init.zeros_(self.b)

    def forward(self, x, with_bias: bool = True):
        """The projection in ``dtype``; without ``with_bias`` as Conv2d's."""
        dt = self.dtype or torch.float32
        if folding():
            _tally(not with_bias)
        # channels_last (B, C, H, W) is a contiguous (B, H, W, C) after the permute.
        h = torch.matmul(x.to(dt).permute(0, 2, 3, 1), self.W.to(dt))
        if with_bias:
            h = h + self.b.to(dt)
        return h.permute(0, 3, 1, 2)


class DDPMDense(nn.Module):
    """Dense layer with DDPM init and zero bias (used for temb projections)."""

    def __init__(self, in_features: int, features: int, init_scale: float = 1.0, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, init_scale, dtype)

    def forward(self, x):
        return self.Dense_0(x)


class GroupNorm(nn.Module):
    """GroupNorm(min(ch//4, 32), eps=1e-6), optionally followed by SiLU in the same
    kernel, or by another activation ``act`` after it. Output in the compute
    ``dtype`` (float32 when None)."""

    def __init__(self, ch: int, silu: bool = True, dtype=None, eps: float = 1e-6,
                 act: Optional[Callable] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.num_groups = gn.num_groups_for(ch)
        self.silu, self.dtype, self.eps, self.act = silu, dtype, eps, act

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, pre_bias=None):
        """GroupNorm of x + pre_bias[:, :, None, None] (pre_bias: (B, C) in the
        compute dtype, added in float32 inside the kernel), then SiLU if ``silu``."""
        x = x.to(self.dtype or torch.float32).contiguous(memory_format=CL)
        y = gn.group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps, self.silu,
                              pre_bias)
        return y if self.act is None else self.act(y)


def norm_act(ch: int, nonlinearity: str = "swish", dtype=None) -> GroupNorm:
    """GroupNorm then the activation ``nonlinearity``: swish fused into the
    kernel (K2 with SiLU), any other applied after K2 without SiLU."""
    if nonlinearity == "swish":
        return GroupNorm(ch, silu=True, dtype=dtype)
    return GroupNorm(ch, silu=False, dtype=dtype, act=get_act(nonlinearity))


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the (log-)time. W is fixed: it never trains."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(embedding_size), requires_grad=False)
        self.scale = scale

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.W.copy_(torch.randn(self.W.shape, generator=generator) * self.scale)

    def forward(self, x):
        x_proj = x.float()[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal positional embedding."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def residual(x, h, skip_rescale: bool, fold: bool, bias=None, skip_bias=None):
    """The merge of a skip x with a branch h: (x + h) / sqrt(2) with
    ``skip_rescale``, else x + h. With ``fold``, K8 adds the float32 (C,)
    ``bias`` and ``skip_bias`` that h's and x's convolutions left out in the
    same pass and writes the result over h; without it they are not read (the
    convolutions added them)."""
    if fold:
        return rm.residual_merge(h.contiguous(memory_format=CL), x.contiguous(memory_format=CL),
                                 1.0 / math.sqrt(2.0) if skip_rescale else 1.0, bias, skip_bias)
    return (x + h) / math.sqrt(2.0) if skip_rescale else x + h


def _pre_bias(temb_bias, conv_bias, h):
    """GroupNorm_1's (B, C) pre-bias in h's dtype with Conv_0's float32 bias
    folded in: added to the time-embedding bias in float32 and rounded once (it
    alone where there is none)."""
    if temb_bias is None:
        return conv_bias.to(h.dtype).expand(h.shape[0], -1).contiguous()
    return temb_bias.add_(conv_bias)


class Combine(nn.Module):
    """Combine a pyramid skip with the trunk: 1x1 conv then sum/concat."""

    def __init__(self, in_ch: int, dim2: int, method: str = "cat", dtype=None):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.Conv_0 = Conv1x1(in_ch, dim2, dtype=dtype)
        self.method = method

    def forward(self, x, y):
        if self.method == "cat":
            return torch.cat([self.Conv_0(x), y], dim=1)
        fold = folding()
        return residual(y, self.Conv_0(x, with_bias=not fold), False, fold,
                        self.Conv_0.Conv_0.bias)


class AttnBlockpp(nn.Module):
    """Single-head self-attention over the H*W tokens, scale C^-0.5, softmax in
    float32. The QK^T and PV products are plain ``torch.matmul``."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 dtype=None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels, silu=False, dtype=dtype)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale, dtype=dtype)
        self.skip_rescale = skip_rescale

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.GroupNorm_0(x)

        def tokens(t):  # (B, C, H, W) channels_last -> (B, H*W, C)
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

        q, k, v = tokens(self.NIN_0(hn)), tokens(self.NIN_1(hn)), tokens(self.NIN_2(hn))
        logits = torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5)
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        fold = folding()
        return residual(x, self.NIN_3(out, with_bias=not fold), self.skip_rescale, fold,
                        self.NIN_3.b)


class FIRConv2d(nn.Module):
    """Conv2d fused with FIR up- or downsampling (JAX ``FIRConv2d``): K6, one
    launch of ``csrc/fir_conv.cu`` on the card with the bias added inside it
    (``ufd.upsample_conv_2d`` / ``ufd.conv_downsample_2d``; in bfloat16 the
    kernel rounds once where JAX rounds the conv and the bias add apart, at
    most one bf16 step). ``weight`` is OIHW, drawn with the DDPM rule;
    ``bias`` is zero-initialised."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, up: bool = False,
                 down: bool = False, resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 use_bias: bool = True, dtype=None):
        super().__init__()
        assert not (up and down)
        assert kernel >= 1 and kernel % 2 == 1
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.up, self.down, self.dtype = up, down, dtype
        self.resample_kernel = tuple(resample_kernel)

    def init_parameters(self, generator: torch.Generator) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        ddpm_init_(self.weight, 1.0, in_ch * kh * kw, out_ch * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype or torch.float32
        x, w = x.to(dt), self.weight.to(dt)
        if self.up:
            return ufd.upsample_conv_2d(x, w, k=self.resample_kernel, bias=self.bias)
        if self.down:
            return ufd.conv_downsample_2d(x, w, k=self.resample_kernel, bias=self.bias)
        x = F.conv2d(x, w, padding=w.shape[-1] // 2)
        if self.bias is not None:
            x = x + self.bias.to(dt)[:, None, None]
        return x


class Upsample(nn.Module):
    """2x upsampling, FIR or nearest, with an optional conv (JAX ``Upsample``):
    FIR with conv is K6 (``Conv2d_0``), FIR alone K1, nearest a repeat then
    the 3x3 ``Conv_0``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, 3, up=True, resample_kernel=fir_kernel,
                                      dtype=dtype)
        elif with_conv:
            self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)

    def forward(self, x):
        x = x.contiguous(memory_format=CL)
        if not self.fir:
            h = ufd.naive_upsample_2d(x, factor=2)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return ufd.upsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


class Downsample(nn.Module):
    """2x downsampling, FIR or pooling, with an optional conv (JAX
    ``Downsample``): FIR with conv is K6 (``Conv2d_0``), FIR alone K1; without
    FIR a (0, 1) pad and the stride-2 3x3 ``Conv_0``, or a 2x2 mean."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, 3, down=True, resample_kernel=fir_kernel,
                                      dtype=dtype)
        elif with_conv:
            self.Conv_0 = Conv3x3(in_ch, out_ch, stride=2, padding=0, dtype=dtype)

    def forward(self, x):
        x = x.contiguous(memory_format=CL)
        if not self.fir:
            if self.with_conv:
                return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
            return ufd.naive_downsample_2d(x, factor=2)
        if not self.with_conv:
            return ufd.downsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


def _dropout(h, rate: float, training: bool, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout`` in ``train()`` mode: keep with probability 1 - rate,
    scale by its inverse; the mask from ``generator`` (under
    ``parallel.global_rows``, this process's rows of the global batch's mask)."""
    if not training or rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = draw(lambda shape: torch.empty(shape, device=h.device).bernoulli_(
        keep, generator=generator), h.shape)
    return torch.where(mask.bool(), h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


class ResnetBlockDDPMpp(nn.Module):
    """DDPM-style residual block (JAX ``ResnetBlockDDPMpp``): norm, act, 3x3,
    the time-embedding bias (fused into GroupNorm_1's kernel, as in the BigGAN
    block), norm, act, dropout, 3x3; where the channel count changes, the
    shortcut is the 3x3 ``Conv_2`` (``conv_shortcut``) or the 1x1 ``NIN_0``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, nonlinearity: str = "swish",
                 conv_shortcut: bool = False, dropout: float = 0.1, skip_rescale: bool = False,
                 init_scale: float = 0.0, temb_dim: Optional[int] = None, dtype=None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.act = get_act(nonlinearity)
        self.dropout, self.skip_rescale = dropout, skip_rescale
        self.GroupNorm_0 = norm_act(in_ch, nonlinearity, dtype)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = DDPMDense(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = norm_act(out_ch, nonlinearity, dtype)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = Conv3x3(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)

    def forward(self, x, temb=None, generator: Optional[torch.Generator] = None):
        fold = folding()
        h = self.Conv_0(self.GroupNorm_0(x), with_bias=not fold)
        bias = None if temb is None else self.Dense_0(self.act(temb))
        if fold:
            bias = _pre_bias(bias, self.Conv_0.Conv_0.bias, h)
        h = _dropout(self.GroupNorm_1(h, bias), self.dropout, self.training, generator)
        h = self.Conv_1(h, with_bias=not fold)
        skip_bias = None
        if hasattr(self, "Conv_2"):
            x, skip_bias = self.Conv_2(x, with_bias=not fold), self.Conv_2.Conv_0.bias
        elif hasattr(self, "NIN_0"):
            x, skip_bias = self.NIN_0(x, with_bias=not fold), self.NIN_0.b
        return residual(x, h, self.skip_rescale, fold, self.Conv_1.Conv_0.bias, skip_bias)


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN-style residual block with optional FIR up/down.

    The block's activation is ``nonlinearity``: swish is fused into the
    GroupNorm kernel, any other runs after it. The time-embedding bias before
    GroupNorm_1, which the JAX block adds to h in the compute dtype, is fused
    into the kernel too: the port adds it in float32, so in bfloat16 it skips
    one rounding of the sum; where no gradient is recorded, Conv_0's bias joins
    it, and Conv_1's and Conv_2's go into K8 with the merge (module docstring).
    ``dropout`` applies after GroupNorm_1 in ``train()`` mode only (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale by its inverse),
    drawing its mask from the ``generator`` given to forward.
    """

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, up: bool = False,
                 down: bool = False, dropout: float = 0.0, fir: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, temb_dim: Optional[int] = None, dtype=None,
                 nonlinearity: str = "swish"):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.up, self.down, self.fir = up, down, fir
        self.dropout = dropout
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.act = get_act(nonlinearity)
        self.GroupNorm_0 = norm_act(in_ch, nonlinearity, dtype)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = DDPMDense(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = norm_act(out_ch, nonlinearity, dtype)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch or up or down:
            self.Conv_2 = Conv1x1(in_ch, out_ch, dtype=dtype)

    def _resample(self, h, x):
        """Resample h and the skip x alike; with FIR, in one kernel launch."""
        if self.fir:
            pair = ufd.upsample_2d_pair if self.up else ufd.downsample_2d_pair
            return pair(h, x, self.fir_kernel, factor=2)
        naive = ufd.naive_upsample_2d if self.up else ufd.naive_downsample_2d
        return naive(h, factor=2), naive(x, factor=2)

    def forward(self, x, temb=None, generator: Optional[torch.Generator] = None):
        fold = folding()
        h = self.GroupNorm_0(x)
        if self.up or self.down:
            h, x = self._resample(h.contiguous(memory_format=CL),
                                  x.contiguous(memory_format=CL))
        h = self.Conv_0(h, with_bias=not fold)
        bias = None if temb is None else self.Dense_0(self.act(temb))
        if fold:
            bias = _pre_bias(bias, self.Conv_0.Conv_0.bias, h)
        h = self.GroupNorm_1(h, bias)
        h = _dropout(h, self.dropout, self.training, generator)
        h = self.Conv_1(h, with_bias=not fold)
        skip_bias = None
        if hasattr(self, "Conv_2"):
            x, skip_bias = self.Conv_2(x, with_bias=not fold), self.Conv_2.Conv_0.bias
        return residual(x, h, self.skip_rescale, fold, self.Conv_1.Conv_0.bias, skip_bias)
