"""DCUNet: the complex-valued U-Net score backbone (Interspeech 2022 model).
Counterpart of ``sgmse_tpu/models/dcunet.py``.

Complex activations travel as one real tensor with the batch stacked,
``[re; im]`` of shape (2B, C, H, W), in ``torch.channels_last`` memory: the
JAX package's design, whose complex convolution is two real convolutions over
that stacked tensor, recombined by the complex-multiplication rule
F(a + ib) = f1(a) - f2(b) + i(f1(b) + f2(a)). Here the two real
convolutions (``re`` and ``im``, each a cuDNN convolution in JAX's parameter
names) run as one cuDNN call on their concatenated weights, and every layer
after them (the time-embedding add, the norm, the activation, the skip
concatenation) acts on the stacked tensor. No complex dtype reaches a
convolution. The transposed convolutions are ``F.conv_transpose2d``, whose
weight is the JAX kernel permuted to (C_in, C_out, kh, kw), not flipped:
JAX correlates the flipped kernel with the zero-stuffed input, which is what
a transposed convolution computes. The output size the JAX package fixes
through ``output_shape`` becomes ``output_padding``, with the same range
check.

Norms, as in the JAX package:

- ``bN``: BatchNorm on the real and on the imaginary part (flax
  ``nn.BatchNorm``, momentum 0.9, eps 1e-5). In ``train()`` mode it
  normalises with the batch's mean and biased variance (flax's E[x^2] -
  E[x]^2, from sums accumulated in float64: :class:`BatchStatistics`)
  and updates its ``mean``/``var`` buffers once per forward, ``ra <- 0.9 ra + 0.1 batch``, storing the biased
  batch variance (``nn.BatchNorm2d`` would store the unbiased one); in
  ``eval()`` mode it uses the running statistics.
- ``CbN``: complex whitening over the 2x2 covariance of (re, im), with batch
  statistics in both modes (the reference builds it with
  ``track_running_stats=False``): a row's output depends on the other rows
  of its batch, padded rows and frames included.

Under data-parallel training (a process group of more than one rank,
``parallel``) the ``train()``-mode statistics of both norms are the global
batch's, as the JAX package's are when its batch is sharded over a mesh:
the per-channel statistics are all-reduced with autograd
(``torch.distributed.nn.functional.all_reduce``), so the gradient sees the
global statistics too, and every rank's running statistics move alike.
``CbN`` takes batch statistics in ``eval()`` mode too, and reduces them over
the group that ``parallel.global_rows`` names for the batch: the
``--data_parallel`` workers' (``parallel.pool``). Validation in training
runs each rank's own batches outside it, and reduces nothing.

Time embedding: Gaussian Fourier (``gfp``, W fixed: never trained) or
DiffWave-style (``ds``), real or complex, then ``dcunet_temb_layers_global``
complex linears with the activation, and per block a ``TimeEmbedLayer``.
Precision: parameters, norms and statistics stay float32; ``precision``
bfloat16 casts the convolutions' inputs and weights, and their outputs come
back as float32, as in the JAX package.

Call contract: ``forward(x_t, y, t) -> complex64 (B, 1, F, T)`` with
complex (B, 1, F, T) inputs stacked as the two input channels; the legacy
``score = -dnn(...)`` sign lives in the ScoreModel. F - 1 must divide by the
encoders' frequency-stride product; T - 1 is padded or trimmed to the time-
stride product (``dcunet_fix_length``) and the output is cut or padded back
to T frames.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce

from .. import parallel
from ..parallel import rows
from .blocks import CL, _uniform_
from .ncsnpp import compute_dtype_for
from .registry import BackboneRegistry


def get_activation(name: str):
    if name == "silu":
        return F.silu
    elif name == "relu":
        return F.relu
    elif name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    raise NotImplementedError(f"Unknown activation: {name}")


# ---------------------------------------------------------------------------------------
# Architecture tables (the JAX package's, which follow the reference)
# ---------------------------------------------------------------------------------------

def _auto_pad(kernel_size, padding):
    return tuple(n // 2 for n in kernel_size) if padding == "auto" else tuple(padding)


def _unet(encoder_args):
    """(encoder args, decoder args) of a symmetric U-Net with skip connections."""
    encoders = tuple((ic, oc, tuple(k), tuple(s), _auto_pad(k, p), tuple(d))
                     for ic, oc, k, s, p, d in encoder_args)
    decoders = []
    for enc_in, enc_out, k, s, p, d in reversed(encoders):
        skip_in = enc_out if decoders else 0
        decoders.append((enc_out + skip_in, enc_in, k, s, p, d))
    return encoders, tuple(decoders)


DCUNET_ARCHITECTURES = {
    "DCUNet-10": _unet((
        (1, 32, (7, 5), (2, 2), "auto", (1, 1)),
        (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
    )),
    "DCUNet-16": _unet((
        (1, 32, (7, 5), (2, 2), "auto", (1, 1)),
        (32, 32, (7, 5), (2, 1), "auto", (1, 1)),
        (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
    )),
    "DCUNet-20": _unet((
        (1, 32, (7, 1), (1, 1), "auto", (1, 1)),
        (32, 32, (1, 7), (1, 1), "auto", (1, 1)),
        (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
        (64, 64, (7, 5), (2, 1), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
        (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
        (64, 90, (5, 3), (2, 1), "auto", (1, 1)),
    )),
    # the architecture of the SGMSE / Interspeech paper
    "DilDCUNet-v2": _unet((
        (1, 32, (4, 4), (1, 1), "auto", (1, 1)),
        (32, 32, (4, 4), (1, 1), "auto", (1, 1)),
        (32, 32, (4, 4), (1, 1), "auto", (1, 1)),
        (32, 64, (4, 4), (2, 1), "auto", (2, 1)),
        (64, 128, (4, 4), (2, 2), "auto", (4, 1)),
        (128, 256, (4, 4), (2, 2), "auto", (8, 1)),
    )),
}


# ---------------------------------------------------------------------------------------
# Complex layers on batch-stacked [re; im] tensors
# ---------------------------------------------------------------------------------------

def _recombine(f: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """The stacked complex result of the two real maps f1 = f[:, :c] and
    f2 = f[:, c:] of a stacked input: [f1(re) - f2(im); f1(im) + f2(re)]."""
    return torch.cat([f[:b, :c] - f[b:, c:], f[b:, :c] + f[:b, c:]], dim=0)


class Linear(nn.Module):
    """Flax ``nn.Dense`` with torch's default init, U(+-1/sqrt(in)) for the
    (out, in) weight and the bias."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def init_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)


class ComplexLinear(nn.Module):
    """Complex dense layer (JAX ``ComplexLinear``) on a stacked (2B, D) input."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.re = Linear(in_features, features)
        self.im = Linear(in_features, features)

    def forward(self, x):
        w = torch.cat([self.re.weight, self.im.weight], dim=0)
        bias = torch.cat([self.re.bias, self.im.bias], dim=0)
        return _recombine(F.linear(x, w, bias), x.shape[0] // 2, self.re.weight.shape[0])


class ConvWeight(nn.Module):
    """The parameters of one real conv of a complex conv: an OIHW ``weight``
    and an optional ``bias``, with torch's default init, U(+-1/sqrt(fan_in))."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


class ComplexConv2d(nn.Module):
    """Complex conv (JAX ``ComplexConv2d``): the real convs ``re`` and ``im``
    as one cuDNN call on the stacked input, in the compute ``dtype``; the
    result float32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), use_bias: bool = True, dtype=None):
        super().__init__()
        self.re = ConvWeight(in_ch, out_ch, kernel_size, use_bias)
        self.im = ConvWeight(in_ch, out_ch, kernel_size, use_bias)
        self.stride, self.padding, self.dilation = tuple(stride), tuple(padding), tuple(dilation)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.float32
        w = torch.cat([self.re.weight, self.im.weight], dim=0).to(dt)
        bias = None if self.re.bias is None else torch.cat([self.re.bias, self.im.bias]).to(dt)
        f = F.conv2d(x.to(dt), w, bias, self.stride, self.padding, self.dilation)
        return _recombine(f.float(), x.shape[0] // 2, self.re.weight.shape[0])


class ComplexConvTranspose2d(nn.Module):
    """Complex transposed conv (JAX ``ComplexConvTranspose2d``): ``re_weight``
    and ``im_weight`` are (C_in, C_out, kh, kw), the JAX ``re_kernel`` and
    ``im_kernel`` permuted; one ``F.conv_transpose2d`` on the stacked input in
    the compute ``dtype``, the result float32, the biases added in float32.
    ``output_size`` (H, W) sets the output padding, which must lie in
    [0, max(stride, dilation))."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), use_bias: bool = True, dtype=None):
        super().__init__()
        self.re_weight = nn.Parameter(torch.zeros(in_ch, out_ch, *kernel_size))
        self.im_weight = nn.Parameter(torch.zeros(in_ch, out_ch, *kernel_size))
        if use_bias:
            self.re_bias = nn.Parameter(torch.zeros(out_ch))
            self.im_bias = nn.Parameter(torch.zeros(out_ch))
        self.use_bias = use_bias
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.padding, self.dilation = tuple(padding), tuple(dilation)
        self.dtype = dtype

    def init_parameters(self, generator: torch.Generator) -> None:
        in_ch = self.re_weight.shape[0]
        bound = 1.0 / math.sqrt(in_ch * self.kernel_size[0] * self.kernel_size[1])
        for name in ("re_weight", "re_bias", "im_weight", "im_bias"):
            if hasattr(self, name):
                _uniform_(getattr(self, name), bound, generator)

    def forward(self, x, output_size: Optional[Tuple[int, int]] = None):
        k, s, p, d = self.kernel_size, self.stride, self.padding, self.dilation
        op = (0, 0)
        if output_size is not None:
            op = tuple(output_size[i] - ((x.shape[2 + i] - 1) * s[i] - 2 * p[i]
                                         + d[i] * (k[i] - 1) + 1) for i in range(2))
            for i in range(2):
                if not 0 <= op[i] < max(s[i], d[i]):
                    raise ValueError(f"requested output size {output_size[i]} invalid for "
                                     f"conv_transpose (computed output_padding {op[i]})")
        dt = self.dtype or torch.float32
        w = torch.cat([self.re_weight, self.im_weight], dim=1).to(dt)
        f = F.conv_transpose2d(x.to(dt), w, None, s, p, op, 1, d).float()
        if self.use_bias:
            f = f + torch.cat([self.re_bias, self.im_bias])[:, None, None]
        return _recombine(f, x.shape[0] // 2, self.re_weight.shape[1])


class GaussianFourierProjectionComplex(nn.Module):
    """Gaussian Fourier features of t, real (sin, cos) or complex exp(i t W 2 pi),
    as a stacked (2B, embed_dim) tensor. W is fixed: it never trains."""

    def __init__(self, embed_dim: int = 128, scale: float = 16.0, complex_valued: bool = False):
        super().__init__()
        dim = embed_dim if complex_valued else embed_dim // 2
        self.W = nn.Parameter(torch.zeros(dim), requires_grad=False)
        self.scale, self.complex_valued = scale, complex_valued

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.W.copy_(torch.randn(self.W.shape, generator=generator) * self.scale)

    def forward(self, t):
        return _embed(t.float()[:, None] * self.W[None, :] * 2.0 * math.pi, self.complex_valued)


class DiffusionStepEmbedding(nn.Module):
    """DiffWave-style embedding of t with the factors 10^(4 i / (dim - 1)),
    real or complex, as a stacked (2B, embed_dim) tensor."""

    def __init__(self, embed_dim: int = 128, complex_valued: bool = False):
        super().__init__()
        self.dim = embed_dim if complex_valued else embed_dim // 2
        self.complex_valued = complex_valued

    def forward(self, t):
        fac = 10.0 ** (4.0 * torch.arange(self.dim, device=t.device) / (self.dim - 1))
        return _embed(t.float()[:, None] * fac[None, :], self.complex_valued)


def _embed(phase: torch.Tensor, complex_valued: bool) -> torch.Tensor:
    """[re; im] of exp(i phase), or of the real cat(sin, cos) (imaginary part 0)."""
    if complex_valued:
        return torch.cat([torch.cos(phase), torch.sin(phase)], dim=0)
    re = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
    return torch.cat([re, torch.zeros_like(re)], dim=0)


class BatchNorm(nn.Module):
    """One flax ``nn.BatchNorm`` over (B, H, W) per channel: ``weight`` (scale)
    and ``bias`` parameters, ``mean`` and ``var`` running-statistics buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def init_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)


class BatchStatistics(torch.autograd.Function):
    """(mean, biased variance) over the dims (1, 3, 4) of a (2, B, C, H, W)
    tensor, per (re|im, channel), float32, and in a process group over every
    rank's rows too (equal counts). The forward takes flax's E[x^2] - E[x]^2
    from sums in float64, all-reduced over the ranks: rounded to float32 they
    do not depend on how the rows are split, where float32 sums (or Welford's
    float32 pass) do, by ~1e-7, which DilDCUNet-v2's ill-conditioned
    train-mode gradient turns into 1.1-1.4e-2 of a leaf's max|g| between one
    batch of 8 and two ranks of 4. The backward is float32, one pass: dv =
    (g_mean + 2 (v - mean) g_var) / n, after an all-reduce of the upstream
    (g_mean, g_var) (the loss is the sum of the ranks' losses). Autograd
    through the float64 sums wrote several full-size tensors and took about
    twice this one's device time (NVIDIA H100 80GB HBM3, 700 W; PERF.md)."""

    @staticmethod
    def forward(ctx, v):
        dims = (1, 3, 4)
        sums = torch.stack([v.sum(dims, dtype=torch.float64),
                            (v * v).sum(dims, dtype=torch.float64)])
        n = v.shape[1] * v.shape[3] * v.shape[4] * parallel.world()
        if parallel.world() > 1:
            dist.all_reduce(sums)
        mean, mean_sq = sums / n
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        mean, var = mean.float(), var.float()
        ctx.save_for_backward(v, mean)
        ctx.n = n
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        v, mean = ctx.saved_tensors
        g = torch.stack([g_mean, g_var]) / ctx.n
        if parallel.world() > 1:
            dist.all_reduce(g)
        at = lambda t: t[:, None, :, None, None]  # noqa: E731 - (2, C) against v
        return torch.addcmul(at(g[0]), v - at(mean), at(2.0 * g[1]))


class BatchNormOnReIm(nn.Module):
    """``bN``: a BatchNorm on the real part (``re``) and one on the imaginary
    part (``im``). See the module docstring for the running statistics."""

    def __init__(self, ch: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.re, self.im = BatchNorm(ch), BatchNorm(ch)
        self.momentum, self.eps = momentum, eps

    def forward(self, x):
        v = x.view(2, x.shape[0] // 2, *x.shape[1:])  # (re|im, B, C, H, W)
        parts = (self.re, self.im)
        if self.training:
            mean, var = BatchStatistics.apply(v)
            with torch.no_grad():
                for i, bn in enumerate(parts):
                    bn.mean.copy_(self.momentum * bn.mean + (1 - self.momentum) * mean[i])
                    bn.var.copy_(self.momentum * bn.var + (1 - self.momentum) * var[i])
        else:
            mean = torch.stack([bn.mean for bn in parts])
            var = torch.stack([bn.var for bn in parts])
        scale = torch.rsqrt(var + self.eps) * torch.stack([bn.weight for bn in parts])
        shift = torch.stack([bn.bias for bn in parts])
        y = (v - mean[:, None, :, None, None]) * scale[:, None, :, None, None]
        return (y + shift[:, None, :, None, None]).reshape(x.shape)


class ComplexBatchNorm(nn.Module):
    """``CbN``: whitening by the inverse square root of the 2x2 covariance of
    (re, im) per channel, from the batch's statistics in both modes, then the
    affine map (``Wrr``, ``Wri``, ``Wii``, ``Br``, ``Bi``). The statistics are
    float64 sums, rounded to float32, and where the batch's rows are split
    over a group they are the group's sums: two all-reduces per forward, with
    autograd where gradients are taken. The group is the one
    ``parallel.global_rows`` names (the ``--data_parallel`` workers'), or in
    ``train()`` mode the process group of data-parallel training."""

    def __init__(self, ch: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.affine, self.eps = affine, eps
        if affine:
            self.Wrr = nn.Parameter(torch.ones(ch))
            self.Wri = nn.Parameter(torch.zeros(ch))
            self.Wii = nn.Parameter(torch.ones(ch))
            self.Br = nn.Parameter(torch.zeros(ch))
            self.Bi = nn.Parameter(torch.zeros(ch))

    def init_parameters(self, generator: torch.Generator) -> None:
        if self.affine:
            nn.init.ones_(self.Wrr)
            nn.init.ones_(self.Wii)
            nn.init.zeros_(self.Br)
            nn.init.zeros_(self.Bi)
            with torch.no_grad():
                self.Wri.copy_(torch.rand(self.Wri.shape, generator=generator) * 1.8 - 0.9)

    def forward(self, x):
        v = x.view(2, x.shape[0] // 2, *x.shape[1:])
        xr, xi = v[0], v[1]
        group = rows.batch_group()
        if group is None and self.training and parallel.world() > 1:
            group = dist.group.WORLD  # data-parallel training: over the global batch
        n = xr.shape[0] * xr.shape[2] * xr.shape[3]
        if group is None:
            reduce = lambda t: t  # noqa: E731 - this batch alone
        elif torch.is_grad_enabled():  # the gradient sees the global statistics too
            n *= dist.get_world_size(group)
            reduce = lambda t: all_reduce(t, group=group)  # noqa: E731
        else:
            n *= dist.get_world_size(group)
            reduce = rows.all_sum

        def means(*ts):  # per channel, from float64 sums (over the group's rows)
            return (reduce(torch.stack([t.sum((0, 2, 3), keepdim=True, dtype=torch.float64)
                                        for t in ts])) / n).float()

        m = means(xr, xi)
        xr, xi = xr - m[0], xi - m[1]
        c = means(xr * xr, xr * xi, xi * xi)
        vrr, vri, vii = c[0] + self.eps, c[1], c[2] + self.eps
        tau = vrr + vii
        delta = vrr * vii - vri * vri
        s = torch.sqrt(delta)
        t = torch.sqrt(tau + 2 * s)
        rst = 1.0 / (s * t)
        urr, uii, uri = (s + vii) * rst, (s + vrr) * rst, -vri * rst
        if self.affine:
            c = lambda p: p[None, :, None, None]
            wrr, wri, wii = c(self.Wrr), c(self.Wri), c(self.Wii)
            zrr, zri = wrr * urr + wri * uri, wrr * uri + wri * uii
            zir, zii = wri * urr + wii * uri, wri * uri + wii * uii
            yr = zrr * xr + zri * xi + c(self.Br)
            yi = zir * xr + zii * xi + c(self.Bi)
        else:
            yr, yi = urr * xr + uri * xi, uri * xr + uii * xi
        return torch.cat([yr, yi], dim=0)


class TimeEmbedLayer(nn.Module):
    """Per-block time embedding: ``temb_layers`` - 1 complex linears
    (``lin{i}``) with the activation, then ``feature_dense`` to the block's
    channels and the activation."""

    def __init__(self, embed_dim: int, out_ch: int, temb_layers: int, temb_activation: str):
        super().__init__()
        self.n_lin = max(0, temb_layers - 1)
        for i in range(self.n_lin):
            self.add_module(f"lin{i}", ComplexLinear(embed_dim, embed_dim))
        self.feature_dense = ComplexLinear(embed_dim, out_ch)
        self.act = get_activation(temb_activation)

    def forward(self, t_embed):
        h = t_embed
        for i in range(self.n_lin):
            h = self.act(self._modules[f"lin{i}"](h))
        return self.act(self.feature_dense(h))[:, :, None, None]


class _Block(nn.Module):
    """An encoder (``conv``) or decoder (``deconv``) block: complex conv, the
    time-embedding bias, the norm, the activation on re and im."""

    def __init__(self, conv_name: str, conv: nn.Module, out_ch: int, norm_type: str,
                 activation: str, embed_dim: Optional[int], temb_layers: int,
                 temb_activation: str):
        super().__init__()
        self.conv_name = conv_name
        self.add_module(conv_name, conv)
        if embed_dim is not None:
            self.embed_layer = TimeEmbedLayer(embed_dim, out_ch, temb_layers, temb_activation)
        self.norm = ComplexBatchNorm(out_ch) if norm_type == "CbN" else BatchNormOnReIm(out_ch)
        self.act = get_activation(activation)

    def forward(self, x, t_embed, output_size=None):
        conv = self._modules[self.conv_name]
        y = conv(x) if output_size is None else conv(x, output_size)
        if t_embed is not None and hasattr(self, "embed_layer"):
            y = y + self.embed_layer(t_embed)
        return self.act(self.norm(y)).contiguous(memory_format=CL)


@BackboneRegistry.register("dcunet")
class DCUNet(nn.Module):
    """Complex U-Net score backbone; keyword arguments and defaults as the JAX
    ``DCUNet`` (whose class defaults differ from its CLI's: two global
    time-embedding layers and relu here, one and leaky_relu there)."""

    def __init__(
        self,
        dcunet_architecture: str = "DilDCUNet-v2",
        dcunet_time_embedding: str = "gfp",
        dcunet_temb_layers_global: int = 2,
        dcunet_temb_layers_local: int = 1,
        dcunet_temb_activation: str = "silu",
        dcunet_time_embedding_complex: bool = False,
        dcunet_fix_length: str = "pad",
        dcunet_mask_bound: str = "none",
        dcunet_norm_type: str = "bN",
        dcunet_activation: str = "relu",
        embed_dim: int = 128,
        precision: str = "float32",
        freq_bins: Optional[int] = None,
    ):
        config = {k: v for k, v in locals().items()
                  if k not in ("self", "__class__", "freq_bins")}
        super().__init__()
        self.config = config
        if dcunet_mask_bound != "none":
            raise NotImplementedError("DCUNet mask bounding is not implemented (as in the "
                                      "JAX package and the reference)")
        if dcunet_time_embedding not in ("gfp", "ds", "none"):
            raise ValueError(f"dcunet_time_embedding {dcunet_time_embedding!r} unrecognized")
        if dcunet_fix_length not in ("pad", "trim", "none"):
            raise ValueError(f"dcunet_fix_length {dcunet_fix_length!r} unrecognized")
        self.architecture = dcunet_architecture
        self.fix_length = None if dcunet_fix_length == "none" else dcunet_fix_length
        self.time_embedding = dcunet_time_embedding
        self.precision = precision
        dt = self.compute_dtype = compute_dtype_for(precision)
        conf_encoders, conf_decoders = DCUNET_ARCHITECTURES[dcunet_architecture]
        self.stride_product = tuple(int(v) for v in np.prod(
            [s for _, _, _, s, _, _ in conf_encoders], axis=0))

        embed = None
        if dcunet_time_embedding != "none":
            embed = embed_dim
            if dcunet_time_embedding == "gfp":
                self.embed_gfp = GaussianFourierProjectionComplex(
                    embed_dim, complex_valued=dcunet_time_embedding_complex)
            else:
                self.embed_ds = DiffusionStepEmbedding(
                    embed_dim, complex_valued=dcunet_time_embedding_complex)
            for i in range(dcunet_temb_layers_global):
                self.add_module(f"embed_global{i}", ComplexLinear(embed_dim, embed_dim))
        self.n_global = dcunet_temb_layers_global if embed is not None else 0
        self.temb_act = get_activation(dcunet_temb_activation)
        common = dict(norm_type=dcunet_norm_type, activation=dcunet_activation,
                      embed_dim=embed, temb_layers=dcunet_temb_layers_local,
                      temb_activation=dcunet_temb_activation)

        input_channels = 2  # x_t and y as complex channels
        self.n_enc = len(conf_encoders)
        for idx, (ic, oc, k, s, p, d) in enumerate(conf_encoders):
            ic = input_channels if idx == 0 else ic
            self.add_module(f"encoder{idx}", _Block(
                "conv", ComplexConv2d(ic, oc, k, s, p, d, use_bias=False, dtype=dt), oc,
                **common))
        self.n_dec = len(conf_decoders) - 1
        for idx, (ic, oc, k, s, p, d) in enumerate(conf_decoders[:-1]):
            self.add_module(f"decoder{idx}", _Block(
                "deconv", ComplexConvTranspose2d(ic, oc, k, s, p, dilation=d, use_bias=False,
                                                 dtype=dt), oc, **common))
        ic, oc, k, s, p, d = conf_decoders[-1]
        self.output_layer = ComplexConvTranspose2d(ic, oc, k, s, p, dilation=d, dtype=dt)

    def _time_embedding(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        if self.time_embedding == "none":
            return None
        embed = self.embed_gfp if self.time_embedding == "gfp" else self.embed_ds
        h = embed(t)
        for i in range(self.n_global):
            h = self.temb_act(self._modules[f"embed_global{i}"](h))
        return h

    def forward(self, x_t: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the backbones' common contract; DCUNet
        draws nothing."""
        spec = torch.cat([x_t, y], dim=1)  # (B, 2, F, T) complex
        b, _, f, target_t = spec.shape
        x = torch.cat([spec.real, spec.imag], dim=0).float()  # (2B, 2, F, T)
        freq_prod, time_prod = self.stride_product
        if (f - 1) % freq_prod:
            raise TypeError(f"Input shape must be [batch, ch, freq + 1, time + 1] with freq "
                            f"divisible by {freq_prod}, got {tuple(spec.shape)} instead")
        remainder = (target_t - 1) % time_prod
        if remainder:
            if self.fix_length is None:
                raise TypeError(
                    f"Input shape must be [batch, ch, freq + 1, time + 1] with time divisible "
                    f"by {time_prod}, got {tuple(spec.shape)} instead. Set 'dcunet_fix_length' "
                    f"to 'pad' or 'trim' to fix shapes automatically.")
            elif self.fix_length == "pad":
                x = F.pad(x, (0, time_prod - remainder))
            else:
                x = x[..., :x.shape[-1] - remainder]
        x = x.contiguous(memory_format=CL)
        in_hw = tuple(x.shape[2:])

        t_embed = self._time_embedding(t)
        enc_outs = []
        for idx in range(self.n_enc):
            x = self._modules[f"encoder{idx}"](x, t_embed)
            enc_outs.append(x)
        for idx, enc_out in zip(range(self.n_dec), reversed(enc_outs[:-1])):
            x = self._modules[f"decoder{idx}"](x, t_embed, tuple(enc_out.shape[2:]))
            x = torch.cat([x, enc_out], dim=1)
        out = self.output_layer(x, in_hw)

        cur_t = out.shape[-1]
        if cur_t < target_t:
            out = F.pad(out, (0, target_t - cur_t))
        elif cur_t > target_t:
            out = out[..., :target_t]
        return torch.complex(out[:b, 0], out[b:, 0])[:, None]

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--dcunet-architecture", dest="dcunet_architecture",
                            type=str, default="DilDCUNet-v2",
                            choices=DCUNET_ARCHITECTURES.keys(),
                            help="The concrete DCUNet architecture. 'DilDCUNet-v2' by default.")
        parser.add_argument("--dcunet-time-embedding", dest="dcunet_time_embedding",
                            type=str, choices=("gfp", "ds", "none"), default="gfp",
                            help="Timestep embedding style. 'gfp' by default.")
        parser.add_argument("--dcunet-temb-layers-global", dest="dcunet_temb_layers_global",
                            type=int, default=1,
                            help="Number of global linear+activation layers for the time "
                                 "embedding. 1 by default.")
        parser.add_argument("--dcunet-temb-layers-local", dest="dcunet_temb_layers_local",
                            type=int, default=1,
                            help="Number of local (per-encoder/per-decoder) linear+activation "
                                 "layers for the time embedding. 1 by default.")
        parser.add_argument("--dcunet-temb-activation", dest="dcunet_temb_activation",
                            type=str, default="silu",
                            help="The (complex) activation to use between all (global&local) "
                                 "time embedding layers.")
        parser.add_argument("--dcunet-time-embedding-complex",
                            dest="dcunet_time_embedding_complex", action="store_true",
                            help="Use complex-valued timestep embedding.")
        parser.add_argument("--dcunet-fix-length", dest="dcunet_fix_length",
                            type=str, default="pad", choices=("pad", "trim", "none"),
                            help="DCUNet strategy to 'fix' mismatched input timespan.")
        parser.add_argument("--dcunet-mask-bound", dest="dcunet_mask_bound",
                            type=str, choices=("tanh", "sigmoid", "none"), default="none",
                            help="DCUNet output bounding strategy. 'none' by default.")
        parser.add_argument("--dcunet-norm-type", dest="dcunet_norm_type",
                            type=str, choices=("bN", "CbN"), default="bN",
                            help="The type of norm to use within each encoder and decoder "
                                 "layer.")
        parser.add_argument("--dcunet-activation", dest="dcunet_activation",
                            type=str, choices=("leaky_relu", "relu", "silu"),
                            default="leaky_relu",
                            help="The activation to use within each encoder and decoder layer.")
        parser.add_argument("--precision", type=str, default="float32",
                            choices=("float32", "bfloat16"),
                            help="Compute dtype for the complex convs (params stay float32).")
        return parser
