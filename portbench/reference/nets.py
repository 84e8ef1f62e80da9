"""Plain NCSN++: the flagship ``ncsnpp`` and ``ncsnpp_v2`` U-Net in float32.

A frozen copy of the port's ``models/ncsnpp.py`` (``NCSNppBase``),
``models/blocks.py`` (the BigGAN res-block, attention, combine, GroupNorm,
Fourier embedding) and the plain versions of its two kernels,
``ops/upfirdn2d.py:upfirdn2d_plain`` and
``ops/group_norm.py:group_norm_act_plain``, reduced to the branch that the
published SGMSE+ and Schroedinger-bridge configurations use: BigGAN blocks,
FIR resampling, ``output_skip`` and ``input_skip`` pyramids combined by
``sum``, swish, Fourier time embedding, no dropout. Any other setting raises.
Submodules and parameters carry the port's names, so one state dict of the
benchmark's weights loads into both.

Products go through :mod:`.lowp` in the precision each layer holds (float32,
or a control's, set for the whole net by :func:`precision`); the GroupNorm
statistics, the softmax and everything else are float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import lowp

SUPPORTED = dict(resblock_type="biggan", fir=True, progressive="output_skip",
                 progressive_input="input_skip", progressive_combine="sum",
                 nonlinearity="swish", embedding_type="fourier", conditional=True,
                 centered=True, dropout=0.0, output_layer_before_sigma=False,
                 skip_rescale=True)


def fir_taps(k: Sequence[float], gain: float) -> np.ndarray:
    """The separable FIR as a normalised 2-D kernel times ``gain``."""
    k = np.asarray(k, dtype=np.float32)
    k = np.outer(k, k)
    return (k / np.sum(k) * gain).astype(np.float32)


def upfirdn2d(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad) -> torch.Tensor:
    """Upsample by zero insertion, pad, FIR-filter and downsample (B, C, H, W)."""
    kt = torch.as_tensor(k, dtype=torch.float32, device=x.device)
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
    weight = torch.flip(kt, [0, 1])[None, None].expand(c, 1, *kt.shape).contiguous()
    return F.conv2d(out, weight, stride=down, groups=c)


def upsample_2d(x, k, factor=2):
    taps = fir_taps(k, factor ** 2)
    p = taps.shape[0] - factor
    return upfirdn2d(x, taps, factor, 1, ((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k, factor=2):
    taps = fir_taps(k, 1.0)
    p = taps.shape[0] - factor
    return upfirdn2d(x, taps, 1, factor, ((p + 1) // 2, p // 2))


class Conv2d(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.prec = stride, padding, "f32"

    def forward(self, x):
        return lowp.conv2d(self.prec, x, self.weight, self.bias, self.stride, self.padding)


class Conv3x3(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch, 3, 1, 1)

    def forward(self, x):
        return self.Conv_0(x)


class Conv1x1(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return self.Conv_0(x)


class Dense(nn.Module):
    def __init__(self, in_f, out_f):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f))
        self.prec = "f32"

    def forward(self, x):
        return lowp.linear(self.prec, x, self.weight, self.bias)


class DDPMDense(nn.Module):
    def __init__(self, in_f, out_f):
        super().__init__()
        self.Dense_0 = Dense(in_f, out_f)

    def forward(self, x):
        return self.Dense_0(x)


class NIN(nn.Module):
    """1x1 projection over channels: W is (in, out)."""

    def __init__(self, in_dim, units):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(in_dim, units))
        self.b = nn.Parameter(torch.zeros(units))
        self.prec = "f32"

    def forward(self, x):
        return (lowp.matmul(self.prec, x.permute(0, 2, 3, 1), self.W) + self.b).permute(0, 3, 1, 2)


class GroupNorm(nn.Module):
    """GroupNorm over min(C // 4, 32) groups, eps 1e-6, of x + pre_bias, then
    SiLU if ``silu``."""

    def __init__(self, ch, silu=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.groups, self.silu = min(ch // 4, 32), silu

    def forward(self, x, pre_bias=None):
        b, c, h, w = x.shape
        g = self.groups
        u = x.float()
        if pre_bias is not None:
            u = u + pre_bias.float()[:, :, None, None]
        ug = u.reshape(b, g, c // g, h * w)
        mean = ug.mean(dim=(2, 3), keepdim=True)
        var = (ug * ug).mean(dim=(2, 3), keepdim=True) - mean * mean
        y = (ug - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-6)
        y = y.reshape(b, c, h, w) * self.weight[:, None, None] + self.bias[:, None, None]
        return F.silu(y) if self.silu else y


class GaussianFourierProjection(nn.Module):
    def __init__(self, embedding_size):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(embedding_size), requires_grad=False)

    def forward(self, x):
        x_proj = x.float()[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
    def __init__(self, in_ch, dim2):
        super().__init__()
        self.Conv_0 = Conv1x1(in_ch, dim2)

    def forward(self, x, y):
        return self.Conv_0(x) + y


class AttnBlockpp(nn.Module):
    """Single-head self-attention over the H*W positions, scale C^-0.5."""

    def __init__(self, ch):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(ch, silu=False)
        self.NIN_0, self.NIN_1, self.NIN_2, self.NIN_3 = (NIN(ch, ch) for _ in range(4))
        self.prec = "f32"

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.GroupNorm_0(x)

        def tokens(t):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

        q, k, v = tokens(self.NIN_0(hn)), tokens(self.NIN_1(hn)), tokens(self.NIN_2(hn))
        weights = torch.softmax(lowp.matmul(self.prec, q, k.transpose(1, 2)) * (c ** -0.5), -1)
        out = lowp.matmul(self.prec, weights, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return (x + self.NIN_3(out)) / math.sqrt(2.0)


class ResnetBlockBigGANpp(nn.Module):
    def __init__(self, in_ch, out_ch=None, up=False, down=False, fir_kernel=(1, 3, 3, 1),
                 temb_dim=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down, self.fir_kernel = up, down, tuple(fir_kernel)
        self.GroupNorm_0 = GroupNorm(in_ch)
        self.Conv_0 = Conv3x3(in_ch, out_ch)
        self.Dense_0 = DDPMDense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch)
        self.Conv_1 = Conv3x3(out_ch, out_ch)
        if in_ch != out_ch or up or down:
            self.Conv_2 = Conv1x1(in_ch, out_ch)

    def forward(self, x, temb):
        h = self.GroupNorm_0(x)
        if self.up:
            h, x = upsample_2d(h, self.fir_kernel), upsample_2d(x, self.fir_kernel)
        elif self.down:
            h, x = downsample_2d(h, self.fir_kernel), downsample_2d(x, self.fir_kernel)
        h = self.Conv_0(h)
        h = self.GroupNorm_1(h, self.Dense_0(F.silu(temb)))
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return (x + h) / math.sqrt(2.0)


class NCSNpp(nn.Module):
    """The NCSN++ U-Net at ``freq_bins`` frequency bins. ``scale_by_sigma``
    divides the output by t (``ncsnpp``; ``ncsnpp_v2`` does not)."""

    def __init__(self, nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
                 attn_resolutions=(16,), fir_kernel=(1, 3, 3, 1), scale_by_sigma=True,
                 freq_bins=256, **settings):
        super().__init__()
        for key, value in settings.items():
            if key in SUPPORTED and (list(value) if isinstance(value, (list, tuple))
                                     else value) != SUPPORTED[key]:
                raise NotImplementedError(f"the plain reference has no {key}={value!r}")
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.fir_kernel = tuple(fir_kernel)
        self.scale_by_sigma = scale_by_sigma
        channels, temb_dim = 4, nf * 4

        def resblock(name, in_ch, out_ch=None, up=False, down=False):
            self.add_module(name, ResnetBlockBigGANpp(in_ch, out_ch, up, down, fir_kernel,
                                                      temb_dim))

        self.fourier = GaussianFourierProjection(nf)
        self.temb_dense0 = DDPMDense(2 * nf, temb_dim)
        self.temb_dense1 = DDPMDense(temb_dim, temb_dim)
        self.conv_in = Conv3x3(channels, nf)
        hs_c, in_ch = [nf], nf
        levels = len(self.ch_mult)
        for level in range(levels):
            res = freq_bins // 2 ** level
            for block in range(num_res_blocks):
                out_ch = nf * self.ch_mult[level]
                resblock(f"down_{level}_block{block}", in_ch, out_ch)
                in_ch = out_ch
                if res in self.attn_resolutions:
                    self.add_module(f"down_{level}_attn{block}", AttnBlockpp(in_ch))
                hs_c.append(in_ch)
            if level != levels - 1:
                resblock(f"down_{level}_downres", in_ch, down=True)
                self.add_module(f"down_{level}_combine", Combine(channels, in_ch))
                hs_c.append(in_ch)
        resblock("mid_block0", in_ch)
        self.mid_attn = AttnBlockpp(in_ch)
        resblock("mid_block1", in_ch)
        h_c = in_ch
        for level in reversed(range(levels)):
            res = freq_bins // 2 ** level
            for block in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[level]
                resblock(f"up_{level}_block{block}", h_c + hs_c.pop(), out_ch)
                h_c = in_ch = out_ch
            if res in self.attn_resolutions:
                self.add_module(f"up_{level}_attn", AttnBlockpp(in_ch))
            self.add_module(f"up_{level}_pyramid_norm", GroupNorm(in_ch))
            self.add_module(f"up_{level}_pyramid_conv", Conv3x3(in_ch, channels))
            if level != 0:
                resblock(f"up_{level}_upres", in_ch, up=True)
        self.output_layer = Conv2d(channels, 2, 1)

    def forward(self, x_t, y, t):
        m = self._modules
        levels = len(self.ch_mult)
        x = torch.stack([x_t[:, 0].real, x_t[:, 0].imag, y[:, 0].real, y[:, 0].imag], dim=1)
        x = x.float()
        temb = self.temb_dense1(F.silu(self.temb_dense0(self.fourier(torch.log(t)))))
        input_pyramid = x
        hs = [self.conv_in(x)]
        for level in range(levels):
            for block in range(self.num_res_blocks):
                h = m[f"down_{level}_block{block}"](hs[-1], temb)
                if h.shape[2] in self.attn_resolutions:
                    h = m[f"down_{level}_attn{block}"](h)
                hs.append(h)
            if level != levels - 1:
                h = m[f"down_{level}_downres"](hs[-1], temb)
                input_pyramid = downsample_2d(input_pyramid, self.fir_kernel)
                hs.append(m[f"down_{level}_combine"](input_pyramid, h))
        h = m["mid_block0"](hs[-1], temb)
        h = self.mid_attn(h)
        h = m["mid_block1"](h, temb)
        pyramid = None
        for level in reversed(range(levels)):
            for block in range(self.num_res_blocks + 1):
                h = m[f"up_{level}_block{block}"](torch.cat([h, hs.pop()], dim=1), temb)
            if h.shape[2] in self.attn_resolutions:
                h = m[f"up_{level}_attn"](h)
            pyramid_h = m[f"up_{level}_pyramid_conv"](m[f"up_{level}_pyramid_norm"](h))
            if level == levels - 1:
                pyramid = pyramid_h
            else:
                pyramid = upsample_2d(pyramid, self.fir_kernel) + pyramid_h
            if level != 0:
                h = m[f"up_{level}_upres"](h, temb)
        h = pyramid
        if self.scale_by_sigma:
            h = h / t[:, None, None, None]
        h = self.output_layer(h)
        return torch.complex(h[:, 0], h[:, 1])[:, None]


@contextlib.contextmanager
def precision(net: nn.Module, mode: str):
    """Within: every product of ``net`` computes in ``mode`` (:mod:`.lowp`)."""
    if mode not in lowp.MODES:
        raise ValueError(f"precision {mode!r}: one of {lowp.MODES}")
    layers = [m for m in net.modules() if hasattr(m, "prec")]
    for m in layers:
        m.prec = mode
    try:
        yield net
    finally:
        for m in layers:
            m.prec = "f32"


def build(config: dict) -> NCSNpp:
    """The reference network of a benchmark configuration (``configs/*.json``)."""
    net = dict(config["network"])
    backbone = config["backbone"]
    if backbone not in ("ncsnpp", "ncsnpp_v2"):
        raise NotImplementedError(f"the plain reference has no backbone {backbone!r}")
    net.setdefault("scale_by_sigma", backbone == "ncsnpp")
    net.pop("precision", None)
    return NCSNpp(freq_bins=config["stft"]["n_fft"] // 2 + 1, **net)
