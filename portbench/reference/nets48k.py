"""Plain ``ncsnpp_48k``: the 48 kHz EARS network in float32.

The U-Net of Richter et al., *EARS: An Anechoic Fullband Speech Dataset
Benchmarked for Speech Enhancement and Dereverberation*, Interspeech 2024
(arXiv:2406.06185), as the sp-uhh/sgmse ``ncsnpp_48k`` backbone has it and
the port's ``models/ncsnpp.py`` ``NCSNpp_48k`` computes it: NCSN++ with
``nf`` channels over ``len(ch_mult)`` levels, ``num_res_blocks`` BigGAN
res-blocks a level, FIR [1, 3, 3, 1] resampling inside the up and down
res-blocks, attention in the middle block only, no input or output pyramid,
a head of GroupNorm + SiLU (``out_norm``) and a 3x3 convolution to 4 channels
(``out_conv``), then the 1x1 output layer, then the division by t.

It is built from the frozen blocks of :mod:`.nets` (res-block, attention,
GroupNorm, convolutions, Fourier embedding), which it imports and does not
change, so its products go through :mod:`.lowp` and follow
:func:`.nets.precision` as the flagship's do. Submodules and parameters carry
the port's names, so one state dict of the benchmark's weights loads into
both.

Departures from the published description:

- only the branch the published configuration takes: BigGAN blocks, FIR
  resampling, swish, Fourier time embedding, no pyramids, no dropout, centred
  inputs, attention at no level (``attn_resolutions`` empty); any other
  setting raises;
- the weights are the benchmark's seeded ones (``portbench/weights.py``),
  never a trained checkpoint; ``out_norm``'s shift is drawn as a bias
  (N(0, 4e-4)), since ``weights.leaf_scale`` names GroupNorm shifts by the
  flagship's module names.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nets import (AttnBlockpp, Conv2d, Conv3x3, DDPMDense, GaussianFourierProjection, GroupNorm,
                   ResnetBlockBigGANpp)

SUPPORTED = dict(resblock_type="biggan", fir=True, progressive="none", progressive_input="none",
                 progressive_combine="sum", nonlinearity="swish", embedding_type="fourier",
                 conditional=True, centered=True, dropout=0.0, output_layer_before_sigma=True,
                 skip_rescale=True, attn_resolutions=[])


class NCSNpp48k(nn.Module):
    """The ``ncsnpp_48k`` U-Net. ``scale_by_sigma`` divides the output by t
    after the output layer."""

    def __init__(self, nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
                 fir_kernel=(1, 3, 3, 1), scale_by_sigma=True, **settings):
        super().__init__()
        for key, value in settings.items():
            if key in SUPPORTED and (list(value) if isinstance(value, (list, tuple))
                                     else value) != SUPPORTED[key]:
                raise NotImplementedError(f"the plain 48 kHz reference has no {key}={value!r}")
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
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
            for block in range(num_res_blocks):
                out_ch = nf * self.ch_mult[level]
                resblock(f"down_{level}_block{block}", in_ch, out_ch)
                in_ch = out_ch
                hs_c.append(in_ch)
            if level != levels - 1:
                resblock(f"down_{level}_downres", in_ch, down=True)
                hs_c.append(in_ch)
        resblock("mid_block0", in_ch)
        self.mid_attn = AttnBlockpp(in_ch)
        resblock("mid_block1", in_ch)
        h_c = in_ch
        for level in reversed(range(levels)):
            for block in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[level]
                resblock(f"up_{level}_block{block}", h_c + hs_c.pop(), out_ch)
                h_c = in_ch = out_ch
            if level != 0:
                resblock(f"up_{level}_upres", in_ch, up=True)
        self.out_norm = GroupNorm(in_ch)
        self.out_conv = Conv3x3(in_ch, channels)
        self.output_layer = Conv2d(channels, 2, 1)

    def forward(self, x_t, y, t):
        m = self._modules
        levels = len(self.ch_mult)
        x = torch.stack([x_t[:, 0].real, x_t[:, 0].imag, y[:, 0].real, y[:, 0].imag], dim=1)
        x = x.float()
        temb = self.temb_dense1(F.silu(self.temb_dense0(self.fourier(torch.log(t)))))
        hs = [self.conv_in(x)]
        for level in range(levels):
            for block in range(self.num_res_blocks):
                hs.append(m[f"down_{level}_block{block}"](hs[-1], temb))
            if level != levels - 1:
                hs.append(m[f"down_{level}_downres"](hs[-1], temb))
        h = m["mid_block0"](hs[-1], temb)
        h = self.mid_attn(h)
        h = m["mid_block1"](h, temb)
        for level in reversed(range(levels)):
            for block in range(self.num_res_blocks + 1):
                h = m[f"up_{level}_block{block}"](torch.cat([h, hs.pop()], dim=1), temb)
            if level != 0:
                h = m[f"up_{level}_upres"](h, temb)
        h = self.output_layer(self.out_conv(self.out_norm(h)))
        if self.scale_by_sigma:
            h = h / t[:, None, None, None]
        return torch.complex(h[:, 0], h[:, 1])[:, None]


def build(config: dict) -> NCSNpp48k:
    """The reference network of an ``ncsnpp_48k`` configuration (``configs/*.json``)."""
    if config["backbone"] != "ncsnpp_48k":
        raise NotImplementedError(f"{config['backbone']!r} is not the 48 kHz backbone")
    net = dict(config["network"])
    net.pop("precision", None)
    return NCSNpp48k(**net)
