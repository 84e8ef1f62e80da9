"""NCSN++ score networks: the flagship ``ncsnpp``, ``ncsnpp_v2`` and
``ncsnpp_48k``. Counterpart of ``sgmse_tpu/models/ncsnpp.py``.

The three share one U-Net and differ in defaults: ``ncsnpp_v2`` does not scale
its output by 1/t (its preconditioning lives in the ScoreModel);
``ncsnpp_48k`` has no attention outside the middle block, no progressive
pyramids by default (its head is ``out_norm`` GroupNorm+SiLU and the ``out_conv`` 3x3)
and applies the output layer before the 1/t scaling.

The complex inputs ``x_t``/``y`` of shape (B, 1, F, T) are packed into a real
(B, 4, F, T) tensor [x.re, x.im, y.re, y.im] in channels_last memory; F plays
the image-height role, so attention triggers on the runtime frequency height
``h.shape[2] in attn_resolutions``. Which levels hold attention parameters is
fixed at construction from ``freq_bins``, the frequency height the model is
built for, as the JAX package's parameter tree is fixed by the input it was
initialised with; a forward whose frequency height triggers attention at a
level without parameters raises. The ScoreModel passes its STFT's
``n_fft // 2 + 1``; without ``freq_bins`` the height is ``image_size``. The
JAX package never reads ``image_size`` (its configs all say 256), so the port
keeps it only as a config value and as that fallback.

Every branch of the JAX network is ported: BigGAN or DDPM res-blocks
(``resblock_type``; DDPM resamples with the ``Upsample``/``Downsample``
blocks), FIR or nearest/mean resampling (``fir``), ``output_skip``,
``residual`` or no output pyramid (``progressive``), ``input_skip``,
``residual`` or no input pyramid (``progressive_input``) combined by ``sum``
or ``cat``, swish (fused into K2) or elu, relu, lrelu after K2
(``nonlinearity``), Fourier or positional time embedding. The FIR
convolutions of the residual pyramids and of the DDPM resamplers are K6
(``ops.upfirdn2d.upsample_conv_2d`` / ``conv_downsample_2d``: one launch of
``csrc/fir_conv.cu`` per call, the bias inside).
Training, as in the JAX package: ``dropout`` applies inside each res-block in
``train()`` mode only, with masks drawn from the ``generator`` given to
forward; ``remat`` recomputes each res-block in the backward pass
(``torch.utils.checkpoint``) instead of storing its activations, replaying
the same dropout masks. Every K1 and K2 call is differentiable through its
hand-written backward (``ops``); under ``remat`` the recomputation launches
the forward kernels a second time.

Call contract: ``forward(x_t, y, t) -> complex64 (B, 1, F, T)``; the legacy
``score = -dnn(...)`` sign lives in the ScoreModel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..ops import upfirdn2d as ufd
from .blocks import (CL, AttnBlockpp, Combine, Conv2d, Conv3x3, DDPMDense, Downsample,
                     GaussianFourierProjection, ResnetBlockBigGANpp, ResnetBlockDDPMpp,
                     Upsample, folding, get_act, get_timestep_embedding, norm_act, residual)
from .registry import BackboneRegistry


def compute_dtype_for(precision: str):
    if precision in ("bfloat16", "bf16"):
        return torch.bfloat16
    if precision in ("float32", "fp32", "f32"):
        return None
    raise ValueError(f"Unknown precision: {precision}")


class NCSNppBase(nn.Module):
    """NCSN++ U-Net; keyword arguments and defaults as the JAX ``NCSNppBase``."""

    def __init__(
        self,
        scale_by_sigma: bool = True,
        nonlinearity: str = "swish",
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        resamp_with_conv: bool = True,
        conditional: bool = True,
        fir: bool = True,
        fir_kernel: Sequence[int] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        progressive: str = "output_skip",
        progressive_input: str = "input_skip",
        progressive_combine: str = "sum",
        init_scale: float = 0.0,
        fourier_scale: float = 16.0,
        image_size: int = 256,
        embedding_type: str = "fourier",
        dropout: float = 0.0,
        centered: bool = True,
        output_layer_before_sigma: bool = False,
        precision: str = "float32",
        remat: bool = False,
        freq_bins: Optional[int] = None,
    ):
        config = {k: v for k, v in locals().items()
                  if k not in ("self", "__class__", "freq_bins")}
        super().__init__()
        self.config = config
        checks = {"progressive": (progressive, ("none", "output_skip", "residual")),
                  "progressive_input": (progressive_input, ("none", "input_skip", "residual")),
                  "embedding_type": (embedding_type, ("fourier", "positional")),
                  "resblock_type": (resblock_type, ("biggan", "ddpm")),
                  "progressive_combine": (progressive_combine.lower(), ("sum", "cat"))}
        for name, (got, known) in checks.items():
            if got not in known:
                raise ValueError(f"{name} {got!r} unrecognized (one of {known})")
        self.act = get_act(nonlinearity)
        self.nf = nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.conditional = conditional
        self.scale_by_sigma = scale_by_sigma
        self.embedding_type = embedding_type
        self.centered = centered
        self.output_layer_before_sigma = output_layer_before_sigma
        self.image_size = image_size
        self.freq_bins = image_size if freq_bins is None else freq_bins
        self.precision = precision
        self.remat = remat
        self.skip_rescale = skip_rescale
        self.resblock_type = resblock_type
        self.progressive, self.progressive_input = progressive, progressive_input
        self.combine_method = progressive_combine.lower()
        dt = self.compute_dtype = compute_dtype_for(precision)
        num_channels = 4
        temb_dim = nf * 4 if conditional else None

        def resblock(name, in_ch, out_ch=None, up=False, down=False):
            if resblock_type == "biggan":
                block = ResnetBlockBigGANpp(
                    in_ch, out_ch, up=up, down=down, dropout=dropout, fir=fir,
                    fir_kernel=self.fir_kernel, skip_rescale=skip_rescale, init_scale=init_scale,
                    temb_dim=temb_dim, dtype=dt, nonlinearity=nonlinearity)
            else:
                block = ResnetBlockDDPMpp(
                    in_ch, out_ch, nonlinearity=nonlinearity, dropout=dropout,
                    skip_rescale=skip_rescale, init_scale=init_scale, temb_dim=temb_dim, dtype=dt)
            self.add_module(name, block)

        def attn(name, ch):
            self.add_module(name, AttnBlockpp(ch, skip_rescale=skip_rescale,
                                              init_scale=init_scale, dtype=dt))

        def resample(cls, name, in_ch, out_ch=None, with_conv=resamp_with_conv):
            self.add_module(name, cls(in_ch, out_ch, with_conv=with_conv, fir=fir,
                                      fir_kernel=self.fir_kernel, dtype=dt))

        if embedding_type == "fourier":
            self.fourier = GaussianFourierProjection(embedding_size=nf, scale=fourier_scale)
        if conditional:
            emb_dim = 2 * nf if embedding_type == "fourier" else nf
            self.temb_dense0 = DDPMDense(emb_dim, nf * 4, dtype=dt)
            self.temb_dense1 = DDPMDense(nf * 4, nf * 4, dtype=dt)

        # Channel bookkeeping mirrors the JAX forward pass.
        self.conv_in = Conv3x3(num_channels, nf, dtype=dt)
        hs_c = [nf]
        in_ch = nf
        pyramid_ch = num_channels
        num_resolutions = len(self.ch_mult)
        for i_level in range(num_resolutions):
            res = self.freq_bins // 2**i_level
            for i_block in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                resblock(f"down_{i_level}_block{i_block}", in_ch, out_ch)
                in_ch = out_ch
                if res in self.attn_resolutions:
                    attn(f"down_{i_level}_attn{i_block}", in_ch)
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                if resblock_type == "ddpm":
                    resample(Downsample, f"down_{i_level}_downsample", in_ch)
                else:
                    resblock(f"down_{i_level}_downres", in_ch, down=True)
                if progressive_input == "input_skip":
                    self.add_module(f"down_{i_level}_combine",
                                    Combine(num_channels, in_ch, self.combine_method, dtype=dt))
                    if self.combine_method == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    resample(Downsample, f"down_{i_level}_pyramid_down", pyramid_ch, in_ch,
                             with_conv=True)
                    pyramid_ch = in_ch
                hs_c.append(in_ch)

        resblock("mid_block0", in_ch)
        attn("mid_attn", in_ch)
        resblock("mid_block1", in_ch)

        h_c = in_ch
        for i_level in reversed(range(num_resolutions)):
            res = self.freq_bins // 2**i_level
            for i_block in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                resblock(f"up_{i_level}_block{i_block}", h_c + hs_c.pop(), out_ch)
                h_c = in_ch = out_ch
            if res in self.attn_resolutions:
                attn(f"up_{i_level}_attn", in_ch)
            if progressive != "none":
                top = i_level == num_resolutions - 1
                if progressive == "output_skip" or top:
                    self.add_module(f"up_{i_level}_pyramid_norm",
                                    norm_act(in_ch, nonlinearity, dt))
                    conv_out, scale = ((num_channels, init_scale) if progressive == "output_skip"
                                       else (in_ch, 1.0))
                    self.add_module(f"up_{i_level}_pyramid_conv",
                                    Conv3x3(in_ch, conv_out, init_scale=scale, dtype=dt))
                else:  # residual
                    resample(Upsample, f"up_{i_level}_pyramid_up", pyramid_ch, in_ch,
                             with_conv=True)
                pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    resample(Upsample, f"up_{i_level}_upsample", in_ch)
                else:
                    resblock(f"up_{i_level}_upres", in_ch, up=True)
        assert not hs_c
        if progressive != "output_skip":
            self.out_norm = norm_act(in_ch, nonlinearity, dt)
            self.out_conv = Conv3x3(in_ch, num_channels, init_scale=init_scale, dtype=dt)

        # 1x1 conv 4 -> 2 with torch's default init.
        self.output_layer = Conv2d(num_channels, 2, 1, dtype=dt, init="torch")

    def _attn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        block = self._modules.get(name)
        if block is None:
            raise RuntimeError(f"frequency height {h.shape[2]} triggers attention at {name}, "
                               f"but the model was built for {self.freq_bins} frequency bins")
        return block(h)

    def _resblock(self, name: str, x: torch.Tensor, temb, generator):
        """Res-block ``name``; under ``remat`` (training with grad) its
        activations are recomputed in the backward, with the generator's state
        of the first call, so dropout draws the same masks and the generator is
        left where the forward left it."""
        block = self._modules[name]
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(x, temb, generator)
        state = None if generator is None else generator.get_state()
        calls = []

        def run(x, temb):
            if calls and state is not None:
                current = generator.get_state()
                generator.set_state(state)
                try:
                    return block(x, temb, generator)
                finally:
                    generator.set_state(current)
            calls.append(1)
            return block(x, temb, generator)

        return torch.utils.checkpoint.checkpoint(run, x, temb, use_reentrant=False)

    def _merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A residual pyramid's merge with the trunk (K8 where no gradient is
        recorded, written over b)."""
        return residual(a, b, self.skip_rescale, folding())

    def forward(self, x_t: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in ``train()`` mode."""
        m = self._modules
        res = lambda name, h: self._resblock(name, h, temb, generator)
        dt = self.compute_dtype
        num_resolutions = len(self.ch_mult)
        ddpm = self.resblock_type == "ddpm"

        # Complex (B, 1, F, T) pair -> real (B, 4, F, T), channels_last.
        x = torch.stack([x_t[:, 0].real, x_t[:, 0].imag, y[:, 0].real, y[:, 0].imag], dim=-1)
        x = x.to(dt or torch.float32).permute(0, 3, 1, 2)

        # --- time embedding -----------------------------------------------------------
        used_sigmas = t
        if self.embedding_type == "fourier":
            temb = self.fourier(torch.log(t))
        else:
            temb = get_timestep_embedding(t, self.nf)
        if self.conditional:
            temb = self.temb_dense0(temb)
            temb = self.temb_dense1(self.act(temb))
        else:
            temb = None

        if not self.centered:
            x = 2.0 * x - 1.0

        # --- down path ----------------------------------------------------------------
        input_pyramid = x.contiguous(memory_format=CL)
        hs = [self.conv_in(x)]
        for i_level in range(num_resolutions):
            for i_block in range(self.num_res_blocks):
                h = res(f"down_{i_level}_block{i_block}", hs[-1])
                if h.shape[2] in self.attn_resolutions:
                    h = self._attn(f"down_{i_level}_attn{i_block}", h)
                hs.append(h)
            if i_level != num_resolutions - 1:
                if ddpm:
                    h = m[f"down_{i_level}_downsample"](hs[-1])
                else:
                    h = res(f"down_{i_level}_downres", hs[-1])
                if self.progressive_input == "input_skip":
                    if self.fir:
                        input_pyramid = ufd.downsample_2d(input_pyramid, self.fir_kernel, factor=2)
                    else:
                        input_pyramid = ufd.naive_downsample_2d(input_pyramid, factor=2)
                    h = m[f"down_{i_level}_combine"](input_pyramid, h)
                elif self.progressive_input == "residual":
                    input_pyramid = m[f"down_{i_level}_pyramid_down"](input_pyramid)
                    h = input_pyramid = self._merge(input_pyramid, h)
                hs.append(h)

        # --- middle -------------------------------------------------------------------
        h = res("mid_block0", hs[-1])
        h = m["mid_attn"](h)
        h = res("mid_block1", h)

        # --- up path ------------------------------------------------------------------
        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for i_block in range(self.num_res_blocks + 1):
                h = res(f"up_{i_level}_block{i_block}", torch.cat([h, hs.pop()], dim=1))
            if h.shape[2] in self.attn_resolutions:
                h = self._attn(f"up_{i_level}_attn", h)
            if self.progressive != "none":
                if self.progressive == "output_skip" or i_level == num_resolutions - 1:
                    pyramid_h = m[f"up_{i_level}_pyramid_conv"](m[f"up_{i_level}_pyramid_norm"](h))
                if i_level == num_resolutions - 1:
                    pyramid = pyramid_h
                elif self.progressive == "output_skip":
                    pyramid = pyramid.contiguous(memory_format=CL)
                    if self.fir:
                        pyramid = ufd.upsample_2d(pyramid, self.fir_kernel, factor=2)
                    else:
                        pyramid = ufd.naive_upsample_2d(pyramid, factor=2)
                    pyramid = pyramid + pyramid_h
                else:  # residual
                    pyramid = m[f"up_{i_level}_pyramid_up"](pyramid)
                    h = pyramid = self._merge(pyramid, h)
            if i_level != 0:
                if ddpm:
                    h = m[f"up_{i_level}_upsample"](h)
                else:
                    h = res(f"up_{i_level}_upres", h)
        assert not hs
        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = self.out_conv(self.out_norm(h))

        # --- output scaling + complex packing -----------------------------------------
        h = h.float()
        if self.output_layer_before_sigma:
            h = self.output_layer(h)
            if self.scale_by_sigma:
                h = h / used_sigmas[:, None, None, None]
        else:
            if self.scale_by_sigma:
                h = h / used_sigmas[:, None, None, None]
            h = self.output_layer(h)
        h = h.float()
        return torch.complex(h[:, 0], h[:, 1])[:, None]


@BackboneRegistry.register("ncsnpp")
class NCSNpp(NCSNppBase):
    """SGMSE+ flagship backbone."""

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--nf", type=int, default=128, help="Base channel count.")
        parser.add_argument("--ch_mult", type=int, nargs="+", default=[1, 1, 2, 2, 2, 2, 2])
        parser.add_argument("--num_res_blocks", type=int, default=2)
        parser.add_argument("--attn_resolutions", type=int, nargs="+", default=[16])
        parser.add_argument("--no-centered", dest="centered", action="store_false",
                            help="The data is not centered [-1, 1]")
        parser.add_argument("--centered", dest="centered", action="store_true",
                            help="The data is centered [-1, 1]")
        parser.set_defaults(centered=True)
        parser.add_argument("--precision", type=str, default="float32",
                            choices=("float32", "bfloat16"),
                            help="Compute dtype (params stay float32).")
        parser.add_argument("--remat", action="store_true",
                            help="Recompute res-block activations in backward "
                                 "(less memory, ~30%% more FLOPs).")
        return parser


@BackboneRegistry.register("ncsnpp_v2")
class NCSNpp_v2(NCSNppBase):
    """The U-Net used with preconditioning: no 1/t output scaling; c_in, c_out
    and c_skip live in the ScoreModel."""

    def __init__(self, scale_by_sigma: bool = False, **kwargs):
        super().__init__(scale_by_sigma=scale_by_sigma, **kwargs)

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--nf", type=int, default=128)
        parser.add_argument("--ch_mult", type=int, nargs="+", default=[1, 1, 2, 2, 2, 2, 2])
        parser.add_argument("--num_res_blocks", type=int, default=2)
        parser.add_argument("--attn_resolutions", type=int, nargs="+", default=[16])
        parser.add_argument("--precision", type=str, default="float32",
                            choices=("float32", "bfloat16"),
                            help="Compute dtype (params stay float32).")
        parser.add_argument("--remat", action="store_true",
                            help="Recompute res-block activations in backward "
                                 "(less memory, ~30%% more FLOPs).")
        return parser


@BackboneRegistry.register("ncsnpp_48k")
class NCSNpp_48k(NCSNppBase):
    """48 kHz fullband variant: attention in the middle block only, no
    progressive pyramids, output layer before the 1/t scaling."""

    def __init__(self, attn_resolutions: Sequence[int] = (), progressive: str = "none",
                 progressive_input: str = "none", output_layer_before_sigma: bool = True,
                 **kwargs):
        super().__init__(attn_resolutions=attn_resolutions, progressive=progressive,
                         progressive_input=progressive_input,
                         output_layer_before_sigma=output_layer_before_sigma, **kwargs)

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--ch_mult", type=int, nargs="+", default=[1, 1, 2, 2, 2, 2, 2])
        parser.add_argument("--num_res_blocks", type=int, default=2)
        parser.add_argument("--attn_resolutions", type=int, nargs="+", default=[])
        parser.add_argument("--nf", type=int, default=128,
                            help="Number of channels to use in the model")
        parser.add_argument("--no-centered", dest="centered", action="store_false")
        parser.add_argument("--centered", dest="centered", action="store_true")
        parser.set_defaults(centered=True)
        parser.add_argument("--progressive", type=str, default="none",
                            help="Progressive downsampling method")
        parser.add_argument("--progressive_input", type=str, default="none",
                            help="Progressive upsampling method")
        parser.add_argument("--precision", type=str, default="float32",
                            choices=("float32", "bfloat16"),
                            help="Compute dtype (params stay float32).")
        parser.add_argument("--remat", action="store_true",
                            help="Recompute res-block activations in backward "
                                 "(less memory, ~30%% more FLOPs).")
        return parser
