"""The residual merge K8 (``ops/residual_merge.py``) and the blocks' folded
biases (``models/blocks.py``), on the CPU.

- K8's plain version against the arithmetic the blocks run with autograd on
  (each bias its own add, then the sum and the scale, each rounded): in
  float32 equal to 1e-6 of max|out| (a division against a multiplication by
  the reciprocal); in bfloat16 within two bf16 steps of max|out| (the old
  arithmetic rounds up to four times, K8 once), and within half a step of the
  exact sum (one rounding).
- Each block, and a small NCSN++, where no gradient is recorded (biases folded
  into K2's pre-bias and K8) against its output with autograd on, on the same
  weights with non-zero biases: float32 within 1e-5 of max|out|. In bfloat16
  the folded block is within one bf16 step (2^-7) of max|out| of the same
  block in float32, and within two of the block with autograd on, which is
  itself up to ~1.1 steps off the float32 block (it rounds each bias add, the
  sum and the scale; over 84 drawn blocks the folded one read at most 0.83
  steps off, the unfolded one 1.12, and 1.19 apart).
- ``BIAS_ADDS``: with no gradient recorded every res-block's Conv_0, Conv_1
  and shortcut bias is folded, and the tally matches the calls that forward
  pre-hooks see; with autograd on none is folded and the tally counts
  nothing.
"""
import math

import pytest
import torch

from sgmse_tpu_torch.models import blocks as pb
from sgmse_tpu_torch.models.ncsnpp import NCSNpp, NCSNpp_48k
from sgmse_tpu_torch.ops import residual_merge as rm

BF16_STEP = 2.0**-7


def _cl(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)


def _randomise(module, seed=0):
    """Draw every parameter by its rule (unit-gain weights), then move each
    vector (biases, GroupNorm's affine) by noise: no bias is zero."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(g)
    with torch.no_grad():
        for p in module.parameters():
            if p.requires_grad and p.ndim == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    return module


def _rel(got, ref):
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("channels", [16, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip_bias", [False, True])
@pytest.mark.parametrize("skip_rescale", [True, False])
def test_plain_merge_matches_the_unfolded_arithmetic(channels, dtype, skip_bias, skip_rescale):
    shape = (2, channels, 6, 5)
    skip, h = _cl(shape, dtype, 0), _cl(shape, dtype, 1)
    g = torch.Generator().manual_seed(2)
    b1, b2 = (0.5 * torch.randn(channels, generator=g) for _ in range(2))
    b2 = b2 if skip_bias else None
    # With autograd on: each conv adds its bias in the compute dtype, then the merge.
    x_old = skip if b2 is None else skip + b2.to(dtype)[:, None, None]
    h_old = h + b1.to(dtype)[:, None, None]
    old = (x_old + h_old) / math.sqrt(2.0) if skip_rescale else x_old + h_old
    exact = (skip.double() + (0.0 if b2 is None else b2.double()[:, None, None])
             + h.double() + b1.double()[:, None, None]) * (0.5**0.5 if skip_rescale else 1.0)
    scale = 1.0 / math.sqrt(2.0) if skip_rescale else 1.0
    target = h.clone()
    got = rm.residual_merge(target, skip, scale, b1, b2)
    assert got is target and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        assert _rel(got, old) <= 1e-6
    else:
        assert _rel(got, old) <= 2 * BF16_STEP
        assert _rel(got, exact) <= BF16_STEP / 2


def test_merge_refuses_to_record_a_gradient():
    h = _cl((1, 8, 2, 2), torch.float32, 0).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        rm.residual_merge(h, _cl((1, 8, 2, 2), torch.float32, 1))
    with torch.no_grad():
        rm.residual_merge(h, _cl((1, 8, 2, 2), torch.float32, 1))


# (kind, in_ch, out_ch, up, down, conv_shortcut): BigGAN up, down or neither, with and
# without the 1x1 Conv_2; DDPM with the NIN_0 or Conv_2 shortcut, or none.
BLOCKS = [
    ("biggan", 16, 16, False, False, False),
    ("biggan", 16, 32, False, False, False),
    ("biggan", 16, 16, True, False, False),
    ("biggan", 32, 16, False, True, False),
    ("ddpm", 16, 32, False, False, False),
    ("ddpm", 16, 32, False, False, True),
    ("ddpm", 16, 16, False, False, False),
]


def _block(kind, in_ch, out_ch, up, down, conv_shortcut, temb, dtype):
    temb_dim = 24 if temb else None
    if kind == "biggan":
        return pb.ResnetBlockBigGANpp(in_ch, out_ch, up=up, down=down, fir=True,
                                      init_scale=1.0, temb_dim=temb_dim, dtype=dtype)
    return pb.ResnetBlockDDPMpp(in_ch, out_ch, conv_shortcut=conv_shortcut, skip_rescale=True,
                                init_scale=1.0, temb_dim=temb_dim, dtype=dtype)


def _agree(make, dtype, *inputs):
    """The block ``make(dtype)`` where no gradient is recorded against itself
    with autograd on, and in bfloat16 against ``make(None)``, the same weights
    in float32."""
    module = _randomise(make(dtype)).eval()
    with torch.enable_grad():
        ref = module(*inputs).detach()
    with torch.inference_mode():
        got = module(*inputs)
    assert got.shape == ref.shape and got.dtype == ref.dtype == (dtype or torch.float32)
    if dtype is None:
        assert _rel(got, ref) <= 1e-5
        return
    assert _rel(got, ref) <= 2 * BF16_STEP
    f32 = make(None).eval()
    f32.load_state_dict(module.state_dict())
    with torch.inference_mode():
        exact = f32(*(t.float() if t.is_floating_point() else t for t in inputs))
    assert _rel(got, exact) <= BF16_STEP


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("temb", [True, False])
@pytest.mark.parametrize("kind,in_ch,out_ch,up,down,conv_shortcut", BLOCKS)
def test_res_block_folded_matches_autograd_mode(kind, in_ch, out_ch, up, down, conv_shortcut,
                                                temb, dtype):
    x = _cl((2, in_ch, 8, 6), dtype or torch.float32, 3)
    inputs = (x, torch.randn(2, 24, generator=torch.Generator().manual_seed(4))) if temb else (x,)
    _agree(lambda dt: _block(kind, in_ch, out_ch, up, down, conv_shortcut, temb, dt), dtype,
           *inputs)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("skip_rescale", [True, False])
def test_attention_folded_matches_autograd_mode(skip_rescale, dtype):
    _agree(lambda dt: pb.AttnBlockpp(16, skip_rescale=skip_rescale, init_scale=1.0, dtype=dt),
           dtype, _cl((2, 16, 4, 6), dtype or torch.float32, 5))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_combine_sum_folded_matches_autograd_mode(dtype):
    x, y = (_cl(shape, dtype or torch.float32, seed)
            for shape, seed in (((2, 4, 6, 4), 6), ((2, 16, 6, 4), 7)))
    _agree(lambda dt: pb.Combine(4, 16, method="sum", dtype=dt), dtype, x, y)


SMALL = dict(nf=16, ch_mult=(1, 2, 2), num_res_blocks=1, init_scale=1.0)
NETS = {
    "flagship": lambda: NCSNpp(attn_resolutions=(8,), freq_bins=32, **SMALL),
    "48k": lambda: NCSNpp_48k(freq_bins=32, **SMALL),
    "ddpm_residual": lambda: NCSNpp(resblock_type="ddpm", progressive="residual",
                                    progressive_input="residual", attn_resolutions=(8,),
                                    freq_bins=32, **SMALL),
}


def _net_inputs():
    g = torch.Generator().manual_seed(8)
    x, y = (torch.randn(2, 1, 32, 16, generator=g, dtype=torch.complex64) for _ in range(2))
    return x, y, torch.tensor([0.3, 0.8])


@pytest.mark.parametrize("net", sorted(NETS))
def test_every_res_block_bias_is_folded_where_no_gradient_is_recorded(net):
    model = _randomise(NETS[net]()).eval()
    blocks = [m for m in model.modules()
              if isinstance(m, (pb.ResnetBlockBigGANpp, pb.ResnetBlockDDPMpp))]
    block_convs = set()
    for b in blocks:
        for name in ("Conv_0", "Conv_1", "Conv_2", "NIN_0"):
            m = getattr(b, name, None)
            if m is not None:
                block_convs.add(id(m if isinstance(m, pb.NIN) else m.Conv_0))
    seen = []  # (module id, with_bias) of each biased convolution or projection called

    def note(module, args, kwargs):
        if getattr(module, "bias", getattr(module, "b", None)) is not None:
            seen.append((id(module), kwargs.get("with_bias", args[1] if len(args) > 1 else True)))

    hooks = [m.register_forward_pre_hook(note, with_kwargs=True) for m in model.modules()
             if isinstance(m, (pb.Conv2d, pb.NIN))]
    try:
        before = dict(pb.BIAS_ADDS)
        with torch.enable_grad():
            ref = model(*_net_inputs())
        grad_mode = {k: pb.BIAS_ADDS[k] - before[k] for k in before}
        grad_seen, seen[:] = list(seen), []
        before = dict(pb.BIAS_ADDS)
        with torch.inference_mode():
            got = model(*_net_inputs())
        folded = {k: pb.BIAS_ADDS[k] - before[k] for k in before}
    finally:
        for h in hooks:
            h.remove()
    # With autograd on every convolution adds its own bias, and the tally counts nothing.
    assert all(with_bias for _, with_bias in grad_seen)
    assert grad_mode == {"folded": 0, "separate": 0}
    # Where no gradient is recorded, every res-block convolution leaves its bias out; the
    # tally counts each biased call by where its bias went.
    assert {i for i, _ in seen} >= block_convs
    assert not any(with_bias for i, with_bias in seen if i in block_convs)
    assert folded == {"folded": sum(not w for _, w in seen), "separate": sum(w for _, w in seen)}
    assert folded["folded"] >= len(block_convs) and len(seen) == len(grad_seen)
    assert _rel(got, ref.detach()) <= 1e-5
