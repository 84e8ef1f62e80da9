"""The frozen counts at small shapes against counts made by hand."""
import math

import pytest
import torch

from conftest import tiny

from portbench.counts import kernels, network, peaks
from portbench.reference import nets


def test_k1_downsample_pair_by_hand():
    # (1, 2, 8, 8) pair, 4x4 taps, down 2, pad (1, 1): output 4x4; 16 taps an output
    sig = ((1, 2, 8, 8), 1, 2, (1, 1), (1.0 / 64,) * 16, 2, "bfloat16")
    nbytes, ops, ops_s = kernels.upfirdn2d(sig)
    out = 1 * 2 * 4 * 4
    assert nbytes == 2 * (128 + out) * 2
    assert ops == 2 * out * 16 * 2
    assert kernels.bound_s("upfirdn2d", sig) == max(nbytes / 3.35e12, ops / 67e12)


def test_k1_upsample_by_hand():
    # up 2, pad (2, 1): (8*2 + 3 - 4) + 1 = 16; 4 of the 16 taps land on a sample
    sig = ((2, 3, 8, 8), 2, 1, (2, 1), (1.0,) * 16, 1, "float32")
    nbytes, ops, _ = kernels.upfirdn2d(sig)
    out = 2 * 3 * 16 * 16
    assert nbytes == (2 * 3 * 64 + out) * 4
    assert ops == out * 4 * 2


def test_k2_and_k2b_by_hand():
    sig = ((2, 8, 4, 4), 2, 1e-6, True, True, "bfloat16")
    n = 2 * 8 * 16
    assert kernels.group_norm_act(sig)[:2] == (2 * n * 2 + 2 * 8 * 4 + 2 * 8 * 2, n * 9)
    assert kernels.group_norm_act_bwd(sig)[:2] == (
        3 * n * 2 + 4 * 8 * 4 + 2 * 2 * 2 * 4 + 2 * 2 * 8 * 2, n * 31)
    plain = ((2, 8, 4, 4), 2, 1e-6, False, False, "float32")
    assert kernels.group_norm_act(plain)[1] == n * 5
    assert kernels.group_norm_act_bwd(plain)[1] == n * 13


def test_k6_by_hand():
    sig = ("down", (1, 4, 8, 8), (6, 4, 3, 3), (1.0,) * 4, 2, 1.0, True, "bfloat16")
    nbytes, ops, ops_s = kernels.fir_conv(sig)
    conv = 2 * (1 * 6 * 4 * 4) * 4 * 9
    fir = 2 * 8 * 1 * 4 * 9 * 9
    assert ops == conv + fir
    assert ops_s == pytest.approx(conv / peaks.BF16_FLOPS + fir / peaks.F32_FLOPS)
    assert nbytes == (256 + 96 + 216) * 2 + 6 * 4


def hand_count(config, batch, freq, frames):
    """FLOPs of the reference network's products, from forward hooks on its
    layers and the attention shapes: 2 per multiply-add."""
    with torch.device("meta"):
        net = nets.build(config)
    total = []

    def conv_hook(m, args, out):
        o, i, kh, kw = m.weight.shape
        total.append(2 * out.numel() * i * kh * kw)

    def dense_hook(m, args, out):
        total.append(2 * out.numel() * m.weight.shape[1])

    def nin_hook(m, args, out):
        total.append(2 * out.numel() * m.W.shape[0])

    def attn_hook(m, args, out):
        b, c, h, w = args[0].shape
        total.append(2 * 2 * b * (h * w) ** 2 * c)

    def fir_hook(m, args, out):  # the FIR resampling of a res-block's h and skip
        if m.up or m.down:
            b, c, h, w = args[0].shape
            ho, wo = (2 * h, 2 * w) if m.up else (h // 2, w // 2)
            total.append(2 * 2 * b * c * ho * wo * 16)

    for mod in net.modules():
        hook = {nets.Conv2d: conv_hook, nets.Dense: dense_hook, nets.NIN: nin_hook,
                nets.AttnBlockpp: attn_hook, nets.ResnetBlockBigGANpp: fir_hook}.get(type(mod))
        if hook:
            mod.register_forward_hook(hook)
    x = torch.empty(batch, 1, freq, frames, dtype=torch.complex64, device="meta")
    with torch.no_grad():
        net(x, x, torch.empty(batch, device="meta"))
    levels = len(config["network"]["ch_mult"])
    # the input pyramid's FIR downsampling of the 4 input channels at each level
    pyramid = sum(2 * batch * 4 * (freq >> (k + 1)) * (frames >> (k + 1)) * 16
                  for k in range(levels - 1))
    # the output pyramid's FIR upsampling of its 4 channels
    pyramid += sum(2 * batch * 4 * (freq >> k) * (frames >> k) * 4 * 4 for k in range(levels - 1))
    return sum(total) + pyramid


@pytest.mark.parametrize("cell", ["sgmse-plus-16k.enhance-b16", "sgmse-sb-16k.train-b16"])
def test_network_flops_by_hand(cell):
    config, _ = tiny(cell)
    assert network.forward_flops(config, 2, 32, 64) == hand_count(config, 2, 32, 64)


def test_flagship_flops_per_utterance_evaluation():
    from portbench import harness

    config = harness.config("sgmse-plus-16k")
    flops = network.forward_flops(config, 1, 256, 256)
    assert flops == hand_count(config, 1, 256, 256)
    assert 5.0e11 < flops < 5.6e11  # 533 GFLOP an utterance (256 frames) and evaluation
    assert network.forward_flops(config, 4, 256, 256) == 4 * flops
    assert math.isclose(network.forward_flops(config, 1, 256, 512), 2 * flops, rel_tol=0.05)
