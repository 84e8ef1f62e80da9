"""On-card tests of the port's hand-written CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with nvcc and skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel is held against its plain PyTorch version on the same inputs, at
the small test config's shapes plus awkward ones (C = 4, odd sizes, negative
padding, a pre-bias, pairs) and the largest of the 48 kHz network (F = 768);
chip_smoke.py does the same at every full-width shape.
Tolerances, relative to max|plain|: float32 2e-5 (sums in another order),
bfloat16 2^-7 (one bf16 rounding step).
"""
import numpy as np
import pytest
import torch

from sgmse_tpu_torch.ops import group_norm as gn
from sgmse_tpu_torch.ops import upfirdn2d as ufd

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _input(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _agree(got, ref, dtype):
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pad", [
    ((2, 4, 64, 64), 1, 2, (1, 1)),
    ((2, 16, 32, 16), 2, 1, (2, 1)),
    ((1, 8, 9, 11), 1, 1, (-1, 2)),
    ((1, 12, 7, 5), 2, 2, (1, -1)),
])
def test_upfirdn2d_kernel_matches_plain(dev, dtype, shape, up, down, pad):
    x = _input(shape, dtype, dev)
    k = ufd.setup_kernel([1, 3, 3, 1])
    before = ufd.upfirdn2d_cuda.launches
    got = ufd.upfirdn2d(x, k, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert ufd.upfirdn2d_cuda.launches == before + 1
    _agree(got, ufd.upfirdn2d_plain(x, k, up=up, down=down, pad=pad), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pad", [
    ((2, 128, 32, 48), 1, 2, (1, 1)),
    ((2, 64, 16, 8), 2, 1, (2, 1)),
    ((1, 12, 9, 11), 2, 1, (2, 1)),
    ((4, 128, 768, 256), 1, 2, (1, 1)),  # the 48 kHz net's largest down pair
    ((4, 128, 384, 128), 2, 1, (2, 1)),  # and its largest up pair, to 768x256
])
def test_upfirdn2d_pair_kernel_matches_plain(dev, dtype, shape, up, down, pad):
    x0, x1 = _input(shape, dtype, dev, seed=0), _input(shape, dtype, dev, seed=1)
    k = ufd.setup_kernel([1, 3, 3, 1]) * (4.0 if up == 2 else 1.0)
    before = ufd.upfirdn2d_cuda.launches
    got = ufd.upfirdn2d_pair(x0, x1, k, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert ufd.upfirdn2d_cuda.launches == before + 1
    for g, r in zip(got, ufd.upfirdn2d_pair_plain(x0, x1, k, up=up, down=down, pad=pad)):
        _agree(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,silu,bias", [((2, 16, 64, 64), True, False),
                                             ((2, 48, 33, 7), True, True),
                                             ((1, 384, 16, 16), True, False),
                                             ((2, 32, 16, 16), False, False),
                                             ((4, 128, 128, 128), True, True),
                                             ((4, 512, 4, 4), True, True),
                                             # the 48 kHz net's largest: ~403 MB in bf16
                                             ((4, 256, 768, 256), True, True),
                                             ((4, 128, 12, 4), False, False)])
def test_group_norm_act_kernel_matches_plain(dev, dtype, shape, silu, bias):
    x = _input(shape, dtype, dev) * 2.0 + 0.5
    b, c = shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    pre_bias = torch.randn(b, c, generator=g, device=dev).to(dtype) if bias else None
    groups = gn.num_groups_for(c)
    before = gn.group_norm_act_cuda.launches
    got = gn.group_norm_act(x, gamma, beta, groups, 1e-6, silu, pre_bias)
    torch.cuda.synchronize()
    assert gn.group_norm_act_cuda.launches == before + 1
    _agree(got, gn.group_norm_act_plain(x, gamma, beta, groups, 1e-6, silu, pre_bias), dtype)
    again = gn.group_norm_act(x, gamma, beta, groups, 1e-6, silu, pre_bias)
    assert torch.equal(got, again)  # a fixed summation order: bit for bit


def test_kernels_refuse_what_they_do_not_take(dev):
    nchw = torch.randn(1, 16, 8, 8, device=dev)  # contiguous NCHW, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        ufd.upfirdn2d(nchw, ufd.setup_kernel([1, 3, 3, 1]), down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="channels_last"):
        gn.group_norm_act(nchw, torch.ones(16, device=dev), torch.zeros(16, device=dev), 4)
    odd = _input((1, 6, 8, 8), torch.float32, dev)
    with pytest.raises(ValueError, match="unsupported"):
        ufd.upfirdn2d(odd, ufd.setup_kernel([1, 3, 3, 1]), down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gn.group_norm_act(_input((1, 16, 4, 4), torch.float16, dev),
                          torch.ones(16, device=dev), torch.zeros(16, device=dev), 4)
    with pytest.raises(ValueError, match="pre_bias"):
        gn.group_norm_act(_input((2, 16, 4, 4), torch.float32, dev), torch.ones(16, device=dev),
                          torch.zeros(16, device=dev), 4, pre_bias=torch.zeros(16, device=dev))
    with pytest.raises(ValueError, match="one shape"):
        ufd.upfirdn2d_pair(_input((1, 8, 8, 8), torch.float32, dev),
                           _input((1, 8, 8, 6), torch.float32, dev),
                           ufd.setup_kernel([1, 3, 3, 1]), down=2, pad=(1, 1))
