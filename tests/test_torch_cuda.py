"""On-card tests of the port's hand-written CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with nvcc and skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel is held against its plain PyTorch version on the same inputs, at
the small test config's shapes plus awkward ones (C = 4, odd sizes, negative
padding); chip_smoke.py does the same at the full-width shapes.
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
@pytest.mark.parametrize("shape,silu", [((2, 16, 64, 64), True), ((2, 48, 33, 7), True),
                                        ((1, 384, 16, 16), True), ((2, 32, 16, 16), False)])
def test_group_norm_act_kernel_matches_plain(dev, dtype, shape, silu):
    x = _input(shape, dtype, dev) * 2.0 + 0.5
    c = shape[1]
    g = torch.Generator(device=dev).manual_seed(1)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    groups = gn.num_groups_for(c)
    before = gn.group_norm_act_cuda.launches
    got = gn.group_norm_act(x, gamma, beta, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert gn.group_norm_act_cuda.launches == before + 1
    _agree(got, gn.group_norm_act_plain(x, gamma, beta, groups, 1e-6, silu), dtype)


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
