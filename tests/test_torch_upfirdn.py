"""The port's upfirdn2d (sgmse_tpu_torch.ops.upfirdn2d) against the JAX package's,
on the cases of tests/test_upfirdn.py.

The port takes NCHW-indexed tensors in channels_last memory, the JAX package
NHWC arrays; the same numpy data goes to both. On the CPU the dispatcher runs
the plain PyTorch version; the CUDA kernel is held against that same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerance: 1e-5 relative to max|ref| (float32 sums of <= 16 taps in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgmse_tpu.ops import upfirdn2d as jufd
from sgmse_tpu_torch.ops import upfirdn2d as ufd

RTOL = 1e-5
FIR = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64.0


def _to_port(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels_last view


def _from_port(t):
    assert t.is_contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1)


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (0, 0)),
    (2, 1, (2, 1)),   # FIR upsample shape
    (1, 2, (1, 1)),   # FIR downsample shape
    (2, 1, (3, 1)),
    (1, 2, (2, 1)),
    (1, 1, (-1, 2)),  # negative padding crops
    (2, 2, (1, -1)),
])
def test_upfirdn_matches_jax(rng, up, down, pad):
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    ref = jufd.upfirdn2d(jnp.asarray(x), FIR, up=up, down=down, pad=pad)
    _close(_from_port(ufd.upfirdn2d(_to_port(x), FIR, up=up, down=down, pad=pad)), ref)


def test_upfirdn_nonseparable_kernel(rng):
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    k = rng.standard_normal((3, 3)).astype(np.float32)
    ref = jufd.upfirdn2d(jnp.asarray(x), k, up=2, down=1, pad=(1, 1))
    _close(_from_port(ufd.upfirdn2d(_to_port(x), k, up=2, down=1, pad=(1, 1))), ref)


@pytest.mark.parametrize("fn,shape,out", [
    ("upsample_2d", (2, 16, 12, 4), (2, 32, 24, 4)),
    ("downsample_2d", (2, 16, 12, 4), (2, 8, 6, 4)),
    ("upsample_2d", (1, 8, 4, 128), (1, 16, 8, 128)),
    ("downsample_2d", (1, 8, 4, 128), (1, 4, 2, 128)),
])
def test_resampling_matches_jax(rng, fn, shape, out):
    x = rng.standard_normal(shape).astype(np.float32)
    got = _from_port(getattr(ufd, fn)(_to_port(x), [1, 3, 3, 1], factor=2))
    assert got.shape == out
    _close(got, getattr(jufd, fn)(jnp.asarray(x), [1, 3, 3, 1], factor=2))


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
def test_pair_matches_two_jax_calls(rng, fn):
    """upfirdn2d_pair's plain version (the res-block's h and skip x in one call)
    against two calls of the JAX resampling."""
    x0 = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    x1 = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    got = getattr(ufd, fn + "_pair")(_to_port(x0), _to_port(x1), [1, 3, 3, 1], factor=2)
    assert len(got) == 2
    for g, x in zip(got, (x0, x1)):
        _close(_from_port(g), getattr(jufd, fn)(jnp.asarray(x), [1, 3, 3, 1], factor=2))
    k = ufd.setup_kernel([1, 3, 3, 1])
    direct = ufd.upfirdn2d_pair(_to_port(x0), _to_port(x1), k, down=2, pad=(1, 1))
    _close(_from_port(direct[1]), jufd.upfirdn2d(jnp.asarray(x1), k, down=2, pad=(1, 1)))


def test_bf16_input_keeps_dtype_and_layout(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    x = x.to(torch.bfloat16).float().numpy()  # a bf16-representable input
    got = ufd.downsample_2d(_to_port(x).to(torch.bfloat16), [1, 3, 3, 1])
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jufd.downsample_2d(jnp.asarray(x), [1, 3, 3, 1]))
    # float32 arithmetic, one bf16 rounding of the result
    assert np.abs(_from_port(got.float()) - ref).max() <= 2.0**-8 * np.abs(ref).max()


def test_naive_resampling_matches_jax(rng):
    x = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)
    up = ufd.naive_upsample_2d(_to_port(x))
    np.testing.assert_array_equal(_from_port(up), np.asarray(jufd.naive_upsample_2d(jnp.asarray(x))))
    down = ufd.naive_downsample_2d(up)
    _close(_from_port(down), jufd.naive_downsample_2d(jnp.asarray(_from_port(up))))


def test_setup_kernel_matches_jax():
    np.testing.assert_array_equal(ufd.setup_kernel([1, 3, 3, 1]), jufd.setup_kernel([1, 3, 3, 1]))


def test_cpu_dispatch_never_launches_and_kernel_refuses_cpu(rng):
    """On the CPU the dispatcher takes the plain version; the kernel wrapper
    itself takes only CUDA tensors (there is no fallback inside it)."""
    x = _to_port(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    before = ufd.upfirdn2d_cuda.launches
    ufd.upsample_2d(x, [1, 3, 3, 1])
    assert ufd.upfirdn2d_cuda.launches == before
    ufd.upsample_2d_pair(x, x, [1, 3, 3, 1])
    assert ufd.upfirdn2d_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ufd.upfirdn2d_cuda(x, FIR, up=2, pad=(2, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ufd.upfirdn2d_pair_cuda(x, x, FIR, up=2, pad=(2, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        ufd.upfirdn2d(x.to("meta"), FIR)
