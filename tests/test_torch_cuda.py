"""On-card tests of the port's hand-written CUDA kernels (marker ``cuda``).

They need an NVIDIA GPU with nvcc and skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel is held against its plain PyTorch version on the same inputs, at
the small test config's shapes plus awkward ones (C = 4, odd sizes, negative
padding, a pre-bias, pairs) and the largest of the 48 kHz network (F = 768);
chip_smoke.py does the same at every full-width shape.
Tolerances, relative to max|plain|: float32 2e-5 (sums in another order),
bfloat16 2^-7 (one bf16 rounding step). The backward kernels (K2b and the K1
adjoint) are held the same way; K2b's float32 outputs (dgamma, dbeta, and all
of them for float32 inputs) to 1e-4, its sums running over up to B*H*W terms
per channel in another order. K8, the residual merge, is held to its plain
version bit for bit (the same float32 operations in the same order, one
rounding) at small shapes, at the main path's (cell 1's 16 x 128 x 256 x
{192, 512} and 16 x 256 x 64 x 128, the 48 kHz cell's 1 x 128 x 768 x 512)
and on its general path (any C, unaligned tensors),
and a small network whose biases are folded into K2 and K8 to its output with
autograd on. Beside them, one test holds the bridge sampler and its training
loss to making no synchronising call.
"""
import numpy as np
import pytest
import torch

from sgmse_tpu_torch.ops import group_norm as gn
from sgmse_tpu_torch.ops import residual_merge as rm
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


def _grad_tol(t):
    return 1e-4 if t.dtype == torch.float32 else 2.0**-7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,silu,bias", [((2, 32, 8, 8), True, True),
                                             ((1, 64, 16, 12), False, False),
                                             ((2, 16, 5, 7), True, False),
                                             ((4, 512, 4, 4), True, True),
                                             ((2, 128, 64, 64), True, True),
                                             ((2, 256, 16, 16), False, False),
                                             ((8, 128, 128, 128), True, True),
                                             ((2, 384, 32, 32), True, True),
                                             ((2, 512, 64, 64), False, True),
                                             ((3, 256, 33, 17), True, True),
                                             ((1, 128, 768, 256), True, False),
                                             # the bridge recipe's B=16 train step
                                             ((16, 256, 128, 128), True, True)])
def test_group_norm_act_bwd_kernel_matches_plain(dev, dtype, shape, silu, bias):
    """K2b against the plain formula on the same dy, x and forward statistics;
    the statistics K2 writes against the plain forward's; bit-for-bit repeats.
    The shapes span one wave and several (8 x 128 x 128^2), C = 384 and 512,
    odd H x W, and a tile larger than the chip's shared memory (128 x 768 x
    256, the 48 kHz top level), whose blocks read part of their range twice,
    and a call of the bridge recipe's B=16 train step (16 x 256 x 128^2)."""
    x = _input(shape, dtype, dev) * 2.0 + 0.5
    dy = _input(shape, dtype, dev, seed=3)
    b, c = shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    pre_bias = torch.randn(b, c, generator=g, device=dev).to(dtype) if bias else None
    groups = gn.num_groups_for(c)
    _, stats = gn.group_norm_act_cuda(x, gamma, beta, groups, 1e-6, silu, pre_bias,
                                      return_stats=True)
    _, stats_plain = gn.group_norm_act_plain(x, gamma, beta, groups, 1e-6, silu, pre_bias,
                                             return_stats=True)
    torch.testing.assert_close(stats[..., 0], stats_plain[..., 0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[..., 1], stats_plain[..., 1], rtol=1e-4, atol=1e-6)
    before = gn.group_norm_act_bwd_cuda.launches
    got = gn.group_norm_act_bwd(dy, x, gamma, beta, stats, groups, 1e-6, silu, pre_bias)
    torch.cuda.synchronize()
    assert gn.group_norm_act_bwd_cuda.launches == before + 1
    ref = gn.group_norm_act_bwd_plain(dy, x, gamma, beta, stats, groups, 1e-6, silu, pre_bias)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for name, k, r in zip(("dx", "dgamma", "dbeta", "dpre_bias"), got, ref):
        if r is None:
            assert k is None
            continue
        assert k.shape == r.shape and k.dtype == r.dtype, name
        err = (k.float() - r.float()).abs().max().item()
        assert err <= _grad_tol(r) * r.float().abs().max().item(), (name, err)
    again = gn.group_norm_act_bwd(dy, x, gamma, beta, stats, groups, 1e-6, silu, pre_bias)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_act_bwd_kernel_clamp_matches_plain(dev, dtype):
    """Groups whose variance before the clamp is exactly 0 (f = 1/2) and below
    0 (f = 0) in batch row 0, on odd H x W over several blocks per tile."""
    shape = (2, 128, 65, 63)
    x = _input(shape, dtype, dev)
    dy = _input(shape, dtype, dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(1)
    gamma = 1.0 + 0.1 * torch.randn(128, generator=g, device=dev)
    beta = 0.1 * torch.randn(128, generator=g, device=dev)
    pre_bias = torch.randn(2, 128, generator=g, device=dev).to(dtype)
    groups = gn.num_groups_for(128)
    _, stats = gn.group_norm_act_plain(x, gamma, beta, groups, 1e-6, True, pre_bias,
                                       return_stats=True)
    stats[0, 0, 1], stats[0, 5, 1] = 0.0, -1e-7
    got = gn.group_norm_act_bwd(dy, x, gamma, beta, stats, groups, 1e-6, True, pre_bias)
    ref = gn.group_norm_act_bwd_plain(dy, x, gamma, beta, stats, groups, 1e-6, True, pre_bias)
    for name, k, r in zip(("dx", "dgamma", "dbeta", "dpre_bias"), got, ref):
        err = (k.float() - r.float()).abs().max().item()
        assert err <= _grad_tol(r) * r.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,pair", [((2, 128, 32, 48), 1, True),
                                           ((2, 64, 16, 8), 2, True),
                                           ((2, 4, 64, 64), 1, False),  # pyramid, C = 4
                                           ((2, 4, 8, 8), 2, False),
                                           ((1, 12, 9, 11), 1, True),   # odd sizes
                                           ((1, 8, 7, 5), 2, False),
                                           # the bridge recipe's B=16 train step
                                           ((16, 128, 256, 256), 1, True)])
def test_upfirdn2d_backward_kernel_matches_plain(dev, dtype, shape, up, pair):
    """The K1 adjoint (one launch, a pair launch for a pair) against autograd
    through the plain version, at the resampling of the score network."""
    k = ufd.setup_kernel([1, 3, 3, 1])
    kw = dict(up=2, pad=(2, 1)) if up == 2 else dict(down=2, pad=(1, 1))
    k = k * 4.0 if up == 2 else k
    xs = [_input(shape, dtype, dev, seed=i).requires_grad_() for i in range(1 + pair)]
    ys = ufd.upfirdn2d_pair(*xs, k, **kw) if pair else (ufd.upfirdn2d(xs[0], k, **kw),)
    dys = [_input(y.shape, dtype, dev, seed=5 + i) for i, y in enumerate(ys)]
    before = (ufd.upfirdn2d_cuda.launches, ufd.upfirdn2d_cuda.adjoint_launches)
    grads = torch.autograd.grad(ys, xs, dys)
    torch.cuda.synchronize()
    assert (ufd.upfirdn2d_cuda.launches, ufd.upfirdn2d_cuda.adjoint_launches) == (
        before[0], before[1] + 1)
    plain = [x.detach().clone().requires_grad_() for x in xs]
    refs = torch.autograd.grad([ufd.upfirdn2d_plain(p, k, **kw) for p in plain], plain, dys)
    for g, r in zip(grads, refs):
        _agree(g, r.contiguous(memory_format=torch.channels_last), dtype)


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,x_shape,c_out", [(False, (2, 4, 24, 40), 16),   # narrow path
                                              (False, (2, 32, 21, 34), 24),  # ragged tiles
                                              (False, (1, 256, 24, 8), 256),
                                              (True, (2, 32, 9, 20), 16),
                                              (True, (1, 256, 12, 4), 256),
                                              (True, (2, 128, 40, 24), 128)])
def test_fir_conv_kernel_matches_plain(dev, dtype, tf32, up, x_shape, c_out):
    """K6 (one launch, with its bias) against the composition of the plain
    version; float32 in TF32 (tolerance 2e-3) and in three TF32 products."""
    if dtype == torch.bfloat16 and tf32:
        pytest.skip("TF32 applies to float32 only")
    x = _input(x_shape, dtype, dev)
    w = (0.1 * _input((c_out, x_shape[1], 3, 3), torch.float32, dev, seed=1)).to(dtype)
    bias = torch.randn(c_out, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    before = ufd.fir_conv_cuda.launches
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        got = ufd.fir_conv(x, w, (1, 3, 3, 1), 2, 1.0, bias, up)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert ufd.fir_conv_cuda.launches == before + 1
    ref = ufd.fir_conv_plain(x, w, (1, 3, 3, 1), 2, 1.0, bias, up)
    assert got.shape == ref.shape and got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= (2e-3 if tf32 else TOL[dtype]) * ref.float().abs().max().item(), err


@pytest.mark.parametrize("up", [False, True])
def test_fir_conv_gradients_match_plain(dev, up):
    """K6's backward (the FIR's adjoint as one K1 launch, cuDNN's gradients,
    the bias sum; down recomputes FIR(x) with one K1 launch) against autograd
    through the plain composition, float32."""
    x = _input((2, 32, 12, 20), torch.float32, dev).requires_grad_()
    w = (0.1 * _input((16, 32, 3, 3), torch.float32, dev, seed=1)).requires_grad_()
    bias = torch.randn(16, device=dev).requires_grad_()
    fn = ufd.upsample_conv_2d if up else ufd.conv_downsample_2d
    y = fn(x, w, k=(1, 3, 3, 1), bias=bias)
    dy = _input(y.shape, torch.float32, dev, seed=3)
    before = (ufd.upfirdn2d_cuda.launches, ufd.upfirdn2d_cuda.adjoint_launches)
    grads = torch.autograd.grad(y, (x, w, bias), dy)
    torch.cuda.synchronize()
    assert (ufd.upfirdn2d_cuda.launches - before[0],
            ufd.upfirdn2d_cuda.adjoint_launches - before[1]) == ((0, 1) if up else (1, 1))
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, bias)]
    ref = ufd.fir_conv_composition(*leaves[:2], (1, 3, 3, 1), 2, 1.0, leaves[2], up)
    refs = torch.autograd.grad(ref, leaves, dy)
    for g, r in zip(grads, refs):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def test_fir_conv_kernel_refuses_what_it_does_not_take(dev):
    x = _input((1, 32, 16, 16), torch.float32, dev)
    w = _input((16, 32, 3, 3), torch.float32, dev)
    with pytest.raises(ValueError):  # a 2-D FIR
        ufd.fir_conv_cuda(x, w, np.ones((4, 4)), 2, 1.0, None, True)
    with pytest.raises(ValueError):  # factor 3
        ufd.fir_conv_cuda(x, w, (1, 3, 3, 1), 3, 1.0, None, True)
    with pytest.raises(ValueError):  # 5x5 weights
        ufd.fir_conv_cuda(x, _input((16, 32, 5, 5), torch.float32, dev), (1, 3, 3, 1), 2, 1.0,
                          None, False)
    with pytest.raises(ValueError):  # C_in of 24 on the up path
        ufd.fir_conv_cuda(_input((1, 24, 8, 8), torch.float32, dev),
                          _input((16, 24, 3, 3), torch.float32, dev), (1, 3, 3, 1), 2, 1.0,
                          None, True)


def test_training_gradients_reach_every_parameter_through_the_kernels(dev):
    """A small network's loss and gradients through the kernels (forward and
    backward) against the plain versions, 1e-3 of max|grad| per leaf; every
    trainable parameter gets a finite, non-zero gradient. The attention key
    bias (``NIN_1.b``), whose exact gradient is zero (softmax invariance), is
    held at rounding level instead."""
    from sgmse_tpu_torch import kernel_times as kt
    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel("ncsnpp", "ouve", nf=16, ch_mult=(1, 1, 2), num_res_blocks=1,
                       attn_resolutions=(16,), image_size=64, init_scale=1.0, n_fft=126)
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).train()
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy((rng.standard_normal((2, 1, 64, 64))
                              + 1j * rng.standard_normal((2, 1, 64, 64))).astype(np.complex64))
            .to(dev) for _ in range(2))
    t = torch.tensor([0.3, 0.7], device=dev)
    z = torch.from_numpy((rng.standard_normal((2, 1, 64, 64))
                          + 1j * rng.standard_normal((2, 1, 64, 64))).astype(np.complex64)
                         / np.sqrt(2)).to(dev)
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    before = gn.group_norm_act_bwd_cuda.launches
    loss = model.step_loss(x, y, t=t, z=z)
    grads = torch.autograd.grad(loss, params)
    assert gn.group_norm_act_bwd_cuda.launches > before
    with kt.routed(plain=True):
        loss_ref = model.step_loss(x, y, t=t, z=z)
        refs = torch.autograd.grad(loss_ref, params)
    assert abs(loss.item() - loss_ref.item()) <= 1e-4 * abs(loss_ref.item())
    scale = max(r.abs().max() for r in refs)
    for name, g, r in zip(names, grads, refs):
        assert torch.isfinite(g).all(), name
        if name.endswith("NIN_1.b"):
            assert max(g.abs().max(), r.abs().max()) <= 1e-6 * scale, name
            continue
        assert g.abs().max() > 0, name
        assert (g - r).abs().max() <= 1e-3 * r.abs().max(), name


def test_first_launches_from_many_threads(dev):
    """A fresh process whose first K1 (pair) and K2 launches come from eight
    threads at once, each on its own stream, in float32 and bfloat16
    (``python -m sgmse_tpu_torch.first_launch``): every result within the
    tolerances of ``chip_smoke.py``'s kernel checks, the counters exact."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.first_launch", "--threads", "8"],
                         cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["launches"] == {"upfirdn2d": 16, "group_norm_act": 16}


def test_bridge_sampler_and_loss_never_block_the_host(dev):
    """The bridge sampler's steps (``ode``, and ``sde`` drawing its noise on the
    card) and an SBVE model's ``step_loss`` make no synchronising call: under
    ``torch.cuda.set_sync_debug_mode("error")`` any would raise. One untimed run
    first builds the kernels and fills the allocator."""
    from sgmse_tpu_torch import sampling, sdes
    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel("ncsnpp_v2", "sbve", nf=16, ch_mult=(1, 1, 2), num_res_blocks=1,
                       attn_resolutions=(16,), image_size=64, init_scale=1.0, n_fft=126,
                       hop_length=32, loss_type="data_prediction")
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).train()
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y = (sdes.crandn((2, 1, 64, 64), gen) for _ in range(2))
    x0 = x[:1].expand(3, -1, -1, -1)
    sde = sdes.SBVESDE(N=6)

    def model_fn(xt, yt, t):
        return x0 + 0.1 * t[:, None, None, None] * (xt - yt)

    def run():
        loss = model.step_loss(x, y, gen)
        outs = [sampling.sb_sampler(sde, model_fn, y[:1].expand(3, -1, -1, -1), gen,
                                    sampler_type=s)[0] for s in ("ode", "sde")]
        return loss, outs

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, outs = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss) and all(torch.isfinite(o).all() for o in outs)


def test_long_path_replays_the_network_from_cuda_graphs(dev):
    """Inside ``enhance_long`` the network's evaluations are replayed from one
    CUDA graph per chunk shape: the output equals ``enhance``'s plain
    evaluations bit for bit (the same kernels), three chunks capture once, and
    weights loaded in place are seen by the replay."""
    from sgmse_tpu_torch import model as port_model
    from sgmse_tpu_torch.model import ScoreModel

    net = dict(nf=16, ch_mult=(1, 2, 2), num_res_blocks=1, fir_kernel=(1, 3, 3, 1),
               precision="bfloat16")
    model = ScoreModel("ncsnpp_48k", "ouve", sr=16000, n_fft=62, hop_length=16, N=3, **net)
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    y = np.random.default_rng(0).standard_normal(2300).astype(np.float32) * 0.3
    kw = dict(N=3, pad_mode="reflection")

    def plain(seg, seed):
        return model.enhance(seg, generator=torch.Generator(device=dev).manual_seed(seed), **kw)

    def graphed(seg, seed, seconds):
        return model.enhance_long(seg, chunk_seconds=seconds, overlap=0.1,
                                  generator=torch.Generator(device=dev).manual_seed(seed), **kw)

    seg = y[:960]
    np.testing.assert_array_equal(graphed(seg, 1, 0.06), plain(seg, 1))
    assert len(port_model._GRAPHS[model]) == 1
    first = graphed(y, 2, 0.06)  # three chunks of 960 samples, one shape
    assert len(port_model._GRAPHS[model]) == 1 and np.isfinite(first).all()
    np.testing.assert_array_equal(graphed(y, 2, 0.06), first)
    other = ScoreModel("ncsnpp_48k", "ouve", sr=16000, n_fft=62, hop_length=16, N=3, **net)
    other.init_params(torch.Generator().manual_seed(1))
    model.dnn.load_state_dict(other.dnn.state_dict())  # copied into the same storage
    np.testing.assert_array_equal(graphed(seg, 1, 0.06), plain(seg, 1))
    assert len(port_model._GRAPHS[model]) == 1


@pytest.mark.parametrize("biases", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (1, 256, 3, 3), (16, 128, 256, 192),
                                   (16, 128, 256, 512), (16, 256, 64, 128), (1, 128, 768, 512),
                                   # the general path: C off the 16-byte vector, past 256 of them
                                   (2, 4, 5, 7), (1, 12, 3, 5), (1, 2056, 2, 3)])
def test_residual_merge_kernel_matches_plain(dev, shape, dtype, biases):
    h, skip = _input(shape, dtype, dev, seed=0), _input(shape, dtype, dev, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    bias, skip_bias = (0.1 * torch.randn(shape[1], generator=g, device=dev) if on else None
                       for on in biases)
    for scale in (2.0**-0.5, 1.0):
        target = h.clone()
        before = rm.residual_merge_cuda.launches
        got = rm.residual_merge(target, skip, scale, bias, skip_bias)
        torch.cuda.synchronize()
        assert got is target and rm.residual_merge_cuda.launches == before + 1
        assert torch.equal(got, rm.residual_merge_plain(h.clone(), skip, scale, bias, skip_bias))


def test_residual_merge_kernel_refuses_what_it_does_not_take(dev):
    h = _input((1, 16, 4, 4), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="channels_last"):
        rm.residual_merge(h, h.contiguous())
    with pytest.raises(ValueError, match="distinct"):
        rm.residual_merge(h, h)
    with pytest.raises(ValueError, match="shape, dtype"):
        rm.residual_merge(h, _input((1, 16, 4, 4), torch.float32, dev))
    with pytest.raises(ValueError, match="bias"):
        rm.residual_merge(h, _input((1, 16, 4, 4), torch.bfloat16, dev, seed=1),
                          bias=torch.zeros(16, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_merge_kernel_takes_unaligned_tensors(dev, dtype):
    """channels_last views one element past a 16-byte boundary take the
    general path, bit for bit against plain."""
    b, c, hh, w = 2, 16, 5, 3

    def unaligned(seed):
        flat = torch.randn(b * c * hh * w + 1, generator=torch.Generator().manual_seed(seed))
        t = flat.to(dev, dtype)[1:].view(b, hh, w, c).permute(0, 3, 1, 2)
        assert t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16
        return t

    h, skip = unaligned(0), unaligned(1)
    bias = torch.linspace(-0.5, 0.5, c, device=dev)
    want = rm.residual_merge_plain(h.clone(memory_format=torch.channels_last), skip, 2.0**-0.5,
                                   bias, bias.flip(0))
    got = rm.residual_merge(h, skip, 2.0**-0.5, bias, bias.flip(0))
    torch.cuda.synchronize()
    assert got is h and torch.equal(got, want)


# Small networks on the folded path: the flagship (BigGAN blocks, attention, a sum-combined
# input pyramid), and the residual pyramids with BigGAN blocks and FIR (K6 in the pyramids)
# or with DDPM blocks, no FIR and elu.
FOLDED_NETS = {
    "flagship": dict(progressive_combine="sum"),
    "fir_residual": dict(progressive="residual", progressive_input="residual"),
    "ddpm_residual": dict(resblock_type="ddpm", progressive="residual",
                          progressive_input="residual", fir=False, nonlinearity="elu"),
}


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", sorted(FOLDED_NETS))
def test_folded_network_matches_autograd_mode(dev, net, precision):
    """A small network with non-zero biases, evaluated where no gradient is
    recorded (its biases folded into K2's pre-bias and K8; one K8 launch per
    res-block, attention block, sum Combine and residual pyramid merge),
    against the same evaluation with autograd on: float32 within 1e-4 of
    max|out| (cuDNN's convolutions with and without a bias may sum in another
    order), bfloat16 within 5e-2, the repo's NCSN++ bf16 bound (the unfolded
    path rounds each bias add, the sum and the scale, and the roundings
    compound over the network's depth: 0.013-0.021 on the CPU over three
    draws of the flagship)."""
    from sgmse_tpu_torch.model import ScoreModel
    from sgmse_tpu_torch.models import blocks as pb

    model = ScoreModel("ncsnpp", "ouve", nf=16, ch_mult=(1, 1, 2), num_res_blocks=1,
                       attn_resolutions=(16,), image_size=64, init_scale=1.0, n_fft=126,
                       precision=precision, **FOLDED_NETS[net])
    model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1 and p.requires_grad:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    merges = sum(isinstance(m, (pb.ResnetBlockBigGANpp, pb.ResnetBlockDDPMpp, pb.AttnBlockpp))
                 or (isinstance(m, pb.Combine) and m.method == "sum") for m in model.modules())
    if "residual" in net:  # a merge at each pyramid level but the last, down and up
        merges += 2 * (len(model.dnn.ch_mult) - 1)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy((rng.standard_normal((2, 1, 64, 64))
                              + 1j * rng.standard_normal((2, 1, 64, 64))).astype(np.complex64))
            .to(dev) for _ in range(2))
    t = torch.tensor([0.3, 0.7], device=dev)
    with torch.enable_grad():
        ref = torch.view_as_real(model(x, y, t).detach())
    before = rm.residual_merge_cuda.launches
    with torch.inference_mode():
        got = torch.view_as_real(model(x, y, t))
    torch.cuda.synchronize()
    assert rm.residual_merge_cuda.launches == before + merges
    tol = 1e-4 if precision == "float32" else 5e-2
    assert (got - ref).abs().max() <= tol * ref.abs().max()
