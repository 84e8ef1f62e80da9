"""GroupNorm with an optional bias added first and an optional SiLU after.

Counterpart of the JAX package's ``blocks.group_norm`` (flax ``nn.GroupNorm``
with min(C//4, 32) groups and eps 1e-6, ``sgmse_tpu/models/blocks.py:157-167``)
followed by ``jax.nn.silu``. With ``pre_bias`` it also takes in the res-block's
time-embedding add before ``GroupNorm_1`` (``blocks.py:416-421``):
y = act(GN(x + pre_bias[:, :, None, None])), with ``pre_bias`` (B, C) in x's
dtype (the Dense_0 output as it is, so no cast runs).

Arithmetic, for both versions below: ``pre_bias`` is added to x in float32
(flax adds in the compute dtype, so in bfloat16 it rounds the sum once more),
the statistics are float32 whatever the input dtype, the variance is
E[x^2] - E[x]^2 clamped at 0 (flax 0.12's ``use_fast_variance``), and
y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, followed by x * sigmoid(x)
when ``silu`` is set, all in float32 and rounded once to the input dtype. The
plain version takes the means with torch's float32 reductions; the kernel sums
in float32 per block of pixels and combines the blocks in float64, in a fixed
order, so its results repeat bit for bit. Against flax in float32 the two agree
to about 1e-6 relative for inputs whose mean is not large against their spread
(the E[x^2] - E[x]^2 form loses digits as mean^2/var grows); in bfloat16 they
differ from flax by up to two bf16 rounding steps, because flax rounds the
normalised value to bf16 before the SiLU and the port rounds once after it.

:func:`group_norm_act` dispatches on the device of its input: a CPU tensor goes
through :func:`group_norm_act_plain`, a CUDA tensor through the hand-written
kernel ``csrc/group_norm_act.cu`` (:func:`group_norm_act_cuda`, one launch per
call), which raises on anything it does not take. The note at the top of the
``.cu`` file says what bounds the kernel on the H100 and what the design does
about it.

Gradients. When an input requires grad, the dispatcher runs as a
``torch.autograd.Function``: the forward also writes each (batch, group)'s
float32 (mean, variance before the clamp) to a (B, G, 2) buffer (K2 writes it
from the statistics it computes anyway; at inference no buffer is made), and
the backward is :func:`group_norm_act_bwd`: the hand-written kernel
``csrc/group_norm_act_bwd.cu`` (K2b, :func:`group_norm_act_bwd_cuda`) on the
card, the explicit formula :func:`group_norm_act_bwd_plain` on the CPU. With
u = x + pre_bias, x^ = (u - mean) * rstd, v = gamma * x^ + beta, s = sigmoid(v),
dv = dy * s * (1 + v * (1 - s)) (dv = dy without SiLU) and g = gamma * dv:

    dgamma = sum_{b,hw} dv * x^,  dbeta = sum_{b,hw} dv,
    du = rstd * (g - mean_grp(g) - f * x^ * mean_grp(g * x^)),
    dx = du,  dpre_bias[b, c] = sum_hw du,

where f is 1 where the variance is above 0, 0 where the clamp at 0 is active
and 1/2 where it is exactly 0 (JAX's derivative of ``maximum``), so that the
gradient is the one JAX's autodiff of the same forward gives. dx and
dpre_bias come back in x's dtype, dgamma and dbeta in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import kernels


def num_groups_for(channels: int) -> int:
    """The NCSN++ group count: min(C // 4, 32)."""
    return min(channels // 4, 32)


def _stats_plain(x: torch.Tensor, num_groups: int, pre_bias: Optional[torch.Tensor]):
    """(u grouped as (B, G, C//G, H*W) float32, mean, variance before the clamp),
    the statistics as (B, G, 1, 1)."""
    b, c, h, w = x.shape
    xf = x.float()
    if pre_bias is not None:
        xf = xf + pre_bias.float()[:, :, None, None]
    ug = xf.reshape(b, num_groups, c // num_groups, h * w)
    mean = ug.mean(dim=(2, 3), keepdim=True)
    mean2 = (ug * ug).mean(dim=(2, 3), keepdim=True)
    return ug, mean, mean2 - mean * mean


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float = 1e-6, silu: bool = True,
                         pre_bias: Optional[torch.Tensor] = None, return_stats: bool = False):
    """Plain PyTorch GroupNorm (+ SiLU) on (B, C, H, W), after adding the
    (B, C) ``pre_bias`` if given; result in x's dtype and channels_last memory.
    With ``return_stats``, also the float32 (B, G, 2) (mean, unclamped
    variance) that :func:`group_norm_act_bwd_plain` takes."""
    b, c, h, w = x.shape
    cg = c // num_groups
    ug, mean, var_raw = _stats_plain(x, num_groups, pre_bias)
    mul = torch.rsqrt(var_raw.clamp_min(0.0) + eps) * gamma.float().reshape(1, num_groups, cg, 1)
    y = (ug - mean) * mul + beta.float().reshape(1, num_groups, cg, 1)
    y = y.reshape(b, c, h, w)
    if silu:
        y = F.silu(y)
    y = y.to(x.dtype).contiguous(memory_format=torch.channels_last)
    if return_stats:
        return y, torch.stack([mean.reshape(b, num_groups), var_raw.reshape(b, num_groups)], -1)
    return y


def group_norm_act_bwd_plain(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, stats: torch.Tensor, num_groups: int,
                             eps: float = 1e-6, silu: bool = True,
                             pre_bias: Optional[torch.Tensor] = None):
    """The plain version of K2b: the gradients (dx, dgamma, dbeta, dpre_bias)
    of :func:`group_norm_act` from dy and the forward's ``stats``, by the
    explicit formula of the module docstring, in float32; dpre_bias is None
    without a pre-bias."""
    b, c, h, w = x.shape
    cg = c // num_groups
    ug, _, _ = _stats_plain(x, num_groups, pre_bias)
    mean = stats[..., 0].float().reshape(b, num_groups, 1, 1)
    var_raw = stats[..., 1].float().reshape(b, num_groups, 1, 1)
    rstd = torch.rsqrt(var_raw.clamp_min(0.0) + eps)
    xhat = (ug - mean) * rstd
    gam = gamma.float().reshape(1, num_groups, cg, 1)
    dv = dy.float().reshape(b, num_groups, cg, h * w)
    if silu:
        v = xhat * gam + beta.float().reshape(1, num_groups, cg, 1)
        s = torch.sigmoid(v)
        dv = dv * s * (1.0 + v * (1.0 - s))
    dgamma = (dv * xhat).sum(dim=(0, 3)).reshape(c)
    dbeta = dv.sum(dim=(0, 3)).reshape(c)
    g = gam * dv
    f = torch.where(var_raw > 0, 1.0, torch.where(var_raw == 0, 0.5, 0.0))
    du = rstd * (g - g.mean(dim=(2, 3), keepdim=True)
                 - f * xhat * (g * xhat).mean(dim=(2, 3), keepdim=True))
    dx = du.reshape(b, c, h, w).to(x.dtype).contiguous(memory_format=torch.channels_last)
    dpre_bias = None if pre_bias is None else du.sum(dim=3).reshape(b, c).to(pre_bias.dtype)
    return dx, dgamma, dbeta, dpre_bias


def _check_cuda_args(what: str, x: torch.Tensor, gamma, beta, num_groups, pre_bias,
                     tensors=()):
    """Raise on anything the kernels do not take (shared by K2 and K2b)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    b, c = x.shape[:2]
    for name, t in (("x", x), *tensors):
        if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{what}: {name} must be a 4-D tensor in channels_last memory")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} must have x's shape, dtype and device")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    vec = 16 // x.element_size()
    if c % vec or c // vec > 512 or c % num_groups:
        raise ValueError(f"{what}: unsupported C={c}, groups={num_groups} for {x.dtype}")
    params = [("gamma", gamma, (c,), torch.float32), ("beta", beta, (c,), torch.float32)]
    if pre_bias is not None:
        params.append(("pre_bias", pre_bias, (b, c), x.dtype))
    for name, p, shape, dtype in params:
        if (p.device != x.device or p.dtype != dtype or tuple(p.shape) != shape
                or not p.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {shape} tensor on "
                             f"{x.device}")


def group_norm_act_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        num_groups: int, eps: float = 1e-6, silu: bool = True,
                        pre_bias: Optional[torch.Tensor] = None, return_stats: bool = False):
    """Launch the hand-written kernel once. Takes a CUDA tensor (B, C, H, W) in
    channels_last memory, float32 or bfloat16, with C a multiple of the 16-byte
    vector (4 float32 or 8 bfloat16 channels), at most 512 such vectors, and a
    multiple of num_groups; float32 gamma and beta of shape (C,); and an optional
    ``pre_bias`` of shape (B, C) in x's dtype. Raises on anything else. With
    ``return_stats`` the same launch also writes the (B, G, 2) statistics."""
    _check_cuda_args("group_norm_act_cuda", x, gamma, beta, num_groups, pre_bias)
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = (torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
             if return_stats else None)
    # Scratch for the per-block partial sums: at most one block per SM.
    blocks = max(b, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((blocks, num_groups, 2), dtype=torch.float32, device=x.device)
    err = kernels.lib().sgmse_group_norm_act(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if pre_bias is None else pre_bias.data_ptr(),
        None if stats is None else stats.data_ptr(), partial.data_ptr(), blocks,
        b, h * w, c, num_groups, eps, int(silu), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "group_norm_act kernel")
    kernels.count_launch(group_norm_act_cuda)
    return (y, stats) if return_stats else y


group_norm_act_cuda.launches = 0


BWD_THREADS = 512            # K2b's threads per block (kThreads in the .cu)
BWD_SMEM_LIMIT = 232_448     # the H100's dynamic shared memory per block, opted in
BWD_MIN_BLOCK_BYTES = 64 * 1024  # a tile's x + dy is spread over blocks down to this
BWD_PREFETCH_BYTES = 12 * 2**20  # of the next wave's x + dy asked of L2 during a wave
BWD_L2_TAIL_BYTES = 12 * 2**20   # of a wave's x + dy beyond shared memory, read twice


class BwdPlan(NamedTuple):
    """How K2b covers a call: tiles of (batch row, band of ``band`` channels)
    over all HW pixels; ``nbt`` blocks per tile, each with ``ppb`` pixels of
    which ``stage_pix`` are held in shared memory and ``pf_pix`` of the next
    wave's range are prefetched into L2; ``tpw`` tiles per wave, in ``waves``
    waves; ``grid`` = tpw * nbt blocks of ``smem`` bytes each."""
    band: int
    nbt: int
    ppb: int
    stage_pix: int
    pf_pix: int
    tpw: int
    waves: int
    grid: int
    smem: int


def bwd_smem_bytes(stage_pix: int, band: int, groups_per_band: int, element_size: int) -> int:
    """A K2b block's dynamic shared memory, laid out as ``smem_bytes`` in the
    .cu reckons it: x and dy of the staged pixels, the reduction slots (a
    float4 per warp, or per pixel row where a row spans warps, and channel),
    the sums, the group coefficients, gamma, the groups' variances and a flag."""
    lanes = band * element_size // 16
    stride = -(-lanes // 32) * 32 if lanes > 32 else 1 << (lanes - 1).bit_length()
    rows = BWD_THREADS // 32 if stride <= 32 else BWD_THREADS // stride
    return (2 * stage_pix * band * element_size + rows * band * 16 + band * 16
            + groups_per_band * 16 + band * 4 + groups_per_band * 4 + 4)


def bwd_band(c: int, groups: int, element_size: int) -> int:
    """The narrowest run of whole groups that is whole 16-byte vectors and at
    least 128 bytes (a cache line per pixel), with the bands dividing C; C
    itself where no such run exists."""
    cpg, vec = c // groups, 16 // element_size
    for k in range(1, groups + 1):
        band = k * cpg
        if groups % k == 0 and band % vec == 0 and band * element_size >= 128:
            return band
    return c


def bwd_plan(b: int, hw: int, c: int, groups: int, element_size: int, sms: int,
             smem_limit: int = BWD_SMEM_LIMIT) -> BwdPlan:
    """K2b's plan for x of (b, c, hw) on a card of ``sms`` SMs (one block per
    SM at most). A wave holds as many tiles as the SMs' shared memory plus
    BWD_L2_TAIL_BYTES take (evened out over the waves; one at least); each
    tile is spread over the wave's share of the SMs, down to
    BWD_MIN_BLOCK_BYTES of x + dy a block. What of a block's range does not fit
    its shared memory (the tail) is read twice, the second time from L2 where
    it is still there. Raises if a band is wider than a block's threads."""
    band = bwd_band(c, groups, element_size)
    if band > BWD_THREADS:
        raise ValueError(f"group_norm_act_bwd: a band of {band} channels (C={c}, "
                         f"groups={groups}) is wider than {BWD_THREADS}")
    gpb = band // (c // groups)
    pix_bytes = 2 * band * element_size
    pmax = (smem_limit - bwd_smem_bytes(0, band, gpb, element_size)) // pix_bytes
    tiles = b * (c // band)
    tile_bytes = hw * pix_bytes
    fit = (sms * pmax * pix_bytes + BWD_L2_TAIL_BYTES) // tile_bytes
    for tpw in range(max(1, min(tiles, fit, sms)), 0, -1):
        tpw = -(-tiles // -(-tiles // tpw))  # the same waves, evened out
        nbt = max(1, min(sms // tpw, -(-tile_bytes // BWD_MIN_BLOCK_BYTES), hw))
        ppb = -(-hw // nbt)
        nbt = -(-hw // ppb)
        stage_pix = min(ppb, pmax)
        if tpw * nbt * (ppb - stage_pix) * pix_bytes <= BWD_L2_TAIL_BYTES:
            break  # else fewer tiles a wave, down to one
    pf_pix = min(stage_pix, BWD_PREFETCH_BYTES // (tpw * nbt * pix_bytes))
    return BwdPlan(band=band, nbt=nbt, ppb=ppb, stage_pix=stage_pix, pf_pix=pf_pix, tpw=tpw,
                   waves=-(-tiles // tpw), grid=tpw * nbt,
                   smem=bwd_smem_bytes(stage_pix, band, gpb, element_size))


def group_norm_act_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, stats: torch.Tensor, num_groups: int,
                            eps: float = 1e-6, silu: bool = True,
                            pre_bias: Optional[torch.Tensor] = None):
    """Launch K2b once (one cooperative kernel, planned by :func:`bwd_plan`):
    the gradients of :func:`group_norm_act_bwd_plain`. dy and x: CUDA
    (B, C, H, W), channels_last, one dtype (float32 or bfloat16), the forward's
    constraints on C; stats the forward's float32 (B, G, 2). Raises on anything
    else."""
    _check_cuda_args("group_norm_act_bwd_cuda", x, gamma, beta, num_groups, pre_bias,
                     tensors=(("dy", dy),))
    b, c, h, w = x.shape
    if (stats.device != x.device or stats.dtype != torch.float32
            or tuple(stats.shape) != (b, num_groups, 2) or not stats.is_contiguous()):
        raise ValueError(f"group_norm_act_bwd_cuda: stats must be a contiguous float32 "
                         f"({b}, {num_groups}, 2) tensor on {x.device}")
    props = torch.cuda.get_device_properties(x.device)
    plan = bwd_plan(b, h * w, c, num_groups, x.element_size(), props.multi_processor_count,
                    getattr(props, "shared_memory_per_block_optin", BWD_SMEM_LIMIT))
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    dpre_bias = None if pre_bias is None else torch.empty_like(pre_bias)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((plan.grid, plan.band, 4), **f32)
    rowsum = torch.empty((b, c, 4), **f32)
    coefs = torch.empty((plan.waves, plan.tpw, plan.band * num_groups // c, 4), **f32)
    sync = torch.empty((plan.waves, plan.tpw, 64), dtype=torch.int32, device=x.device)
    err = kernels.lib().sgmse_group_norm_act_bwd(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if pre_bias is None else pre_bias.data_ptr(), stats.data_ptr(),
        None if dpre_bias is None else dpre_bias.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), partial.data_ptr(), rowsum.data_ptr(), coefs.data_ptr(),
        sync.data_ptr(), b, h * w, c, num_groups,
        plan.band, plan.nbt, plan.ppb, plan.stage_pix, plan.pf_pix, plan.tpw, plan.waves, eps,
        int(silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "group_norm_act_bwd kernel")
    kernels.count_launch(group_norm_act_bwd_cuda)
    return dx, dgamma, dbeta, dpre_bias


group_norm_act_bwd_cuda.launches = 0


def group_norm_act_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, stats: torch.Tensor, num_groups: int,
                       eps: float = 1e-6, silu: bool = True,
                       pre_bias: Optional[torch.Tensor] = None):
    """Gradients of :func:`group_norm_act`: K2b on the card, the plain formula
    on the CPU."""
    args = (dy, x, gamma, beta, stats, num_groups, eps, silu, pre_bias)
    if x.device.type == "cuda":
        return group_norm_act_bwd_cuda(*args)
    if x.device.type == "cpu":
        return group_norm_act_bwd_plain(*args)
    raise ValueError(f"group_norm_act_bwd: unsupported device {x.device}")


def _forward(x, gamma, beta, num_groups, eps, silu, pre_bias, return_stats=False):
    """K2 on the card, the plain version on the CPU. No autograd."""
    args = (x, gamma, beta, num_groups, eps, silu, pre_bias, return_stats)
    if x.device.type == "cuda":
        return group_norm_act_cuda(*args)
    if x.device.type == "cpu":
        return group_norm_act_plain(*args)
    raise ValueError(f"group_norm_act: unsupported device {x.device}")


class _GroupNormAct(torch.autograd.Function):
    """group_norm_act with :func:`group_norm_act_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, pre_bias, num_groups, eps, silu):
        y, stats = _forward(x, gamma, beta, num_groups, eps, silu, pre_bias, return_stats=True)
        ctx.save_for_backward(x, gamma, beta, pre_bias, stats)
        ctx.num_groups, ctx.eps, ctx.silu = num_groups, eps, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, pre_bias, stats = ctx.saved_tensors
        dx, dgamma, dbeta, dpre_bias = group_norm_act_bwd(
            dy.contiguous(memory_format=torch.channels_last), x, gamma, beta, stats,
            ctx.num_groups, ctx.eps, ctx.silu, pre_bias)
        return dx, dgamma, dbeta, dpre_bias, None, None, None


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float = 1e-6, silu: bool = True,
                   pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over `num_groups` groups of x + pre_bias, then SiLU if `silu`;
    differentiable in x, gamma, beta and pre_bias."""
    tensors = (x, gamma, beta) + (() if pre_bias is None else (pre_bias,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GroupNormAct.apply(x, gamma, beta, pre_bias, num_groups, eps, silu)
    return _forward(x, gamma, beta, num_groups, eps, silu, pre_bias)
