"""The measurement helpers of sgmse_tpu_torch.kernel_times, on the CPU.

- The library yardsticks that chip_smoke.py and kernel_times time beside the
  kernels (depthwise F.conv2d / F.conv_transpose2d for upfirdn2d, F.group_norm
  for group_norm_act) compute the same function as the plain versions, and
  those agree with the JAX package's resampling. Tolerance: 1e-5 of max|ref|
  (float32 sums in another order).
- The dispatcher recorder sees every kernel call of a forward at the small test
  config, with the pair launches and the temb pre-bias, and leaves the output
  as it was.
- K8's yardstick (the ops it replaces: each bias's add, the sum, the scale,
  each rounded) against its plain version: 1e-6 of max|ref| in float32 (a
  division against a multiplication), two bf16 steps in bfloat16.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgmse_tpu.ops import upfirdn2d as jufd
from sgmse_tpu_torch import kernel_times as kt
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.models.blocks import AttnBlockpp, GroupNorm, ResnetBlockBigGANpp
from sgmse_tpu_torch.ops import upfirdn2d as ufd

CPU = torch.device("cpu")
UP_TAPS = tuple(float(v) for v in (ufd.setup_kernel([1, 3, 3, 1]) * 4).ravel())
DOWN_TAPS = tuple(float(v) for v in ufd.setup_kernel([1, 3, 3, 1]).ravel())


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("sig", [
    ((2, 16, 8, 12), 1, 2, (1, 1), DOWN_TAPS, 1),
    ((2, 16, 6, 10), 2, 1, (2, 1), UP_TAPS, 1),
    ((1, 8, 8, 8), 1, 2, (1, 1), DOWN_TAPS, 2),
    ((1, 8, 4, 6), 2, 1, (2, 1), UP_TAPS, 2),
    ((2, 16, 13, 11), 1, 1, (1, 1), UP_TAPS, 1),  # K6 up's FIR pass
    ((2, 16, 12, 10), 1, 1, (2, 2), DOWN_TAPS, 1),  # K6 down's
])
def test_upfirdn2d_library_yardstick_matches_plain(sig):
    shape, up, down, pad, _, n = sig
    case = kt.make_case("upfirdn2d", sig, torch.float32, CPU, torch.Generator().manual_seed(0))
    lib, ref = case["library"](), case["library_ref"]()
    assert len(lib) == len(ref) == n
    for got, want in zip(lib, ref):
        _close(got, want)
    oh, ow = ref[0].shape[2:]
    assert (oh, ow) == ((shape[2] * up + sum(pad) - 4) // down + 1,
                        (shape[3] * up + sum(pad) - 4) // down + 1)
    assert case["bytes"] == n * (np.prod(shape) + shape[0] * shape[1] * oh * ow) * 4
    assert case["ops"] == n * shape[0] * shape[1] * oh * ow * (16 // up**2) * 2
    assert case["bound_by"] == "bytes" and case["bound_ms"] > 0


@pytest.mark.parametrize("kind,c_in", [("up", 16), ("down", 16), ("down", 4)])
def test_k6_library_yardstick_matches_plain(kind, c_in):
    """K6's yardstick, one convolution with the FIR folded into 6x6 weights and
    the bias, computes the plain composition's function; its bytes are the
    input, output, weights and bias, its operations the convolution's and the
    separable FIR's (8 MACs an output); its planted FIR fault misses the plain
    version by far more than K6's limit."""
    sig = (kind, (2, c_in, 10, 6), (8, c_in, 3, 3), (1.0, 3.0, 3.0, 1.0), 2, 1.0, True)
    case = kt.make_case("fir_conv", sig, torch.float32, CPU, torch.Generator().manual_seed(0))
    ref = case["library_ref"]()
    _close(case["library"](), ref)
    out = ref.shape
    assert out == ((2, 8, 20, 12) if kind == "up" else (2, 8, 5, 3))
    assert case["bytes"] == (2 * c_in * 60 + int(np.prod(out)) + 8 * c_in * 9) * 4 + 8 * 4
    conv = 2 * (2 * c_in * 60 if kind == "up" else int(np.prod(out)) * c_in) * 9 * (
        8 if kind == "up" else 1)
    fir = 2 * 8 * (int(np.prod(out)) if kind == "up" else 2 * c_in * 11 * 7)
    assert case["ops"] == conv + fir and case["bound_ms"] > 0
    fault = case["faults"]["tap_dropped"]()
    assert (fault - ref).abs().max() > 2 * kt.K6_TOL * ref.abs().max()


def test_plain_resampling_is_the_jax_resampling():
    """What the yardsticks are held to is the JAX package's upsample/downsample."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
    for fn in ("upsample_2d", "downsample_2d"):
        got = getattr(ufd, fn)(torch.from_numpy(x).permute(0, 3, 1, 2), [1, 3, 3, 1])
        _close(got.permute(0, 2, 3, 1).numpy(), getattr(jufd, fn)(jnp.asarray(x), [1, 3, 3, 1]))


@pytest.mark.parametrize("silu,bias", [(False, False), (True, True)])
def test_group_norm_library_yardstick_matches_plain(silu, bias):
    sig = ((2, 32, 8, 6), 8, 1e-6, silu, bias)
    case = kt.make_case("group_norm_act", sig, torch.float32, CPU,
                        torch.Generator().manual_seed(1))
    _close(case["library"](), case["library_ref"]())
    assert case["library_same_function"] == (not silu and not bias)
    assert case["bytes"] == 2 * 2 * 32 * 48 * 4 + 2 * 32 * 4 + (2 * 32 * 4 if bias else 0)  # f32


def test_recorder_sees_every_kernel_call_of_a_forward():
    small = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,),
                 image_size=64, init_scale=1.0, n_fft=126)
    score_model = ScoreModel("ncsnpp", "ouve", **small)
    score_model.init_params(torch.Generator().manual_seed(0))
    model = score_model.dnn.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy((rng.standard_normal((2, 1, 64, 64))
                              + 1j * rng.standard_normal((2, 1, 64, 64))).astype(np.complex64))
            for _ in range(2))
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        want = model(x, y, t)
        with kt.routed(calls=[], plain=True) as calls:
            got = model(x, y, t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    counts = kt.per_forward(calls)
    mods = list(model.modules())
    resblocks = [m for m in mods if isinstance(m, ResnetBlockBigGANpp)]
    n_levels = len(small["ch_mult"])
    gn_calls = [s for (n, s), c in counts.items() for _ in range(c) if n == "group_norm_act"]
    ufd_calls = [s for (n, s), c in counts.items() for _ in range(c) if n == "upfirdn2d"]
    assert len(gn_calls) == sum(isinstance(m, GroupNorm) for m in mods)
    assert sum(s[4] for s in gn_calls) == len(resblocks)  # one temb pre-bias per block
    assert sum(not s[3] for s in gn_calls) == sum(isinstance(m, AttnBlockpp) for m in mods)
    assert sum(s[-1] == 2 for s in ufd_calls) == sum(m.up or m.down for m in resblocks)
    assert sum(s[-1] == 1 for s in ufd_calls) == 2 * (n_levels - 1)  # the two pyramids


def test_per_nfe_sums_each_signature_times_its_calls():
    rows = [dict(name="group_norm_act", per_forward=3, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                 library_ms=4.0, bytes=10, ops=1),
            dict(name="group_norm_act", per_forward=2, ms=0.5, plain_ms=1.0, bound_ms=0.25,
                 library_ms=None, bytes=10, ops=1),
            dict(name="upfirdn2d", per_forward=1, ms=0.1, plain_ms=0.2, bound_ms=0.05,
                 library_ms=0.3, bytes=1, ops=10**9)]
    sums = kt.per_nfe(rows)
    gn = sums["group_norm_act"]
    assert gn["launches_per_nfe"] == 5 and gn["ms"] == 4.0 and gn["plain_ms"] == 8.0
    assert gn["bound_ms"] == 2.0 and gn["library_ms"] is None and gn["bound_by"] == "bytes"
    up = sums["upfirdn2d"]
    assert up["library_ms"] == 0.3 and up["bound_by"] == "operations"


@pytest.mark.parametrize("backbone,f_bins,per_forward,silu_split,pre_bias", [
    ("ncsnpp", 256, {"upfirdn2d": 24, "group_norm_act": 109, "residual_merge": 59}, [105, 4],
     49),
    ("ncsnpp_v2", 256, {"upfirdn2d": 24, "group_norm_act": 109, "residual_merge": 59},
     [105, 4], 49),
    ("ncsnpp_48k", 768, {"upfirdn2d": 12, "group_norm_act": 100, "residual_merge": 50},
     [99, 1], 49),
    ("48k_residual", 768, {"upfirdn2d": 12, "fir_conv": 12, "group_norm_act": 101,
                           "residual_merge": 62}, [100, 1], 49),
    ("ncsnpp_variant", 256, {"upfirdn2d": 0, "group_norm_act": 85, "residual_merge": 41},
     [0, 85], 37),
    ("learn_demo", 256, {"upfirdn2d": 12, "group_norm_act": 45, "residual_merge": 24}, [44, 1],
     20),
    ("demo_48k", 768, {"upfirdn2d": 6, "group_norm_act": 42, "residual_merge": 21}, [41, 1], 20),
])
def test_kernel_calls_per_forward_of_each_backbone(backbone, f_bins, per_forward, silu_split,
                                                   pre_bias):
    """At full depth (narrow, short): the calls chip_smoke.py expects per network
    evaluation. The 48 kHz net has no pyramids (res-block pairs only) and keeps
    the middle block's attention, whose norm has no SiLU; with residual
    pyramids (``kt.VARIANTS``) it adds 12 K6 calls (``fir_conv``, one kernel
    launch each: 6 down, 6 up, each with its bias) and the top pyramid norm.
    The ``ncsnpp`` variant (DDPM blocks, no FIR, elu) calls no K1, and K2
    always without SiLU. K8 (``residual_merge``) merges each res-block and
    attention block, each sum Combine and each residual pyramid level. The
    learn demos' nets (nf 32, four levels of one
    res-block) make a quarter of the res-block pairs' calls, the 16 kHz one
    with its pyramids."""
    backbone, settings = kt.VARIANTS.get(backbone, (backbone, {}))
    model = ScoreModel(backbone, "ouve", init_scale=1.0, **dict(dict(nf=8), **settings))
    model = model.dnn.eval()
    x = torch.zeros(1, 1, f_bins, 64, dtype=torch.complex64)
    with torch.inference_mode(), kt.routed(calls=[], plain=True) as calls:
        model(x, x, torch.full((1,), 0.5))
    assert {k: sum(1 for n, _ in calls if n == k) for k in per_forward} == per_forward
    gn_sigs = [s for n, s in calls if n == "group_norm_act"]
    assert [sum(1 for s in gn_sigs if s[3] == flag) for flag in (True, False)] == silu_split
    assert sum(1 for s in gn_sigs if s[4]) == pre_bias
    k6 = [s for n, s in calls if n == "fir_conv"]
    assert sorted({(s[0], s[4], s[5], s[6]) for s in k6}) == (
        [("down", 2, 1.0, True), ("up", 2, 1.0, True)] if k6 else [])
    assert not [s for n, s in calls if n == "upfirdn2d" and s[1:3] == (1, 1)]


def test_train_signatures_are_the_flagship_training_calls():
    """At full depth (narrow, short): one train step's forward makes the
    inference calls (24 K1, 109 K2) and its backward 109 K2b and 18 K1 adjoints:
    the 12 res-block pairs and the 6 output-pyramid upsamplings. The input
    pyramid's 6 downsamplings act on the network input, which needs no
    gradient. Each adjoint's signature is adjoint_args of its forward's."""
    model = ScoreModel("ncsnpp", "ouve", nf=8, init_scale=1.0)
    fwd, bwd = kt.record_train_calls(model, CPU, frames=64, batch=1)
    names = lambda calls: {k: sum(1 for n, _ in calls if n == k) for k, _ in calls}
    assert names(fwd) == {"group_norm_act": 109, "upfirdn2d": 24}
    assert names(bwd) == {"group_norm_act_bwd": 109, "upfirdn2d_adjoint": 18}
    assert sorted(s for n, s in bwd if n == "group_norm_act_bwd") == sorted(
        s for n, s in fwd if n == "group_norm_act")
    want = []
    for name, sig in fwd:
        if name != "upfirdn2d":
            continue
        shape, up, down, pad, taps, n = sig
        if n == 1 and down == 2:  # the input pyramid: no gradient
            continue
        out_hw = ((shape[2] * up + sum(pad) - 4) // down + 1,
                  (shape[3] * up + sum(pad) - 4) // down + 1)
        k, kw, crop = ufd.adjoint_args(shape[2:], out_hw, np.reshape(taps, (4, 4)), up, down,
                                       pad)
        assert crop is None
        want.append(((*shape[:2], *out_hw), kw["up"], kw["down"], kw["pad"],
                     tuple(float(v) for v in k.ravel()), n))
    assert sorted(s for _, s in bwd if _ == "upfirdn2d_adjoint") == sorted(want)


@pytest.mark.parametrize("variant,f_bins,per_step", [
    ("learn_demo", 256, {"group_norm_act": 45, "upfirdn2d": 12, "group_norm_act_bwd": 45,
                         "upfirdn2d_adjoint": 9, "residual_merge": 0}),
    ("demo_48k", 768, {"group_norm_act": 42, "upfirdn2d": 6, "group_norm_act_bwd": 42,
                       "upfirdn2d_adjoint": 6, "residual_merge": 0}),
])
def test_train_calls_of_the_learn_demo_nets(variant, f_bins, per_step):
    """The launches per train step chip_smoke.py expects of the demos' nets
    (phases 14a and 15a): the 16 kHz net's adjoints are its 6 res-block
    pairs' and 3 output-pyramid upsamplings', the 48 kHz net (no pyramids)
    has its 6 pairs' alone. A train step calls no K8 (its biases are not
    folded with autograd on)."""
    backbone, settings = kt.VARIANTS[variant]
    model = ScoreModel(backbone, "ouve", init_scale=1.0, **settings)
    fwd, bwd = kt.record_train_calls(model, CPU, batch=1, f_bins=f_bins, frames=64)
    assert {k: sum(1 for n, _ in fwd + bwd if n == k) for k in per_step} == per_step


@pytest.mark.parametrize("sig", [((2, 16, 8, 12), 2, 1, (2, 1), DOWN_TAPS, 2),  # adjoint of down
                                 ((2, 16, 12, 8), 1, 2, (1, 1), UP_TAPS, 1),  # adjoint of up
                                 ((2, 16, 12, 8), 1, 1, (2, 2), UP_TAPS, 1),  # of K6 up's FIR
                                 ((2, 16, 12, 8), 1, 1, (1, 1), DOWN_TAPS, 1)])  # K6 down's
def test_adjoint_library_yardstick_matches_plain(sig):
    """cuDNN's depthwise backward-input computes the K1 adjoint's function."""
    case = kt.make_case("upfirdn2d_adjoint", sig, torch.float32, CPU,
                        torch.Generator().manual_seed(0))
    for got, want in zip(case["library"](), case["library_ref"]()):
        _close(got, want)


@pytest.mark.parametrize("silu,bias", [(False, False), (True, True)])
def test_group_norm_bwd_library_yardstick_matches_plain(silu, bias):
    sig = ((2, 32, 8, 6), 8, 1e-6, silu, bias)
    case = kt.make_case("group_norm_act_bwd", sig, torch.float32, CPU,
                        torch.Generator().manual_seed(1))
    for got, want in zip(case["library"](), case["library_ref"]()):
        _close(got, want)
    assert len(case["plain"]()) == (4 if bias else 3)
    assert case["bytes"] == 3 * 2 * 32 * 48 * 4 + 4 * 32 * 4 + 2 * 8 * 2 * 4 + (
        2 * 2 * 32 * 4 if bias else 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("scale,bias,skip_bias", [(2.0**-0.5, True, True), (2.0**-0.5, True, False),
                                                  (1.0, True, False), (2.0**-0.5, False, False)])
def test_k8_library_yardstick_matches_plain(dtype, tol, scale, bias, skip_bias):
    """The ops K8 replaces compute its function; each callable of the case
    writes over its own copy of h, so that the first calls of all of them
    start from the same inputs."""
    sig = ((2, 16, 6, 5), scale, bias, skip_bias)
    case = kt.make_case("residual_merge", sig, dtype, CPU, torch.Generator().manual_seed(2))
    ref = case["library_ref"]()
    _close(case["library"]().float(), ref.float(), tol)
    assert torch.equal(case["plain"](), ref)
    esize = torch.empty((), dtype=dtype).element_size()
    assert case["bytes"] == 3 * 2 * 16 * 30 * esize + 4 * 16 * (int(bias) + int(skip_bias))
    assert case["sig"] == kt.label("residual_merge", sig)
