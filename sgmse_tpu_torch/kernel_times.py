"""Device time of the port's kernels at every shape of the full-width main path.

    python -m sgmse_tpu_torch.kernel_times [--backbone ncsnpp_48k] [--out FILE]
    python -m sgmse_tpu_torch.kernel_times --train [--batch 8] [--out FILE]
    python sgmse_tpu_torch/kernel_times.py --root DIR [--out FILE]

Records the calls that one evaluation of a full-width NCSN++ (seeded weights,
B=4, T=256 frames: the flagship ``ncsnpp`` at F=256, which ``ncsnpp_v2``
shares, or ``ncsnpp_48k`` at F=768) makes to the two kernel dispatchers,
then, for each distinct call signature, in bfloat16 (the main path's dtype),
times:

- the kernel, its plain PyTorch version and the library yardstick (the one
  PyTorch call that computes the same function, where there is one): a CUDA
  graph of ``REPS`` back-to-back calls on the same inputs, replayed three
  times, each replay bracketed by CUDA events; the median over ``REPS``. The
  graph holds no host launch cost, so this is device time. The inputs stay in
  the 50 MB L2 between calls where they fit, as in the network, where each
  kernel reads what the layer before it has just written;
- the bound: the larger of the bytes the call must move (each input read once,
  each output written once) over 3.35 TB/s and its float32 operations over
  67 TFLOP/s, the H100 SXM's published peaks.

Per network evaluation, each is the sum over signatures of its time times the
signature's calls per evaluation. ``--variant`` takes the calls of one of the
``VARIANTS`` instead: the 48 kHz net with residual pyramids, whose K6 (FIR +
conv + bias, ``fir_conv``; yardstick: one cuDNN call with the FIR folded into
6x6 weights) runs in each pyramid level, or the full-width ``ncsnpp`` with
DDPM blocks, ``cat`` combine, no FIR and elu, whose K2 calls run without
SiLU, or the learn demos' narrow nets (``learn_demo`` at 16 kHz, ``demo_48k`` at 48 kHz).
K8 (``residual_merge``, the residual merge with the folded convolution
biases) runs in every evaluation, where no gradient is recorded; its
yardstick is the PyTorch ops it replaces (each bias's broadcast add, the sum,
the scale), and it has no calls in a train step. With
``--train`` the calls are those of one train step of the flagship (or of
``--variant``) at the JAX defaults
(B=8, F=T=256, float32, remat off; ``--batch`` sets another batch), forward
and backward: K1 and K2 forward, the K1 adjoint
(``upfirdn2d_adjoint``, yardstick cuDNN's depthwise convolution
backward-input) and K2b (``group_norm_act_bwd``, yardstick
``aten.native_group_norm_backward``: GroupNorm only, on NCHW copies, as
autograd hands them to it), timed in float32, per train step. Prints one JSON
line (and writes it to ``--out``). With ``--root``, the ``sgmse_tpu_torch`` of checkout DIR is timed
in place of this one, so that another commit's kernels (unpacked with
``git archive``) are measured by the same code; the library yardsticks are
never called by the port. ``chip_smoke.py`` uses the same functions.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

B, F_BINS, T_FRAMES = 4, 256, 256  # four 2.04-s utterances
TRAIN_B = 8  # the JAX training CLI's default batch
# Frequency bins of each backbone's full-width input: n_fft 510 at 16 kHz, 1534 at 48 kHz.
BINS = {"ncsnpp": F_BINS, "ncsnpp_48k": 768}
# The NCSN++ branches beyond the flagship's, at full width: (backbone, settings). The 48 kHz
# net with residual pyramids runs K6 (FIR + conv + bias, one launch) in each pyramid level;
# the variant runs K2 without SiLU (elu after it) and no K1 (no FIR).
VARIANTS = {
    "48k_residual": ("ncsnpp_48k", dict(progressive="residual", progressive_input="residual")),
    "ncsnpp_variant": ("ncsnpp", dict(resblock_type="ddpm", progressive_combine="cat",
                                      fir=False, nonlinearity="elu")),
    # The learn demo's net (tools/learn_demo.py): narrow and shallow, full input size.
    "learn_demo": ("ncsnpp", dict(nf=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)),
    # The 48 kHz learn demo's net (tools/learn_demo_48k.py): the same widths at F=768.
    "demo_48k": ("ncsnpp_48k", dict(nf=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)),
}
SEED = 0
REPS = 25
# --k6 in bf16, relative to max|plain|: the kernel a few bf16 steps (the plain version
# rounds three times, the kernel twice; chip_smoke.TOL says where the limit sits between
# the kernel's readings and the planted faults'); the folded call a few (its 6x6 weights
# are rounded to bf16).
K6_TOL, K6_LIBRARY_TOL = 2.0**-5, 2.0**-6
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bfloat16 on the tensor cores (K6's convolution)
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 on the tensor cores
K2_LIBRARY_NOTE = ("F.group_norm: the same function on the calls without SiLU and "
                   "pre-bias; on the others it computes GN only (no one-call "
                   "equivalent with SiLU or the pre-bias)")
K1_LIBRARY_NOTE = ("depthwise cuDNN: F.conv2d(stride 2, padding 1, groups C) with the "
                   "flipped FIR for down, F.conv_transpose2d(stride 2, padding 1, "
                   "groups C) with the FIR for up; one call per tensor of a pair")
K1_ADJOINT_LIBRARY_NOTE = ("depthwise cuDNN backward-input (aten.convolution_backward, "
                           "input mask only) of the K1 yardstick's convolution; one call "
                           "per tensor of a pair")
K6_LIBRARY_NOTE = ("depthwise cuDNN at stride 1: F.conv2d(padding p, groups C) with the "
                   "flipped FIR for K6's FIR at up = down = 1 (pads (p, p); the down "
                   "backward's recompute); its backward-input for the adjoint")
K6_FOLDED_NOTE = ("one cuDNN call with the FIR folded into the weights: the 6x6 kernel "
                  "w * k at stride 2, padding 2 (F.conv_transpose2d up, F.conv2d down), "
                  "then the bias add")
K8_LIBRARY_NOTE = ("the ops K8 replaces, as the blocks run them with autograd on after "
                   "cuDNN's bias-free convolution: each bias's broadcast add_ in the "
                   "compute dtype, the sum, and the scale")
K2B_LIBRARY_NOTE = ("aten.native_group_norm_backward on NCHW copies: GroupNorm only (no "
                    "SiLU, no pre-bias), dx, dgamma and dbeta")
LIBRARY_NOTES = {"upfirdn2d": K1_LIBRARY_NOTE, "upfirdn2d_adjoint": K1_ADJOINT_LIBRARY_NOTE,
                 "group_norm_act": K2_LIBRARY_NOTE, "group_norm_act_bwd": K2B_LIBRARY_NOTE,
                 "fir_conv": K6_FOLDED_NOTE, "residual_merge": K8_LIBRARY_NOTE}


def ops_modules():
    gn = importlib.import_module("sgmse_tpu_torch.ops.group_norm")
    ufd = importlib.import_module("sgmse_tpu_torch.ops.upfirdn2d")
    return gn, ufd


def merge_module():
    """``ops/residual_merge.py`` (K8), or None in a checkout without it."""
    try:
        return importlib.import_module("sgmse_tpu_torch.ops.residual_merge")
    except ModuleNotFoundError:
        return None


@contextlib.contextmanager
def routed(calls=None, plain=False):
    """Route the network's kernel dispatchers through a recorder of their call
    signatures (appended to ``calls``) and, with ``plain``, to the plain
    versions (autograd then differentiates the plain versions, K6 with its
    own backward). The backward dispatchers are recorded too: K2b as
    ``group_norm_act_bwd``, the K1 adjoint as ``upfirdn2d_adjoint`` (a K1
    launch in a backward that computes a forward, K6 down's recompute of
    FIR(x), as ``upfirdn2d``). K6 is ``fir_conv``, with the signature
    ``("up" | "down", x shape, w shape, 1-D FIR taps, factor, gain, bias?)``.
    K8 is ``residual_merge``, with the signature ``(shape, scale, bias?,
    skip bias?)``. Works for checkouts with and without the pair launch, the
    pre-bias, the backward kernels, K6's kernel and K8."""
    gn, ufd = ops_modules()
    rm = merge_module()
    orig = {"gn": gn.group_norm_act, "u": ufd.upfirdn2d,
            "pair": getattr(ufd, "upfirdn2d_pair", None),
            "bwd": getattr(gn, "group_norm_act_bwd", None),
            "k6": getattr(ufd, "fir_conv", None),
            "k8": None if rm is None else rm.residual_merge}

    def taps(kernel):
        return tuple(float(v) for v in np.asarray(kernel, np.float32).ravel())

    def group_norm_act(x, gamma, beta, num_groups, eps=1e-6, silu=True, pre_bias=None):
        if calls is not None:
            calls.append(("group_norm_act", (tuple(x.shape), num_groups, eps, bool(silu),
                                             pre_bias is not None)))
        fn = gn.group_norm_act_plain if plain else orig["gn"]
        args = (x, gamma, beta, num_groups, eps, silu)
        return fn(*args) if pre_bias is None else fn(*args, pre_bias)

    def k1_name(adjoint):
        return "upfirdn2d_adjoint" if adjoint.get("adjoint") else "upfirdn2d"

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0), **adjoint):
        if calls is not None:
            calls.append((k1_name(adjoint), (tuple(x.shape), up, down, tuple(pad),
                                             taps(kernel), 1)))
        if plain:
            return ufd.upfirdn2d_plain(x, kernel, up, down, pad)
        return orig["u"](x, kernel, up, down, pad, **adjoint)

    def upfirdn2d_pair(x0, x1, kernel, up=1, down=1, pad=(0, 0), **adjoint):
        if calls is not None:
            calls.append((k1_name(adjoint), (tuple(x0.shape), up, down, tuple(pad),
                                             taps(kernel), 2)))
        if plain:
            return ufd.upfirdn2d_pair_plain(x0, x1, kernel, up, down, pad)
        return orig["pair"](x0, x1, kernel, up, down, pad, **adjoint)

    def group_norm_act_bwd(dy, x, gamma, beta, stats, num_groups, eps=1e-6, silu=True,
                           pre_bias=None):
        if calls is not None:
            calls.append(("group_norm_act_bwd", (tuple(x.shape), num_groups, eps, bool(silu),
                                                 pre_bias is not None)))
        return orig["bwd"](dy, x, gamma, beta, stats, num_groups, eps, silu, pre_bias)

    def fir_conv(x, w, k, factor, gain, bias, up):
        if calls is not None:
            calls.append(("fir_conv", ("up" if up else "down", tuple(x.shape), tuple(w.shape),
                                       taps(() if k is None else k), factor, gain,
                                       bias is not None)))
        fn = ufd.fir_conv_plain if plain else orig["k6"]
        return fn(x, w, k, factor, gain, bias, up)

    def residual_merge(h, skip, scale=1.0, bias=None, skip_bias=None):
        if calls is not None:
            calls.append(("residual_merge", (tuple(h.shape), float(scale), bias is not None,
                                             skip_bias is not None)))
        fn = rm.residual_merge_plain if plain else orig["k8"]
        return fn(h, skip, scale, bias, skip_bias)

    gn.group_norm_act, ufd.upfirdn2d = group_norm_act, upfirdn2d
    if orig["k6"] is not None:
        ufd.fir_conv = fir_conv
    if orig["k8"] is not None:
        rm.residual_merge = residual_merge
    if orig["pair"] is not None:
        ufd.upfirdn2d_pair = upfirdn2d_pair
    if orig["bwd"] is not None:
        gn.group_norm_act_bwd = group_norm_act_bwd
    try:
        yield calls
    finally:
        gn.group_norm_act, ufd.upfirdn2d = orig["gn"], orig["u"]
        if orig["pair"] is not None:
            ufd.upfirdn2d_pair = orig["pair"]
        if orig["bwd"] is not None:
            gn.group_norm_act_bwd = orig["bwd"]
        if orig["k6"] is not None:
            ufd.fir_conv = orig["k6"]
        if orig["k8"] is not None:
            rm.residual_merge = orig["k8"]


def full_model(dev, precision="float32", backbone="ncsnpp", **settings):
    """The backbone's default (full-width) ScoreModel, with ``settings`` (a
    ``VARIANTS`` entry's), with seeded weights. init_scale 1 instead of the
    DDPM 0 (1e-10), so that every layer contributes to the output."""
    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel(backbone, "ouve", init_scale=1.0, precision=precision, **settings)
    model.init_params(torch.Generator().manual_seed(SEED))
    return model.to(dev, memory_format=torch.channels_last).eval()


def network_inputs(dev, f_bins=F_BINS, batch=B, frames=T_FRAMES):
    rng = np.random.default_rng(SEED)
    shape = (batch, 1, f_bins, frames)
    cplx = lambda: (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.3
    x, y = cplx().astype(np.complex64), cplx().astype(np.complex64)
    t = rng.uniform(0.03, 1.0, (batch,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, t))


def per_forward(calls):
    """{(name, signature): calls per evaluation}, in first-call order."""
    counts = {}
    for key in calls:
        counts[key] = counts.get(key, 0) + 1
    return counts


def label(name, sig):
    if name == "residual_merge":
        shape, scale, bias, skip_bias = sig
        return (f"{shape} scale={scale:.4f}" + (" bias" if bias else "")
                + (" skip_bias" if skip_bias else ""))
    if name.startswith("upfirdn2d"):
        shape, up, down, pad, _, n = sig
        return f"{shape} up={up} down={down} pad={pad}" + (" pair" if n == 2 else "")
    shape, groups, _, silu, bias = sig
    return f"{shape} groups={groups} silu={silu}" + (" pre_bias" if bias else "")


def make_case(name, sig, dtype, dev, gen):
    """Inputs and the callables of one signature: ``kernel``, ``plain``, and,
    where a yardstick exists, ``library`` with ``library_ref`` (the plain version
    of the function the yardstick computes). Also its bytes and operations.
    K6 (``fir_conv``) is :func:`make_k6_case`'s, K8 (``residual_merge``)
    :func:`make_k8_case`'s."""
    if name == "fir_conv":
        return make_k6_case(sig, dtype, dev, gen)
    if name == "residual_merge":
        return make_k8_case(sig, dtype, dev, gen)
    gn, ufd = ops_modules()
    shape = sig[0]

    def rand(*s):
        t = torch.randn(s, generator=gen, device=dev).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if len(s) == 4 else t

    case = dict(name=name, sig=label(name, sig), dtype=str(dtype).split(".")[-1])
    esize = torch.empty((), dtype=dtype).element_size()
    if name.startswith("upfirdn2d"):
        _, up, down, pad, taps, n = sig
        xs = [rand(*shape) for _ in range(n)]
        k = np.asarray(taps, np.float32).reshape(4, 4)
        k_dev = torch.from_numpy(k).to(dev)  # no taps copy inside the plain's bracket
        if n == 2:
            case["kernel"] = lambda: ufd.upfirdn2d_pair_cuda(xs[0], xs[1], k, up, down, pad)
        else:
            case["kernel"] = lambda: ufd.upfirdn2d_cuda(xs[0], k, up, down, pad)
        case["plain"] = lambda: tuple(ufd.upfirdn2d_plain(x, k_dev, up, down, pad) for x in xs)
        c = shape[1]
        oh, ow = (ufd._out_size(n_in, 4, up, down, *pad) for n_in in shape[2:])
        same = (up, down) == (1, 1) and pad[0] == pad[1] and pad[0] >= 0
        if same and name == "upfirdn2d":  # K6's FIR pass: a stride-1 depthwise conv
            w = torch.flip(k_dev, [0, 1])[None, None].expand(c, 1, 4, 4).to(dtype).contiguous()
            case["library"] = lambda: tuple(F.conv2d(x, w, padding=pad[0], groups=c)
                                            for x in xs)
        elif same:  # its adjoint: the backward-input of that conv, whose pad is 3 - p
            w = k_dev[None, None].expand(c, 1, 4, 4).to(dtype).contiguous()
            like = torch.empty((shape[0], c, oh, ow), dtype=dtype, device=dev).contiguous(
                memory_format=torch.channels_last)
            case["library"] = lambda: tuple(torch.ops.aten.convolution_backward(
                x, like, w, None, [1, 1], [3 - pad[0]] * 2, [1, 1], False, [0, 0], c,
                [True, False, False])[0] for x in xs)
        elif name == "upfirdn2d":
            if (up, down, tuple(pad)) == (1, 2, (1, 1)):
                w = torch.flip(k_dev, [0, 1])[None, None].expand(c, 1, 4, 4).to(dtype).contiguous()
                case["library"] = lambda: tuple(F.conv2d(x, w, stride=2, padding=1, groups=c)
                                                for x in xs)
            elif (up, down, tuple(pad)) == (2, 1, (2, 1)):
                w = k_dev[None, None].expand(c, 1, 4, 4).to(dtype).contiguous()
                case["library"] = lambda: tuple(F.conv_transpose2d(x, w, stride=2, padding=1,
                                                                   groups=c) for x in xs)
        else:  # the adjoint of the yardstick's convolution: its backward-input
            transposed = (up, down, tuple(pad)) == (1, 2, (1, 1))  # adjoint of an upsample
            if transposed or (up, down, tuple(pad)) == (2, 1, (2, 1)):
                fir = torch.flip(k_dev, [0, 1]) if transposed else k_dev
                w = fir[None, None].expand(c, 1, 4, 4).to(dtype).contiguous()
                like = torch.empty((shape[0], c, oh, ow), dtype=dtype, device=dev).contiguous(
                    memory_format=torch.channels_last)
                case["library"] = lambda: tuple(torch.ops.aten.convolution_backward(
                    x, like, w, None, [2, 2], [1, 1], [1, 1], transposed, [0, 0], c,
                    [True, False, False])[0] for x in xs)
        case["library_ref"] = case["plain"]
        out_elems = shape[0] * c * oh * ow
        taps_per_out = 16 // (up * up)
        case["bytes"] = n * (np.prod(shape) + out_elems) * esize
        case["ops"] = n * out_elems * taps_per_out * 2
    else:
        _, groups, eps, silu, has_bias = sig
        b, c = shape[:2]
        x = rand(*shape)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        pre_bias = 0.1 * rand(b, c) if has_bias else None
        extra = (pre_bias,) if has_bias else ()
        n_el = int(np.prod(shape))
        # F.group_norm takes its affine in x's dtype; its plain reference gets the same values.
        gamma_l, beta_l = gamma.to(dtype), beta.to(dtype)
        if name == "group_norm_act":
            case["kernel"] = lambda: gn.group_norm_act_cuda(x, gamma, beta, groups, eps, silu,
                                                            *extra)
            case["plain"] = lambda: gn.group_norm_act_plain(x, gamma, beta, groups, eps, silu,
                                                            *extra)
            case["library"] = lambda: F.group_norm(x, groups, gamma_l, beta_l, eps)
            case["library_ref"] = lambda: gn.group_norm_act_plain(x, gamma_l.float(),
                                                                  beta_l.float(), groups, eps,
                                                                  False)
            case["bytes"] = 2 * n_el * esize + 2 * c * 4 + (b * c * esize if has_bias else 0)
            # sums (add, fma), normalise (sub, mul, add), bias add, SiLU (exp, add, div)
            case["ops"] = n_el * (5 + int(has_bias) + (3 if silu else 0))
        else:  # group_norm_act_bwd
            dy = rand(*shape)
            _, stats = gn.group_norm_act_plain(x, gamma, beta, groups, eps, silu, pre_bias,
                                               return_stats=True)
            args = (dy, x, gamma, beta, stats, groups, eps, silu, pre_bias)
            some = lambda out: tuple(t for t in out if t is not None)
            case["kernel"] = lambda: some(gn.group_norm_act_bwd_cuda(*args))
            case["plain"] = lambda: some(gn.group_norm_act_bwd_plain(*args))
            xl, dyl = x.contiguous(), dy.contiguous()  # NCHW, as autograd hands them over
            hw = n_el // (b * c)
            _, mean, rstd = torch.ops.aten.native_group_norm(xl, gamma_l, beta_l, b, c, hw,
                                                             groups, eps)
            case["library"] = lambda: torch.ops.aten.native_group_norm_backward(
                dyl, xl, mean, rstd, gamma_l, b, c, hw, groups, [True, True, True])
            _, stats_l = gn.group_norm_act_plain(x, gamma_l.float(), beta_l.float(), groups, eps,
                                                 False, return_stats=True)

            def library_ref():
                dx, dg, db, _ = gn.group_norm_act_bwd_plain(dy, x, gamma_l.float(),
                                                            beta_l.float(), stats_l, groups,
                                                            eps, False)
                return dx.contiguous(), dg.to(dtype), db.to(dtype)

            case["library_ref"] = library_ref
            # read x and dy, write dx; gamma, beta, stats in; dgamma, dbeta (and the
            # pre-bias and its gradient) in and out
            case["bytes"] = (3 * n_el * esize + 4 * c * 4 + b * groups * 2 * 4
                             + (2 * b * c * esize if has_bias else 0))
            # x^ and dv (and its SiLU) in each of the two passes, the sums, then dx
            case["ops"] = n_el * (13 + (16 if silu else 0) + (2 if has_bias else 0))
        case["library_same_function"] = not silu and not has_bias
    bytes_ms = case["bytes"] / PEAK_BYTES_PER_S * 1e3
    ops_ms = case["ops"] / PEAK_F32_FLOPS * 1e3
    case["bytes"], case["ops"] = int(case["bytes"]), int(case["ops"])
    case["bound_ms"] = max(bytes_ms, ops_ms)
    case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def graph_ms(fn, reps: int = REPS) -> float:
    """Device ms per call: a CUDA graph of ``reps`` back-to-back calls, replayed
    three times, each replay bracketed by CUDA events; the median replay / reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the graph (allocator, cuDNN plans)
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def time_case(case) -> dict:
    """Kernel, plain and library ms of one case (and K6's earlier route's,
    ``composition_ms``), with its bound."""
    row = {k: case[k] for k in ("name", "sig", "dtype", "bytes", "ops", "bound_ms", "bound_by",
                                "ops_ms") if k in case}
    row["ms"] = graph_ms(case["kernel"])
    row["plain_ms"] = graph_ms(case["plain"])
    row["library_ms"] = graph_ms(case["library"]) if "library" in case else None
    if "composition" in case:
        row["composition_ms"] = graph_ms(case["composition"])
    return row


def record_calls(dev, backbone="ncsnpp", **settings):
    """The kernel-dispatcher calls of one full-width evaluation (plain route)."""
    model = full_model(dev, backbone=backbone, **settings)
    x, y, t = network_inputs(dev, BINS[backbone])
    with torch.inference_mode(), routed(calls=[], plain=True) as calls:
        out = model.dnn(x, y, t)
    return calls, out, model


def record_train_calls(model, dev, batch, f_bins=F_BINS, frames=T_FRAMES):
    """The kernel-dispatcher calls of one train step of ``model`` at ``batch``
    (its forward in train mode with remat off, then the backward of a loss on
    its output),
    on the dispatchers' own route: (forward calls, backward calls)."""
    model.train()
    x, y, t = network_inputs(dev, f_bins, batch)
    x, y = x[..., :frames], y[..., :frames]
    params = [p for p in model.parameters() if p.requires_grad]
    with routed(calls=[]) as calls:
        out = model.dnn(x, y, t)
        n_fwd = len(calls)
        torch.autograd.grad(out.abs().square().mean(), params)
    return calls[:n_fwd], calls[n_fwd:]


def per_nfe(rows) -> dict:
    """Per kernel, per network evaluation: the sums over its timed signatures of
    each time x the signature's ``per_forward`` calls (each one launch)."""
    out = {}
    for name in dict.fromkeys(r["name"] for r in rows):
        mine = [r for r in rows if r["name"] == name]
        total = lambda key: sum(r[key] * r["per_forward"] for r in mine)
        bytes_ms = total("bytes") / PEAK_BYTES_PER_S * 1e3
        ops_ms = (total("ops_ms") if name == "fir_conv"  # its convolution on tensor cores
                  else total("ops") / PEAK_F32_FLOPS * 1e3)
        out[name] = dict(
            launches_per_nfe=sum(r["per_forward"] for r in mine),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=(None if any(r["library_ms"] is None for r in mine)
                        else total("library_ms")),
            **({"composition_ms": total("composition_ms")}
               if all("composition_ms" in r for r in mine) else {}),
            library_note=LIBRARY_NOTES[name] + (
                "; " + K6_LIBRARY_NOTE if any("up=1 down=1" in r.get("sig", "") for r in mine)
                else ""))
    return out


def record_k6_calls(dev, backbone="ncsnpp_48k", **settings):
    """The K6 (``fir_conv``) calls of one full-width evaluation of a
    ``VARIANTS`` net, in first-call order (plain route)."""
    model = full_model(dev, backbone=backbone, **settings)
    x, y, t = network_inputs(dev, BINS[backbone])
    with torch.inference_mode(), routed(calls=[], plain=True) as calls:
        model.dnn(x, y, t)
    return [c for c in calls if c[0] == "fir_conv"]


def _full_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The full 2-D convolution of one (kh, kw) kernel ``a`` with each of the
    (N, 3, 3) kernels ``b``: (N, kh + 2, kw + 2)."""
    out = F.conv2d(F.pad(a[None, None], (2, 2, 2, 2)), torch.flip(b, [1, 2])[:, None])
    return out[0]


def make_k6_case(sig, dtype, dev, gen):
    """K6 at one ``fir_conv`` call signature: ``kernel`` (``csrc/fir_conv.cu``),
    ``plain`` (the composition with the plain FIR), ``composition`` (cuDNN's
    convolution and the K1 kernel's FIR pass, the route K6 took before its
    kernel; timed, never called by the port), ``library`` (one cuDNN call with
    the FIR folded into the weights: a 6x6 kernel at stride 2, padding 2, and
    the bias) with ``library_ref``; ``faults``, two planted faults; bytes and
    operations of the function. Weights and bias as the network holds them: channels_last in x's dtype,
    float32."""
    _, ufd = ops_modules()
    kind, x_shape, w_shape, taps, factor, gain, has_bias = sig
    up = kind == "up"
    x = torch.randn(x_shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = (0.05 * torch.randn(w_shape, generator=gen, device=dev)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bias = 0.1 * torch.randn(w_shape[0], generator=gen, device=dev) if has_bias else None
    k2, _ = ufd._fir_args(w, taps, factor, gain, up)
    # the FIR pass's taps on the device (no host copy inside a CUDA graph's capture)
    k_dev = torch.from_numpy(np.asarray(k2, np.float32)).to(dev)
    plain_fir = lambda y, _k, pad: ufd.upfirdn2d_plain(y, k_dev, pad=pad)
    k1_fir = lambda y, _k, pad: ufd.upfirdn2d_cuda(y, k2, pad=pad)
    args = (x, w, taps, factor, gain, bias, up)

    kn = torch.from_numpy(np.asarray(ufd.setup_kernel(taps), np.float32)).to(dev)
    o, i = w_shape[:2]
    wf = w.float()
    lib_bias = None if bias is None else bias.to(dtype)
    if up:  # conv_transpose2d(w flipped) then the FIR: one transposed conv
        wt = torch.flip(wf, [2, 3]).transpose(0, 1).reshape(i * o, *w_shape[2:])
        folded = _full_conv(kn * factor**2 * gain, wt).reshape(i, o, 6, 6).to(dtype)
        library = lambda: F.conv_transpose2d(x, folded, lib_bias, stride=factor, padding=2)
    else:  # the FIR (a correlation with the flipped taps) then the strided conv
        folded = _full_conv(torch.flip(kn * gain, [0, 1]), wf.reshape(o * i, *w_shape[2:]))
        folded = folded.reshape(o, i, 6, 6).to(dtype)
        library = lambda: F.conv2d(x, folded, lib_bias, stride=factor, padding=2)
    plain = lambda: ufd.fir_conv_composition(*args, fir=plain_fir)
    esize = torch.empty((), dtype=dtype).element_size()
    y_shape = tuple(plain().shape)
    b, c_in, h, wd = x_shape
    # The FIR is separable: 4 taps across, then 4 down, 8 MACs per FIR output.
    if up:  # the transposed conv's MACs, then the FIR on every output
        conv_ops = 2 * b * c_in * h * wd * o * 9
        fir_ops = 2 * 8 * int(np.prod(y_shape))
    else:  # the FIR on the input + 1 per side, then the strided conv's MACs
        conv_ops = 2 * int(np.prod(y_shape)) * c_in * 9
        fir_ops = 2 * 8 * b * c_in * (h + 1) * (wd + 1)
    # Two planted faults, to show what the limit must catch: the FIR's horizontal pass
    # without its first tap (the plain version so changed), and the kernel skipping C_in's
    # first slice (16 channels in bf16, 8 in f32, one on the narrow path; its weights zeroed).
    k_drop = k_dev.clone()
    k_drop[:, 0] = 0
    drop_fir = lambda y, _k, pad: ufd.upfirdn2d_plain(y, k_drop, pad=pad)
    w_skip = w.clone()
    w_skip[:, :1 if c_in < 16 else 32 // esize] = 0
    faults = dict(tap_dropped=lambda: ufd.fir_conv_composition(*args, fir=drop_fir),
                  slice_skipped=lambda: ufd.fir_conv_cuda(x, w_skip, taps, factor, gain, bias, up))
    case = dict(name="fir_conv", sig=f"{kind} x={x_shape} w={w_shape}",
                dtype=str(dtype).split(".")[-1],
                kernel=lambda: ufd.fir_conv_cuda(*args), plain=plain,
                composition=lambda: ufd.fir_conv_composition(*args, fir=k1_fir),
                library=library, library_ref=plain, faults=faults,
                bytes=int((np.prod(x_shape) + np.prod(y_shape) + np.prod(w_shape)) * esize
                          + (w_shape[0] * 4 if has_bias else 0)),
                ops=conv_ops + fir_ops)
    # the convolution on the tensor cores at the rate of the type this run computes in
    conv_rate = (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else
                 PEAK_TF32_FLOPS if torch.backends.cudnn.allow_tf32 else PEAK_F32_FLOPS)
    bytes_ms = case["bytes"] / PEAK_BYTES_PER_S * 1e3
    ops_ms = (conv_ops / conv_rate + fir_ops / PEAK_F32_FLOPS) * 1e3
    case["bound_ms"], case["ops_ms"] = max(bytes_ms, ops_ms), ops_ms
    case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def k8_library(h, skip, scale, bias, skip_bias):
    """The PyTorch ops K8 replaces, as the blocks run them with autograd on
    after cuDNN's bias-free convolution: each bias's broadcast ``add_`` in the
    compute dtype (over h, and over skip), the sum, and the scale."""
    c = h.shape[1]
    if bias is not None:
        h.add_(bias.to(h.dtype).reshape(1, c, 1, 1))
    if skip_bias is not None:
        skip.add_(skip_bias.to(h.dtype).reshape(1, c, 1, 1))
    return (skip + h) / math.sqrt(2.0) if scale != 1.0 else skip + h


def make_k8_case(sig, dtype, dev, gen):
    """K8 at one ``residual_merge`` call signature: ``kernel``
    (``csrc/residual_merge.cu``), ``plain``, ``library`` (:func:`k8_library`)
    with ``library_ref`` (the plain version); bytes (skip and h read, h
    written, the biases read) and operations. Each callable writes over its
    own copy of the same h (the library over its own skip too), so that the
    first call of each computes from the same inputs; the kernel's
    writes in place, as the network calls it. The biases are float32, as the
    network holds them."""
    rm = merge_module()
    shape, scale, has_bias, has_skip_bias = sig
    c = shape[1]
    h, skip = (torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    bias, skip_bias = (0.1 * torch.randn(c, generator=gen, device=dev) if on else None
                       for on in (has_bias, has_skip_bias))
    h_k, h_p, h_l, h_r, skip_l = (t.clone() for t in (h, h, h, h, skip))
    n_el = int(np.prod(shape))
    esize = torch.empty((), dtype=dtype).element_size()
    n_bias = int(has_bias) + int(has_skip_bias)
    case = dict(name="residual_merge", sig=label("residual_merge", sig),
                dtype=str(dtype).split(".")[-1],
                kernel=lambda: rm.residual_merge_cuda(h_k, skip, scale, bias, skip_bias),
                plain=lambda: rm.residual_merge_plain(h_p, skip, scale, bias, skip_bias),
                library=lambda: k8_library(h_l, skip_l, scale, bias, skip_bias),
                library_ref=lambda: rm.residual_merge_plain(h_r, skip, scale, bias, skip_bias),
                bytes=3 * n_el * esize + 4 * c * n_bias,
                # the bias adds, the sum, the scale
                ops=n_el * (n_bias + 1 + int(scale != 1.0)))
    bytes_ms = case["bytes"] / PEAK_BYTES_PER_S * 1e3
    ops_ms = case["ops"] / PEAK_F32_FLOPS * 1e3
    case["bound_ms"] = max(bytes_ms, ops_ms)
    case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=str, default=None,
                        help="checkout whose sgmse_tpu_torch to time (default: this one)")
    parser.add_argument("--backbone", choices=sorted(BINS), default="ncsnpp",
                        help="whose full-width call signatures to time")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                        help="time the call signatures of this NCSN++ variant instead "
                             "(48k_residual: K6 and K1; ncsnpp_variant: K2 "
                             "without SiLU; learn_demo, demo_48k: the learn demos' nets), "
                             "with --train those of its train step")
    parser.add_argument("--k6", action="store_true",
                        help="with --variant 48k_residual: time K6 (FIR + conv + bias, "
                             "fir_conv) at each of its call signatures, beside its earlier route "
                             "(cuDNN + the K1 kernel) and one cuDNN call with the FIR folded "
                             "into the weights; checks the kernel and the folded call against "
                             "the plain version, and that two planted faults miss it")
    parser.add_argument("--train", action="store_true",
                        help="time the calls of one flagship train step (float32), "
                             "forward and backward, per step")
    parser.add_argument("--batch", type=int, default=TRAIN_B,
                        help="the train step's batch (with --train)")
    parser.add_argument("--out", type=str, default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times runs on the card only")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.k6:
        backbone, settings = VARIANTS[args.variant or "48k_residual"]
        counts, dtype = per_forward(record_k6_calls(dev, backbone, **settings)), torch.bfloat16
    elif args.train:
        backbone, settings = VARIANTS[args.variant] if args.variant else ("ncsnpp", {})
        fwd, bwd = record_train_calls(full_model(dev, backbone=backbone, **settings), dev,
                                      args.batch, f_bins=BINS[backbone])
        counts, dtype = per_forward(fwd + bwd), torch.float32
    else:
        backbone, settings = VARIANTS[args.variant] if args.variant else (args.backbone, {})
        calls, _, model = record_calls(dev, backbone, **settings)
        del model
        counts, dtype = per_forward(calls), torch.bfloat16
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for key, n in counts.items():
        case = make_case(*key, dtype, dev, gen)
        if args.k6:  # the kernel, the folded call and the planted faults against plain
            ref = case["plain"]().float()
            rel = lambda f: ((f().float() - ref).abs().max() / ref.abs().max()).item()
            errs = dict(err=rel(case["kernel"]), library_err=rel(case["library"]),
                        **{f"fault_{k}_err": rel(f) for k, f in case["faults"].items()})
            faults = [v for k, v in errs.items() if k.startswith("fault_")]
            if not (errs["err"] <= K6_TOL and errs["library_err"] <= K6_LIBRARY_TOL
                    and min(faults) > K6_TOL):
                raise AssertionError(f"{case['sig']}: K6 against the plain version {errs}")
        rows.append(dict(time_case(case), per_forward=n, **(errs if args.k6 else {})))
    result = dict(card=card(), root=args.root or ".", backbone=args.backbone,
                  variant=args.variant, shapes=rows)
    if args.train:
        result.update(batch=args.batch, dtype="float32", per_train_step=per_nfe(rows))
    else:
        result["per_nfe"] = per_nfe(rows)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
