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
conv) makes K1 calls at up = down = 1 (yardstick: cuDNN's stride-1
depthwise convolution), or the full-width ``ncsnpp`` with DDPM blocks, ``cat``
combine, no FIR and elu, whose K2 calls run without SiLU, or the learn
demo's narrow net (``learn_demo``). With ``--train`` the calls are those of
one train step of the flagship (or of ``--variant``) at the JAX defaults
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
# net with residual pyramids runs K6 (cuDNN + K1 at up = down = 1) in each pyramid level;
# the variant runs K2 without SiLU (elu after it) and no K1 (no FIR).
VARIANTS = {
    "48k_residual": ("ncsnpp_48k", dict(progressive="residual", progressive_input="residual")),
    "ncsnpp_variant": ("ncsnpp", dict(resblock_type="ddpm", progressive_combine="cat",
                                      fir=False, nonlinearity="elu")),
    # The learn demo's net (tools/learn_demo.py): narrow and shallow, full input size.
    "learn_demo": ("ncsnpp", dict(nf=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)),
}
SEED = 0
REPS = 25
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bfloat16 on the tensor cores (K6's convolution)
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
                   "flipped FIR for a K6 FIR pass (up = down = 1, pads (p, p)); its "
                   "backward-input for the adjoint")
K6_FOLDED_NOTE = ("one cuDNN call with the FIR folded into the weights: the 6x6 kernel "
                  "w * k at stride 2, padding 2 (F.conv_transpose2d up, F.conv2d down)")
K2B_LIBRARY_NOTE = ("aten.native_group_norm_backward on NCHW copies: GroupNorm only (no "
                    "SiLU, no pre-bias), dx, dgamma and dbeta")
LIBRARY_NOTES = {"upfirdn2d": K1_LIBRARY_NOTE, "upfirdn2d_adjoint": K1_ADJOINT_LIBRARY_NOTE,
                 "group_norm_act": K2_LIBRARY_NOTE, "group_norm_act_bwd": K2B_LIBRARY_NOTE,
                 "k6_fir_conv": K6_FOLDED_NOTE}


def ops_modules():
    gn = importlib.import_module("sgmse_tpu_torch.ops.group_norm")
    ufd = importlib.import_module("sgmse_tpu_torch.ops.upfirdn2d")
    return gn, ufd


@contextlib.contextmanager
def routed(calls=None, plain=False):
    """Route the network's kernel dispatchers through a recorder of their call
    signatures (appended to ``calls``) and, with ``plain``, to the plain
    versions (autograd then differentiates the plain versions). The backward
    dispatchers are recorded too: K2b as ``group_norm_act_bwd``, the K1
    adjoint as an ``upfirdn2d`` call after the forward's. Works for checkouts
    with and without the pair launch, the pre-bias and the backward kernels."""
    gn, ufd = ops_modules()
    orig = {"gn": gn.group_norm_act, "u": ufd.upfirdn2d,
            "pair": getattr(ufd, "upfirdn2d_pair", None),
            "bwd": getattr(gn, "group_norm_act_bwd", None)}

    def taps(kernel):
        return tuple(float(v) for v in np.asarray(kernel, np.float32).ravel())

    def group_norm_act(x, gamma, beta, num_groups, eps=1e-6, silu=True, pre_bias=None):
        if calls is not None:
            calls.append(("group_norm_act", (tuple(x.shape), num_groups, eps, bool(silu),
                                             pre_bias is not None)))
        fn = gn.group_norm_act_plain if plain else orig["gn"]
        args = (x, gamma, beta, num_groups, eps, silu)
        return fn(*args) if pre_bias is None else fn(*args, pre_bias)

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0), **adjoint):
        if calls is not None:
            calls.append(("upfirdn2d", (tuple(x.shape), up, down, tuple(pad), taps(kernel), 1)))
        if plain:
            return ufd.upfirdn2d_plain(x, kernel, up, down, pad)
        return orig["u"](x, kernel, up, down, pad, **adjoint)

    def upfirdn2d_pair(x0, x1, kernel, up=1, down=1, pad=(0, 0), **adjoint):
        if calls is not None:
            calls.append(("upfirdn2d", (tuple(x0.shape), up, down, tuple(pad), taps(kernel), 2)))
        if plain:
            return ufd.upfirdn2d_pair_plain(x0, x1, kernel, up, down, pad)
        return orig["pair"](x0, x1, kernel, up, down, pad, **adjoint)

    def group_norm_act_bwd(dy, x, gamma, beta, stats, num_groups, eps=1e-6, silu=True,
                           pre_bias=None):
        if calls is not None:
            calls.append(("group_norm_act_bwd", (tuple(x.shape), num_groups, eps, bool(silu),
                                                 pre_bias is not None)))
        return orig["bwd"](dy, x, gamma, beta, stats, num_groups, eps, silu, pre_bias)

    gn.group_norm_act, ufd.upfirdn2d = group_norm_act, upfirdn2d
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
    if name.startswith("upfirdn2d"):
        shape, up, down, pad, _, n = sig
        return f"{shape} up={up} down={down} pad={pad}" + (" pair" if n == 2 else "")
    shape, groups, _, silu, bias = sig
    return f"{shape} groups={groups} silu={silu}" + (" pre_bias" if bias else "")


def make_case(name, sig, dtype, dev, gen):
    """Inputs and the callables of one signature: ``kernel``, ``plain``, and,
    where a yardstick exists, ``library`` with ``library_ref`` (the plain version
    of the function the yardstick computes). Also its bytes and operations."""
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
    """Kernel, plain and library ms of one case, with its bound."""
    row = {k: case[k] for k in ("name", "sig", "dtype", "bytes", "ops", "bound_ms", "bound_by",
                                "ops_ms") if k in case}
    row["ms"] = graph_ms(case["kernel"])
    row["plain_ms"] = graph_ms(case["plain"])
    row["library_ms"] = graph_ms(case["library"]) if "library" in case else None
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
    on the dispatchers' own route: (forward calls, backward calls), the
    backward's upfirdn2d calls renamed ``upfirdn2d_adjoint``."""
    model.train()
    x, y, t = network_inputs(dev, f_bins, batch)
    x, y = x[..., :frames], y[..., :frames]
    params = [p for p in model.parameters() if p.requires_grad]
    with routed(calls=[]) as calls:
        out = model.dnn(x, y, t)
        n_fwd = len(calls)
        torch.autograd.grad(out.abs().square().mean(), params)
    bwd = [("upfirdn2d_adjoint" if name == "upfirdn2d" else name, sig)
           for name, sig in calls[n_fwd:]]
    return calls[:n_fwd], bwd


def per_nfe(rows) -> dict:
    """Per kernel, per network evaluation: the sums over its timed signatures of
    each time x the signature's ``per_forward`` calls (each one launch)."""
    out = {}
    for name in dict.fromkeys(r["name"] for r in rows):
        mine = [r for r in rows if r["name"] == name]
        total = lambda key: sum(r[key] * r["per_forward"] for r in mine)
        bytes_ms = total("bytes") / PEAK_BYTES_PER_S * 1e3
        ops_ms = (total("ops_ms") if name == "k6_fir_conv"  # its convolution on tensor cores
                  else total("ops") / PEAK_F32_FLOPS * 1e3)
        out[name] = dict(
            launches_per_nfe=sum(r["per_forward"] for r in mine),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=(None if any(r["library_ms"] is None for r in mine)
                        else total("library_ms")),
            library_note=LIBRARY_NOTES[name] + (
                "; " + K6_LIBRARY_NOTE if any("up=1 down=1" in r.get("sig", "") for r in mine)
                else ""))
    return out


def record_k6_calls(dev, backbone="ncsnpp_48k", **settings):
    """The K6 (FIR + conv) calls of one full-width evaluation of a ``VARIANTS``
    net: ``("up" | "down", x shape, w shape, FIR taps, factor)``, in first-call
    order."""
    _, ufd = ops_modules()
    model = full_model(dev, backbone=backbone, **settings)
    x, y, t = network_inputs(dev, BINS[backbone])
    calls, orig = [], {"up": ufd.upsample_conv_2d, "down": ufd.conv_downsample_2d}

    def recorder(kind):
        def call(x, w, k=None, factor=2, gain=1.0):
            calls.append((kind, tuple(x.shape), tuple(w.shape), tuple(k), factor))
            return orig[kind](x, w, k=k, factor=factor, gain=gain)
        return call

    ufd.upsample_conv_2d, ufd.conv_downsample_2d = recorder("up"), recorder("down")
    try:
        with torch.inference_mode(), routed(plain=True):
            model.dnn(x, y, t)
    finally:
        ufd.upsample_conv_2d, ufd.conv_downsample_2d = orig["up"], orig["down"]
    return calls


def _full_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The full 2-D convolution of one (kh, kw) kernel ``a`` with each of the
    (N, 3, 3) kernels ``b``: (N, kh + 2, kw + 2)."""
    out = F.conv2d(F.pad(a[None, None], (2, 2, 2, 2)), torch.flip(b, [1, 2])[:, None])
    return out[0]


def make_k6_case(kind, x_shape, w_shape, taps, factor, dtype, dev, gen):
    """K6 at one call signature: ``kernel`` (cuDNN's convolution and the K1
    pass, as the network runs it), ``plain`` (the same with the plain FIR),
    ``library`` (one cuDNN call with the FIR folded into the weights: a 6x6
    kernel at stride 2, padding 2) with ``library_ref``; bytes and
    operations of the function."""
    _, ufd = ops_modules()
    x = torch.randn(x_shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = 0.05 * torch.randn(w_shape, generator=gen, device=dev)
    fn = ufd.upsample_conv_2d if kind == "up" else ufd.conv_downsample_2d
    # the FIR pass's taps as the composition scales them, on the device (no host copy
    # inside a CUDA graph's capture)
    k_dev = torch.from_numpy(np.asarray(ufd.setup_kernel(taps), np.float32)
                             * (factor**2 if kind == "up" else 1)).to(dev)

    def plain():  # the composition with the plain FIR pass
        orig = ufd.upfirdn2d
        ufd.upfirdn2d = lambda y, _k, up=1, down=1, pad=(0, 0), **_: ufd.upfirdn2d_plain(
            y, k_dev, up, down, pad)
        try:
            return fn(x, w, k=taps, factor=factor)
        finally:
            ufd.upfirdn2d = orig

    k2 = torch.from_numpy(np.asarray(ufd.setup_kernel(taps), np.float32)).to(dev)
    o, i = w_shape[:2]
    if kind == "up":  # conv_transpose2d(w flipped) then the FIR: one transposed conv
        wt = torch.flip(w, [2, 3]).transpose(0, 1).reshape(i * o, *w_shape[2:])
        folded = _full_conv(k2 * factor**2, wt).reshape(i, o, 6, 6).to(dtype)
        library = lambda: F.conv_transpose2d(x, folded, stride=factor, padding=2)
    else:  # the FIR (a correlation with the flipped taps) then the strided conv
        folded = _full_conv(torch.flip(k2, [0, 1]), w.reshape(o * i, *w_shape[2:]))
        folded = folded.reshape(o, i, 6, 6).to(dtype)
        library = lambda: F.conv2d(x, folded, stride=factor, padding=2)
    esize = torch.empty((), dtype=dtype).element_size()
    y_shape = tuple(plain().shape)
    b, c_in, h, wd = x_shape
    if kind == "up":  # the transposed conv's MACs, then 16 taps per FIR output
        conv_ops = 2 * b * c_in * h * wd * o * 9
        fir_ops = 2 * 16 * int(np.prod(y_shape))
    else:  # 16 taps per FIR output (input + 1 per side), then the strided conv's MACs
        conv_ops = 2 * int(np.prod(y_shape)) * c_in * 9
        fir_ops = 2 * 16 * b * c_in * (h + 1) * (wd + 1)
    case = dict(name="k6_fir_conv", sig=f"{kind} x={x_shape} w={w_shape}", dtype=str(dtype)
                .split(".")[-1], kernel=lambda: fn(x, w, k=taps, factor=factor), plain=plain,
                library=library, library_ref=plain,
                bytes=int((np.prod(x_shape) + np.prod(y_shape) + np.prod(w_shape)) * esize),
                ops=conv_ops + fir_ops)
    bytes_ms = case["bytes"] / PEAK_BYTES_PER_S * 1e3
    ops_ms = (conv_ops / PEAK_BF16_FLOPS + fir_ops / PEAK_F32_FLOPS) * 1e3
    case["bound_ms"], case["ops_ms"] = max(bytes_ms, ops_ms), ops_ms
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
                             "(48k_residual: K1 at the K6 signatures; ncsnpp_variant: K2 "
                             "without SiLU; learn_demo: the learn demo's net), with --train "
                             "those of its train step")
    parser.add_argument("--k6", action="store_true",
                        help="with --variant 48k_residual: time K6 (FIR + conv) itself at each "
                             "of its call signatures, beside one cuDNN call with the FIR folded "
                             "into the weights")
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
        case = (make_k6_case(*key, dtype, dev, gen) if args.k6
                else make_case(*key, dtype, dev, gen))
        if args.k6:  # the folded call computes the same function: hold it to the plain
            ref, lib = case["library_ref"]().float(), case["library"]().float()
            case["library_err"] = ((lib - ref).abs().max() / ref.abs().max()).item()
            if not case["library_err"] <= 2.0**-6:  # a few bf16 roundings apart
                raise AssertionError(f"{case['sig']}: folded K6 off by {case['library_err']}")
        rows.append(dict(time_case(case), per_forward=n,
                         **({"library_err": case["library_err"]} if args.k6 else {})))
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
