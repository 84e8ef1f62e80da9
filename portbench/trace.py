"""What a traced run reads: the device trace and the kernel calls of a window.

:class:`Calls` wraps the port's kernel dispatchers (``ops/group_norm.py``,
``ops/upfirdn2d.py``; the same points the port's ``kernel_times.routed``
wraps) for the duration and counts every call by signature, as
:mod:`portbench.counts.kernels` takes it. The wrapped functions call the
originals unchanged.

:func:`profile` runs ``torch.profiler`` (host and device activity) and
:func:`analyse` reads its events without exporting them: device busy time
(kernel, copy and set intervals merged), kernels by kind (the port's kernel
names), launches, the costliest device operations, and the longest idle
gaps named by the innermost host operation running at their middle. The
kinds follow the port's ``nfe_profile.KINDS`` (frozen copy).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
from typing import Dict, List, Tuple

import numpy as np
import torch

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("K6", ("fir_conv",)),
    ("K2b", ("gn_bwd_",)),
    ("K2", ("gn_act_kernel",)),
    ("K1", ("upfirdn2d",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "nhwcAddPadding", "cudnn", "xmma",
                     "implicit_gemm", "conv")),
    ("matmul", ("nvjet", "gemm")),
    ("elementwise", ("elementwise",)),
    ("reduction", ("reduce_kernel",)),
)
NAME_CHARS = 160  # a device operation's name is cut to this many characters


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _taps(kernel) -> tuple:
    return tuple(float(v) for v in np.asarray(kernel, np.float32).ravel())


class Calls:
    """Counts of kernel calls by (kernel, signature) while active."""

    def __init__(self):
        self.counts: Dict[Tuple[str, tuple], int] = collections.Counter()

    def _add(self, name, sig):
        self.counts[(name, sig)] += 1

    @contextlib.contextmanager
    def active(self):
        gn = importlib.import_module("sgmse_tpu_torch.ops.group_norm")
        ufd = importlib.import_module("sgmse_tpu_torch.ops.upfirdn2d")
        orig = {(gn, "group_norm_act"): gn.group_norm_act,
                (gn, "group_norm_act_bwd"): gn.group_norm_act_bwd,
                (ufd, "upfirdn2d"): ufd.upfirdn2d, (ufd, "upfirdn2d_pair"): ufd.upfirdn2d_pair,
                (ufd, "fir_conv"): ufd.fir_conv}
        add = self._add

        def gn_sig(x, num_groups, eps, silu, pre_bias):
            return (tuple(x.shape), int(num_groups), float(eps), bool(silu),
                    pre_bias is not None, _dtype(x))

        def group_norm_act(x, gamma, beta, num_groups, eps=1e-6, silu=True, pre_bias=None):
            add("group_norm_act", gn_sig(x, num_groups, eps, silu, pre_bias))
            return orig[(gn, "group_norm_act")](x, gamma, beta, num_groups, eps, silu, pre_bias)

        def group_norm_act_bwd(dy, x, gamma, beta, stats, num_groups, eps=1e-6, silu=True,
                               pre_bias=None):
            add("group_norm_act_bwd", gn_sig(x, num_groups, eps, silu, pre_bias))
            return orig[(gn, "group_norm_act_bwd")](dy, x, gamma, beta, stats, num_groups, eps,
                                                    silu, pre_bias)

        def k1_sig(x, kernel, up, down, pad, n):
            return (tuple(x.shape), int(up), int(down), tuple(int(p) for p in pad),
                    _taps(kernel), n, _dtype(x))

        def k1_name(kw):
            return "upfirdn2d_adjoint" if kw.get("adjoint") else "upfirdn2d"

        def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0), **kw):
            add(k1_name(kw), k1_sig(x, kernel, up, down, pad, 1))
            return orig[(ufd, "upfirdn2d")](x, kernel, up, down, pad, **kw)

        def upfirdn2d_pair(x0, x1, kernel, up=1, down=1, pad=(0, 0), **kw):
            add(k1_name(kw), k1_sig(x0, kernel, up, down, pad, 2))
            return orig[(ufd, "upfirdn2d_pair")](x0, x1, kernel, up, down, pad, **kw)

        def fir_conv(x, w, k, factor, gain, bias, up):
            add("fir_conv", ("up" if up else "down", tuple(x.shape), tuple(w.shape),
                             _taps(() if k is None else k), factor, gain, bias is not None,
                             _dtype(x)))
            return orig[(ufd, "fir_conv")](x, w, k, factor, gain, bias, up)

        wrapped = {"group_norm_act": group_norm_act, "group_norm_act_bwd": group_norm_act_bwd,
                   "upfirdn2d": upfirdn2d, "upfirdn2d_pair": upfirdn2d_pair,
                   "fir_conv": fir_conv}
        for (module, name) in orig:
            setattr(module, name, wrapped[name])
        try:
            yield self
        finally:
            for (module, name), fn in orig.items():
                setattr(module, name, fn)


@contextlib.contextmanager
def profile():
    """``torch.profiler`` over host and device activity for the duration."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def analyse(prof) -> dict:
    """The device's work within the trace's ``portbench.window`` span: its
    length, busy seconds, seconds and launches by kind, the top device
    operations and the idle gaps by what the host was doing."""
    events = prof.profiler.kineto_results.events()
    # record_function spans (the benchmark's, the optimizer's "Optimizer.step#Adam.step")
    # are mirrored on the device's timeline; they are no device work. A kernel's name
    # may hold "#" too (a lambda's, "{lambda(int)#1}"), so they go by their host names.
    spans = {e.name() for e in events if not _is_device(e) and e.is_user_annotation()}
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    marks = {}
    for e in events:
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if _is_device(e):
            if not (e.is_user_annotation() or name in spans):
                dev.append((start, end, name))
        else:
            if name == "portbench.window":
                marks[name] = (start, end)
            host.append((start, end, name))
    if "portbench.window" not in marks:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = marks["portbench.window"]
    dev = sorted(d for d in dev if d[0] >= lo and d[1] <= hi)
    busy_ns, intervals = 0, []
    by_kind: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    by_name: Dict[str, float] = collections.Counter()
    for start, end, name in dev:
        if intervals and start <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], end)
        else:
            intervals.append([start, end])
        memop = name.startswith("Memcpy") or name.startswith("Memset")
        kind = "copy/set" if memop else kind_of(name)
        by_kind[kind][0] += (end - start) / 1e9
        by_kind[kind][1] += 0 if memop else 1
        by_name[name[:NAME_CHARS]] += (end - start) / 1e9
    busy_ns = sum(e - s for s, e in intervals)
    gaps = []
    edges = [lo] + [x for iv in intervals for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]

    def doing(t):  # the innermost host event running at t (latest start that covers it)
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 50000, -1), -1):
            s, e, name = host[j]
            if e >= t and name != "portbench.window" and name != "ProfilerStep":
                return name
        return "(no host event)"

    idle = collections.Counter()
    for dur, a, b in gaps[:200]:
        idle[doing((a + b) // 2)[:NAME_CHARS]] += dur / 1e9
    return dict(
        window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
        launches=sum(v[1] for v in by_kind.values()),
        kinds={k: dict(seconds=v[0], launches=v[1]) for k, v in by_kind.items()},
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in idle.most_common(10)])
