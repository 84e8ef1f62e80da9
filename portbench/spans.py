"""Where a traced window's device time goes, by the port's own spans.

:func:`attribute` reads the profiler's events (:func:`portbench.trace.profile`)
within the ``portbench.window`` span, as :func:`portbench.trace.analyse` does,
and charges every nanosecond of the window to one of the port's spans
(``sgmse.<stage>``, ``sgmse_tpu_torch.utils.profiling.span``):

- **the timeline**: on the thread that opened the window, the innermost
  ``sgmse.`` span open at each instant, ``(outside)`` where none is;
- **idle**: every interval in which the device ran nothing, cut exactly at the
  timeline's boundaries, each piece charged to the span open there (the
  device had nothing queued, so the host's stage is what held it);
- **busy**: each device operation charged to the timeline's span at the
  moment its launch call began (the CUDA runtime or driver call of the same
  correlation id; an operation with none, at its own start), so that a kernel
  the autograd engine's thread launched in the backward goes to the span the
  window's thread had open, ``sgmse.train.backward``; busy time merged as
  ``analyse`` merges it, each instant where operations overlap charged to the
  earliest-launched one;
- **blocking calls**: the host seconds and number of the runtime calls that
  make the host wait for the device (``cuda*Synchronize``, ``cudaMemcpy``, and
  a ``cudaMemcpyAsync`` whose copy is pageable, which the host waits out),
  charged as busy is, to the timeline's span at the call's start.

Busy summed over the names is ``analyse``'s ``busy_s``, and busy plus idle is
its ``window_s``, to the nanosecond. :func:`metrics` turns the attribution and
the window's counts into the per-layer readings it makes possible.

Run as a script, it measures a cell as ``run.py --trace 1`` does (set-up, the
traced stretch untraced then traced, the check) and prints the per-span table
on standard error and one JSON line on standard output (also appended to
``--out``): the attribution, the readings, their sums against the window's,
each span count against the window's count of its unit, and the cost of a
span on this host while no profiler runs (:func:`gate_cost`).

    python3 portbench/spans.py --workload <cell> --seed <n> [--out FILE]

The script (:func:`main`, :func:`analysed_with_spans`) stands in until
``trace.analyse`` returns the attribution and ``run.py`` prints its table;
it goes then, and :func:`attribute`, :func:`metrics`, :func:`counts`,
:func:`table` and :func:`gate_cost` stay.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import heapq
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.trace import _is_device  # noqa: E402

PREFIX = "sgmse."
OUTSIDE = "(outside)"
WINDOW = "portbench.window"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def _timeline(spans: List[Tuple[int, int, str]], lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """Contiguous (start, end, innermost span) pieces covering [lo, hi] from
    one thread's spans; a span that outlasts its parent is cut at the parent's
    end, as a stack of open spans has it."""
    pieces, stack, at = [], [], lo

    def emit(end, name):
        nonlocal at
        end = min(max(end, at), hi)
        if end > at:
            pieces.append((at, end, name))
            at = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            emit(*stack.pop())
        emit(start, stack[-1][1] if stack else OUTSIDE)
        stack.append((min(end, stack[-1][0]) if stack else end, name))
    while stack:
        emit(*stack.pop())
    emit(hi, OUTSIDE)
    return pieces


def attribute(prof) -> Dict[str, dict]:
    """{span name: {busy_s, idle_s, host_s, count, blocking_s, blocking}}
    over the window: device busy and idle seconds charged to the span, the
    seconds the window's thread spent inside spans of that name, their
    number, and the host seconds and number of blocking runtime calls charged
    to it; ``(outside)`` holds what no span covers."""
    events = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in events if not _is_device(e) and e.is_user_annotation()}
    window = [e for e in events if not _is_device(e) and e.name() == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi, tid = window[-1].start_ns(), window[-1].end_ns(), window[-1].start_thread_id()
    spans, launches, ops, calls, pageable = [], {}, [], [], set()
    for e in events:
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if _is_device(e):
            if not (e.is_user_annotation() or name in annotations) and start >= lo and end <= hi:
                ops.append((start, end, e.correlation_id()))
            if "Pageable" in name:
                pageable.add(e.correlation_id())
        elif e.is_user_annotation():
            if name.startswith(PREFIX) and e.start_thread_id() == tid and end > lo and start < hi:
                spans.append((start, end, name))
        elif name.startswith("cu") and e.correlation_id():  # a CUDA runtime or driver call
            launches[e.correlation_id()] = start
            if lo <= start < hi and (name in SYNC_CALLS or name == "cudaMemcpyAsync"):
                calls.append((start, end, name, e.correlation_id()))
    pieces = _timeline(spans, lo, hi)
    starts = [p[0] for p in pieces]

    def at(t):
        return pieces[max(bisect.bisect_right(starts, t) - 1, 0)][2] if lo <= t < hi else OUTSIDE

    out = collections.defaultdict(lambda: dict(busy_s=0.0, idle_s=0.0, host_s=0.0, count=0,
                                               blocking_s=0.0, blocking=0))
    out[OUTSIDE]  # reported even where nothing is charged to it
    for start, end, name in spans:
        out[name]["host_s"] += (min(end, hi) - max(start, lo)) / 1e9
        out[name]["count"] += start >= lo
    for start, end, name, corr in calls:
        if name in SYNC_CALLS or corr in pageable:
            row = out[at(start)]
            row["blocking_s"] += (end - start) / 1e9
            row["blocking"] += 1
    # Busy: sweep the operations' edges; the active one launched first is charged.
    ops.sort()
    charge = [at(launches.get(c, s)) for s, _, c in ops]
    edges = sorted({t for s, e, _ in ops for t in (s, e)})
    busy_ns, active, k = collections.Counter(), [], 0
    for a, b in zip(edges, edges[1:]):
        while k < len(ops) and ops[k][0] <= a:
            s, e, c = ops[k]
            heapq.heappush(active, (launches.get(c, s), k, e))
            k += 1
        while active and active[0][2] <= a:
            heapq.heappop(active)
        if active:
            busy_ns[charge[active[0][1]]] += b - a
    # Idle: the window less the merged busy intervals, cut at the timeline's pieces.
    merged = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    idle_ns, j = collections.Counter(), 0
    for a, b in zip(edges[0::2], edges[1::2]):
        while a < b:
            while pieces[j][1] <= a:
                j += 1
            end = min(b, pieces[j][1])
            idle_ns[pieces[j][2]] += end - a
            a = end
    for name, ns in busy_ns.items():
        out[name]["busy_s"] = ns / 1e9
    for name, ns in idle_ns.items():
        out[name]["idle_s"] = ns / 1e9
    return dict(out)


def _sum(spans: Dict[str, dict], names, *keys) -> float:
    return sum(spans.get(PREFIX + n, {}).get(k, 0.0) for n in names for k in keys)


def _ms_per(seconds: float, units) -> Optional[float]:
    return None if not units else 1e3 * seconds / units


def metrics(spans: Dict[str, dict], window: dict) -> Dict[str, Optional[float]]:
    """The per-layer readings of an attribution, over the window's own counts
    (``nfe``, ``batches``, ``sampler_steps`` of an enhance window; ``steps`` of
    a train window): each in ms per unit, None where the unit is not counted."""
    out = {}
    if "nfe" in window:
        out.update({
            "enhance.net_idle_ms_per_nfe": _ms_per(_sum(spans, ["net"], "idle_s"),
                                                   window["nfe"]),
            "enhance.sampler_ms_per_step": _ms_per(
                _sum(spans, ["sampler", "sampler.step"], "busy_s", "idle_s"),
                window.get("sampler_steps")),
            "enhance.prep_ms_per_batch": _ms_per(
                _sum(spans, ["enhance.prep"], "busy_s", "idle_s"), window["batches"]),
            "enhance.post_ms_per_batch": _ms_per(
                _sum(spans, ["enhance.post"], "busy_s", "idle_s"), window["batches"])})
    if "steps" in window:
        data = ["data.epoch", "data.wait"]
        out.update({
            "train.data_wait_ms_per_step": _ms_per(_sum(spans, data, "host_s"), window["steps"]),
            "train.loader_idle_ms_per_step": _ms_per(_sum(spans, data, "idle_s"),
                                                     window["steps"]),
            "train.backward_idle_ms_per_step": _ms_per(
                _sum(spans, ["train.backward"], "idle_s"), window["steps"]),
            "train.optimizer_ms_per_step": _ms_per(
                _sum(spans, ["train.optimizer"], "busy_s", "idle_s"), window["steps"])})
    return out


def counts(spans: Dict[str, dict], window: dict) -> Dict[str, list]:
    """{span: [its count, the window's count of its unit]} for the spans one
    of which runs per unit."""
    units = {"net": "nfe", "sampler.step": "sampler_steps", "enhance.post": "batches",
             "enhance.prep": "batches", "train.backward": "steps", "train.optimizer": "steps",
             "train.step": "steps"}
    return {n: [spans.get(PREFIX + n, {}).get("count", 0), window[u]]
            for n, u in units.items() if u in window}


def table(spans: Dict[str, dict]) -> str:
    rows = [f"{'span':<24}{'busy s':>12}{'idle s':>12}{'host s':>12}{'count':>8}"
            f"{'blocked s':>12}{'blocks':>8}"]
    for name, v in sorted(spans.items(), key=lambda kv: -(kv[1]["busy_s"] + kv[1]["idle_s"])):
        rows.append(f"{name:<24}{v['busy_s']:>12.6f}{v['idle_s']:>12.6f}{v['host_s']:>12.6f}"
                    f"{v['count']:>8}{v['blocking_s']:>12.6f}{v['blocking']:>8}")
    return "\n".join(rows)


def gate_cost(calls: int = 200_000, repeats: int = 3) -> Dict[str, List[float]]:
    """Microseconds a call, ``repeats`` times over ``calls`` calls, while no
    profiler runs: the profiler-state check alone (``check_us``), one
    ``with span(...)`` of the port (``span_us``), one ``with`` of
    ``torch.profiler.record_function`` (``record_function_us``, what an
    ungated span would cost) and one ``with`` of an empty context
    (``empty_with_us``, the floor of any ``with``)."""
    import torch

    from sgmse_tpu_torch.utils.profiling import span

    enabled = torch._C._autograd._profiler_enabled
    empty = contextlib.nullcontext()

    def check(n):
        for _ in range(n):
            enabled()

    def gated(n):
        for _ in range(n):
            with span("net"):
                pass

    def ungated(n):
        for _ in range(n):
            with torch.profiler.record_function("sgmse.net"):
                pass

    def floor(n):
        for _ in range(n):
            with empty:
                pass

    out = {}
    for key, body, n in (("check_us", check, calls), ("span_us", gated, calls),
                         ("record_function_us", ungated, max(calls // 20, 1)),
                         ("empty_with_us", floor, calls)):
        out[key] = []
        for _ in range(repeats):
            t = time.perf_counter()
            body(n)
            out[key].append(1e6 * (time.perf_counter() - t) / n)
    return out


@contextlib.contextmanager
def analysed_with_spans():
    """Within: ``trace.analyse`` also returns the attribution, as ``spans``."""
    from portbench import trace

    analyse = trace.analyse
    trace.analyse = lambda prof: dict(analyse(prof), spans=attribute(prof))
    try:
        yield
    finally:
        trace.analyse = analyse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    args.trace, args.seconds = 1, 0.0  # a traced stretch is a fixed amount of work
    import torch

    from portbench import harness, run

    cell = dict(harness.cell(args.workload),
                **{w["name"]: w for w in harness.benchmark()["workloads"]}[args.workload])
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with analysed_with_spans():
        out = run.measure(args, cell, device)
    a, window = out["analysis"], dict(out["window"])
    if "nfe" in window:  # every sampler of the configurations runs N steps a batch
        window.setdefault("sampler_steps", out["config"]["sde_params"]["N"] * window["batches"])
    spans = a["spans"]
    print(table(spans), file=sys.stderr)
    gate = gate_cost()
    busy = sum(v["busy_s"] for v in spans.values())
    idle = sum(v["idle_s"] for v in spans.values())
    line = dict(
        workload=args.workload, seed=args.seed, kind=torch.cuda.get_device_name(device),
        power_limit=run.power_limit(), correct=harness.checks_passed(out["checks"]),
        forbidden=harness.forbidden_modules(), window_s=a["window_s"], busy_s=a["busy_s"],
        busy_sum_s=busy, idle_sum_s=idle, untraced_wall_s=out["untraced"]["wall_s"],
        traced_wall_s=window["wall_s"],
        units={k: window[k] for k in ("nfe", "batches", "sampler_steps", "steps") if k in window},
        counts=counts(spans, window), metrics=metrics(spans, window), gate_us=gate,
        spans=spans)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
