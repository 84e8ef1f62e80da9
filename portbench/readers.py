"""Arithmetic that the per-layer metric readers (``metrics/*.py``) share.

A reader's ``read(ctx)`` takes the traced run's context: ``analysis`` (the
device trace, :func:`portbench.trace.analyse`), ``calls`` (kernel calls by
signature, :class:`portbench.trace.Calls`), ``window`` (what the driver
counted in the traced stretch), ``untraced`` (what it counted in the same
stretch run before, without the profiler), ``config``, ``peak`` (bytes). It returns the metric's value, or
None where the run has nothing to read; a share of a roofline or of a peak is
never returned as 0 for want of a reading.
"""
from __future__ import annotations

from typing import Optional

from .counts import kernels, network, peaks


def per(ctx, seconds_or_count: float, unit_key: str, scale: float = 1.0) -> Optional[float]:
    """``seconds_or_count`` per unit of the window's ``unit_key`` (nfe, steps)."""
    units = ctx["window"].get(unit_key)
    return None if not units else seconds_or_count * scale / units


def roofline_pct(ctx, names, kind: str) -> Optional[float]:
    """The frozen bounds of the window's calls to kernels ``names`` over the
    traced time of kernels of ``kind``, in percent."""
    traced = ctx["analysis"]["kinds"].get(kind, {}).get("seconds", 0.0)
    bound = sum(n * kernels.bound_s(name, sig)
                for (name, sig), n in ctx["calls"].counts.items() if name in names)
    if traced <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / traced


def idle_pct(ctx) -> Optional[float]:
    a = ctx["analysis"]
    return None if a["window_s"] <= 0 else 100.0 * (1.0 - a["busy_s"] / a["window_s"])


def mfu_pct(ctx, peak: str) -> Optional[float]:
    """The untraced stretch's network FLOPs (``work``: rows, frequency bins,
    frames and forward-equivalents of each batch or step) over its wall time
    by the host's clock, against the ``peak`` rate, in percent."""
    w = ctx["untraced"]
    flops = sum(k * network.forward_flops(ctx["config"], r, f, t) for r, f, t, k in w["work"])
    if not flops or w["wall_s"] <= 0:
        return None
    return 100.0 * flops / w["wall_s"] / peaks.FLOPS[peak]
