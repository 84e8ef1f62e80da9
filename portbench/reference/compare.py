"""The numbers that decide ``correct``: each a gap between the program's
output and the plain reference's, judged against a limit in the cell's
``workloads/<cell>.json``.

- :func:`pooled_rel_err` (enhance cells): ||x_prog - x_ref|| / ||x_ref|| over
  the checked rows' own samples together, of the waveforms or of their
  compressed spectrograms (the representation the network works in);
  :func:`worst_row_rel_err`, the same for the worst row.
- :func:`norm_gap` (train cell): for each leaf, the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; the worst leaf's gap.
- :func:`rel_gap`: |a - b| / |b|, the largest over pairs (the losses).
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np


def _rows(prog, ref, lengths, spec):
    """Each row's (program, reference) over its own samples, float64, or of
    their compressed spectrograms with ``spec``; None where the program's
    row is not finite."""
    import torch

    for p, r, n in zip(prog, ref, lengths):
        p, r = np.asarray(p[:n], np.float64), np.asarray(r[:n], np.float64)
        if not np.isfinite(p).all():
            yield None
            continue
        if spec is not None:
            p, r = (spec.wav_to_spec(torch.as_tensor(v, dtype=torch.float32)[None])
                    .to(torch.complex128).numpy() for v in (p, r))
        yield p, r


def pooled_rel_err(prog, ref, lengths: Sequence[int], spec=None) -> float:
    """||x_prog - x_ref|| / ||x_ref|| over all the rows' own samples together
    (of their compressed spectrograms, with ``spec``: a
    :class:`portbench.reference.dsp.Spec`)."""
    num = den = 0.0
    for pair in _rows(prog, ref, lengths, spec):
        if pair is None:
            return float("inf")
        p, r = pair
        num += float(np.sum(np.abs(p - r) ** 2))
        den += float(np.sum(np.abs(r) ** 2))
    return float(np.sqrt(num / max(den, 1e-300)))


def worst_row_rel_err(prog, ref, lengths: Sequence[int], spec=None) -> float:
    """The largest, over the rows, of ||x_prog - x_ref|| / ||x_ref||."""
    worst = 0.0
    for pair in _rows(prog, ref, lengths, spec):
        if pair is None:
            return float("inf")
        p, r = pair
        worst = max(worst, float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30)))
    return worst


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Iterable[str] = None) -> tuple:
    """(worst gap, its leaf) over ``leaves`` (default: every leaf of ``ref``)."""
    leaves = list(ref) if leaves is None else list(leaves)
    median = float(np.median([ref[k] for k in leaves]))
    worst, where = 0.0, None
    for k in leaves:
        p = prog[k]
        gap = float("inf") if not np.isfinite(p) else abs(p - ref[k]) / max(ref[k], median,
                                                                            1e-30)
        if gap > worst or where is None:
            worst, where = gap, k
    return worst, where


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        if not np.isfinite(p):
            return float("inf")
        worst = max(worst, abs(p - r) / max(abs(r), 1e-30))
    return worst
