"""Random draws of the global batch, of which this process keeps its rows.

The JAX package draws t, z, the dropout masks and the sampler's noise for
the whole (global) batch from one key, then shards the arrays over the mesh.
For N processes to compute what one process computes on the global batch,
each draws the global shape from an identically seeded generator and keeps
its own rows: rank r of N, holding B rows, keeps rows [r B, (r + 1) B) of a
draw of N B rows. Every generator then advances as in the one-process run.

:func:`global_rows` sets the (index, count) of this thread's rows for the
duration; :func:`draw` is where the draw sites (``sdes.crandn``,
``model.step_loss``'s diffusion times, the res-blocks' dropout) go through.
Outside it, or with a count of one, :func:`draw` is the plain draw.

What couples the rows of a batch reduces over the process group that holds
its other rows, which :func:`global_rows` names too (``group``): the CbN
statistics of DCUNet, the ``langevin`` corrector's batch means and the
``rk45`` solver's norms (:func:`all_sum`). JAX computes them over its
zero-padded global array; with the group they are the same sums over the same
rows. Without a group, or outside :func:`global_rows`, the sums are this
process's own.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

_STATE = threading.local()
# all_sum's calls and host seconds in them, in this process (the on-card check reads them).
COLLECTIVES = {"calls": 0, "seconds": 0.0}


def current() -> Optional[Tuple[int, int]]:
    """(index, count) of this thread's rows, or None."""
    return getattr(_STATE, "rows", None)


def batch_group():
    """The process group whose ranks hold the other rows of this thread's
    batch, or None."""
    return getattr(_STATE, "group", None)


@contextlib.contextmanager
def global_rows(index: int, count: int, group=None):
    """Within: batch-first draws cover ``count`` times the rows, and this
    thread keeps the ``index``-th block of them; ``group`` (a process group of
    ``count`` ranks, rank ``index`` this process) holds the other blocks."""
    if not 0 <= index < count:
        raise ValueError(f"row block {index} of {count}")
    if group is not None and dist.get_world_size(group) != count:
        raise ValueError(f"a group of {dist.get_world_size(group)} for {count} row blocks")
    previous = current(), batch_group()
    _STATE.rows, _STATE.group = (int(index), int(count)), group
    try:
        yield
    finally:
        _STATE.rows, _STATE.group = previous


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the group of this thread's batch (one
    all-reduce); ``t`` itself without one."""
    g = batch_group()
    if g is not None:
        start = time.perf_counter()
        dist.all_reduce(t, group=g)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["seconds"] += time.perf_counter() - start
    return t


def draw(fn: Callable[..., torch.Tensor], shape, **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (a ``torch.randn``-like function whose first
    axis is the batch), drawn for the global batch and cut to this thread's
    rows."""
    rows = current()
    if rows is None or rows[1] == 1:
        return fn(tuple(shape), **kwargs)
    index, count = rows
    b = shape[0]
    return fn((b * count, *shape[1:]), **kwargs)[index * b:(index + 1) * b]
