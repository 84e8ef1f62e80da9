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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch

_STATE = threading.local()


def current() -> Optional[Tuple[int, int]]:
    """(index, count) of this thread's rows, or None."""
    return getattr(_STATE, "rows", None)


@contextlib.contextmanager
def global_rows(index: int, count: int):
    """Within: batch-first draws cover ``count`` times the rows, and this
    thread keeps the ``index``-th block of them."""
    if not 0 <= index < count:
        raise ValueError(f"row block {index} of {count}")
    previous = current()
    _STATE.rows = (int(index), int(count))
    try:
        yield
    finally:
        _STATE.rows = previous


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
