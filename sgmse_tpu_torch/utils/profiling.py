"""Timing and tracing helpers. Counterpart of ``sgmse_tpu/utils/profiling.py``,
in PyTorch's idiom:

- :func:`rtf_harness`: the steady-state real-time factor of an enhancement
  call, after explicit warm-up calls, each timed call fenced by
  ``torch.cuda.synchronize`` (kernel launches return before the card is
  done);
- :func:`trace`: a ``torch.profiler`` trace of a block (host, and the card's
  kernels where CUDA is in use), written as a Chrome trace;
- :func:`span`: the port's own named spans (``sgmse.<name>``) in such a
  trace, at no cost beyond one check where no profiler runs;
- :func:`debug_nans`: autograd's anomaly mode for a block (the backward pass
  that produced a NaN raises, naming the forward op), as ``jax_debug_nans``
  is JAX's.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict

import torch

_OFF = contextlib.nullcontext()  # the one span of every call while no profiler runs


def span(name: str):
    """A context manager marking one stage of the port in a profiler's trace:
    ``torch.profiler.record_function("sgmse." + name)`` while a profiler runs
    on this thread, so that the stage is a host event on the clock of the
    card's kernels; otherwise one shared no-op, after one check of the
    profiler's state (``record_function`` costs microseconds a call even
    where nothing records it).

    The spans and what they cover: ``enhance.prep`` (host-to-device copy,
    normalisation, STFT, padding), ``sampler`` (the sampler call),
    ``sampler.step`` (one step of a sampler, or one rk45 attempt),
    ``net`` (one evaluation of the score network, ``ScoreModel.forward``, or
    inside ``enhance_long`` on a card its replay from a CUDA graph),
    ``enhance.post`` (inverse transform, iSTFT, readback), ``enhance.long``
    (one ``ScoreModel.enhance_long`` call, its chunks' enhancement inside),
    ``enhance.long.merge`` (one chunk's crossfade and overlap-add on the
    host; ``model.LONG_SERVED`` counts the calls, chunks and samples),
    ``data.epoch`` (a loader epoch's prologue), ``data.wait`` (waiting for
    one loaded batch), ``train.step``, ``train.backward``,
    ``train.optimizer``."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function("sgmse." + name)


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def rtf_harness(enhance_fn: Callable[[], object], audio_seconds: float,
                warmup: int = 1, reps: int = 3) -> Dict[str, float]:
    """Steady-state real-time factor of a zero-argument enhancement call.

    Returns ``{"rtf": wall/audio (lower better), "inv_rtf": audio/wall,
    "wall_s": mean wall seconds}`` over ``reps`` calls, after ``warmup``
    untimed ones (kernel builds, cuDNN plans, allocator growth)."""
    for _ in range(warmup):
        enhance_fn()
    _fence()
    t0 = time.perf_counter()
    for _ in range(reps):
        enhance_fn()
    _fence()
    wall = (time.perf_counter() - t0) / reps
    return {"rtf": wall / audio_seconds, "inv_rtf": audio_seconds / wall, "wall_s": wall}


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile a block: ``with trace("out/"): step()`` writes
    ``out/trace.json`` (open it in Perfetto or ``chrome://tracing``). The
    card's kernels are traced where CUDA is available, the host always. Yields
    the profiler (``key_averages()`` for a table)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _fence()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / name))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly detection on (or off) for the block: a backward that
    computes a NaN raises, with the traceback of the forward op it came from."""
    previous = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(previous)
