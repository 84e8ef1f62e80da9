"""``--data_parallel`` inference: ``ScoreModel.enhance`` with the batch split by
rows over one worker process per device.

Counterpart of ``ScoreModel.enhance(mesh=...)`` (``sgmse_tpu/model.py:518-572``):
the batch is zero-padded to a multiple of the device count, each worker
enhances its block of rows, and the padding rows are dropped from the output.
Each worker draws the noise of the whole padded batch from a generator in
the caller's generator's state and keeps its own rows (``parallel.rows``), so
the result equals ``model.enhance`` on one device of the zero-padded batch
with that generator; the caller's generator is left where that call would
leave it.

The workers are processes, not threads: one evaluation of the flagship is
~1,200 eager launches from Python, which threads would take turns at under
the GIL. Each worker holds its own replica of the model and builds, or
loads, its own copy of the kernels on first use. The device list may repeat
a device (``["cuda:0", "cuda:0"]``, ``["cpu", "cpu"]``): a Python-API hook
that runs the split on one card or on the CPU.

What couples rows reduces over a process group of the workers, which each
joins at start-up and leaves when the pool closes: DCUNet's ``CbN`` (batch
statistics in inference too), the ``langevin`` corrector (one step size from
batch means) and the ``rk45`` ODE solver (one step-size control over the
batch's norms). The pool names the group in ``global_rows`` around each call,
and those sums go through it (``parallel.rows.all_sum``), over the global,
zero-padded batch, as JAX reduces over its padded array: every worker takes
the same step sizes, accepts and rejects alike, and stops at the same step.
The group is NCCL where the workers hold distinct cards and gloo otherwise
(the CPU, or a card repeated in the device list: NCCL refuses two ranks on
one device); its rendezvous is a file in a temporary directory of the pool's.
"""
from __future__ import annotations

import io
import itertools
import math
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp

from . import rows
from .dist import init_process_group

READY_TIMEOUT_S = 600.0  # a worker's start: import, replica, first use of the device
# The longest a worker waits in a collective for the others (a kernel build on first
# use included): past it, the call fails rather than hangs.
COLLECTIVE_TIMEOUT_S = 600.0
# The caller's numerics, which each worker takes on: a worker computes as the caller's
# process would (TF32 or not, cuDNN or not, its deterministic algorithms or not).
BACKEND_FLAGS = ((torch.backends.cudnn, "enabled"), (torch.backends.cudnn, "allow_tf32"),
                 (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark"),
                 (torch.backends.cuda.matmul, "allow_tf32"))


def _worker(index: int, count: int, device: str, tasks, results, threads: int,
            group: Optional[dict]) -> None:
    """A worker's loop: build the replica from the first message (the model),
    join the workers' group (``group``: its ``init_method`` and ``backend``;
    None for a pool of one), answer ``ready``, then enhance its rows of each
    task until it gets None."""
    import torch.distributed as dist

    from ..model import ScoreModel  # the worker's own import, after the spawn

    torch.set_num_threads(threads)
    try:
        payload = tasks.get()
        for (owner, attr), value in zip(BACKEND_FLAGS, payload["backends"]):
            setattr(owner, attr, value)
        model = ScoreModel.from_config(payload["config"])
        model.sde = payload["sde"]
        model.dnn.load_state_dict(torch.load(io.BytesIO(payload["state"]), weights_only=True))
        model = model.to(device, memory_format=torch.channels_last).eval()
        if group is not None:
            init_process_group(group["init_method"], count, index, device,
                               backend=group["backend"], timeout=COLLECTIVE_TIMEOUT_S)
    except Exception:  # noqa: BLE001 - reported to the parent, which raises it
        results.put((None, index, False, traceback.format_exc()))
        return
    results.put((None, index, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            call, y, gen_state, kwargs = task
            if y is None:  # a read of this worker's counters
                results.put((call, index, True, (_counters(**kwargs), None)))
                continue
            try:
                generator = torch.Generator(device=device)
                generator.set_state(torch.from_numpy(gen_state))
                with rows.global_rows(index, count, dist.group.WORLD if group else None):
                    out = model.enhance(y, generator=generator, timeit=True, **kwargs)
                results.put((call, index, True, (out, generator.get_state().numpy()
                                                 if index == 0 else None)))
            except Exception:  # noqa: BLE001 - the caller's future gets it
                results.put((call, index, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _counters(collectives: bool = False, reset: bool = False) -> Dict:
    """This process's kernel launch counters, or with ``collectives`` its
    collectives' count and host seconds (``parallel.rows.COLLECTIVES``); set
    to 0 with ``reset`` after the read."""
    if not collectives:
        return _launch_counts(reset)
    counts = dict(rows.COLLECTIVES)
    if reset:
        rows.COLLECTIVES.update(calls=0, seconds=0.0)
    return counts


def _launch_counts(reset: bool = False) -> Dict[str, int]:
    """This process's kernel launch counters (``ops``), set to 0 with ``reset``."""
    from ..ops import group_norm as gn, residual_merge as rm, upfirdn2d as ufd

    counters = {"upfirdn2d": (ufd.upfirdn2d_cuda, "launches"),
                "upfirdn2d_adjoint": (ufd.upfirdn2d_cuda, "adjoint_launches"),
                "group_norm_act": (gn.group_norm_act_cuda, "launches"),
                "group_norm_act_bwd": (gn.group_norm_act_bwd_cuda, "launches"),
                "fir_conv": (ufd.fir_conv_cuda, "launches"),
                "residual_merge": (rm.residual_merge_cuda, "launches")}
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    if reset:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
    return counts


class DataParallelModel:
    """A ScoreModel whose :meth:`enhance` runs on a pool of worker processes,
    one per entry of ``devices``. It stands in for the model where the entry
    points use one (``enhance.main``, ``BatchingEnhancer``): the attributes
    they read are the model's (the model stays where it is, and the workers
    get a copy of its weights). Close it (or use it as a context manager) to
    stop the workers. Each worker takes its share of the caller's CPU threads
    and the caller's cuDNN and TF32 settings (``BACKEND_FLAGS``)."""

    def __init__(self, model, devices: Sequence):
        self.model = model
        self.devices = [torch.device(d) for d in devices]
        if not self.devices or len({d.type for d in self.devices}) != 1:
            raise ValueError(f"devices {devices}: one or more of one type")
        self._rendezvous, group = None, None
        if len(self.devices) > 1:
            distinct_cards = (self.devices[0].type == "cuda"
                              and len({d.index for d in self.devices}) == len(self.devices))
            self._rendezvous = tempfile.mkdtemp(prefix="sgmse_pool_")
            group = dict(init_method="file://" + os.path.join(self._rendezvous, "store"),
                         backend="nccl" if distinct_cards else "gloo")
        threads = max(1, torch.get_num_threads() // len(self.devices))
        # The weights go as bytes through the pipe, not as tensors in shared memory,
        # which a container may hold small.
        state = io.BytesIO()
        torch.save({k: v.detach().cpu() for k, v in model.dnn.state_dict().items()}, state)
        payload = dict(config=model.config_dict(), sde=model.sde, state=state.getvalue(),
                       backends=[getattr(owner, attr) for owner, attr in BACKEND_FLAGS])
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in self.devices]
        self._procs = [ctx.Process(target=_worker, daemon=True, name=f"sgmse-enhance-{i}",
                                   args=(i, len(self.devices), str(d), self._tasks[i],
                                         self._results, threads, group))
                       for i, d in enumerate(self.devices)]
        self._calls = itertools.count()
        self._pending: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._closed = False
        for p, q in zip(self._procs, self._tasks):
            p.start()
            q.put(payload)  # through the queue: see parallel.dist.spawn
        try:
            self._wait_ready()
        except BaseException:
            self.close()
            raise
        self._receiver = threading.Thread(target=self._receive, daemon=True,
                                          name="sgmse-enhance-results")
        self._receiver.start()

    # --- what the entry points read of a model ---------------------------------------------

    @property
    def device(self) -> torch.device:
        """The workers' first device: where a caller's generator lives."""
        return self.devices[0]

    def __getattr__(self, name):  # spec, sr, sde, sde_name, backbone, ...
        if name in ("model", "devices"):
            raise AttributeError(name)
        return getattr(self.model, name)

    # --- enhancement ------------------------------------------------------------------------

    def enhance(self, y_wav, generator: Optional[torch.Generator] = None,
                timeit: bool = False, prior_noise=None, corrector_noise=None,
                evaluation_lock=None, **kwargs):
        """``ScoreModel.enhance`` of ``y_wav`` (``(L,)`` or ``(B, L)``) with the
        same arguments and results, the batch split over the workers.
        ``evaluation_lock`` is not needed (each worker launches from its own
        process) and is ignored. Injected noise is split by rows too (its
        batch axis is its fourth from last), zero-padded like the batch. The
        SDE goes with every call, so that one set on this object after the
        workers started (``model.sde = ...``, as the serving entry point sets
        its sampler type) is the one they sample with."""
        kwargs["sde"] = kwargs.get("sde") or self.sde
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        start = time.time() if timeit else None
        y = np.asarray(y_wav, dtype=np.float32)
        squeeze = y.ndim == 1
        y = y[None] if squeeze else y
        n, count = y.shape[0], len(self.devices)
        rows = math.ceil(n / count)
        y = np.concatenate([y, np.zeros((rows * count - n, y.shape[1]), np.float32)])

        def split(noise):
            if noise is None:
                return [None] * count
            noise = np.asarray(noise)
            axis = noise.ndim - 4
            pad = [(0, 0)] * noise.ndim
            pad[axis] = (0, rows * count - noise.shape[axis])
            noise = np.pad(noise, pad)
            return [np.take(noise, range(i * rows, (i + 1) * rows), axis=axis)
                    for i in range(count)]

        priors, correctors = split(prior_noise), split(corrector_noise)
        state = generator.get_state().numpy()  # numpy: pickled, not in shared memory
        future = self._submit(lambda i: (y[i * rows:(i + 1) * rows], state, dict(
            kwargs, prior_noise=priors[i], corrector_noise=correctors[i])))
        parts, gen_state = future.result()
        generator.set_state(torch.from_numpy(gen_state))
        x_hat = np.concatenate([p[0] for p in parts])[:n]
        trajectory = None
        if len(parts[0]) == 4:  # (x_hat, trajectory, nfe, rtf)
            trajectory = np.concatenate([p[1] for p in parts], axis=1)[:, :n]
        nfe = parts[0][-2]
        if squeeze:
            x_hat = x_hat[0]
        out = (x_hat,) if trajectory is None else (x_hat, trajectory)
        if timeit:
            return (*out, nfe, (time.time() - start) / (x_hat.shape[-1] / self.model.sr))
        return out if trajectory is not None else x_hat

    def launch_counts(self, reset: bool = False) -> Dict[str, int]:
        """The workers' kernel launch counters, summed (each worker counts the
        launches of its own process); with ``reset`` each is set to 0 after
        the read."""
        future = self._submit(lambda i: (None, None, dict(reset=reset)))
        parts, _ = future.result()
        return {k: sum(p[k] for p in parts) for k in parts[0]}

    def collective_counts(self, reset: bool = False) -> List[Dict]:
        """Each worker's collectives (``calls``) and the host seconds it spent
        in them (``seconds``) since the last reset; with ``reset`` each is set
        to 0 after the read."""
        future = self._submit(lambda i: (None, None, dict(collectives=True, reset=reset)))
        return future.result()[0]

    def enhance_long(self, y_wav, generator: Optional[torch.Generator] = None, **kwargs):
        """``ScoreModel.enhance_long`` with each chunk enhanced through the pool."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.model.enhance_long(y_wav, generator=generator, enhance=self.enhance,
                                       **kwargs)

    # --- the workers ------------------------------------------------------------------------

    def _submit(self, task_of) -> Future:
        """Put ``(call, *task_of(i))`` on worker i's queue, for every worker
        (under the lock: every worker sees the calls in one order); the future
        of (every worker's answer, worker 0's generator state)."""
        future: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("DataParallelModel is closed")
            call = next(self._calls)
            self._pending[call] = dict(future=future, parts=[None] * len(self._tasks),
                                       left=len(self._tasks))
            for i, q in enumerate(self._tasks):
                q.put((call, *task_of(i)))
        return future

    def _wait_ready(self) -> None:
        ready, deadline = set(), time.monotonic() + READY_TIMEOUT_S
        while len(ready) < len(self._procs):
            try:
                _, index, ok, err = self._results.get(timeout=1.0)
            except queue.Empty:
                self._raise_if_dead()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"enhance workers not ready after {READY_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"enhance worker {index} ({self.devices[index]}) failed "
                                   f"to start:\n{err}")
            ready.add(index)

    def _raise_if_dead(self) -> None:
        dead = [(p.name, p.exitcode) for p in self._procs if p.exitcode is not None]
        if dead:
            raise RuntimeError(f"enhance workers exited: {dead}")

    def _receive(self) -> None:
        """Route the workers' answers to the calls' futures; fail every
        pending call if a worker dies."""
        while True:
            try:
                call, index, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                with self._lock:
                    if self._closed:
                        return
                try:
                    self._raise_if_dead()
                except RuntimeError as e:
                    self._fail_all(e)
                    return
                continue
            except (EOFError, OSError):
                return
            with self._lock:
                entry = self._pending.get(call)
                if entry is None:
                    continue
                if not ok:
                    del self._pending[call]
                    entry["future"].set_exception(RuntimeError(
                        f"enhance worker {index} ({self.devices[index]}) failed:\n{value}"))
                    continue
                out, gen_state = value
                entry["parts"][index] = out
                if index == 0:
                    entry["gen_state"] = gen_state
                entry["left"] -= 1
                if entry["left"] == 0:
                    del self._pending[call]
                    entry["future"].set_result((entry["parts"], entry["gen_state"]))

    def _fail_all(self, error: Exception) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for entry in pending.values():
            entry["future"].set_exception(error)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the workers (after the tasks they hold) and the receiver."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join()
        receiver = getattr(self, "_receiver", None)
        if receiver is not None:
            receiver.join(timeout)
        self._fail_all(RuntimeError("DataParallelModel closed"))
        for q in (*self._tasks, self._results):
            q.cancel_join_thread()  # what a dead worker never read is dropped
            q.close()
        if self._rendezvous is not None:
            shutil.rmtree(self._rendezvous, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def local_devices(device) -> List[torch.device]:
    """The devices of ``--data_parallel``: every visible GPU for a CUDA device,
    ``device`` itself otherwise; a list is taken as it is (the test hook)."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]
