"""Serving: dynamic batching of enhancement requests, and its HTTP
entry point.

    python -m sgmse_tpu_torch.serve (--ckpt DIR | --weights W.npz [--config C.json]) \\
        [--port 8000 --batch_size 8 --max_delay_ms 100 --warm_seconds 2 4 \\
         --precision bfloat16]
    curl -s --data-binary @noisy.wav http://127.0.0.1:8000/enhance -o enhanced.wav

Counterpart of ``sgmse_tpu/serve.py`` (:class:`BatchingEnhancer`) and
``cli/serve.py`` (the HTTP front end). The model comes from ``--ckpt`` (a
checkpoint of the port's training) or ``--weights`` with an optional
``--config``, built by ``enhance.build_model``. ``--data_parallel`` splits
every composed batch by rows over every visible GPU, one worker process each
(``parallel.pool``), as ``cli/serve.py`` shards it over its mesh; the
dispatcher, buckets, deadline and ``max_pending`` stay as they are.

Concurrent callers submit waveforms of any length. One dispatcher thread
groups them into batches by padded frame count (multiples of 64 frames, the
granularity the model pads to anyway), pads each batch's rows up to a power of
two, so a bucket has at most log2(max_batch)+1 shapes, all of which
:meth:`BatchingEnhancer.warmup` runs before traffic. A batch launches when it
is full or when its oldest request has waited ``max_delay_ms``. Requests
longer than ``max_seconds`` run alone through ``ScoreModel.enhance_long``.

Each composed batch runs on a pool of executor threads, so that a batch that
is slow to start (a shape cuDNN has not planned yet, a stream's allocator
growth) does not block a warm bucket's batch, and a long-path request does not
hold short ones back until all its chunks are done. Each executor thread owns
one CUDA stream and runs its batches on it; the host fence at the end of
``ScoreModel.enhance`` then waits for that stream only, and the weights are
shared read-only. The executors take turns per network evaluation
(``enhance``'s ``evaluation_lock``): eager PyTorch launches each op from
Python, and threads that launch at the same time hand the GIL to each other
between ops, which made four executors 2.8× slower than one in a burst on an
NVIDIA H100 (PERF.md §6). The first evaluation of a shape an executor has
not run yet takes no turn (:class:`_Turn`): that is where a cold shape spends
its set-up, so a cold batch never waits for a turn, and no one waits for its
set-up. A stall in a later evaluation of a batch does hold the others up.

Unlike JAX's ``BatchingEnhancer``, the dispatcher composes a batch only when an
executor is free: under load the requests wait in their buckets, where they
grow into fuller batches and where ``max_pending`` counts them, instead of in
a queue of small batches behind busy executors. Among the buckets that may
launch, the one whose oldest request waited longest goes first.

Sampling noise is drawn per batch from its own ``torch.Generator`` on the
model's device, seeded with ``np.random.SeedSequence((seed, i))
.generate_state(1)[0]`` for the i-th dispatched batch (:meth:`generator`).
JAX's ``fold_in`` keys cannot be reproduced in PyTorch, so a served output
equals JAX's only with injected noise (``prior_noise`` in
``sampler_kwargs``). A request's output depends on the batch it landed in;
``max_batch=1`` makes outputs independent of batching.

Endpoints (a stdlib ``ThreadingHTTPServer``, one thread per request):

  POST /enhance   body: a WAV file; answer: the enhanced WAV (16-bit PCM at the
                  model's rate). Input is mixed down to mono and resampled.
                  400 for a bad body, 503 with ``"retry": true`` when the
                  queue is full (``--max_pending``), 500 otherwise.
  GET  /healthz   {"status": "ok"} once warmed up.
  GET  /stats     the serving counters (batches, fill, mean wait, ...).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import enhance
from .data.wav import read_wav, resample, write_wav
from .models.ncsnpp import NCSNpp
from .parallel.pool import DataParallelModel
from .utils.inference import target_sr_and_pad


def _ceil64(frames: int) -> int:
    return -(-frames // 64) * 64


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class QueueFullError(RuntimeError):
    """Raised by :meth:`BatchingEnhancer.submit` when ``max_pending`` requests
    are already queued: admission control, so that overload turns into fast
    503s instead of unbounded queueing delay."""


class _Request:
    __slots__ = ("wav", "future", "t_submit", "bucket")

    def __init__(self, wav, future, bucket):
        self.wav = wav
        self.future = future
        self.t_submit = time.time()
        self.bucket = bucket


class _Turn:
    """One batch's turns at the network: ``lock`` is held for each of its
    evaluations, except the first when the shape is ``cold`` on this
    executor. The first evaluation of a shape on a stream is where the set-up
    happens (cuDNN's plans, the caching allocator's growth), so it runs
    beside the other executors' turns instead of inside one."""

    def __init__(self, lock: threading.Lock, cold: bool):
        self._lock, self._free = lock, cold

    def __enter__(self):
        if not self._free:
            self._lock.acquire()

    def __exit__(self, *exc):
        if self._free:
            self._free = False
        else:
            self._lock.release()


class BatchingEnhancer:
    """Dynamic-batching front end over ``ScoreModel.enhance``.

    Args:
        model: a ScoreModel holding its weights, on the device it serves from,
            or a ``parallel.pool.DataParallelModel``, which splits each batch
            by rows over its worker processes (``--data_parallel``); closing
            the enhancer closes it.
        max_batch: largest batch per sampler run.
        max_delay_ms: longest time a request waits for batch-mates.
        max_seconds: longer requests run alone through ``enhance_long``.
        sampler_kwargs: passed to ``enhance`` (N, corrector, snr, prior_noise, ...).
        pad_mode: spectrogram pad mode (``utils.inference.target_sr_and_pad``).
        seed: base seed of the batches' generators (:meth:`generator`).
        chunk_seconds: chunk length of the long path.
        max_pending: :meth:`submit` raises QueueFullError when this many
            requests are queued (None: unbounded).
        execute_workers: executor threads, each with its own CUDA stream.
    """

    def __init__(self, model, *, max_batch: int = 8, max_delay_ms: float = 100.0,
                 max_seconds: float = 30.0, sampler_kwargs: Optional[Dict[str, Any]] = None,
                 pad_mode: str = "zero_pad", seed: int = 0, chunk_seconds: float = 10.0,
                 max_pending: Optional[int] = None, execute_workers: int = 4):
        self.model = model
        self.device = torch.device(model.device)
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.sampler_kwargs = dict(sampler_kwargs or {})
        self.pad_mode = pad_mode
        self.seed = int(seed)
        self.chunk_seconds = float(chunk_seconds)
        self.max_pending = None if max_pending is None else int(max_pending)
        self.hop = model.spec.hop_length
        self.max_frames = _ceil64(1 + int(max_seconds * model.sr) // self.hop)

        self._cond = threading.Condition()
        self._queues: Dict[Optional[int], deque] = {}  # bucket frames -> deque[_Request]
        self._stop = False
        self._batch_counter = 0
        self._idle = max(1, int(execute_workers))  # executors without a batch
        self._evaluation_lock = threading.Lock()
        self._executor = threading.local()  # .warm: the (rows, frames) it has run
        self._stats = {"requests": 0, "batches": 0, "batched_rows": 0,
                       "long_requests": 0, "errors": 0, "rejected": 0,
                       "wait_s_sum": 0.0}
        if self.device.type == "cuda":
            # The weights were copied on the default stream; the executors'
            # streams read them only once the copies are done.
            torch.cuda.synchronize(self.device)
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._workers = [threading.Thread(target=self._work_loop, daemon=True,
                                          name=f"sgmse-serve-exec-{i}")
                         for i in range(self._idle)]
        for w in self._workers:
            w.start()
        self._dispatcher = threading.Thread(target=self._run, daemon=True,
                                            name="sgmse-serve-dispatcher")
        self._dispatcher.start()

    # --- client API ---------------------------------------------------------------------

    def bucket_for(self, num_samples: int) -> Optional[int]:
        """Padded-frame bucket of an utterance, or None for the long path."""
        frames = _ceil64(1 + num_samples // self.hop)
        return frames if frames <= self.max_frames else None

    def samples_for_bucket(self, frames: int) -> int:
        """Waveform length that gives exactly ``frames`` STFT frames."""
        return (frames - 1) * self.hop

    def generator(self, index: int) -> torch.Generator:
        """The generator of the ``index``-th dispatched batch, on the model's
        device: seeded with ``SeedSequence((seed, index)).generate_state(1)[0]``."""
        state = np.random.SeedSequence((self.seed, int(index))).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def submit(self, wav: np.ndarray) -> Future:
        """Queue a 1-D float waveform at the model's rate; returns a Future of
        the enhanced waveform, trimmed to the input's length."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim != 1:
            raise ValueError(f"submit() takes a 1-D waveform, got {wav.shape}")
        fut: Future = Future()
        req = _Request(wav, fut, self.bucket_for(len(wav)))
        with self._cond:
            if self._stop:
                raise RuntimeError("BatchingEnhancer is closed")
            if self.max_pending is not None:
                pending = sum(len(q) for q in self._queues.values())
                if pending >= self.max_pending:
                    self._stats["rejected"] += 1
                    raise QueueFullError(f"{pending} requests pending (max_pending="
                                         f"{self.max_pending}); retry later")
            self._queues.setdefault(req.bucket, deque()).append(req)
            self._stats["requests"] += 1
            self._cond.notify()
        return fut

    def enhance(self, wav: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking wrapper around :meth:`submit`."""
        return self.submit(wav).result(timeout)

    def warmup(self, buckets: List[int], batch_sizes: Optional[List[int]] = None) -> int:
        """Run every (bucket, batch size) shape once, one step long, on every
        executor's stream, before traffic: kernel builds, cuDNN's plans and
        each stream's share of the caching allocator happen here. Batch sizes
        default to every power of two up to max_batch, every shape the
        dispatcher can launch for these buckets. The model's SDE is not
        touched (``enhance.warm_up`` passes a shortened copy down). Its
        evaluations all take turns, its cold ones too, so it would hold up
        traffic: call it before. Returns the NFE of one executor's warm-up."""
        if batch_sizes is None:
            batch_sizes = [1 << i for i in range(self.max_batch.bit_length())
                           if 1 << i <= self.max_batch]
        frames = {(b, int(f)) for f in buckets for b in batch_sizes}
        shapes = {(b, self.samples_for_bucket(f)) for b, f in frames}
        kwargs = dict(self.sampler_kwargs, pad_mode=self.pad_mode,
                      evaluation_lock=self._evaluation_lock)
        # One task per executor: each waits until all are running, so each runs
        # on its own thread, and so on its own stream.
        barrier = threading.Barrier(len(self._workers))
        futs = []
        for _ in self._workers:
            fut: Future = Future()

            def warm(fut=fut):
                try:
                    barrier.wait()
                    gen = torch.Generator(device=self.device).manual_seed(0)
                    nfe = enhance.warm_up(self.model, shapes, gen, kwargs)
                    self._executor.warm.update(frames)
                    fut.set_result(nfe)
                except BaseException as e:  # noqa: BLE001 - the caller gets it
                    barrier.abort()
                    fut.set_exception(e)

            self._work.put(warm)
            futs.append(fut)
        return [f.result() for f in futs][0]

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            s = dict(self._stats)
            s["pending"] = sum(len(q) for q in self._queues.values())
        if s["batches"]:
            s["mean_wait_ms"] = 1000.0 * s["wait_s_sum"] / max(
                1, s["batched_rows"] + s["long_requests"])
            s["mean_batch_fill"] = s["batched_rows"] / s["batches"]
        return s

    def close(self, timeout: float = 30.0) -> None:
        """Serve what is queued, then stop the dispatcher and the executors."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(timeout)
        for _ in self._workers:
            self._work.put(None)
        for w in self._workers:
            w.join()
        if isinstance(self.model, DataParallelModel):
            self.model.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- dispatcher and executors ----------------------------------------------------------

    def _pick_batch(self, now: float):
        """Under the lock: (requests, None) when a batch may launch, (None, wait
        seconds) when the dispatcher should sleep, (None, None) when idle. A
        bucket may launch when it holds a full batch, when its oldest request
        has waited max_delay, when it is the long path (one request at a
        time) or when closing; of those, the oldest request's goes first."""
        ready, best_deadline = None, None
        for frames, q in self._queues.items():
            if not q:
                continue
            deadline = q[0].t_submit + self.max_delay
            if len(q) >= self.max_batch or frames is None or self._stop or deadline <= now:
                if ready is None or q[0].t_submit < ready[1][0].t_submit:
                    ready = (frames, q)
            elif best_deadline is None or deadline < best_deadline:
                best_deadline = deadline
        if ready is not None:
            frames, q = ready
            take = 1 if frames is None else min(len(q), self.max_batch)
            return [q.popleft() for _ in range(take)], None
        if best_deadline is not None:
            return None, best_deadline - now
        return None, None

    def _run(self):
        while True:
            with self._cond:
                while True:
                    # Compose a batch only for a free executor: until then the
                    # requests wait in their buckets and batches fill up.
                    reqs, wait = self._pick_batch(time.time()) if self._idle else (None, None)
                    if reqs is not None:
                        break
                    if self._stop and not any(self._queues.values()):
                        return
                    self._cond.wait(timeout=wait)
                self._idle -= 1
                index = self._batch_counter
                self._batch_counter += 1
            self._work.put(lambda reqs=reqs, index=index: self._execute_safe(reqs, index))

    def _work_loop(self):
        self._executor.warm = set()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            while True:
                task = self._work.get()
                if task is None:
                    return
                task()

    def _execute_safe(self, reqs: List[_Request], index: int):
        try:
            self._execute(reqs, index)
        except Exception as e:  # noqa: BLE001 - failures belong to the callers
            with self._cond:
                self._stats["errors"] += len(reqs)
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            with self._cond:
                self._idle += 1
                self._cond.notify_all()

    def _turn(self, rows: int, frames: Optional[int]) -> _Turn:
        """This executor's turn for a batch of ``(rows, frames)``, which is
        warm from then on."""
        warm = self._executor.warm
        turn = _Turn(self._evaluation_lock, cold=(rows, frames) not in warm)
        warm.add((rows, frames))
        return turn

    def _execute(self, reqs: List[_Request], index: int):
        now = time.time()
        generator = self.generator(index)
        if reqs[0].bucket is None:
            (req,) = reqs
            chunk = min(len(req.wav), int(self.chunk_seconds * self.model.sr))
            out = self.model.enhance_long(req.wav, chunk_seconds=self.chunk_seconds,
                                          generator=generator, pad_mode=self.pad_mode,
                                          evaluation_lock=self._turn(1, self.bucket_for(chunk)),
                                          **self.sampler_kwargs)
            with self._cond:
                self._stats["long_requests"] += 1
                self._stats["batches"] += 1
                self._stats["wait_s_sum"] += now - req.t_submit
            req.future.set_result(np.asarray(out[: len(req.wav)]))
            return
        # Rows padded up to a power of two: one shape per (bucket, pow2 batch).
        n = self.samples_for_bucket(reqs[0].bucket)
        yb = np.zeros((_next_pow2(len(reqs)), n), np.float32)
        for i, r in enumerate(reqs):
            yb[i, : len(r.wav)] = r.wav[:n]
        turn = self._turn(len(yb), reqs[0].bucket)
        x_hat = np.asarray(self.model.enhance(yb, generator=generator, pad_mode=self.pad_mode,
                                              evaluation_lock=turn, **self.sampler_kwargs))
        with self._cond:
            self._stats["batches"] += 1
            self._stats["batched_rows"] += len(reqs)
            self._stats["wait_s_sum"] += sum(now - r.t_submit for r in reqs)
        for i, r in enumerate(reqs):
            r.future.set_result(x_hat[i, : len(r.wav)])


# --- the HTTP entry point ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--ckpt", type=str, default=None,
                        help="Checkpoint directory of the port's training (EMA weights and "
                             "its config.json)")
    source.add_argument("--weights", type=str, default=None,
                        help=".npz of the JAX parameter tree (convert.save_npz)")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON of the JAX ScoreModel.config_dict(); without it, the "
                             "flagship from the model flags")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="Most utterances per sampler run")
    parser.add_argument("--max_delay_ms", type=float, default=100.0,
                        help="Longest time a request waits for batch-mates")
    parser.add_argument("--max_seconds", type=float, default=30.0,
                        help="Longer inputs run alone, in overlapping chunks")
    parser.add_argument("--max_pending", type=int, default=64,
                        help="Admission control: answer 503 when this many requests are "
                             "queued; 0 = unbounded")
    parser.add_argument("--chunk_seconds", type=float, default=10.0,
                        help="Chunk length of the long path")
    parser.add_argument("--warm_seconds", type=float, nargs="*", default=[2.0, 4.0],
                        help="Warm up the buckets of these durations (every power-of-two "
                             "batch size) before serving")
    parser.add_argument("--sampler_type", type=str, default="pc",
                        help="pc or ode (OUVE); ode or sde (SBVE, where pc means ode)")
    parser.add_argument("--corrector", type=str, default="ald",
                        choices=("ald", "langevin", "none"))
    parser.add_argument("--corrector_steps", type=int, default=1)
    parser.add_argument("--snr", type=float, default=0.5)
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--t_eps", type=float, default=0.03,
                        help="The minimum process time (0.03 by default)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_parallel", action="store_true",
                        help="Split every served batch by rows over every local GPU, one "
                             "worker process each")
    NCSNpp.add_argparse_args(parser)
    parser.set_defaults(precision=None)  # float32, or the checkpoint's / --config's
    return parser


def build_enhancer(args, device=None):
    """(model, BatchingEnhancer, target sample rate) of the parsed flags. Runs
    on the card; ``device="cpu"`` is for tests. With ``--data_parallel`` the
    model is a ``parallel.pool.DataParallelModel`` over every GPU (``device``
    may be a list, the pool's test hook), whose workers the enhancer's
    ``close`` stops; each composed batch is split over them."""
    model, _ = enhance.load(args, device, "sgmse_tpu_torch.serve")
    target_sr, pad_mode = target_sr_and_pad(model.backbone)
    sampler_type = args.sampler_type
    if model.sde_name == "sbve" and sampler_type == "pc":
        sampler_type = "ode"  # the bridge's pc is its ode sampler
    model.sde = dataclasses.replace(model.sde, sampler_type=sampler_type)
    sampler_kwargs = dict(N=args.N, corrector=args.corrector,
                          corrector_steps=args.corrector_steps, snr=args.snr)
    enhancer = BatchingEnhancer(
        model, max_batch=args.batch_size, max_delay_ms=args.max_delay_ms,
        max_seconds=args.max_seconds, sampler_kwargs=sampler_kwargs, pad_mode=pad_mode,
        seed=args.seed, chunk_seconds=args.chunk_seconds,
        max_pending=args.max_pending or None)
    return model, enhancer, target_sr


def warm_buckets(enhancer: BatchingEnhancer, seconds, target_sr: int) -> List[int]:
    """The buckets of utterances of these durations (long-path ones left out)."""
    return sorted({b for s in seconds
                   if (b := enhancer.bucket_for(int(s * target_sr))) is not None})


def make_handler(enhancer: BatchingEnhancer, target_sr: int):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, enhancer.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/enhance":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                wav, sr = read_wav(io.BytesIO(self.rfile.read(n)))
                y = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
                if sr != target_sr:
                    y = resample(y, sr, target_sr)
            except Exception as e:  # noqa: BLE001 - a malformed body
                self._json(400, {"error": f"bad WAV body: {e}"})
                return
            try:
                x_hat = enhancer.enhance(y, timeout=600.0)
                buf = io.BytesIO()
                write_wav(buf, x_hat, target_sr)
                self._send(200, buf.getvalue(), "audio/wav")
            except QueueFullError as e:
                self._json(503, {"error": str(e), "retry": True})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *log_args):  # the request log goes to stderr
            print("serve: " + fmt % log_args, file=sys.stderr)

    return Handler


def main(argv=None, device=None) -> None:
    """Load the model, warm up, serve until interrupted. Runs on the card;
    ``device="cpu"`` (not a command-line flag) is for tests."""
    args = build_parser().parse_args(argv)
    model, enhancer, target_sr = build_enhancer(args, device)
    buckets = warm_buckets(enhancer, args.warm_seconds or [], target_sr)
    if buckets:
        print(f"serve: warming {len(buckets)} bucket(s) {buckets} (batch sizes "
              f"1..{args.batch_size}, {len(enhancer._workers)} streams)...", flush=True)
        enhancer.warmup(buckets)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(enhancer, target_sr))
    print(f"serve: ready on http://{args.host}:{args.port} (model {model.backbone}/"
          f"{model.sde_name} @ {target_sr} Hz, {enhancer.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        enhancer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
