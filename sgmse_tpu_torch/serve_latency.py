"""Open-loop load against a running ``python -m sgmse_tpu_torch.serve``:
latency percentiles against offered load.

    python -m sgmse_tpu_torch.serve_latency --url http://127.0.0.1:8000 \\
        --wav a.wav b.wav c.wav --rates 0.5 1 2 --duration 30

Counterpart of ``tools/serve_latency.py``; standard library only. Requests
are fired on a fixed-rate schedule, each from its own thread, whatever the
server answers (arrivals do not wait for completions, so queueing delay is
measured). Each POSTs a WAV body to /enhance; with several ``--wav`` files the
requests cycle through them and the report is also split per file (per padded
bucket, where the files fall into different buckets).

Prints one JSON line per offered rate:
  {"offered_rps": r, "sent": n, "ok": n, "rejected": n (503s), "failed": n,
   "p50_ms": ..., "p95_ms": ..., "p99_ms": ..., "mean_ms": ..., "throughput_rps": ...,
   "per_bucket": {"<seconds>s": {"sent", "ok", "rejected", "p50_ms", "p95_ms",
   "p99_ms"}, ...}}   # several --wav only
Latencies are those of the answered requests (200).

:func:`run_rate` can be called from Python (``chip_smoke.py`` does).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path


def fire(url: str, body: bytes, timeout: float):
    """POST one WAV body to ``url``/enhance: (HTTP status, or -1 where no
    answer came or the answer held no audio; milliseconds)."""
    t0 = time.perf_counter()
    try:
        req = urllib.request.Request(url + "/enhance", data=body,
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status = resp.status if len(resp.read()) > 44 else -1
    except urllib.error.HTTPError as e:
        status = e.code
    except Exception:  # noqa: BLE001 - refused, reset or timed out
        status = -1
    return status, (time.perf_counter() - t0) * 1000.0


def wav_seconds(path: str) -> float:
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def _pct(lat, p):
    return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None


def _summary(results) -> dict:
    lat = sorted(ms for status, ms in results if status == 200)
    return {"sent": len(results), "ok": len(lat),
            "rejected": sum(1 for status, _ in results if status == 503),
            "p50_ms": _pct(lat, 0.50), "p95_ms": _pct(lat, 0.95), "p99_ms": _pct(lat, 0.99),
            "mean_ms": sum(lat) / len(lat) if lat else None}


def run_rate(url: str, bodies, labels, rate: float, duration: float,
             timeout: float) -> dict:
    """Offer ``rate`` requests/s for ``duration`` s, cycling through ``bodies``
    (WAV bytes, named by ``labels``); wait for every answer."""
    n = max(1, int(rate * duration))
    results = [None] * n
    threads = []

    def worker(i):
        results[i] = fire(url, bodies[i % len(bodies)], timeout)

    t_start = time.perf_counter()
    for i in range(n):
        delay = t_start + i / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=worker, args=(i,), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout + 10)
    wall = time.perf_counter() - t_start
    results = [(-1, 0.0) if r is None else r for r in results]
    out = {"offered_rps": rate, **_summary(results)}
    out["failed"] = out["sent"] - out["ok"] - out["rejected"]
    out["throughput_rps"] = out["ok"] / wall
    if len(bodies) > 1:
        out["per_bucket"] = {}
        for j, label in enumerate(labels):
            per = _summary([r for i, r in enumerate(results) if i % len(bodies) == j])
            del per["mean_ms"]
            out["per_bucket"][label] = per
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", type=str, default="http://127.0.0.1:8000")
    ap.add_argument("--wav", type=str, nargs="+", required=True,
                    help="One or more WAVs; several = mixed-length load, reported per file")
    ap.add_argument("--rates", type=float, nargs="+", default=[0.5, 1, 2, 4])
    ap.add_argument("--duration", type=float, default=30.0,
                    help="Seconds of offered load per rate")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--warm", type=int, default=2,
                    help="Requests per wav before the measured windows")
    args = ap.parse_args(argv)

    bodies = [Path(w).read_bytes() for w in args.wav]
    labels = [f"{wav_seconds(w):.2f}s" for w in args.wav]
    for _ in range(args.warm):
        for body in bodies:
            fire(args.url, body, args.timeout)
    for rate in args.rates:
        print(json.dumps(run_rate(args.url, bodies, labels, rate, args.duration,
                                  args.timeout)), flush=True)


if __name__ == "__main__":
    main()
