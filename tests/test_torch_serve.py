"""The port's serving layer (sgmse_tpu_torch.serve) on the CPU: dynamic
batching, buckets, the long path, errors, admission control, HTTP; and a
served batch and a served long request held against the JAX package's
``BatchingEnhancer`` on the same weights and injected noise.

The network is the tiny NCSN++ of ``tests/test_serve.py`` (nf 16, ch_mult
1,1,2, n_fft 126, hop 32) with N=2 sampling steps and no corrector: the point
is the batching, queueing and IO machinery.
Parity tolerance: 1e-3 of max|x| on the output waveform, as
``test_torch_model.py::test_enhance_matches_jax_with_injected_noise`` (float32
network and FFTs in two frameworks through N sampler steps).
"""
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.serve import BatchingEnhancer as JaxBatchingEnhancer
from sgmse_tpu_torch import convert, serve
from sgmse_tpu_torch.data.wav import read_wav, write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.serve import BatchingEnhancer, QueueFullError, _ceil64, _next_pow2

ROOT = Path(__file__).resolve().parent.parent
NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64)
STFT = dict(n_fft=126, hop_length=32, num_frames=64)
N = 2
SAMPLER = dict(N=N, corrector="none", corrector_steps=0)
TOL = 1e-3


@pytest.fixture(scope="module")
def model():
    m = ScoreModel("ncsnpp", "ouve", sr=16000, **NET, **STFT)
    m.init_params(torch.Generator().manual_seed(0))
    return m.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX model with its own initialisation, and the port's model with
    the same weights."""
    jmodel = JaxScoreModel("ncsnpp", "ouve", sr=16000, **NET, **STFT)
    x = np.zeros((1, 1, 64, 64), np.complex64)
    variables = jax.jit(jmodel.dnn.init)(jax.random.key(0), x, x, np.full((1,), 0.5, np.float32))
    variables = jax.tree.map(np.asarray, variables)
    m = ScoreModel("ncsnpp", "ouve", sr=16000, **NET, **STFT)
    m.dnn.load_state_dict(convert.params_from_jax(variables["params"], **NET))
    return jmodel, variables, m.to(memory_format=torch.channels_last).eval()


def make_enhancer(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 80.0)
    kw.setdefault("max_seconds", 1.0)
    kw.setdefault("chunk_seconds", 0.5)
    kw.setdefault("sampler_kwargs", SAMPLER)
    return BatchingEnhancer(model, **kw)


def _noise(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            ).astype(np.complex64)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_pow2_and_bucket_helpers(model):
    assert [_next_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 16]
    assert _ceil64(1) == 64 and _ceil64(64) == 64 and _ceil64(65) == 128
    with make_enhancer(model) as enh:
        b = enh.bucket_for(2000)  # 1 + 2000 // 32 = 63 -> 64 frames
        assert b == 64
        assert enh.samples_for_bucket(b) >= 2000
        assert enh.bucket_for(16000 * 2) is None  # > max_seconds -> long path
        # Each batch's generator is a documented function of (seed, index).
        a, again, other = enh.generator(3), enh.generator(3), enh.generator(4)
        assert torch.equal(torch.randn(4, generator=a), torch.randn(4, generator=again))
        assert not torch.equal(torch.randn(4, generator=enh.generator(3)),
                               torch.randn(4, generator=other))
        state = np.random.SeedSequence((0, 3)).generate_state(1)[0]
        assert a.initial_seed() == int(state)


def test_batched_requests_one_program(model):
    """4 same-bucket requests submitted together run as ONE batch."""
    rng = np.random.default_rng(0)
    with make_enhancer(model, max_delay_ms=200.0) as enh:
        wavs = [rng.standard_normal(1800 + 40 * i).astype(np.float32) * 0.1 for i in range(4)]
        futs = [enh.submit(w) for w in wavs]
        outs = [f.result(timeout=300) for f in futs]
    for w, o in zip(wavs, outs):
        assert o.shape == w.shape
        assert np.all(np.isfinite(o))
    s = enh.stats()
    assert s["requests"] == 4
    assert s["batches"] == 1
    assert s["batched_rows"] == 4
    assert s["errors"] == 0


def test_max_delay_launches_partial_batch(model):
    """A lone request must not wait forever for batch-mates."""
    rng = np.random.default_rng(1)
    with make_enhancer(model, max_delay_ms=30.0) as enh:
        out = enh.enhance(rng.standard_normal(1600).astype(np.float32) * 0.1, timeout=300)
    assert out.shape == (1600,)
    assert enh.stats()["batches"] == 1


def test_long_input_routes_through_enhance_long(model):
    rng = np.random.default_rng(2)
    wav = rng.standard_normal(32000).astype(np.float32) * 0.1  # 2 s > 1 s cap
    with make_enhancer(model) as enh:
        out = enh.enhance(wav, timeout=600)
    assert out.shape == wav.shape
    assert np.all(np.isfinite(out))
    assert enh.stats()["long_requests"] == 1


def test_error_propagates_to_future(model):
    with make_enhancer(model) as enh:
        with pytest.raises(ValueError):
            enh.submit(np.zeros((2, 100), np.float32))  # 2-D rejected at submit
        # A request that fails in an executor gets the exception on its future.
        enh.sampler_kwargs["corrector"] = "no_such_corrector"
        fut = enh.submit(np.zeros(1600, np.float32))
        with pytest.raises(Exception):
            fut.result(timeout=300)
    assert enh.stats()["errors"] == 1


def test_cold_bucket_does_not_block_warm_bucket(model):
    """A bucket whose batch stalls (a cold shape) must not block a warm
    bucket's batch: batches run on the executor pool."""
    stall = threading.Event()

    class ColdBucketModel:
        """Proxy: enhance() on the 128-frame bucket blocks until released."""

        def __getattr__(self, name):
            return getattr(model, name)

        def enhance(self, yb, **kw):
            if yb.shape[1] > 3000:  # 128-frame bucket (4064 samples)
                stall.wait(timeout=30)
            return model.enhance(yb, **kw)

    rng = np.random.default_rng(7)
    cold_wav = rng.standard_normal(3500).astype(np.float32) * 0.1  # 128 frames
    warm_wav = rng.standard_normal(1600).astype(np.float32) * 0.1  # 64 frames
    with make_enhancer(ColdBucketModel(), max_delay_ms=20.0) as enh:
        f_cold = enh.submit(cold_wav)
        time.sleep(0.05)  # the cold batch dispatches first
        f_warm = enh.submit(warm_wav)
        out = f_warm.result(timeout=60)
        assert np.all(np.isfinite(out))
        assert not f_cold.done(), "the cold batch should still be stalled"
        stall.set()
        assert np.all(np.isfinite(f_cold.result(timeout=60)))
    s = enh.stats()
    assert s["errors"] == 0 and s["batches"] == 2


def test_cold_evaluation_does_not_block_warm_bucket(model, monkeypatch):
    """The executors take turns per network evaluation, but a batch's first
    evaluation (where a cold shape spends its set-up) takes no turn: a batch
    stalled inside it must not block a warm bucket's batch."""
    stalled, release = threading.Event(), threading.Event()
    score_fn = model.score_fn

    def stalling_score_fn():
        fn = score_fn()

        def call(x, *args, **kwargs):
            if x.shape[-1] == 128 and not stalled.is_set():  # the 128-frame bucket
                stalled.set()
                release.wait(timeout=60)
            return fn(x, *args, **kwargs)
        return call

    monkeypatch.setattr(model, "score_fn", stalling_score_fn)
    rng = np.random.default_rng(9)
    cold_wav = rng.standard_normal(3500).astype(np.float32) * 0.1  # 128 frames
    warm_wav = rng.standard_normal(1600).astype(np.float32) * 0.1  # 64 frames
    with make_enhancer(model, max_delay_ms=20.0, execute_workers=2) as enh:
        try:
            enh.warmup([64], [1])
            f_cold = enh.submit(cold_wav)
            assert stalled.wait(timeout=60), "the cold batch never reached the network"
            out = enh.submit(warm_wav).result(timeout=30)
            assert out.shape == warm_wav.shape and np.all(np.isfinite(out))
            assert not f_cold.done(), "the cold batch should still be stalled"
        finally:
            release.set()
        assert np.all(np.isfinite(f_cold.result(timeout=60)))
    s = enh.stats()
    assert s["errors"] == 0 and s["batches"] == 2


def test_backlog_waits_in_its_bucket_for_a_free_executor(model):
    """With every executor busy, new requests wait in their bucket (where
    max_pending counts them) and leave as one fuller batch, the oldest
    bucket's first, once an executor is free."""
    stall, order = threading.Event(), []

    class Stalling:
        def __getattr__(self, name):
            return getattr(model, name)

        def enhance(self, yb, **kw):
            order.append(yb.shape)
            if len(order) == 1:
                stall.wait(timeout=30)
            return model.enhance(yb, **kw)

    rng = np.random.default_rng(8)
    short = [rng.standard_normal(1600).astype(np.float32) * 0.1 for _ in range(4)]  # 64 frames
    long = rng.standard_normal(3500).astype(np.float32) * 0.1  # 128 frames
    with make_enhancer(Stalling(), max_delay_ms=10.0, execute_workers=1, max_pending=4) as enh:
        first = enh.submit(short[0])
        time.sleep(0.1)  # dispatched: the only executor stalls on it
        f_long = enh.submit(long)
        rest = [enh.submit(w) for w in short[1:]]
        time.sleep(0.1)  # past max_delay, but no executor is free
        assert enh.stats()["pending"] == 4 and enh.stats()["batches"] == 0
        with pytest.raises(QueueFullError):
            enh.submit(short[0])
        stall.set()
        for f in [first, f_long, *rest]:
            assert np.all(np.isfinite(f.result(timeout=60)))
    s = enh.stats()
    assert (s["batches"], s["batched_rows"], s["errors"]) == (3, 5, 0)
    assert order == [(1, 2016), (1, 4064), (4, 2016)]  # the long bucket's request is older


def test_closed_enhancer_rejects_submits(model):
    enh = make_enhancer(model)
    enh.close()
    with pytest.raises(RuntimeError):
        enh.submit(np.zeros(1600, np.float32))


def test_admission_control_rejects_when_queue_full(model):
    """max_pending caps the queue: overload turns into QueueFullError (503)."""
    rng = np.random.default_rng(5)
    wav = rng.standard_normal(1600).astype(np.float32) * 0.1
    # A long max_delay: the dispatcher waits for batch-mates, so the submits
    # stack up past the cap.
    with make_enhancer(model, max_delay_ms=2000.0, max_pending=2) as enh:
        futs = [enh.submit(wav), enh.submit(wav)]
        with pytest.raises(QueueFullError):
            enh.submit(wav)
        assert enh.stats()["rejected"] == 1
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=300)))


def test_http_server_roundtrip(model):
    """POST a WAV -> enhanced WAV back; 400 on a bad body; /healthz, /stats."""
    rng = np.random.default_rng(3)
    wav = rng.standard_normal(1800).astype(np.float32) * 0.1
    with make_enhancer(model, max_delay_ms=20.0) as enh:
        server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(enh, 16000))
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert json.load(r)["status"] == "ok"
            buf = io.BytesIO()
            write_wav(buf, wav, 16000)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/enhance",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.headers["Content-Type"] == "audio/wav"
                out, sr = read_wav(io.BytesIO(r.read()))
            assert sr == 16000 and out.shape == (1, 1800) and np.all(np.isfinite(out))
            req = urllib.request.Request(f"http://127.0.0.1:{port}/enhance",
                                         data=b"not a wav", method="POST")
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(req, timeout=30)
            assert exc_info.value.code == 400
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
                assert json.load(r)["requests"] >= 1
        finally:
            server.shutdown()
            server.server_close()
            t.join(timeout=10)


def test_warmup_runs_every_shape_on_every_executor_and_leaves_the_sde(model):
    """warmup runs each (bucket, pow2 batch) shape one step long on each
    executor thread, and passes a shortened SDE down instead of swapping the
    model's."""
    seen = []

    class Recording:
        def __getattr__(self, name):
            return getattr(model, name)

        def enhance(self, yb, **kw):
            seen.append((threading.current_thread().name, yb.shape, kw["N"], kw["sde"].N))
            return model.enhance(yb, **kw)

    sde = model.sde
    with make_enhancer(Recording(), execute_workers=3) as enh:
        nfe = enh.warmup([64])
    assert model.sde is sde
    assert nfe == 3  # batch sizes 1, 2, 4; one step, no corrector
    assert len({name for name, *_ in seen}) == 3
    assert sorted(shape for _, shape, *_ in seen) == sorted(
        [(b, 2016) for b in (1, 2, 4)] * 3)
    assert all(n == 1 and sde_n == 1 for *_, n, sde_n in seen)


def test_served_batch_matches_jax(jax_pair):
    """Four waveforms in one batch through JAX's BatchingEnhancer and the
    port's, with the same weights and the same (N+1, 4, 1, 64, 64) prior and
    predictor noise."""
    jmodel, variables, model = jax_pair
    rng = np.random.default_rng(11)
    wavs = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in (1800, 1850, 1900, 2000)]
    z = _noise(rng, (N + 1, 4, 1, 64, 64))
    kw = dict(max_batch=4, max_delay_ms=500.0, max_seconds=1.0,
              sampler_kwargs=dict(SAMPLER, prior_noise=z))
    outs = {}
    for name, enh in (("jax", JaxBatchingEnhancer(jmodel, variables, **kw)),
                      ("torch", BatchingEnhancer(model, **kw))):
        with enh:
            futs = [enh.submit(w) for w in wavs]
            outs[name] = [f.result(timeout=300) for f in futs]
        assert enh.stats()["batches"] == 1 and enh.stats()["batched_rows"] == 4
    for w, got, ref in zip(wavs, outs["torch"], outs["jax"]):
        assert got.shape == ref.shape == w.shape
        assert _rel(got, np.asarray(ref)) <= TOL


def test_served_long_request_matches_jax(jax_pair):
    """One request on the long path: three 2016-sample chunks, each with the
    same injected (N+1, 1, 1, 64, 64) noise on both sides, overlap-added."""
    jmodel, variables, model = jax_pair
    rng = np.random.default_rng(12)
    wav = (0.2 * rng.standard_normal(4000)).astype(np.float32)
    z = _noise(rng, (N + 1, 1, 1, 64, 64))
    kw = dict(max_batch=4, max_delay_ms=20.0, max_seconds=0.1, chunk_seconds=2016 / 16000,
              sampler_kwargs=dict(SAMPLER, prior_noise=z))
    outs = {}
    for name, enh in (("jax", JaxBatchingEnhancer(jmodel, variables, **kw)),
                      ("torch", BatchingEnhancer(model, **kw))):
        with enh:
            assert enh.bucket_for(len(wav)) is None
            outs[name] = np.asarray(enh.enhance(wav, timeout=300))
        assert enh.stats()["long_requests"] == 1
    assert outs["torch"].shape == outs["jax"].shape == wav.shape
    assert _rel(outs["torch"], outs["jax"]) <= TOL


def test_build_enhancer_from_flags(tmp_path):
    """build_enhancer reads the flags of cli/serve.py: weights from an .npz, the
    bridge's pc mapped to ode on its SDE, admission control off at 0."""
    small = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,))
    model = ScoreModel("ncsnpp", "ouve", **small)
    model.init_params(torch.Generator().manual_seed(0))
    convert.save_npz(tmp_path / "w.npz", convert.jax_tree_from_state_dict(model.dnn.state_dict()))
    flags = ["--weights", str(tmp_path / "w.npz"), "--nf", "16", "--ch_mult", "1", "1", "2",
             "--num_res_blocks", "1", "--attn_resolutions", "16", "--batch_size", "2",
             "--max_pending", "0"]
    args = serve.build_parser().parse_args(flags)
    built, enh, sr = serve.build_enhancer(args, device="cpu")
    with enh:
        assert (sr, enh.max_batch, enh.max_pending, len(enh._workers)) == (16000, 2, None, 4)
        assert built.sde.sampler_type == "pc" and enh.pad_mode == "zero_pad"
        assert enh.sampler_kwargs == dict(N=30, corrector="ald", corrector_steps=1, snr=0.5)
        assert serve.warm_buckets(enh, [2.0, 4.0, 60.0], sr) == [256, 512]
    cfg = ScoreModel("ncsnpp_v2", "sbve", loss_type="data_prediction", **small).config_dict()
    (tmp_path / "sb.json").write_text(json.dumps(cfg))
    args = serve.build_parser().parse_args(flags + ["--config", str(tmp_path / "sb.json")])
    built, enh, _ = serve.build_enhancer(args, device="cpu")
    with enh:
        assert built.sde.sampler_type == "ode" and enh.pad_mode == "reflection"
    # --data_parallel (refused before data parallelism) splits the batches over a
    # worker pool: one worker on the CPU (tests/test_torch_data_parallel.py runs two)
    built, enh, _ = serve.build_enhancer(
        serve.build_parser().parse_args(flags + ["--N", "1", "--corrector", "none",
                                                 "--data_parallel"]), device="cpu")
    with enh:
        assert built.devices == [torch.device("cpu")] and built.sde.sampler_type == "pc"
        assert enh.enhance(np.zeros(2016, np.float32), timeout=120).shape == (2016,)


def test_serve_help_runs():
    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.serve", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--max_pending", "--warm_seconds", "--weights", "--ckpt", "--data_parallel"):
        assert flag in res.stdout


def test_serve_entry_point_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """Without ``device`` the entry point runs on the card; with none present it
    raises instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--weights", str(tmp_path / "w.npz"), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--weights", str(tmp_path / "w.npz"), "--port", "0", "--data_parallel"])
