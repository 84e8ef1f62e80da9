"""``sgmse_tpu_torch.utils.profiling`` on the CPU: ``rtf_harness`` runs its
warm-up and timed calls and reports consistent numbers, ``trace`` writes a
Chrome trace holding the traced op, ``debug_nans`` makes a NaN-producing
backward raise and restores the previous mode, and ``span`` marks the port's
stages in a profiler's trace (and nothing without one): enhancement on each
sampler, a train step and a loader epoch, each span where it belongs."""
import collections
import json

import numpy as np
import pytest
import torch

from sgmse_tpu_torch import train
from sgmse_tpu_torch.data.dataset import Specs, WavLoader
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.utils import profiling

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), n_fft=62,
           hop_length=16)
WAV = (0.3 * np.random.default_rng(0).standard_normal((2, 1008))).astype(np.float32)  # 64 frames


def test_rtf_harness_counts_warmup_and_reps():
    calls = []
    out = profiling.rtf_harness(lambda: calls.append(torch.ones(4).sum()), audio_seconds=2.0,
                                warmup=2, reps=3)
    assert len(calls) == 5
    assert out["wall_s"] > 0 and out["rtf"] == pytest.approx(out["wall_s"] / 2.0)
    assert out["inv_rtf"] == pytest.approx(1.0 / out["rtf"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), name="x.json") as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    events = json.loads((tmp_path / "t" / "x.json").read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_nans_raises_in_backward_and_restores():
    before = torch.is_anomaly_enabled()
    x = torch.tensor([0.0], requires_grad=True)
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        y = torch.sqrt(x) * 0.0  # d/dx sqrt at 0 is inf, times 0: NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert torch.is_anomaly_enabled() == before
    with profiling.debug_nans(False):
        assert not torch.is_anomaly_enabled()


def _profiled(fn):
    """(fn's result, the trace's port spans as (start, end, name), by start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len("sgmse."):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("sgmse."))
    return out, spans


def _parents(spans):
    """Each span's innermost enclosing span's name (None at the top), in order;
    raises where two spans overlap without nesting."""
    out, open_ = [], []
    for start, end, name in spans:
        while open_ and open_[-1][0] <= start:
            open_.pop()
        assert not open_ or end <= open_[-1][0], (name, "crosses", open_[-1][1])
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((end, name))
    return out


def _model(backbone="ncsnpp", sde="ouve", **kw):
    model = ScoreModel(backbone, sde, **NET, **kw)
    model.init_params(torch.Generator().manual_seed(0))
    return model


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def record_function(name):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    a, b = profiling.span("net"), profiling.span("sampler.step")
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("case", ["pc", "sb_ode", "rk4"])
def test_enhance_spans_nest_per_step_and_evaluation(case):
    """PC (N=2, ald: two evaluations a step), the bridge's ode (N=3, one) and
    rk4 (N=2, four a step and the denoising step's one outside them): one prep,
    sampler and post, a step span per step inside the sampler, an evaluation
    span per evaluation; the output bit for bit as without the profiler."""
    if case == "sb_ode":
        model, kw, steps, nets = _model("ncsnpp_v2", "sbve", N=3,
                                        loss_type="data_prediction"), {}, 3, 3
    elif case == "pc":
        model, kw, steps, nets = _model(), dict(N=2, corrector="ald"), 2, 4
    else:
        model, kw, steps, nets = _model(), dict(N=2, sampler_type="ode", method="rk4"), 2, 9
    model.eval()
    quiet = model.enhance(WAV, **kw)
    traced, spans = _profiled(lambda: model.enhance(WAV, **kw))
    np.testing.assert_array_equal(traced, quiet)
    parents = _parents(spans)
    assert [n for n, p in parents if p is None] == ["enhance.prep", "sampler", "enhance.post"]
    counts = collections.Counter(parents)
    assert counts[("sampler.step", "sampler")] == steps
    assert counts[("net", "sampler.step")] == (nets - 1 if case == "rk4" else nets)
    assert counts[("net", "sampler")] == (1 if case == "rk4" else 0)  # rk4's denoising step
    assert len(parents) == 3 + steps + nets


def test_train_step_spans_the_network_backward_and_optimizer():
    model = _model()
    state = train.create_train_state(model, torch.Generator().manual_seed(0))
    x, y = WAV, WAV[::-1].copy()
    _, spans = _profiled(lambda: train.train_step(model, state, x, y,
                                                  torch.Generator().manual_seed(1)))
    assert _parents(spans) == [("train.step", None), ("net", "train.step"),
                               ("train.backward", "train.step"),
                               ("train.optimizer", "train.step")]


def test_loader_epoch_spans_its_prologue_and_each_wait(tmp_path):
    for kind in ("clean", "noisy"):
        (tmp_path / "train" / kind).mkdir(parents=True)
        for i in range(5):
            write_wav(tmp_path / "train" / kind / f"u{i}.wav", WAV[0, :800], 16000)
    loader = WavLoader(Specs(str(tmp_path), "train", dummy=False, shuffle_spec=True,
                             num_frames=16, hop_length=16), batch_size=2, shuffle=True,
                       num_workers=2, use_native=False)
    batches, spans = _profiled(lambda: list(loader))
    assert len(batches) == len(loader) == 2
    assert [n for _, _, n in spans] == ["data.epoch", "data.wait", "data.wait"]
    assert _parents(spans) == [(n, None) for _, _, n in spans]
