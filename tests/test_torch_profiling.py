"""``sgmse_tpu_torch.utils.profiling`` on the CPU: ``rtf_harness`` runs its
warm-up and timed calls and reports consistent numbers, ``trace`` writes a
Chrome trace holding the traced op, and ``debug_nans`` makes a NaN-producing
backward raise and restores the previous mode."""
import json

import pytest
import torch

from sgmse_tpu_torch.utils import profiling


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
