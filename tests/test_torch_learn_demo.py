"""The learn demo and the quality tools of the port (``sgmse_tpu_torch.tools``)
on the CPU, cut down: a 4/2/2-file corpus of 1-s pairs, a small net (nf 16,
n_fft 126) trained 4 steps over two epochs, enhanced at N = 2. It runs end to
end through ``create_synthetic_speech``, ``train.main``, ``enhance.main`` and
``calc_metrics``, writes ``_avg_results.txt`` and ``learn_demo.json``, and
reports finite metrics, two validations and the noisy baseline; then
``bf16_quality`` and ``quality_vs_nfe`` run on its ``best_pesq``
checkpoint. Without a card and without ``device``, each entry point
raises."""
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from sgmse_tpu_torch.tools import bf16_quality, learn_demo, quality_vs_nfe

NET = ["--backbone", "ncsnpp", "--sde", "ouve", "--nf", "16", "--ch_mult", "1", "1", "2",
       "--num_res_blocks", "1", "--attn_resolutions", "16", "--n_fft", "126", "--hop_length",
       "32", "--num_frames", "64", "--N", "2"]
CUT = ["--num_train", "4", "--num_valid", "2", "--num_test", "2", "--seconds", "1.0",
       "--max_steps", "4", "--max_epochs", "2", "--num_eval_files", "1", "--batch_size", "2",
       "--N", "2"]


@pytest.fixture(scope="module", autouse=True)
def pesq_scorer():
    """The scorer ``pesq_wb`` picks by importing ``pesq``: take out a stub that
    another test module may have left in ``sys.modules``
    (``tests/_reference_shim.py``), whose calls raise, so that validation
    PESQ is finite and ``best_pesq`` is written."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(sys.modules, "pesq", raising=False)
        yield


@pytest.fixture(scope="module")
def demo(tmp_path_factory, pesq_scorer):
    work = tmp_path_factory.mktemp("learn_demo")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        return learn_demo.main([str(work), *CUT], device="cpu", net_flags=NET)
    finally:
        torch.set_num_threads(threads)


def test_learn_demo_runs_end_to_end(demo):
    work = Path(demo["workdir"])
    assert (work / "enh" / "_avg_results.txt").read_text().startswith("PESQ: ")
    assert json.loads((work / "learn_demo.json").read_text())["steps"] == demo["steps"] == 4
    assert demo["test_files"] == 2 and [v["step"] for v in demo["validations"]] == [2, 4]
    for group in ("noisy", "enhanced", "delta"):
        assert all(math.isfinite(v) for v in demo[group].values()), group
    assert demo["enhance_nfe"] == 4  # one batch of 2 files, N = 2 with ald
    assert set(demo["stages"]) >= {"corpus_s", "train_s", "enhance_s", "calc_metrics_s"}
    assert "train_profile" not in demo  # the card only


def test_quality_tools_on_the_demo_checkpoint(demo, tmp_path):
    ds = Path(demo["workdir"]) / "ds" / "test"
    flags = ["--ckpt", demo["best_pesq"], "--test_dir", str(ds / "noisy"), "--clean_dir",
             str(ds / "clean"), "--batch_size", "2"]
    bf16 = bf16_quality.main([*flags, "--N", "2", "--workdir", str(tmp_path / "bf16")],
                             device="cpu")
    assert sorted(bf16["files"]["float32"]) == sorted(bf16["files"]["bfloat16"])
    assert len(bf16["files"]["float32"]) == 2 and len(bf16["mean_delta"]) == 3
    rows = quality_vs_nfe.main([*flags, "--workdir", str(tmp_path / "qvn")], device="cpu",
                               pc_n=(2, 1), ode=False)
    assert [r["name"] for r in rows] == ["pc N=2", "pc N=1", "noisy input"]
    assert [r["nfe"] for r in rows[:2]] == [4, 2]
    assert [c[0] for c in quality_vs_nfe.configs(0.5)] == [
        "pc N=30", "pc N=20", "pc N=10", "pc N=5", "ode rk45"]


def test_learn_demo_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        learn_demo.main([str(tmp_path)])
