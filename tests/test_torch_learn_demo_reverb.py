"""The dereverberation learn demo of the port
(``sgmse_tpu_torch.tools.learn_demo_reverb``) on the CPU, cut down:

- ``synthesize`` at 3/1/1 pairs of 0.5 s, seed 11, writes the wavs of the
  JAX package's ``tools/learn_demo_reverb.py`` byte for byte;
- ``main`` runs end to end on that corpus with a small net (nf 16, n_fft
  126) trained 2 steps: it writes ``learn_demo_reverb.json`` and
  ``_avg_results.txt``, gives finite reverberant, enhanced and delta values,
  enhances with ``--N 50 --snr 0.33`` (100 evaluations for its one batch)
  and scores against ``anechoic``;
- without a card and without ``device``, it raises.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from sgmse_tpu_torch.tools import learn_demo_reverb

REPO = Path(__file__).resolve().parent.parent
NET = ["--backbone", "ncsnpp", "--sde", "ouve", "--nf", "16", "--ch_mult", "1", "1", "2",
       "--num_res_blocks", "1", "--attn_resolutions", "16", "--n_fft", "126", "--hop_length",
       "32", "--num_frames", "64", "--N", "2"]
COUNTS = {"train": 3, "valid": 1, "test": 1}
CUT = ["--num_train", "3", "--num_valid", "1", "--num_test", "1", "--seconds", "0.5",
       "--max_steps", "2", "--num_eval_files", "1", "--batch_size", "2"]


def _wavs(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.wav"))}


def _jax_tool():
    """``tools/learn_demo_reverb.py`` (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location("jax_learn_demo_reverb",
                                                  REPO / "tools" / "learn_demo_reverb.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def pesq_scorer():
    """Take out a ``pesq`` stub another test module may have left in
    ``sys.modules`` (``tests/_reference_shim.py``), so that validation PESQ
    is finite and ``best_pesq`` is written."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(sys.modules, "pesq", raising=False)
        yield


def test_synthesize_is_byte_identical_to_jax(tmp_path):
    _jax_tool().synthesize(tmp_path / "jax", COUNTS, seconds=0.5, seed=11)
    learn_demo_reverb.synthesize(tmp_path / "port", COUNTS, 0.5, learn_demo_reverb.CORPUS_SEED)
    jax_wavs, port_wavs = _wavs(tmp_path / "jax"), _wavs(tmp_path / "port")
    assert len(jax_wavs) == 10 and port_wavs == jax_wavs


def test_learn_demo_reverb_runs_end_to_end(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        demo = learn_demo_reverb.main([str(tmp_path), *CUT], device="cpu", net_flags=NET)
    finally:
        torch.set_num_threads(threads)
    assert (tmp_path / "enh" / "_avg_results.txt").read_text().startswith("PESQ: ")
    written = json.loads((tmp_path / "learn_demo_reverb.json").read_text())
    assert written["steps"] == demo["steps"] == 2 and demo["test_files"] == 1
    for group in ("noisy", "enhanced", "delta"):
        assert all(math.isfinite(v) for v in demo[group].values()), group
    assert demo["enhance_flags"][:4] == ["--N", "50", "--snr", "0.33"]
    assert demo["enhance_nfe"] == 100  # one batch, N = 50 with ald
    assert [v["step"] for v in demo["validations"]] == [1, 2]  # one step per epoch
    # Scored against the anechoic files: the reverberant input against itself would be exact.
    assert demo["noisy"]["si_sdr"] < 60
    assert sorted(p.name for p in (tmp_path / "enh").glob("*.wav")) == ["rev_test_0000.wav"]
    assert "train_profile" not in demo  # the card only


def test_learn_demo_reverb_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        learn_demo_reverb.main([str(tmp_path)])
