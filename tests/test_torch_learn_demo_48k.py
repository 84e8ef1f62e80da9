"""The 48 kHz learn demo of the port (``sgmse_tpu_torch.tools.learn_demo_48k``)
and the demos' shared scoring, on the CPU:

- ``learn_demo.scores`` equals the JAX tool's ``score``
  (``tools/learn_demo_48k.py``: PESQ at 16 kHz, SI-SDR and ESTOI at the
  files' rate) on the same 48 kHz and 16 kHz files within 1e-6, and at 16 kHz
  it gives what the 16 kHz demo's scoring always gave (PESQ at the file's
  rate, no resampling): bit for bit;
- ``long_utterance`` writes the JAX recipe's 22-s utterance and its clean
  copy byte for byte;
- ``main`` runs end to end with a tiny ``ncsnpp_48k`` (nf 8) and the 48 kHz
  DSP and SDE constants, trained 2 steps on 3/1/1 pairs of 0.6 s, the long
  utterance included: 22 s at 48 kHz out, through ``--chunk_seconds 4``
  with 6 chunks of one chunk's NFE for each of its two files;
- without a card and without ``device``, it raises.
"""
import importlib.util
import inspect
import json
import math
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sgmse_tpu_torch.data.wav import read_wav
from sgmse_tpu_torch.preprocessing import create_synthetic_speech
from sgmse_tpu_torch.tools import learn_demo, learn_demo_48k
from sgmse_tpu_torch.utils.metrics import pesq_wb, si_sdr, stoi

REPO = Path(__file__).resolve().parent.parent
# nf 8 at the demo's four levels (the middle block's attention then spans 96 x 64 positions
# of a 4-s chunk), one res-block per level; 64 training frames (a 0.6-s file covers the crop).
NET = ["--backbone", "ncsnpp_48k", "--sde", "ouve", "--nf", "8", "--ch_mult", "1", "1", "2",
       "2", "--num_res_blocks", "1", "--num_frames", "64", "--N", "1"]
CUT = ["--num_train", "3", "--num_valid", "1", "--num_test", "1", "--seconds", "0.6",
       "--max_steps", "2", "--num_eval_files", "1", "--batch_size", "2", "--N", "1"]


def _jax_tool():
    """``tools/learn_demo_48k.py`` (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location("jax_learn_demo_48k",
                                                  REPO / "tools" / "learn_demo_48k.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def pesq_scorer():
    """Take out a ``pesq`` stub another test module may have left in
    ``sys.modules`` (``tests/_reference_shim.py``), so that PESQ is finite."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(sys.modules, "pesq", raising=False)
        yield


@pytest.mark.parametrize("sr", [48000, 16000])
def test_scores_equal_the_jax_tool(tmp_path, sr):
    create_synthetic_speech.main([str(tmp_path), "--num_train", "0", "--num_valid", "0",
                                  "--num_test", "2", "--seconds", "1.0", "--sr", str(sr),
                                  "--seed", "9"])
    clean, noisy = tmp_path / "test" / "clean", tmp_path / "test" / "noisy"
    got = learn_demo.scores(clean, noisy)
    means = learn_demo.means(got)
    ref = _jax_tool().score(clean, noisy, "noisy")
    for k, want in zip(learn_demo.METRICS, ref):
        assert abs(means[k] - want) <= 1e-6 * max(1.0, abs(want)), (k, means[k], want)
    if sr == 16000:  # the 16 kHz demo's scoring before the resampling rule: unchanged
        for i, f in enumerate(sorted(clean.glob("*.wav"))):
            x, y = read_wav(f)[0][0], read_wav(noisy / f.name)[0][0]
            assert (got["pesq"][i], got["si_sdr"][i], got["estoi"][i]) == (
                pesq_wb(16000, x, y), si_sdr(x, y), stoi(x, y, sr, extended=True))


def test_long_utterance_matches_the_jax_recipe(tmp_path):
    """The JAX tool writes its utterance inline in ``main``: its own lines,
    from the generator to the second wav, run here with its imports."""
    jax_tool = _jax_tool()  # puts the checkout on sys.path, as the tool does for its imports
    from preprocessing.create_synthetic_speech import synth_utterance
    from sgmse_tpu.data.wav import write_wav as jax_write_wav

    lines = inspect.getsource(jax_tool.main).splitlines()
    first = next(i for i, line in enumerate(lines) if "default_rng(123)" in line)
    last = next(i for i, line in enumerate(lines) if '"long0_clean.wav"' in line)
    assert 0 < first < last
    exec(textwrap.dedent("\n".join(lines[first:last + 1])),
         dict(vars(jax_tool), work=tmp_path / "jax", synth_utterance=synth_utterance,
              write_wav=jax_write_wav))

    n = learn_demo_48k.long_utterance(tmp_path / "port")
    assert n == 22 * 48000
    for name in ("long0.wav", "long0_clean.wav"):
        got, want = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / "long" / name)
        assert got == want.read_bytes(), name


def test_learn_demo_48k_runs_end_to_end(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        demo = learn_demo_48k.main([str(tmp_path), *CUT], device="cpu", net_flags=NET)
    finally:
        torch.set_num_threads(threads)
    written = json.loads((tmp_path / "learn_demo_48k.json").read_text())
    assert written["steps"] == demo["steps"] == 2 and demo["test_files"] == 1
    assert demo["config"]["sr"] == 48000 and demo["config"]["n_fft"] == 1534
    assert demo["config"]["theta"] == 2.0 and demo["config"]["sigma_min"] == 0.1
    long = demo["long"]
    for group in ("noisy", "enhanced", "delta"):
        assert all(math.isfinite(v) for v in demo[group].values()), group
        assert all(math.isfinite(v) for v in long[group].values()), group
    assert demo["enhance_nfe"] == 2  # one batch, N = 1 with ald
    # 22 s in 4-s chunks overlapping by 10%: 1 + ceil((22 - 4) / 3.6) = 6 chunks of 2 NFE,
    # for long0.wav and its clean copy.
    assert long["files"] == 2 and long["enhance_nfe"] == 2 * 6 * 2
    assert long["samples"] == long["output_samples"] == 22 * 48000
    out, sr = read_wav(tmp_path / "long_enh" / "long0.wav")
    assert sr == 48000 and out.shape == (1, 22 * 48000) and np.isfinite(out).all()


def test_learn_demo_48k_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        learn_demo_48k.main([str(tmp_path)])
