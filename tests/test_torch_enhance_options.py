"""Two options of the enhance path against the JAX package's behaviour:
``.flac`` inputs (read with soundfile where it imports, else skipped with the
JAX CLI's note) and ``intermediate=True`` (the PC trajectory).

The trajectory is held to JAX's with the same weights and the same injected
(N+1, B, 1, F, T) noise, corrector 'none': 1e-3 of max|.| for the waveform
and for the trajectory (float32 network and FFTs in two frameworks, through N
sampler steps), as ``test_torch_model.py``.
"""
import sys
import types

import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu_torch import convert, enhance
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.model import ScoreModel

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64,
           init_scale=1.0)
STFT = dict(n_fft=126, hop_length=32)
N, B, L = 3, 2, 2016  # 2016 samples -> 64 frames at hop 32
TOL = 1e-3
# The JAX CLI's note for a .flac it cannot read (cli/enhance.py).
FLAC_NOTE = "skipping {}: flac requires the soundfile package"


def test_intermediate_trajectory_matches_jax():
    jmodel = JaxScoreModel("ncsnpp", "ouve", **NET, **STFT)
    x = np.zeros((1, 1, 64, 64), np.complex64)
    variables = jax.jit(jmodel.dnn.init)(jax.random.key(5), x, x, np.full((1,), 0.5, np.float32))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(3)
    y = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
    shape = (N + 1, B, 1, 64, 64)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
         ).astype(np.complex64)
    ref, ref_traj = jmodel.enhance(variables, y, corrector="none", N=N, prior_noise=z,
                                   intermediate=True)
    ref, ref_traj = np.asarray(ref), np.asarray(ref_traj)

    model = ScoreModel("ncsnpp", "ouve", **NET, **STFT)
    model.dnn.load_state_dict(convert.params_from_jax(variables["params"], **NET))
    model = model.to(memory_format=torch.channels_last).eval()
    got, traj, nfe, rtf = model.enhance(y, corrector="none", N=N, prior_noise=z,
                                        intermediate=True, timeit=True)
    assert traj.shape == ref_traj.shape == (N, B, 1, 64, 64) and traj.dtype == np.complex64
    assert nfe == N and rtf > 0
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    assert np.abs(traj - ref_traj).max() <= TOL * np.abs(ref_traj).max()
    # Without timeit: (waveform, trajectory); without the flag: the waveform alone.
    again, traj_again = model.enhance(y, corrector="none", N=N, prior_noise=z,
                                      intermediate=True)
    assert np.array_equal(again, got) and np.array_equal(traj_again, traj)
    assert np.array_equal(model.enhance(y, corrector="none", N=N, prior_noise=z), got)


def _flac_dir(tmp_path):
    write_wav(tmp_path / "a.wav", 0.1 * np.ones(800, np.float32), 16000)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.flac").write_bytes(b"fLaC not really")
    return str(tmp_path)


def test_flac_is_skipped_with_the_jax_note_without_soundfile(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "soundfile", None)  # import soundfile -> ImportError
    items = enhance._load_items(_flac_dir(tmp_path), 16000)
    assert [name for name, _ in items] == ["a.wav"]
    assert FLAC_NOTE.format("sub/b.flac") in capsys.readouterr().err


def test_flac_is_read_with_soundfile(tmp_path, monkeypatch):
    """With soundfile present, a stereo 8 kHz .flac comes in as its first
    channel resampled to the target rate, as the JAX CLI reads it."""
    reads = []

    def read(path, dtype):
        reads.append((path, dtype))
        return np.stack([np.full(400, 0.5), np.zeros(400)], axis=1).astype(dtype), 8000

    monkeypatch.setitem(sys.modules, "soundfile", types.SimpleNamespace(read=read))
    items = dict(enhance._load_items(_flac_dir(tmp_path), 16000))
    assert sorted(items) == ["a.wav", "sub/b.flac"]
    assert reads == [(str(tmp_path / "sub" / "b.flac"), "float32")]
    assert items["sub/b.flac"].shape == (800,)
    assert items["sub/b.flac"][200:600] == pytest.approx(0.5, abs=1e-2)
