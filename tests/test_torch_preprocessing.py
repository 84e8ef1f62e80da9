"""The port's corpus scripts and room simulation (``sgmse_tpu_torch.preprocessing``,
``sgmse_tpu_torch.data.room``) against the JAX package's:

- ``create_synthetic_speech`` at 4/2/2 files of 0.5 s, at 16 kHz with seed 7
  and at 48 kHz with seed 9 (the learn demos' corpora): the wavs of
  ``python -m sgmse_tpu_torch.preprocessing.create_synthetic_speech`` are
  byte-identical to those of ``preprocessing/create_synthetic_speech.py``;
- ``room``: ``inverse_sabine``, ``shoebox_rir``, ``simulate`` and
  ``measure_rt60`` equal ``sgmse_tpu.data.room``'s to the last bit;
- the WSJ0 scripts (CHiME3, QUT, REVERB) on synthetic WSJ0 and noise layouts,
  as ``tests/test_room_and_preprocessing.py`` runs the JAX ones: the port's
  modules (called in this process; the synthetic corpus through ``python
  -m``) write the files the JAX scripts write, byte for byte.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sgmse_tpu.data import room as jroom
from sgmse_tpu_torch.data import room as troom
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.preprocessing import create_wsj0_chime3, create_wsj0_qut, create_wsj0_reverb

REPO = Path(__file__).resolve().parent.parent


def _wavs(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.wav"))}


def _run(argv, timeout=300):
    res = subprocess.run([sys.executable, *map(str, argv)], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-2000:]
    return res


@pytest.mark.parametrize("sr,seed", [(16000, 7), (48000, 9)])  # the 16 and 48 kHz demos'
def test_synthetic_speech_is_byte_identical_to_jax(tmp_path, sr, seed):
    flags = ["--num_train", "4", "--num_valid", "2", "--num_test", "2", "--seconds", "0.5",
             "--sr", str(sr), "--seed", str(seed)]
    _run([REPO / "preprocessing" / "create_synthetic_speech.py", tmp_path / "jax", *flags])
    _run(["-m", "sgmse_tpu_torch.preprocessing.create_synthetic_speech", tmp_path / "port",
          *flags])
    jax_wavs, port_wavs = _wavs(tmp_path / "jax"), _wavs(tmp_path / "port")
    assert len(jax_wavs) == 16 and port_wavs == jax_wavs


@pytest.mark.parametrize("rt60,dims", [(0.4, [6.0, 5.0, 3.0]), (0.9, [12.0, 7.5, 4.2])])
def test_room_equals_jax(rt60, dims):
    assert troom.inverse_sabine(rt60, dims) == jroom.inverse_sabine(rt60, dims)
    e_abs, max_order = troom.inverse_sabine(rt60, dims)
    src, mic = [2.0, 2.0, 1.5], [4.0, 3.0, 1.2]
    order = min(3, max_order)
    rir = troom.shoebox_rir(dims, e_abs, src, mic, fs=16000, max_order=order)
    np.testing.assert_array_equal(rir, jroom.shoebox_rir(dims, e_abs, src, mic, fs=16000,
                                                         max_order=order))
    sig = np.random.default_rng(0).standard_normal(1600)
    np.testing.assert_array_equal(troom.simulate(dims, e_abs, src, mic, sig, max_order=order),
                                  jroom.simulate(dims, e_abs, src, mic, sig, max_order=order))
    assert troom.measure_rt60(rir) == jroom.measure_rt60(rir)


def _wsj0(root: Path, freq: float, seed: int):
    rng = np.random.default_rng(seed)
    for split_dir in ("si_tr_s/401", "si_dt_05/401", "si_et_05/401"):
        d = root / split_dir
        d.mkdir(parents=True)
        x = (0.3 * np.sin(2 * np.pi * freq * np.arange(8000) / 16000)
             + 0.01 * rng.standard_normal(8000)).astype(np.float32)
        write_wav(d / "u0.wav", x, 16000)


def test_wsj0_chime3_equals_jax(tmp_path):
    wsj0, chime = tmp_path / "wsj0", tmp_path / "chime3"
    _wsj0(wsj0, 250, 1)
    bg = chime / "data" / "backgrounds"
    bg.mkdir(parents=True)
    rng = np.random.default_rng(1)
    write_wav(bg / "noise0.CH1.wav", (0.1 * rng.standard_normal(32000)).astype(np.float32),
              16000)
    args = [f"{wsj0}/", f"{chime}/"]
    _run([REPO / "preprocessing" / "create_wsj0_chime3.py", *args, f"{tmp_path / 'jax'}/"])
    create_wsj0_chime3.main([*args, f"{tmp_path / 'port'}/"])
    jax_wavs = _wavs(tmp_path / "jax")
    assert len(jax_wavs) == 6 and _wavs(tmp_path / "port") == jax_wavs


def test_wsj0_qut_equals_jax(tmp_path):
    wsj0, qut = tmp_path / "wsj0", tmp_path / "qut"
    _wsj0(wsj0, 260, 2)
    qd = qut / "noises"
    qd.mkdir(parents=True)
    rng = np.random.default_rng(2)
    # CAR loses 2 min at each end: it needs more than 4 min of samples.
    for name, secs in (("CAFE-CAFE-1.wav", 3), ("CAR-WINDOWNB-1.wav", 242),
                       ("HOME-KITCHEN-1.wav", 3), ("STREET-CITY-1.wav", 3)):
        write_wav(qd / name, (0.1 * rng.standard_normal(16000 * secs)).astype(np.float32),
                  16000)
    args = [f"{wsj0}/", f"{qut}/"]
    _run([REPO / "preprocessing" / "create_wsj0_qut.py", *args, f"{tmp_path / 'jax'}/"])
    create_wsj0_qut.main([*args, f"{tmp_path / 'port'}/"])
    jax_wavs = _wavs(tmp_path / "jax")
    assert len(jax_wavs) == 6 and _wavs(tmp_path / "port") == jax_wavs


def test_wsj0_reverb_equals_jax(tmp_path):
    wsj0 = tmp_path / "wsj0"
    _wsj0(wsj0, 300, 0)
    _run([REPO / "preprocessing" / "create_wsj0_reverb.py", "--wsj0_dir", wsj0, "--target_dir",
          tmp_path / "jax"])
    create_wsj0_reverb.main(["--wsj0_dir", str(wsj0), "--target_dir", str(tmp_path / "port")])
    jax_wavs = _wavs(tmp_path / "jax")
    assert len(jax_wavs) == 7 and _wavs(tmp_path / "port") == jax_wavs
    assert any(k.startswith("audio/test/unauralized/") for k in jax_wavs)
