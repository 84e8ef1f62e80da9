"""``python -m sgmse_tpu_torch.calc_metrics`` against ``cli/calc_metrics.py`` on
the same three directories (the fixture of ``tests/test_cli_calc_metrics.py``:
the VoiceBank ``_5dB`` naming rule, two files): the ``_results.csv`` columns
and values equal when parsed, ``_avg_results.txt`` equal line for line, and
the printed report equal. The port writes the CSV without pandas."""
import csv
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sgmse_tpu_torch import calc_metrics
from sgmse_tpu_torch.data.wav import write_wav

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def metric_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("metrics")
    clean, noisy, enhanced = base / "clean", base / "noisy", base / "enhanced"
    for d in (clean, noisy, enhanced):
        d.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    for i in range(2):
        x = (0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
        n = 0.1 * rng.standard_normal(16000).astype(np.float32)
        write_wav(clean / f"u44{i}c020.wav", x, 16000)
        write_wav(noisy / f"u44{i}c020_5dB.wav", x + n, 16000)
        write_wav(enhanced / f"u44{i}c020_5dB.wav", x + 0.3 * n, 16000)
    return clean, noisy, enhanced


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_calc_metrics_equals_the_jax_cli(metric_dirs, tmp_path):
    clean, noisy, enhanced = metric_dirs
    theirs = tmp_path / "jax"
    shutil.copytree(enhanced, theirs)
    flags = ["--clean_dir", str(clean), "--noisy_dir", str(noisy)]
    res = subprocess.run([sys.executable, str(REPO / "cli" / "calc_metrics.py"), *flags,
                          "--enhanced_dir", str(theirs)],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    ours = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.calc_metrics", *flags,
                           "--enhanced_dir", str(enhanced)],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert ours.returncode == 0, ours.stderr
    assert ours.stdout == res.stdout and "SI-SDR:" in ours.stdout

    got, want = _rows(enhanced / "_results.csv"), _rows(theirs / "_results.csv")
    assert got[0] == want[0] and got[0][:6] == list(calc_metrics.COLUMNS)
    assert len(got) == len(want) == 3
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and g[6:] == w[6:]
        assert [float(v) for v in g[1:6]] == [float(v) for v in w[1:6]]
    assert [r[0] for r in got[1:]] == ["u440c020_5dB.wav", "u441c020_5dB.wav"]
    assert ((enhanced / "_avg_results.txt").read_text().splitlines()
            == (theirs / "_avg_results.txt").read_text().splitlines())


def test_csv_fields_as_pandas_writes_them():
    assert calc_metrics._csv_field(float("nan")) == ""
    assert calc_metrics._csv_field(np.float64(3.0)) == "3.0"
    assert calc_metrics._csv_field(1e-05) == "1e-05"
    assert calc_metrics._csv_field(np.float64(0.1) + np.float64(0.2)) == "0.30000000000000004"
    assert calc_metrics._csv_field("builtin-p862") == "builtin-p862"


@pytest.mark.parametrize("name,clean", [("u440c020_5dB.wav", "u440c020.wav"),
                                        ("u440c020.wav", "u440c020.wav")])
def test_voicebank_naming_rule(name, clean):
    assert calc_metrics.clean_name(name) == clean
