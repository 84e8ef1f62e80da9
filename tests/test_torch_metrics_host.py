"""The port's host-side metrics (``sgmse_tpu_torch.utils.metrics``) against the
JAX package's (``sgmse_tpu.utils.metrics``), from numpy seeds at small sizes:
the SI-SDR family, ``snr_dB``, ``hp_filter``, the statistics helpers,
``Method`` and ``print_metrics``. Both are numpy on the host: the results are
equal to the last bit (``hp_filter`` to 1e-12)."""
import numpy as np
import pytest

from sgmse_tpu.utils import metrics as jm
from sgmse_tpu_torch.utils import metrics as tm


def _signals(seed, n=4000):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(n)
    noise = 0.3 * rng.standard_normal(n)
    return s, noise, s + noise + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_si_sdr_family_equals_jax(seed):
    s, n, s_hat = _signals(seed)
    for got, want in zip(tm.si_sdr_components(s_hat, s, n), jm.si_sdr_components(s_hat, s, n)):
        np.testing.assert_array_equal(got, want)
    assert tm.energy_ratios(s_hat, s, n) == jm.energy_ratios(s_hat, s, n)
    assert tm.si_sdr(s, s_hat) == jm.si_sdr(s, s_hat)
    assert tm.snr_dB(s, n) == jm.snr_dB(s, n)


@pytest.mark.parametrize("cut_off,order,sr", [(80, 10, 16000), (200, 4, 48000)])
def test_hp_filter_equals_jax(cut_off, order, sr):
    x = np.random.default_rng(3).standard_normal(3000)
    np.testing.assert_allclose(tm.hp_filter(x, cut_off, order, sr),
                               jm.hp_filter(x, cut_off, order, sr), rtol=0, atol=1e-12)


def test_statistics_helpers_equal_jax():
    data = np.random.default_rng(4).standard_normal(17)
    with_nan = np.concatenate([data, [np.nan]])
    assert tm.mean_conf_int(data) == jm.mean_conf_int(data)
    assert tm.mean_conf_int(data, 0.9) == jm.mean_conf_int(data, 0.9)
    assert tm.mean_std(with_nan) == jm.mean_std(with_nan)
    for decimal in (1, 2):
        assert tm.print_mean_std(with_nan, decimal) == jm.print_mean_std(with_nan, decimal)


def test_method_accumulator_equals_jax():
    ours, theirs = (m.Method("sgmse", "/x", ["pesq", "si_sdr"]) for m in (tm, jm))
    for v in np.random.default_rng(5).uniform(1, 4, 6):
        ours.append("pesq", v)
        theirs.append("pesq", v)
    assert (ours.name, ours.base_dir) == (theirs.name, theirs.base_dir)
    assert ours.metrics == theirs.metrics
    assert ours.get_mean_ci("pesq") == theirs.get_mean_ci("pesq")


def test_print_metrics_prints_as_jax(capsys):
    t = np.arange(16000) / 16000
    x = 0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    rng = np.random.default_rng(6)
    y = x + 0.1 * rng.standard_normal(len(x))
    x_hat = x + 0.03 * rng.standard_normal(len(x))
    tm.print_metrics(x, y, [x_hat], ["enhanced"])
    ours = capsys.readouterr().out
    jm.print_metrics(x, y, [x_hat], ["enhanced"])
    assert ours == capsys.readouterr().out and ours.count("PESQ") == 1
