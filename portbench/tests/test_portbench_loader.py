"""The loader stage's check: rows that are normalised crops of the corpus
read at float rounding; a crop one sample off, a row normalised by the
wrong signal, or two rows from one pair read far above the limit."""
import numpy as np
import torch

from portbench import harness
from portbench.reference import loader_check

LIMIT = harness.cell("sgmse-sb-16k.train-b16")["limits"]["loader_gap"]


def corpus(n=6, seed=0):
    rng = np.random.default_rng(seed)
    clean = [(0.3 * rng.standard_normal(2000 + 300 * i)).astype(np.float32) for i in range(n)]
    noisy = [(c + 0.1 * rng.standard_normal(c.shape)).astype(np.float32) for c in clean]
    return clean, noisy


def crop(clean, noisy, i, start, length=1024, by="noisy"):
    c, y = clean[i][start:start + length], noisy[i][start:start + length]
    scale = np.abs(y if by == "noisy" else c).max()
    return (c / scale).astype(np.float32), (y / scale).astype(np.float32)


def batch(rows):
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def test_normalised_crops_read_at_rounding():
    clean, noisy = corpus()
    rows = [crop(clean, noisy, i, 17 * i + 5) for i in range(6)]
    gap = loader_check.check(clean, noisy, [batch(rows[:3]), batch(rows[3:])], torch.device("cpu"))
    assert gap <= LIMIT / 10


def test_faulty_rows_read_above_the_limit():
    clean, noisy = corpus()
    good = [crop(clean, noisy, i, 40) for i in range(4)]
    x, y = crop(clean, noisy, 0, 40)
    shifted = (np.roll(x, 1), y)  # the clean crop one sample off its noisy one
    wrong_norm = crop(clean, noisy, 1, 40, by="clean")
    for bad in (shifted, wrong_norm):
        rows = [bad] + good[1:]
        gap = loader_check.check(clean, noisy, [batch(rows)], torch.device("cpu"))
        assert gap > 100 * LIMIT
    twice = [good[0], good[0]] + good[2:]
    assert loader_check.check(clean, noisy, [batch(twice)], torch.device("cpu")) == float("inf")
