"""The window's rate arithmetic: whole batches or steps, ending at the first
completion after ``seconds``, all the work over all the time, a stall
included. A fake clock stands in for the host's; fake programs for the port."""
import numpy as np
import pytest
import torch

from conftest import tiny

from portbench import harness


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for name in ("enhance", "train"):
        monkeypatch.setattr(harness.driver(name).time, "perf_counter", c)
    return c


def enhance_run(clock, durations):
    config, cell = tiny("sgmse-plus-16k.enhance-b16")
    run = harness.driver("enhance").Run(config, cell, 7, torch.device("cpu"))
    drv = harness.driver("enhance")
    run.sr = 16000
    run.sweeps = [[drv.Batch(np.zeros((2, 1600), np.float32), [1600, 800], 128),
                   drv.Batch(np.zeros((1, 3200), np.float32), [3200], 256)]]
    run.kwargs = {}
    steps = iter(durations)

    class Model:
        def enhance(self, wav, **_):
            clock.now += next(steps)
            return np.zeros_like(wav)

    run.model = Model()
    return run


def test_enhance_window_counts_the_stall_and_ends_after_seconds(clock):
    run = enhance_run(clock, [1.0, 5.0, 1.0, 1.0, 1.0])  # the second batch stalls
    w = run.window(3.0)  # the first sweep ends at 6 s
    assert w["batches"] == 2 and w["wall_s"] == pytest.approx(6.0)
    # batch 0: 2400 samples, batch 1: 3200, at 16 kHz, over 6 s
    assert w["e2e"]["enhance_audio_s_per_s"] == pytest.approx((2400 + 3200) / 16000 / 6.0)
    assert w["attempted"] == 3 and w["nfe"] == 2 * 6
    assert w["padded_samples"] == (2 * 128 + 1 * 256) * 16


def test_enhance_window_runs_whole_sweeps_past_the_end(clock):
    run = enhance_run(clock, [1.0] * 10)
    w = run.window(2.5)  # the first sweep ends at 2 s, the second at 4 s
    assert w["sweeps"] == 2 and w["batches"] == 4 and w["wall_s"] == pytest.approx(4.0)
    assert w["e2e"]["enhance_audio_s_per_s"] == pytest.approx(2 * (2400 + 3200) / 16000 / 4)
    traced = run.window(0.0, traced=True)
    assert traced["batches"] == 2  # the traffic's trace_sweeps: one sweep


def test_sweeps_alternate_the_shorter_and_longer_batches():
    drv = harness.driver("enhance")
    groups = [["a0", "a1"], ["b0", "b1"], ["c0", "c1"]]
    assert drv.sweeps(groups) == [["a0", "b1", "c0"], ["a1", "b0", "c1"]]
    assert drv.sweeps([["a0"], ["b0", "b1"]]) == [["a0", "b1"], ["a0", "b0"]]


def test_train_window_counts_the_loader_stall(clock):
    config, cell = tiny("sgmse-sb-16k.train-b16")
    run = harness.driver("train").Run(config, cell, 7, torch.device("cpu"))
    waits = iter([0.0, 4.0, 0.0, 0.0, 0.0])
    batch = config["training"]["batch_size"]

    def next_batch():
        clock.now += next(waits)
        return np.zeros((batch, 8), np.float32), np.zeros((batch, 8), np.float32)

    def train_step(model, state, x, y, gen):
        clock.now += 1.0
        return torch.tensor(0.5)

    run.next_batch, run.train_step = next_batch, train_step
    run.model = run.state = run.gen = None
    w = run.window(3.5)
    # steps end at 1, 6 (a 4-s loader stall before it), 7: the first past 3.5 is the 2nd
    assert w["steps"] == 2 and w["wall_s"] == pytest.approx(6.0)
    assert w["e2e"]["train_samples_per_s"] == pytest.approx(2 * batch / 6.0)
    assert w["loader_wait_s"] == pytest.approx(4.0)
    assert w["failed"] == 0
