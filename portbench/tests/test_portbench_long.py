"""The 48 kHz cell (``ears-48k.enhance-chunked``): its files are found by name,
its reference and count import nothing of the port or of JAX, its FLOP count
matches a hand count, its window counts whole sweeps, its readers read what
the window counted, and at a CPU test's size a sound run is correct while
faults of the program and the controls of the comparison break its limit."""
import argparse
import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import harness, run
from portbench.counts import network48k

CELL = "ears-48k.enhance-chunked"
READERS = ("enhance_long.waste_pct", "enhance_long.mfu_pct")


def tiny(precision="float32"):
    """(config, cell) of the 48 kHz cell cut to a CPU test's size: a narrow net,
    a short STFT, three sampler steps, three recordings of 3-4 chunks of 960
    samples."""
    cell = copy.deepcopy(harness.cell(CELL))
    config = copy.deepcopy(harness.config(cell["config"]))
    config["network"].update(nf=16, ch_mult=[1, 1, 2])
    config["stft"].update(n_fft=62, hop_length=16, num_frames=64)
    config["sde_params"]["N"] = 3
    config["precision"] = {"enhance": precision}
    cell["params"].update(chunk_seconds=0.02)
    cell["params"]["corpus"]["groups"] = [[3, 0.045, 0.075]]
    return config, cell


def test_cell_configuration_driver_and_readers_are_found_by_name():
    """The cell's files are found by name, and BENCHMARK.json lists the cell: it
    reports its rate and set-up, and reads both new metrics beside the enhance
    cells' busy time, launches and idle share. Not the K1 and K2 rooflines,
    which count the kernels' Python calls (``trace.Calls``), which a CUDA graph's
    replay does not make, nor ``enhance.mfu_pct``, whose count cannot build
    this network."""
    found = harness.listing()
    assert "ears-48k" in found["configs"] and CELL in found["workloads"]
    assert "enhance_long" in found["traffic"]
    assert set(READERS) <= set(found["metrics"])
    cell = harness.cell(CELL)
    assert harness.driver(cell["driver"]).Run
    bench = harness.benchmark()
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("ears-48k",
                                                                 cell["traffic"], 1)
    names = [m["name"] for m in harness.per_layer(bench, CELL)]
    assert sorted(names) == sorted(READERS + ("enhance.busy_ms_per_nfe",
                                              "enhance.launches_per_nfe",
                                              "enhance.device_idle_pct"))
    assert [m["name"] for m in harness.end_to_end(bench, CELL)] == ["enhance_audio_s_per_s",
                                                                    "setup_s"]
    for name in names:
        assert callable(harness.reader(name).read)


def test_new_reference_and_count_import_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.nets48k, "
            "portbench.reference.enhance_long, portbench.counts.network48k; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert not set(eval(out)) & {"sgmse_tpu_torch", *harness.FORBIDDEN}


def _resblock(b, h, w, cin, cout, temb):
    flops = 2 * b * cout * temb + 2 * b * h * w * cout * cin * 9 + 2 * b * h * w * cout * cout * 9
    return flops + (2 * b * h * w * cout * cin if cin != cout else 0)


def test_48k_flops_of_one_level_by_hand():
    """One level: no resampling; conv_in, two down blocks, the middle (two blocks
    and attention), three up blocks on the skip concatenations, the head."""
    config = harness.config("ears-48k")
    config["network"].update(nf=32, ch_mult=[1])
    b, h, w, c = 2, 24, 40, 32
    temb = 4 * c
    hand = 2 * b * 2 * c * temb + 2 * b * temb * temb  # the time embedding's two dense layers
    hand += 2 * b * h * w * c * 4 * 9  # conv_in
    hand += 4 * _resblock(b, h, w, c, c, temb)  # two down blocks, the middle two
    hand += 4 * 2 * b * h * w * c * c + 2 * 2 * b * (h * w) ** 2 * c  # attention
    hand += 3 * _resblock(b, h, w, 2 * c, c, temb)  # three up blocks
    hand += 2 * b * h * w * 4 * c * 9 + 2 * b * h * w * 2 * 4  # out_conv, output layer
    assert network48k.forward_flops(config, b, h, w) == hand


def test_48k_flops_at_the_cell_shape():
    config = harness.config("ears-48k")
    flops = network48k.forward_flops(config, 1, 768, 512)
    assert 3.15e12 < flops < 3.25e12  # 3.19 TFLOP an evaluation of one 4-s chunk
    # a quarter of a 16-s chunk's, but for the middle attention's products (square in positions)
    assert 4 * flops == pytest.approx(network48k.forward_flops(config, 1, 768, 2048), rel=1e-4)


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_window_runs_whole_sweeps_and_counts_the_chunks(monkeypatch):
    config, cell = tiny()
    drv = harness.driver("enhance_long")
    clock = Clock()
    monkeypatch.setattr(drv.time, "perf_counter", clock)
    r = drv.Run(config, cell, 7, torch.device("cpu"))
    r.recordings = [np.zeros(2000, np.float32), np.zeros(3000, np.float32)]
    chunks = {2000: 2, 3000: 3}

    class Model:
        def enhance_long(self, y, enhance, **_):
            for _ in range(chunks[len(y)]):
                enhance(np.zeros(960, np.float32), timeit=True)
            clock.now += 1.0
            return np.zeros_like(y), 6 * chunks[len(y)], 0.0

        def enhance(self, seg, **_):
            return np.zeros_like(seg), 6, 0.0

    r.model, r.kwargs = Model(), {}
    w = r.window(2.5)  # sweeps end at 2 and 4 s
    assert w["sweeps"] == 2 and w["wall_s"] == pytest.approx(4.0)
    assert w["attempted"] == 4 and w["batches"] == 10 and w["nfe"] == 60
    assert w["e2e"]["enhance_audio_s_per_s"] == pytest.approx(2 * 5000 / 48000 / 4.0)
    assert w["work"] == [(1, 32, 64, 6)] * 10
    assert w["long"] == dict(calls=0, chunks=0, input_samples=0, enhanced_samples=0)
    assert r.window(0.0, traced=True)["sweeps"] == 1  # the traffic's trace_sweeps


def test_readers_read_the_window_and_say_nothing_without_it():
    waste, mfu = (harness.reader(n) for n in READERS)
    # the cell's sweep: 63 s of input in 19 chunks of 512 frames of 384 samples
    long = dict(calls=3, chunks=19, input_samples=3024000, enhanced_samples=19 * 512 * 384)
    assert waste.read({"window": {"long": long}}) == pytest.approx(19.05, abs=0.01)
    assert waste.read({"window": {"long": None}}) is None
    config = harness.config("ears-48k")
    ctx = {"config": config, "untraced": {"wall_s": 50.0, "work": [(1, 768, 512, 60)] * 19}}
    expect = 100 * 19 * 60 * network48k.forward_flops(config, 1, 768, 512) / 50.0 / 989e12
    assert mfu.read(ctx) == pytest.approx(expect)
    assert mfu.read(dict(ctx, untraced={"wall_s": 50.0, "work": []})) is None


def measure(seed=2 ** 31 + 3, trace=0):
    config, cell = tiny()
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.0, trace=trace)
    out = run.measure(args, cell, torch.device("cpu"), config=config)
    return out, harness.checks_passed(out["checks"])


def test_sound_traced_run_is_correct_and_counts_its_waste():
    out, correct = measure(trace=1)
    assert correct, out["checks"]
    # 2400, 2880, 3360 samples: 3, 4 and 4 chunks of 64 frames of 16 samples
    assert out["window"]["long"] == dict(calls=3, chunks=11, input_samples=8640,
                                         enhanced_samples=11 * 64 * 16)
    assert harness.reader(READERS[0]).read(dict(out)) == pytest.approx(100 * (1 - 8640 / 11264))


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_program_fault_is_not_correct(monkeypatch, fault):
    from sgmse_tpu_torch import model, sampling

    if fault == "state_unchanged":  # every sampler step leaves the state as it was
        monkeypatch.setattr(sampling, "pc_sampler", lambda *a, **k: (a[4], 6))
    else:  # the waveform altered where it is produced
        to_audio = model.ScoreModel.to_audio
        monkeypatch.setattr(model.ScoreModel, "to_audio",
                            lambda self, spec, length=None: 1.5 * to_audio(self, spec, length))
    out, correct = measure()
    assert not correct, out["checks"]


def test_controls_break_the_limit_where_the_program_keeps_it():
    """The reference in fp8 (one precision below the configuration's bf16) and
    the two planted faults of the state's path, in the program's place."""
    config, cell = tiny()
    limit = cell["limits"]["spec_rel_err"]
    r = harness.driver("enhance_long").Run(config, cell, 2 ** 31 + 5, torch.device("cpu"))
    r.setup()
    r.window(0.0)
    r.release()
    row = r.readings(["fp8", "state_swap", "step_off"])
    assert row["program"]["spec_rel_err"] <= limit
    for c in ("fp8", "state_swap", "step_off"):
        assert row[c]["spec_rel_err"] > limit, (c, row[c])


@pytest.mark.cuda
def test_controls_break_the_limit_on_the_card_at_the_cell_size(card):
    """As above, at the cell's own size: the program within the limit, the fp8
    reference and both planted faults beyond it."""
    from portbench import readings

    limit = harness.cell(CELL)["limits"]["spec_rel_err"]
    row = readings.readings(CELL, [2 ** 31 + 101], ["fp8", "state_swap", "step_off"],
                            device=card)[0]
    assert row["program"]["spec_rel_err"] <= limit
    for c in ("fp8", "state_swap", "step_off"):
        assert row[c]["spec_rel_err"] > limit, (c, row[c])
