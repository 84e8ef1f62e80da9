"""A run at a CPU test's size, past the harness's look for a card: sound, it
comes out correct (the program in float32 against the plain reference);
with the timed path broken underneath, each fault the cell can have makes
``correct`` false. The limits are the cells' own (``workloads/*.json``).
One card, so no cell can leave out an exchange between chips."""
import argparse

import numpy as np
import pytest
import torch

from conftest import tiny

from portbench import harness, run

ENHANCE = ["sgmse-plus-16k.enhance-b16", "sgmse-sb-16k.enhance-b16"]
TRAIN = "sgmse-sb-16k.train-b16"


def measure(cell_name, seed=2 ** 31 + 3, trace=0):
    config, cell = tiny(cell_name)
    args = argparse.Namespace(workload=cell_name, seed=seed, seconds=0.0, trace=trace)
    out = run.measure(args, cell, torch.device("cpu"), config=config)
    return out, harness.checks_passed(out["checks"])


@pytest.mark.parametrize("cell", ENHANCE + [TRAIN])
def test_sound_run_is_correct(cell):
    out, correct = measure(cell)
    assert correct, out["checks"]


def _enhance_faults(monkeypatch, fault):
    from sgmse_tpu_torch import model, sampling

    if fault == "state_unchanged":  # every sampler step leaves the state as it was
        monkeypatch.setattr(sampling, "pc_sampler", lambda *a, **k: (a[4], 6))
        monkeypatch.setattr(sampling, "sb_sampler", lambda sde, fn, y, **k: (y, sde.N))
    elif fault == "half_batch":  # the second half of every batch left unenhanced
        enhance = model.ScoreModel.enhance

        def half(self, y_wav, **kw):
            if kw.get("timeit"):  # the warm-up's calls
                return enhance(self, y_wav, **kw)
            keep = max(1, len(y_wav) // 2)
            out = np.zeros_like(y_wav)
            out[:keep] = enhance(self, y_wav[:keep], **{
                k: (v[:, :keep] if k == "prior_noise" and v is not None else
                    v[:, :, :keep] if k == "corrector_noise" and v is not None else v)
                for k, v in kw.items()})
            return out

        monkeypatch.setattr(model.ScoreModel, "enhance", half)
    elif fault == "answer_altered":  # the waveform altered where it is produced
        to_audio = model.ScoreModel.to_audio
        monkeypatch.setattr(model.ScoreModel, "to_audio",
                            lambda self, spec, length=None: 1.5 * to_audio(self, spec, length))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ENHANCE)
def test_enhance_fault_is_not_correct(monkeypatch, cell, fault):
    _enhance_faults(monkeypatch, fault)
    out, correct = measure(cell)
    assert not correct, out["checks"]


def _train_faults(monkeypatch, fault):
    from sgmse_tpu_torch import model, train

    if fault == "state_unchanged":  # the step computes, then updates nothing
        monkeypatch.setattr(train, "apply_gradients", lambda state, grads, decay: None)
    elif fault == "half_batch":  # half of the batch left out, the mean over the rest
        compute = train.compute_gradients

        def half(model_, state, x_wav, y_wav, generator=None):
            keep = len(x_wav) // 2
            return compute(model_, state, x_wav[:keep], y_wav[:keep], generator)

        monkeypatch.setattr(train, "compute_gradients", half)
    elif fault == "answer_altered":  # the loss altered where it is produced
        step_loss = model.ScoreModel.step_loss
        monkeypatch.setattr(model.ScoreModel, "step_loss",
                            lambda self, *a, **k: 1.5 * step_loss(self, *a, **k))
    elif fault == "pesq_dropped":  # no PESQ term, as the model leaves it out at weight 0
        init = model.ScoreModel.__init__

        def no_pesq(self, *a, **k):
            init(self, *a, **k)
            self._pesq_loss = None

        monkeypatch.setattr(model.ScoreModel, "__init__", no_pesq)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "pesq_dropped"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    _train_faults(monkeypatch, fault)
    out, correct = measure(TRAIN)
    assert not correct, out["checks"]


def test_traced_run_reads_the_per_layer_metrics_it_can_on_the_cpu():
    out, correct = measure(ENHANCE[0], trace=1)
    assert correct
    ctx = dict(out)
    assert harness.reader("enhance.pad_waste_pct").read(ctx) > 0
    # no device on the CPU: a roofline share has nothing to read and says nothing
    assert harness.reader("enhance.k2_roofline_pct").read(ctx) is None
