"""Window driver ``enhance_long``: long recordings enhanced offline, in chunks.

Set-up: the port's ScoreModel of the configuration (its ``sr`` handed over
with the model's own arguments) holding the seed's weights, drawn by
``weights.make`` over the plain 48 kHz network (``reference/nets48k.py``,
whose leaves are the port's); the traffic's noisy recordings
(``portbench/corpus.py``), in the seed's order; then
``sgmse_tpu_torch.enhance.warm_up`` at the one chunk shape, one sampler step
through ``enhance_long``, as ``enhance.py --timeit --chunk_seconds`` warms up
(the CUDA graphs of the network's evaluation, which ``enhance_long`` replays,
are captured there), and one chunk's noise drawn once, so that its memory is
the allocator's before the window. A port whose ``warm_up`` takes no
``chunk_seconds`` has no such graphs, and the run stops there.

Window: whole sweeps, cycling, a sweep each recording once, alone, through
``ScoreModel.enhance_long`` with the traffic's ``chunk_seconds`` and
``overlap``, as ``enhance.py --chunk_seconds`` calls it, without its wav
writes. Each chunk goes through ``ScoreModel.enhance`` by ``enhance_long``'s
``enhance=`` hook (the one ``parallel.pool`` uses), which hands it the PC
sampler's noise of that recording visit and chunk, drawn on the card from the
seed, so that the reference can draw it again. ``enhance_long`` returns a
host array, so each recording is a fence. The window ends at the first sweep
completion after ``seconds``: whole sweeps, so that every seed's window holds
the same mix of lengths and chunk padding. ``enhance_audio_s_per_s`` is the
input audio of its recordings over the time from the window's start to that
completion. Traced, the window is the traffic's ``trace_sweeps`` sweeps.
The window's ``long`` is what the port's ``model.LONG_SERVED`` counted in it
(None where the port has no such counter).

Check: one recording visit of the window drawn from the seed; its first
``check_chunks`` chunks enhanced again by the plain reference in float32
(TF32 off), from the same input, weights and noise, and crossfaded as the
port does (``reference/enhance_long.py``). The number compared
(``spec_rel_err``) is the relative L2 error of the program's waveform
against the reference's over the samples those chunks alone determine,
taken on their compressed spectrograms; the waveform's is read beside it.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from portbench import corpus, harness, program, seeds, weights
from portbench.reference import compare, dsp, lowp, nets, nets48k
from portbench.reference import enhance as ref_enhance
from portbench.reference import enhance_long as ref_long
from portbench.reference import sdes as ref_sdes

COUNTS = ("calls", "chunks", "input_samples", "enhanced_samples")


def padded_frames(config: dict, samples: int) -> int:
    """The frames of a chunk of ``samples`` once the pipeline pads them to a
    multiple of 64 (the centred STFT's frame count, rounded up)."""
    n_fft, hop = config["stft"]["n_fft"], config["stft"]["hop_length"]
    frames = (samples + 2 * (n_fft // 2) - n_fft) // hop + 1
    return -(-frames // 64) * 64


def long_counts():
    """A copy of the port's ``enhance_long`` counter, or None where it has none."""
    from sgmse_tpu_torch import model

    served = getattr(model, "LONG_SERVED", None)
    return None if served is None else {k: served[k] for k in COUNTS}


class Run:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed, self.device = config, cell, seed, device
        self.params = cell["params"]
        self.sampler = config["sampler"]
        self.visits = []

    # --- set-up --------------------------------------------------------------------------
    def setup(self):
        from sgmse_tpu_torch.enhance import warm_up

        cfg, p = self.config, self.params
        if p["corpus"]["sample_rate"] != cfg["sr"]:
            raise ValueError("the corpus's sample rate is not the configuration's")
        own = dict(cfg.get("training", {}), sr=cfg["sr"])
        model = program.score_model(dict(cfg, training=own), cfg["precision"]["enhance"],
                                    self.device)
        model.dnn.load_state_dict(self.seeded_weights())
        self.model = model.eval()
        self.recordings = [noisy for _, noisy in corpus.make(p["corpus"], self.seed, "enhance")]
        s = self.sampler
        self.kwargs = dict(sampler_type="pc", predictor=s["predictor"], corrector=s["corrector"],
                           corrector_steps=s["corrector_steps"], snr=s["snr"],
                           N=cfg["sde_params"]["N"], pad_mode=s["pad_mode"])
        chunk = int(p["chunk_seconds"] * cfg["sr"])
        shapes = {(min(len(y), chunk),) for y in self.recordings}
        warm_up(self.model, shapes, torch.Generator(device=self.device).manual_seed(0),
                self.kwargs, p["chunk_seconds"])
        for (samples,) in shapes:
            self.noise(-1, 0, samples)
        harness.sync(self.device)

    def seeded_weights(self):
        """The benchmark's weights of the configuration for the seed
        (:mod:`portbench.weights`), keyed by the plain 48 kHz network's leaves."""
        with torch.device("meta"):
            shape_net = nets48k.build(self.config)
        return weights.make(shape_net, self.seed, self.device, **self.config.get("weights", {}))

    def noise(self, visit: int, chunk: int, samples: int):
        """The PC sampler's noise of chunk ``chunk`` (of ``samples`` samples) of
        recording visit ``visit``: (prior + predictor draws, corrector draws)."""
        n = self.config["sde_params"]["N"]
        shape = (1, 1, self.config["stft"]["n_fft"] // 2 + 1,
                 padded_frames(self.config, samples))
        gen = torch.Generator(device=self.device).manual_seed(
            seeds.derive(self.seed, "noise", visit, chunk))
        return ref_sdes.crandn((n + 1, *shape), gen), ref_sdes.crandn((n, 1, *shape), gen)

    def chunk_enhance(self, visit: int, work: list):
        """``enhance_long``'s ``enhance=`` hook for recording visit ``visit``:
        ``ScoreModel.enhance`` of each chunk with its noise, each chunk's
        (rows, frequency bins, frames) appended to ``work``."""
        count = itertools.count()
        f = self.config["stft"]["n_fft"] // 2 + 1

        def enhance(seg, **kw):
            prior, corr = self.noise(visit, next(count), len(seg))
            work.append((1, f, prior.shape[-1]))
            return self.model.enhance(seg, prior_noise=prior, corrector_noise=corr, **kw)

        return enhance

    # --- the window ----------------------------------------------------------------------
    def window(self, seconds: float, traced: bool = False) -> dict:
        """Whole sweeps until the first sweep completion after ``seconds``;
        traced, the traffic's ``trace_sweeps`` sweeps."""
        p = self.params
        max_sweeps = p["trace_sweeps"] if traced else 0
        before = long_counts()
        harness.sync(self.device)
        t0 = time.perf_counter()
        audio, failed, nfe, done, shapes = 0, 0, 0, 0, []
        visit = len(self.visits)  # visits go on numbering across windows
        while True:
            for r, y in enumerate(self.recordings):
                x_hat, n, _ = self.model.enhance_long(
                    y, chunk_seconds=p["chunk_seconds"], overlap=p["overlap"], timeit=True,
                    enhance=self.chunk_enhance(visit, shapes), **self.kwargs)
                self.visits.append((visit, r, x_hat))
                failed += int(not np.isfinite(x_hat).all())
                audio += len(y)
                nfe += n
                visit += 1
            now = time.perf_counter()
            done += 1
            if (done >= max_sweeps) if max_sweeps else (now - t0 >= seconds):
                break
        wall = now - t0
        after = long_counts()
        per_chunk = nfe // len(shapes)
        return dict(
            e2e={"enhance_audio_s_per_s": audio / self.config["sr"] / wall},
            wall_s=wall, attempted=len(self.recordings) * done, failed=failed, nfe=nfe,
            batches=len(shapes), sweeps=done, audio_samples=audio,
            # (rows, frequency bins, frames, forwards) of each chunk, for the FLOP count
            work=[(r, f, t, per_chunk) for r, f, t in shapes],
            long=None if before is None else {k: after[k] - before[k] for k in COUNTS})

    def release(self):
        """Free the program's state before the reference runs."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------------------
    def sample(self):
        """(visit, recording index, program output) drawn from the seed."""
        rng = seeds.rng(self.seed, "check")
        return self.visits[int(rng.integers(len(self.visits)))]

    def reference(self, visit: int, r: int, precision: str = "f32", fault=None) -> np.ndarray:
        """The plain reference's leading samples of recording ``r`` at
        ``visit`` that its first ``check_chunks`` chunks determine (``fault``:
        one of ``reference.enhance.FAULTS`` planted)."""
        p = self.params
        with torch.device(self.device):
            net = nets48k.build(self.config)
        net.load_state_dict(self.seeded_weights())
        sde = ref_sdes.build(self.config)
        y = self.recordings[r]
        chunk, _, n = ref_long.grid(len(y), self.config["sr"], p["chunk_seconds"], p["overlap"])
        noises = [self.noise(visit, i, chunk) for i in range(min(p["check_chunks"], n))]
        with lowp.strict_f32(), nets.precision(net, precision):
            out = ref_long.enhance_long(self.config, net, sde,
                                        torch.as_tensor(y, device=self.device), noises,
                                        p["chunk_seconds"], p["overlap"], fault=fault)
        return out.cpu().numpy()

    def numbers(self, out: np.ndarray, ref: np.ndarray) -> dict:
        """Every number the check can compare, of ``out`` against ``ref`` over
        ``ref``'s samples."""
        n = len(ref)
        spec = dsp.Spec(**self.config["stft"])
        return dict(spec_rel_err=compare.pooled_rel_err([out[:n]], [ref], [n], spec),
                    wave_rel_err=compare.pooled_rel_err([out[:n]], [ref], [n]))

    def readings(self, controls=()) -> dict:
        """The program's numbers and each control's against the float32
        reference, on the check's sample: a control is the reference in a lower
        precision (``bf16``, ``fp8``) or with a fault of the state's path
        (``state_swap``, ``step_off``) in the program's place."""
        visit, r, x_hat = self.sample()
        ref = self.reference(visit, r)
        res = {"program": self.numbers(x_hat, ref), "recording": [r, len(self.recordings[r])],
               "checked_samples": len(ref)}
        for c in controls:
            out = (self.reference(visit, r, fault=c) if c in ref_enhance.FAULTS
                   else self.reference(visit, r, c))
            res[c] = self.numbers(out, ref)
        return res

    def check(self) -> dict:
        """The numbers the cell's ``limits`` name, each beside its limit."""
        visit, r, x_hat = self.sample()
        got = self.numbers(x_hat, self.reference(visit, r))
        return {k: dict(value=got[k], limit=lim) for k, lim in self.cell["limits"].items()}
