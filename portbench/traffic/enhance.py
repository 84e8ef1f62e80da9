"""Window driver ``enhance``: offline enhancement of a corpus in batches.

Set-up: the port's ScoreModel of the configuration with the seed's weights;
a corpus of noisy utterances of the traffic's lengths (``portbench/corpus.py``),
sorted by length and grouped by the port's own batching,
``sgmse_tpu_torch.enhance._chunks`` (equal padded frame counts, at most
``batch_size`` a batch); the batches dealt into sweeps, each sweep one
batch of every bucket, with the buckets' shorter and longer batches taking
turns, so that every sweep holds the same shapes and about the same audio;
then ``sgmse_tpu_torch.enhance.warm_up`` at each batch shape, one sampler
step each, as ``enhance.py --timeit`` warms up, and the noise of each shape
drawn once, so that its memory is the allocator's before the window.

Window: whole sweeps, cycling, each batch through ``ScoreModel.enhance`` as
``enhance._run`` calls it, without its wav writes. The PC sampler's noise is
the benchmark's, drawn on the card per batch visit from the seed and handed
to the program (``prior_noise``, ``corrector_noise``), so that the
reference can draw it again. The window ends at the first sweep completion
after ``seconds`` (``enhance`` returns host arrays: each completion is a
fence): whole sweeps, so that where the window ends does not change the mix
of shapes it holds. ``enhance_audio_s_per_s`` is the audio of its batches
over the time from the window's start to that completion. Traced, the window
is the traffic's ``trace_sweeps`` sweeps.

Check: one visit of the window drawn from the seed, ``check_rows`` of its
rows drawn from the seed, enhanced again by the plain reference in float32
(TF32 off) from the same inputs, weights and noise, in blocks of
``check_block`` rows. The number compared (``spec_rel_err``) is the relative
L2 error of the program's waveforms against the reference's, taken on their
compressed spectrograms over the rows' own samples, all rows together; the
waveform's, and each of the two for the worst row, are read beside it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from portbench import corpus, harness, program, seeds
from portbench.reference import compare, lowp, nets
from portbench.reference import enhance as ref_enhance
from portbench.reference import sdes as ref_sdes


@dataclasses.dataclass
class Batch:
    wav: np.ndarray        # (rows, max length) float32, zero-padded
    lengths: List[int]     # each row's own length in samples
    frames: int            # padded STFT frames (a multiple of 64)

    @property
    def audio_samples(self) -> int:
        return int(sum(self.lengths))


def sweeps(groups):
    """Sweeps over the buckets ``groups`` (each a list of batches, shortest
    first): sweep i takes batch (i + b) mod n of bucket b, so the shorter and
    longer batches of neighbouring buckets alternate."""
    n = max(len(g) for g in groups)
    return [[g[(i + b) % len(g)] for b, g in enumerate(groups)] for i in range(n)]


class Run:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed, self.device = config, cell, seed, device
        self.params = cell["params"]
        self.sampler = config["sampler"]
        self.visits = []

    # --- set-up --------------------------------------------------------------------------
    def setup(self):
        from sgmse_tpu_torch.enhance import _chunks, warm_up

        cfg, p = self.config, self.params
        model = program.score_model(cfg, cfg["precision"]["enhance"], self.device)
        model.dnn.load_state_dict(program.seeded_weights(cfg, self.seed, self.device))
        self.model = model.eval()
        self.sr = p["corpus"]["sample_rate"]
        pairs = corpus.make(p["corpus"], self.seed, "enhance")
        items = sorted(((f"utt{i:04d}", noisy) for i, (_, noisy) in enumerate(pairs)),
                       key=lambda item: (len(item[1]), item[0]))
        hop = cfg["stft"]["hop_length"]
        groups, by_frames = [], {}
        for chunk in _chunks(items, p["batch_size"], hop):
            maxlen = max(len(y) for _, y in chunk)
            frames = -(-(1 + maxlen // hop) // 64) * 64
            wav = np.stack([np.pad(y, (0, maxlen - len(y))) for _, y in chunk])
            by_frames.setdefault(frames, []).append(
                Batch(wav, [len(y) for _, y in chunk], frames))
        groups = [by_frames[f] for f in sorted(by_frames)]
        self.sweeps = sweeps(groups)
        self.kwargs = self._sampler_kwargs()
        batches = [b for sweep in self.sweeps for b in sweep]
        warm_up(self.model, {b.wav.shape for b in batches},
                torch.Generator(device=self.device).manual_seed(0), self.kwargs)
        for batch in sorted(batches, key=lambda b: -b.wav.size):
            self.noise(-1, batch)
        harness.sync(self.device)

    def _sampler_kwargs(self) -> dict:
        s = self.sampler
        if s["type"] == "pc":
            return dict(sampler_type="pc", predictor=s["predictor"], corrector=s["corrector"],
                        corrector_steps=s["corrector_steps"], snr=s["snr"],
                        N=self.config["sde_params"]["N"], pad_mode=s["pad_mode"])
        return dict(sampler_type="ode", pad_mode=s["pad_mode"])

    def noise(self, visit: int, batch: Batch):
        """The PC sampler's noise of window visit ``visit``: (prior + predictor
        draws, corrector draws), or (None, None) for a noise-free sampler."""
        if self.sampler["type"] != "pc":
            return None, None
        n = self.config["sde_params"]["N"]
        f = self.config["stft"]["n_fft"] // 2 + 1
        shape = (len(batch.lengths), 1, f, batch.frames)
        gen = torch.Generator(device=self.device).manual_seed(
            seeds.derive(self.seed, "noise", visit))
        return ref_sdes.crandn((n + 1, *shape), gen), ref_sdes.crandn((n, 1, *shape), gen)

    # --- the window ----------------------------------------------------------------------
    def window(self, seconds: float, traced: bool = False) -> dict:
        """Whole sweeps until the first sweep completion after ``seconds``;
        traced, the traffic's ``trace_sweeps`` sweeps."""
        max_sweeps = self.params["trace_sweeps"] if traced else 0
        n = self.config["sde_params"]["N"]
        nfe_batch = n * (1 + self.sampler.get("corrector_steps", 0)) if \
            self.sampler["type"] == "pc" else n
        harness.sync(self.device)
        t0 = time.perf_counter()
        audio, rows, failed, work, done = 0, 0, 0, [], 0
        visit = len(self.visits)  # visits go on numbering across windows
        while True:
            for batch in self.sweeps[done % len(self.sweeps)]:
                prior, corr = self.noise(visit, batch)
                x_hat = self.model.enhance(batch.wav, prior_noise=prior, corrector_noise=corr,
                                           **self.kwargs)
                del prior, corr
                self.visits.append((visit, batch, x_hat))
                failed += int(not np.isfinite(x_hat).all())
                audio += batch.audio_samples
                rows += len(batch.lengths)
                work.append((len(batch.lengths), batch.frames, nfe_batch))
                visit += 1
            now = time.perf_counter()
            done += 1
            if (done >= max_sweeps) if max_sweeps else (now - t0 >= seconds):
                break
        wall = now - t0
        f = self.config["stft"]["n_fft"] // 2 + 1
        hop = self.config["stft"]["hop_length"]
        return dict(
            e2e={"enhance_audio_s_per_s": audio / self.sr / wall},
            wall_s=wall, attempted=rows, failed=failed, nfe=nfe_batch * len(work),
            batches=len(work), sweeps=done,
            # (rows, frequency bins, frames, forwards) of each batch, for the FLOP count
            work=[(r, f, t, k) for r, t, k in work],
            padded_samples=sum(r * t * hop for r, t, _ in work), audio_samples=audio)

    def release(self):
        """Free the program's state before the reference runs."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------------------
    def sample(self):
        """(visit, batch, program output, rows) drawn from the seed."""
        rng = seeds.rng(self.seed, "check")
        visit, batch, x_hat = self.visits[int(rng.integers(len(self.visits)))]
        n = len(batch.lengths)
        rows = np.sort(rng.choice(n, size=min(self.params["check_rows"], n), replace=False))
        return visit, batch, x_hat, rows

    def reference(self, visit, batch, rows, precision: str = "f32", fault=None) -> np.ndarray:
        """The plain reference's waveforms of ``rows`` of ``batch`` at ``visit``
        (``fault``: one of ``reference.enhance.FAULTS`` planted)."""
        with torch.device(self.device):
            net = nets.build(self.config)
        net.load_state_dict(program.seeded_weights(self.config, self.seed, self.device))
        sde = ref_sdes.build(self.config)
        prior, corr = self.noise(visit, batch)
        out = []
        block = self.params["check_block"]
        with lowp.strict_f32(), nets.precision(net, precision):
            for i in range(0, len(rows), block):
                idx = torch.as_tensor(rows[i:i + block], device=self.device)
                y = torch.as_tensor(batch.wav[rows[i:i + block]], device=self.device)
                args = (None, None) if prior is None else (prior[:, idx], corr[:, :, idx])
                out.append(ref_enhance.enhance(self.config, net, sde, y, *args,
                                               fault=fault).cpu().numpy())
        return np.concatenate(out)

    def numbers(self, out: np.ndarray, ref: np.ndarray, batch: Batch, rows) -> dict:
        """Every number the check can compare, of rows ``out`` against ``ref``."""
        from portbench.reference import dsp

        lengths = [batch.lengths[r] for r in rows]
        spec = dsp.Spec(**self.config["stft"])
        return dict(spec_rel_err=compare.pooled_rel_err(out, ref, lengths, spec),
                    wave_rel_err=compare.pooled_rel_err(out, ref, lengths),
                    spec_rel_err_worst_row=compare.worst_row_rel_err(out, ref, lengths, spec),
                    wave_rel_err_worst_row=compare.worst_row_rel_err(out, ref, lengths))

    def control(self, name: str, visit, batch, rows, ref: np.ndarray) -> np.ndarray:
        """The waveforms of control ``name`` in the program's place: the
        reference in a lower precision (``bf16``, ``fp8``), with a fault of the
        state's path (``state_swap``, ``step_off``), or a fault of the answer:
        ``state_unchanged`` (the noisy input given back), ``answer_altered``
        (the waveform 1.5 times what it is where it is produced)."""
        if name == "state_unchanged":
            return batch.wav[rows]
        if name == "answer_altered":
            return 1.5 * ref
        if name in ref_enhance.FAULTS:
            return self.reference(visit, batch, rows, fault=name)
        return self.reference(visit, batch, rows, name)

    def readings(self, controls=()) -> dict:
        """The program's numbers and each control's (:meth:`control`) against
        the float32 reference, on the check's sample."""
        visit, batch, x_hat, rows = self.sample()
        ref = self.reference(visit, batch, rows)
        res = {"program": self.numbers(x_hat[rows], ref, batch, rows),
               "shape": list(batch.wav.shape)}
        for c in controls:
            res[c] = self.numbers(self.control(c, visit, batch, rows, ref), ref, batch, rows)
        return res

    def check(self) -> dict:
        """The numbers the cell's ``limits`` name, each beside its limit."""
        visit, batch, x_hat, rows = self.sample()
        ref = self.reference(visit, batch, rows)
        got = self.numbers(x_hat[rows], ref, batch, rows)
        return {k: dict(value=got[k], limit=lim) for k, lim in self.cell["limits"].items()}
