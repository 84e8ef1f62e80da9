"""Window driver ``train``: the training loop's step, fed by the port's loader.

Set-up: a corpus of clean/noisy pairs of the traffic's lengths, written as
16-bit wavs under ``$TMPDIR`` (removed when the run ends); the port's
``SpecsDataModule`` over it (the native loader and its threads, random
crops of ``num_frames``, ``normalize noisy``, reshuffled every epoch); the
port's ScoreModel of the configuration in float32 and its train state
(``train.create_train_state``: Adam and the EMA), holding the seed's
weights; one generator on the card for the steps' draws. The first
``checked_steps`` steps run through ``train.train_step``, as the window's
do, and are what the check follows: their batches, the generator state each
started from, their losses, their PESQ terms (what the program's PESQ loss
returned, read by wrapping it for those steps alone), the first gradient
(from Adam's first moment after one step) and the change of every leaf after
them.

Window: ``train.train_step`` on the loader's next batch, as ``Trainer.fit``'s
inner loop runs it (no validation, no logging). The window ends at the first
step completion after ``seconds``: reading that step's loss is the fence.
``train_samples_per_s`` is the crops of those steps over that time. Traced,
it runs the traffic's ``trace_steps`` steps, with the benchmark's own span
around each ``next()`` of the loader.

Check: the loader's checked batches against the corpus
(``reference/loader_check.py``), then the plain reference's steps in
float32, TF32 off (``reference/training.py``), from the same batches,
weights and generator states; compared: the first step's PESQ term, each
leaf's first gradient norm, each leaf's change of its parameters and of its
EMA after the checked steps; the first step's loss is read beside them.
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import corpus, harness, program, seeds
from portbench.reference import compare, loader_check, lowp, nets
from portbench.reference import training as ref_training


@contextlib.contextmanager
def pesq_probe(model, seen: list):
    """Within: every batch of PESQ losses the program's ``model`` computes is
    appended to ``seen`` (detached); nothing is appended where the model
    computes none."""
    pesq = getattr(model, "_pesq_loss", None)
    if pesq is None:
        yield
        return

    def probe(ref, deg):
        out = pesq(ref, deg)
        seen.append(out.detach())
        return out

    model._pesq_loss = probe
    try:
        yield
    finally:
        model._pesq_loss = pesq


class Run:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed, self.device = config, cell, seed, device
        self.params = cell["params"]
        self.workdir = None

    # --- set-up --------------------------------------------------------------------------
    def setup(self):
        from sgmse_tpu_torch import train
        from sgmse_tpu_torch.data.dataset import SpecsDataModule

        cfg, p = self.config, self.params
        self.workdir = Path(tempfile.mkdtemp(prefix="portbench-train-"))
        pairs = corpus.make(p["corpus"], self.seed, "train")
        for sub in ("clean", "noisy"):
            (self.workdir / "train" / sub).mkdir(parents=True)
        sr = p["corpus"]["sample_rate"]
        for i, (clean, noisy) in enumerate(pairs):
            corpus.write_pcm16(self.workdir / "train" / "clean" / f"pair{i:04d}.wav", clean, sr)
            corpus.write_pcm16(self.workdir / "train" / "noisy" / f"pair{i:04d}.wav", noisy, sr)
        self.model = program.score_model(cfg, cfg["precision"]["train"], self.device)
        self.state = train.create_train_state(self.model, torch.Generator().manual_seed(0))
        w0 = program.seeded_weights(cfg, self.seed, self.device)
        with torch.no_grad():
            for name, param in self.state.params.items():
                param.copy_(w0[name])
                self.state.ema_params[name].copy_(w0[name])
        dm = SpecsDataModule(base_dir=str(self.workdir), batch_size=cfg["training"]["batch_size"],
                             num_workers=p["num_workers"], seed=seeds.derive(self.seed, "loader")
                             % 2 ** 31, **cfg["stft"])
        dm.setup("fit")
        self.loader = dm.train_dataloader()
        self.batches = iter(self.loader)
        self.gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "draws"))
        self.train_step = train.train_step
        self.checked = []
        for k in range(p["checked_steps"]):
            x, y = self.next_batch()
            gen_state = self.gen.get_state()
            seen = []
            with pesq_probe(self.model, seen):
                loss = self.train_step(self.model, self.state, x, y, self.gen)
            self.checked.append(dict(x=np.array(x), y=np.array(y), gen=gen_state, loss=loss,
                                     pesq=seen))
            if k == 0:
                self.first_grad = self.adam_first_grad()
        with torch.no_grad():
            self.change = {n: float((q - w0[n]).norm()) for n, q in self.state.params.items()}
            self.ema_change = {n: float((e - w0[n]).norm())
                               for n, e in self.state.ema_params.items()}
        for c in self.checked:
            c["loss"] = float(c["loss"])
            c["pesq"] = float(torch.cat(c["pesq"]).mean()) if c["pesq"] else None
        del w0
        for _ in range(p["warm_steps"]):
            self.train_step(self.model, self.state, *self.next_batch(), self.gen)
        harness.sync(self.device)

    def next_batch(self):
        try:
            return next(self.batches)
        except StopIteration:  # a new epoch: the loader reshuffles
            self.batches = iter(self.loader)
            return next(self.batches)

    def adam_first_grad(self) -> dict:
        """Each leaf's gradient norm as Adam got it: its first moment after one
        step is (1 - beta1) g."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        by_param = {id(q): n for n, q in self.state.params.items()}
        moments = {id(q): opt.state.get(q, {}).get("exp_avg")
                   for q in opt.param_groups[0]["params"]}
        # a leaf the optimizer holds no moment for got no gradient: it reads 0
        return {by_param[i]: 0.0 if m is None else float(m.norm()) / (1.0 - beta1)
                for i, m in moments.items()}

    # --- the window ----------------------------------------------------------------------
    def window(self, seconds: float, traced: bool = False) -> dict:
        steps_max = self.params["trace_steps"] if traced else 0
        batch = self.config["training"]["batch_size"]
        f = self.config["stft"]["n_fft"] // 2 + 1
        frames = self.config["stft"]["num_frames"]
        harness.sync(self.device)
        t0 = time.perf_counter()
        steps, wait, losses = 0, 0.0, []
        while True:
            t_wait = time.perf_counter()
            with torch.profiler.record_function("portbench.loader_wait"):
                x, y = self.next_batch()
            wait += time.perf_counter() - t_wait
            loss = self.train_step(self.model, self.state, x, y, self.gen)
            losses.append(loss)
            steps += 1
            if (steps >= steps_max) if steps_max else (time.perf_counter() - t0 >= seconds):
                float(loss)  # the fence: this step has completed
                break
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
        return dict(e2e={"train_samples_per_s": steps * batch / wall}, wall_s=wall,
                    attempted=steps, failed=int((~finite).sum()), steps=steps,
                    loader_wait_s=wait, work=[(batch, f, frames, 3)] * steps)

    def release(self):
        self.batches.close()  # the open epoch's loader threads finish and stop
        del self.model, self.state, self.train_step, self.loader, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def __del__(self):
        if self.workdir is not None:
            shutil.rmtree(self.workdir, ignore_errors=True)

    # --- the check -----------------------------------------------------------------------
    def corpus_arrays(self):
        files = sorted((self.workdir / "train" / "noisy").glob("*.wav"))
        clean = [corpus.read_pcm16(self.workdir / "train" / "clean" / f.name) for f in files]
        return clean, [corpus.read_pcm16(f) for f in files]

    def reference(self, precision: str = "f32", keep_rows: int = 0, fault=None) -> dict:
        """The plain reference's readings of the checked steps (in ``precision``;
        ``keep_rows``: the half-batch fault; ``fault``: see
        ``reference/training.py``)."""
        with torch.device(self.device):
            net = nets.build(self.config)
        net.load_state_dict(program.seeded_weights(self.config, self.seed, self.device))
        with lowp.strict_f32():
            return ref_training.train_steps(self.config, net, self.checked,
                                            self.params["check_block"], self.device,
                                            precision, keep_rows, fault)

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        """Every number the check can compare, of ``prog``'s readings against
        ``ref``'s: the first step's loss (the later steps' losses, read beside
        it, swing with the parameters' round-off: one Adam step moves every
        weight by about lr, and the loss of a seeded net then changes many
        times over), the first step's PESQ term (None where the program
        computed none), the first gradient, the change of the parameters and
        of the EMA. Leaves whose first gradient in the reference is under a
        thousandth of the median leaf's (nought but for rounding; Adam moves
        them by round-off alone) are left out of the change."""
        grads = ref["first_grad"]
        median = float(np.median(list(grads.values())))
        moved = [n for n, g in grads.items() if g >= 1e-3 * median]
        change = max(compare.norm_gap(prog["change"], ref["change"], moved)[0],
                     compare.norm_gap(prog["ema_change"], ref["ema_change"], moved)[0])
        pesq = prog["pesq_terms"][0]
        return dict(loss_rel_gap=compare.rel_gap(prog["losses"][:1], ref["losses"][:1]),
                    pesq_rel_gap=None if pesq is None else
                    compare.rel_gap([pesq], ref["pesq_terms"][:1]),
                    grad_norm_gap=compare.norm_gap(prog["first_grad"], grads)[0],
                    change_norm_gap=change,
                    loss_rel_gap_all_steps=compare.rel_gap(prog["losses"], ref["losses"]))

    def program_readings(self) -> dict:
        return dict(losses=[c["loss"] for c in self.checked],
                    pesq_terms=[c["pesq"] for c in self.checked], first_grad=self.first_grad,
                    change=self.change, ema_change=self.ema_change)

    def readings(self, controls=()) -> dict:
        """The program's numbers and each control's, against the float32
        reference: a control is ``bf16`` or ``fp8`` (the reference in that
        precision in the program's place), ``half_batch`` (the reference with
        half of each batch left out), or a fault of ``reference/training.py``:
        ``no_pesq`` (the PESQ term computed but left out of the loss),
        ``answer_altered`` (the loss 1.5 times what it is)."""
        ref = self.reference()
        out = {"program": self.numbers(self.program_readings(), ref)}
        for c in controls:
            if c == "half_batch":
                ctl = self.reference(keep_rows=self.checked[0]["x"].shape[0] // 2)
            elif c in ref_training.FAULTS:
                ctl = self.reference(fault=c)
            else:
                ctl = self.reference(c)
            out[c] = self.numbers(ctl, ref)
        return out

    def check(self) -> dict:
        clean, noisy = self.corpus_arrays()
        gap = loader_check.check(clean, noisy, [(c["x"], c["y"]) for c in self.checked],
                                 self.device)
        got = dict(loader_gap=gap, **self.numbers(self.program_readings(), self.reference()))
        return {k: dict(value=got[k], limit=lim) for k, lim in self.cell["limits"].items()}
