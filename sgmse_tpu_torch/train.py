"""Training entry point of the PyTorch port: train a score model on a dataset
of clean/noisy wav pairs, on one CUDA device.

    python -m sgmse_tpu_torch.train --base_dir DATA [--backbone ncsnpp --sde ouve] \\
        [--batch_size 8 --num_frames 256 --precision float32 --lr 1e-4 --ema_decay 0.999] \\
        [--max_steps S --max_epochs E --num_eval_files 20 --save_ckpt_interval 50000] \\
        [--accumulate_grad_batches K --ckpt DIR --log_dir logs --nolog --seed 0]

Counterpart of ``sgmse_tpu/train.py`` and ``cli/train.py``, whose flags it
takes: a throwaway parser reads ``--backbone`` and ``--sde``, then the chosen
classes, ScoreModel, the trainer and the data module each add their own
argument group. A train step computes the spectrograms on the device, draws
t ~ U(t_eps, T) and the noise from one seeded generator, evaluates the loss,
backpropagates (on the card every K1 and K2 call runs its hand-written
backward, ``ops``), applies ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` (optax.adam's update) and then the EMA with torch_ema's ramp
min(decay, (1 + n) / (10 + n)). ``--accumulate_grad_batches k`` follows
optax.MultiSteps: the running mean of k gradients is applied on every k-th
step, while the step count, ``num_updates`` and the EMA advance on every
step. ``--steps_per_execution`` is accepted for the JAX CLI's sake: the JAX
trainer scans k steps in one program, and here every step is an ordinary
step either way.

Each epoch ends with validation on the EMA weights: the loss over the valid
split and, with ``--num_eval_files`` > 0, PESQ / SI-SDR / ESTOI of that many
enhanced valid files (``utils.inference.evaluate_model``). Checkpoints
(``checkpoint.py``) go to ``{log_dir}/{logger version}/``: ``last``,
``step_<n>``, ``best_pesq``, ``best_si_sdr``; ``--ckpt DIR`` resumes from one
(step, weights, EMA, ``num_updates`` and the model state, DCUNet's BatchNorm
statistics; Adam starts afresh, as in JAX).

Float32 convolutions follow PyTorch's cuDNN default (TF32 allowed); with
TF32 off, cuDNN's heuristics choose FFT convolutions for some layers, which
makes a float32 step several times slower (PERF.md).

``main`` runs on the card and raises when ``torch.cuda.is_available()`` is
false; ``main(argv, device="cpu")`` (not a command-line flag) runs the plain
versions on the CPU, as the tests do. One device only: ``--devices`` above 1
raises (data-parallel training is ROADMAP A13).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .checkpoint import CheckpointPolicies, load_checkpoint
from .data.dataset import SpecsDataModule
from .model import ScoreModel
from .models import BackboneRegistry
from .sdes import SDERegistry
from .utils.inference import evaluate_model, select_eval_files, shard_eval_files
from .utils.loggers import Logger, make_logger


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates. ``params`` are the model's own
    parameters (``model.dnn.named_parameters()``), ``ema_params`` detached
    copies of them; ``model_state`` the model's buffers
    (``model.dnn.named_buffers()``: DCUNet's BatchNorm running statistics, the
    JAX package's ``model_state``), which every train-mode forward updates in
    place and the EMA does not cover; ``acc_grads`` and ``mini_step`` hold
    optax.MultiSteps' running mean of the gradients when
    ``accumulate_grad_batches`` > 1."""
    step: int
    params: Dict[str, torch.nn.Parameter]
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    num_updates: int = 0
    accumulate_grad_batches: int = 1
    acc_grads: Optional[Dict[str, torch.Tensor]] = None
    mini_step: int = 0
    model_state: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def tree(self) -> dict:
        """The saved part of the state (as the JAX package saves it; the model
        state only where the model has one)."""
        tree = {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "ema_params": self.ema_params, "num_updates": self.num_updates}
        if self.model_state:
            tree["model_state"] = {k: b.detach() for k, b in self.model_state.items()}
        return tree


def create_train_state(model: ScoreModel, generator: torch.Generator,
                       accumulate_grad_batches: int = 1) -> TrainState:
    """Draw the model's parameters from ``generator`` and set up Adam and the EMA."""
    model.init_params(generator)
    params = dict(model.dnn.named_parameters())
    optimizer = torch.optim.Adam([p for p in params.values() if p.requires_grad], lr=model.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(step=0, params=params,
                      ema_params={k: p.detach().clone() for k, p in params.items()},
                      optimizer=optimizer, accumulate_grad_batches=accumulate_grad_batches,
                      model_state=dict(model.dnn.named_buffers()))


def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float, num_updates: int) -> None:
    """torch_ema's update with the num_updates ramp, in place:
    d = min(decay, (1 + n) / (10 + n)); ema <- ema - (1 - d) * (ema - param).
    The decay is taken in float32, as the JAX package takes it."""
    n = np.float32(num_updates)
    d = min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    w = float(np.float32(1.0) - np.float32(d))
    ema = list(ema_params.values())
    with torch.no_grad():
        diff = torch._foreach_sub(ema, [params[k].detach() for k in ema_params])
        torch._foreach_mul_(diff, w)
        torch._foreach_sub_(ema, diff)


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor], ema_decay: float) -> None:
    """One optimizer micro-step from ``grads`` (one per trainable parameter),
    then the EMA. With accumulation (optax.MultiSteps), the running mean
    acc <- acc + (g - acc) / (m + 1) of the micro-steps' gradients is applied on
    every k-th call and the parameters stay as they are in between; the step,
    ``num_updates`` and the EMA advance on every call."""
    k = state.accumulate_grad_batches
    with torch.no_grad():
        if k > 1:
            if state.acc_grads is None:
                state.acc_grads = {n: torch.zeros_like(g) for n, g in grads.items()}
            for n, g in grads.items():
                acc = state.acc_grads[n]
                acc.add_((g - acc) / (state.mini_step + 1))
            state.mini_step += 1
            grads = state.acc_grads if state.mini_step == k else None
        if grads is not None:
            for n, p in state.params.items():
                p.grad = grads.get(n)
            state.optimizer.step()
            for p in state.params.values():
                p.grad = None
            if k > 1:
                for acc in state.acc_grads.values():
                    acc.zero_()
                state.mini_step = 0
    state.num_updates += 1
    state.step += 1
    ema_update(state.ema_params, state.params, ema_decay, state.num_updates)


def _specs(model: ScoreModel, x_wav, y_wav):
    """Waveform batches (host or device) -> complex (B, 1, F, T) on the model's device."""
    dev = model.device
    x = torch.as_tensor(np.asarray(x_wav, np.float32) if not torch.is_tensor(x_wav) else x_wav,
                        device=dev)
    y = torch.as_tensor(np.asarray(y_wav, np.float32) if not torch.is_tensor(y_wav) else y_wav,
                        device=dev)
    return model.spec.wav_to_spec(x)[:, None], model.spec.wav_to_spec(y)[:, None]


def train_step(model: ScoreModel, state: TrainState, x_wav, y_wav,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One train step on a waveform batch: spectrograms on the device, the loss
    in ``train()`` mode (which advances the model state, the BatchNorm
    statistics, once), its gradients, Adam and the EMA. Returns the loss (a
    device scalar: reading it waits for the step)."""
    x, y = _specs(model, x_wav, y_wav)
    model.train()
    loss = model.step_loss(x, y, generator)
    names = [n for n, p in state.params.items() if p.requires_grad]
    grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    apply_gradients(state, dict(zip(names, grads)), model.ema_decay)
    return loss.detach()


def valid_step(model: ScoreModel, x_wav, y_wav,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The loss on a waveform batch in ``eval()`` mode, without gradients."""
    x, y = _specs(model, x_wav, y_wav)
    model.eval()
    with torch.no_grad():
        return model.step_loss(x, y, generator)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The EMA weights in the model for the duration, the trained ones after
    (torch_ema's store / copy_to / restore). Parameters only: the model state
    (BatchNorm statistics) stays the live one, as in the JAX package."""
    with torch.no_grad():
        stored = {n: p.detach().clone() for n, p in state.params.items()}
        for n, p in state.params.items():
            p.copy_(state.ema_params[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(stored[n])


class Trainer:
    """Training orchestrator (the JAX ``Trainer`` on one device): train steps,
    logging every ``log_every_n_steps``, validation with the in-training
    evaluation at the end of every epoch, and the four checkpoint policies.
    ``history`` collects (step, train loss) of every step, read at the log
    points."""

    def __init__(self, model: ScoreModel, data_module: SpecsDataModule, logger: Logger,
                 log_dir: str = "logs", max_epochs: int = -1, max_steps: int = -1,
                 accumulate_grad_batches: int = 1, save_ckpt_interval: int = 50000,
                 log_every_n_steps: int = 10, seed: int = 0, device=None):
        self.model = model
        self.data_module = data_module
        self.logger = logger
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.accumulate_grad_batches = accumulate_grad_batches
        self.log_every_n_steps = log_every_n_steps
        self.seed = seed
        self.device = torch.device(device if device is not None else "cuda")
        self.ckpt_dir = Path(log_dir) / str(logger.version)
        self.policies = CheckpointPolicies(self.ckpt_dir, save_ckpt_interval,
                                           monitor_metrics=model.num_eval_files > 0)
        self.history: List[tuple] = []
        self.metrics: Dict[str, float] = {}

    def fit(self, ckpt_path: Optional[str] = None) -> TrainState:
        model = self.model.to(self.device, memory_format=torch.channels_last)
        state = create_train_state(model, torch.Generator().manual_seed(self.seed),
                                   self.accumulate_grad_batches)
        if ckpt_path is not None:
            restored, _ = load_checkpoint(ckpt_path)
            model.dnn.load_state_dict({**restored["params"],
                                       **restored.get("model_state", state.model_state)})
            with torch.no_grad():
                for n, e in state.ema_params.items():
                    e.copy_(restored["ema_params"][n])
            state.step, state.num_updates = int(restored["step"]), int(restored["num_updates"])
        generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.data_module.setup("fit")
        train_loader = self.data_module.train_dataloader()
        valid_loader = self.data_module.val_dataloader()
        config = model.config_dict()
        self.logger.log_hparams(config)

        self.policies.start_from(state.step)
        epoch, running, running_samples, t_start = 0, [], 0, time.time()
        done = False

        def log_running():  # the losses since the last log point: one wait for the device
            values = torch.stack(running).tolist()
            self.history.extend(zip(range(state.step - len(values) + 1, state.step + 1), values))
            running.clear()
            return values

        while not done and not (self.max_epochs >= 0 and epoch >= self.max_epochs):
            for x_wav, y_wav in train_loader:
                running.append(train_step(model, state, x_wav, y_wav, generator))
                running_samples += x_wav.shape[0]
                if state.step % self.log_every_n_steps == 0:
                    avg = float(np.mean(log_running()))
                    rate = running_samples / (time.time() - t_start)
                    self.logger.log_metrics({"train_loss": avg, "samples_per_sec": rate},
                                            state.step)
                    print(f"step {state.step}: train_loss={avg:.4f} ({rate:.1f} samples/s)",
                          flush=True)
                    running_samples, t_start = 0, time.time()
                self.policies.on_train_step(state.step, state.tree(), config)
                done = self.max_steps >= 0 and state.step >= self.max_steps
                if done:
                    break
            if not done:
                epoch += 1
            self.metrics = self.validate(state, valid_loader, generator)
            self.logger.log_metrics(self.metrics, state.step)
            self.policies.on_validation(state.step, state.tree(), config, self.metrics)
        if running:  # steps after the last log point
            log_running()
        return state

    def validate(self, state: TrainState, valid_loader, generator=None) -> Dict[str, float]:
        """Validation on the EMA weights with the live model state, in
        ``eval()`` mode: the sample-weighted mean loss over the valid split,
        and the in-training evaluation on ``num_eval_files``."""
        model = self.model
        model.eval()
        with ema_weights(state):
            loss_acc, n_samples = None, 0
            for x_wav, y_wav in valid_loader:
                loss = valid_step(model, x_wav, y_wav, generator) * x_wav.shape[0]
                loss_acc = loss if loss_acc is None else loss_acc + loss
                n_samples += x_wav.shape[0]
            sums = {"valid_loss": (float(loss_acc) if loss_acc is not None else 0.0, n_samples)}
            valid_set = self.data_module.valid_set
            if model.num_eval_files > 0 and valid_set is not None and valid_set.clean_files:
                clean, noisy = select_eval_files(valid_set.clean_files, valid_set.noisy_files,
                                                 model.num_eval_files)
                clean, noisy = shard_eval_files(clean), shard_eval_files(noisy)
                sums.update(evaluate_model(model, clean, noisy, num_eval_files=len(clean),
                                           generator=generator, N=model.sde.N,
                                           return_sums=True))
        model.train()
        return {k: (float(s) / float(c) if c else float("nan")) for k, (s, c) in sums.items()}


def _argument_groups(parser, args) -> Dict[str, dict]:
    return {group.title: {a.dest: getattr(args, a.dest, None) for a in group._group_actions}
            for group in parser._action_groups}


def build_parser(argv=None):
    """(parser, args): the registry-driven flags of ``cli/train.py``."""
    base_parser = argparse.ArgumentParser(add_help=False)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for parser_ in (base_parser, parser):
        parser_.add_argument("--backbone", type=str,
                             choices=BackboneRegistry.get_all_names(), default="ncsnpp")
        parser_.add_argument("--sde", type=str, choices=SDERegistry.get_all_names(),
                             default="ouve")
        parser_.add_argument("--nolog", action="store_true", help="Turn off logging.")
        parser_.add_argument("--wandb_name", type=str, default=None,
                             help="Name for wandb logger. If not set, a random name is "
                                  "generated.")
        parser_.add_argument("--ckpt", type=str, default=None,
                             help="Resume training from checkpoint.")
        parser_.add_argument("--log_dir", type=str, default="logs",
                             help="Directory to save logs.")
        parser_.add_argument("--save_ckpt_interval", type=int, default=50000,
                             help="Save checkpoint interval.")
    temp_args, _ = base_parser.parse_known_args(argv)
    backbone_cls = BackboneRegistry.get_by_name(temp_args.backbone)
    sde_class = SDERegistry.get_by_name(temp_args.sde)

    trainer_parser = parser.add_argument_group("Trainer", description="Trainer")
    trainer_parser.add_argument("--devices", default="auto",
                                help="How many devices to use ('auto' = 1; more is not "
                                     "ported yet).")
    trainer_parser.add_argument("--accumulate_grad_batches", type=int, default=1,
                                help="Accumulate gradients.")
    trainer_parser.add_argument("--max_epochs", type=int, default=-1,
                                help="Number of epochs to train.")
    trainer_parser.add_argument("--max_steps", type=int, default=-1,
                                help="Number of steps to train (-1 = unlimited).")
    trainer_parser.add_argument("--steps_per_execution", type=int, default=1,
                                help="Accepted for the JAX CLI's sake; every step is an "
                                     "ordinary step here.")
    trainer_parser.add_argument("--seed", type=int, default=0,
                                help="Seeds the parameter init, the diffusion-time, noise "
                                     "and dropout draws, and the data loader's shuffle and "
                                     "crops. Two runs with one seed train alike.")
    ScoreModel.add_argparse_args(
        parser.add_argument_group("ScoreModel", description=ScoreModel.__name__))
    sde_class.add_argparse_args(parser.add_argument_group("SDE", description=sde_class.__name__))
    backbone_cls.add_argparse_args(
        parser.add_argument_group("Backbone", description=backbone_cls.__name__))
    SpecsDataModule.add_argparse_args(
        parser.add_argument_group("DataModule", description=SpecsDataModule.__name__))
    return parser, parser.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Train. Runs on the card; ``device="cpu"`` (not a command-line flag) runs
    the plain versions on the CPU, for tests. Returns the run's statistics."""
    parser, args = build_parser(argv)
    if args.devices not in ("auto", "1"):
        raise NotImplementedError(f"--devices {args.devices}: training on more than one "
                                  "device is not ported yet (ROADMAP A13)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sgmse_tpu_torch.train runs on a CUDA device, and "
                               "torch.cuda.is_available() is false")
        device = "cuda"
    groups = _argument_groups(parser, args)
    model = ScoreModel(backbone=args.backbone, sde=args.sde,
                       **{**groups["ScoreModel"], **groups["SDE"], **groups["Backbone"],
                          **groups["DataModule"]})
    data_module = SpecsDataModule(**groups["DataModule"], seed=args.seed)
    logger = make_logger(args.nolog, args.log_dir, args.wandb_name)
    trainer = Trainer(model, data_module, logger, log_dir=args.log_dir,
                      max_epochs=args.max_epochs, max_steps=args.max_steps,
                      accumulate_grad_batches=args.accumulate_grad_batches,
                      save_ckpt_interval=args.save_ckpt_interval, seed=args.seed,
                      device=device)
    t0 = time.time()
    state = trainer.fit(ckpt_path=args.ckpt)
    return dict(step=state.step, num_updates=state.num_updates, ckpt_dir=str(trainer.ckpt_dir),
                history=trainer.history, metrics=trainer.metrics, fit_s=time.time() - t0,
                device=str(torch.device(device)))


if __name__ == "__main__":
    main(sys.argv[1:])
