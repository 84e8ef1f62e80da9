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

Data parallelism (``parallel``), as the JAX trainer shards its batch over a
mesh: ``--devices N`` (``auto``: every visible GPU) starts N ranks on one
host, one process per GPU; the JAX CLI's bootstrap flags
(``--coordinator_address host:port --num_processes P --process_id p``) or
``--distributed auto`` (torchrun's or SLURM's environment) make this process
one rank of a group started elsewhere. Under ``--devices N``
``--batch_size`` is the global batch, as in the JAX trainer, which splits one
process's batch over its devices: each rank trains its block of batch_size /
N rows (N must divide it). Under the bootstrap flags each rank is one JAX
process: it loads its shard of every epoch and ``--batch_size`` is its
batch. Each rank draws its rows of the global batch's t, z and dropout
masks, takes its gradients with ``torch.autograd.grad``, and one all-reduce
of all of them (NCCL on CUDA; gloo on the CPU) averages them over the ranks
before each update; with accumulation, the running mean is averaged once per
update. Rank 0 writes the logs and the checkpoints; the validation batches
go round the ranks, each rank evaluates its share of the eval files, and one
collective sums the metrics. With one device and no bootstrap flag the
trainer runs alone, without a process group.

``main`` runs on the card and raises when ``torch.cuda.is_available()`` is
false; ``main(argv, device="cpu")`` (not a command-line flag) runs the plain
versions on the CPU, as the tests do, and with ``--devices N`` N gloo ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import parallel
from .checkpoint import CheckpointPolicies, load_checkpoint
from .data.dataset import SpecsDataModule
from .model import ScoreModel
from .models import BackboneRegistry
from .parallel import dist as pdist
from .sdes import SDERegistry, crandn
from .utils.inference import evaluate_model, select_eval_files, shard_eval_files
from .utils.loggers import Logger, make_logger
from .utils.profiling import span


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
    ``num_updates`` and the EMA advance on every call. In a process group the
    gradients that an update applies (``grads``, or the running mean) are
    first averaged over the ranks in place, in one all-reduce
    (``parallel.dist.average_all_``): once per update, as the mean over the
    ranks of each rank's mean is the mean of the global micro-batches."""
    k = state.accumulate_grad_batches
    with span("train.optimizer"), torch.no_grad():
        if k > 1:
            if state.acc_grads is None:
                state.acc_grads = {n: torch.zeros_like(g) for n, g in grads.items()}
            for n, g in grads.items():
                acc = state.acc_grads[n]
                acc.add_((g - acc) / (state.mini_step + 1))
            state.mini_step += 1
            grads = state.acc_grads if state.mini_step == k else None
        if grads is not None:
            pdist.average_all_(list(grads.values()))
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


def compute_gradients(model: ScoreModel, state: TrainState, x_wav, y_wav,
                      generator: Optional[torch.Generator] = None):
    """(loss, {name: gradient} of every trainable parameter) on a waveform
    batch in ``train()`` mode, which advances the model state (the BatchNorm
    statistics) once, by ``torch.autograd.grad``. In a process group the batch
    is this rank's rows of the global batch, and so are the draws; the loss
    and the gradients are this rank's own (:func:`apply_gradients` averages
    the gradients over the ranks)."""
    x, y = _specs(model, x_wav, y_wav)
    model.train()
    names = [n for n, p in state.params.items() if p.requires_grad]
    with parallel.global_rows(parallel.rank(), parallel.world()):
        loss = model.step_loss(x, y, generator)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def train_step(model: ScoreModel, state: TrainState, x_wav, y_wav,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One train step on a waveform batch: spectrograms on the device, the loss
    in ``train()`` mode, its gradients (:func:`compute_gradients`), Adam and
    the EMA (:func:`apply_gradients`, which averages the gradients over the
    ranks). Returns this rank's loss (a device scalar: reading it waits for
    the step)."""
    with span("train.step"):
        loss, grads = compute_gradients(model, state, x_wav, y_wav, generator)
        apply_gradients(state, grads, model.ema_decay)
    return loss


def valid_step(model: ScoreModel, x_wav, y_wav,
               generator: Optional[torch.Generator] = None, skip: bool = False):
    """The loss on a waveform batch in ``eval()`` mode, without gradients.
    With ``skip`` it only makes the step's draws (t and z) and returns None:
    a rank passes over another rank's validation batch so, and its generator
    moves as in a one-process validation."""
    x, y = _specs(model, x_wav, y_wav)
    model.eval()
    with torch.no_grad():
        if skip:
            model.draw_t(x.shape[0], generator, x.device)
            crandn(x.shape, generator, x.device)
            return None
        return model.step_loss(x, y, generator)


def _copy(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


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
    """Training orchestrator (the JAX ``Trainer``): train steps, logging every
    ``log_every_n_steps``, validation with the in-training evaluation at the
    end of every epoch, and the four checkpoint policies. In a process group
    (``parallel``) it is one rank: its gradients are averaged over the ranks
    before each update, and only rank 0 logs and writes checkpoints, in the run directory of rank 0's logger.
    ``history`` collects (step, train loss) of every step, read at the log
    points; the loss is the global batch's, the mean over the ranks."""

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
        self.rank, self.world, self.is_main = parallel.rank(), parallel.world(), parallel.is_main()
        # Every rank's run directory is rank 0's (its logger picked the version).
        self.ckpt_dir = Path(log_dir) / parallel.broadcast_str(str(logger.version))
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
        if self.is_main:
            self.logger.log_hparams(config)

        self.policies.start_from(state.step)
        epoch, running, running_samples, t_start = 0, [], 0, time.time()
        done = False

        def log_running():  # the losses since the last log point: one wait for the device
            values = pdist.average_(torch.stack(running)).tolist()  # the global batch's
            self.history.extend(zip(range(state.step - len(values) + 1, state.step + 1), values))
            running.clear()
            return values

        while not done and not (self.max_epochs >= 0 and epoch >= self.max_epochs):
            for x_wav, y_wav in train_loader:
                running.append(train_step(model, state, x_wav, y_wav, generator))
                running_samples += x_wav.shape[0] * self.world  # the global batch
                if state.step % self.log_every_n_steps == 0:
                    avg = float(np.mean(log_running()))
                    rate = running_samples / (time.time() - t_start)
                    if self.is_main:
                        self.logger.log_metrics({"train_loss": avg, "samples_per_sec": rate},
                                                state.step)
                        print(f"step {state.step}: train_loss={avg:.4f} ({rate:.1f} "
                              "samples/s)", flush=True)
                    running_samples, t_start = 0, time.time()
                if self.is_main:
                    self.policies.on_train_step(state.step, state.tree(), config)
                done = self.max_steps >= 0 and state.step >= self.max_steps
                if done:
                    break
            if not done:
                epoch += 1
            self.metrics = self.validate(state, valid_loader, generator)
            if self.is_main:
                self.logger.log_metrics(self.metrics, state.step)
                self.policies.on_validation(state.step, state.tree(), config, self.metrics)
        if running:  # steps after the last log point
            log_running()
        return state

    def validate(self, state: TrainState, valid_loader, generator=None) -> Dict[str, float]:
        """Validation on the EMA weights with the live model state, in
        ``eval()`` mode: the sample-weighted mean loss over the valid split,
        and the in-training evaluation on ``num_eval_files``. It draws from a
        copy of ``generator``, so the training draws go on as if it had not
        run (the JAX trainer's key is not advanced by validation either).

        As a rank (``sgmse_tpu/train.py:366-423``): batch i is rank i mod
        world's, and batch 0 runs on every rank (only its owner counts it);
        a rank makes the draws of the batches it passes over, so batch i's
        draws are those of a one-process validation. Each rank evaluates its
        share of the eval files (``shard_eval_files``), and one collective sums
        every rank's (sum, count) pairs."""
        model = self.model
        model.eval()
        generator = _copy(generator)
        with ema_weights(state):
            loss_acc, n_samples = None, 0
            for i, (x_wav, y_wav) in enumerate(valid_loader):
                mine = i % self.world == self.rank
                loss = valid_step(model, x_wav, y_wav, generator, skip=not (mine or i == 0))
                if mine:
                    loss = loss * x_wav.shape[0]
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
        sums = parallel.reduce_sums(sums)
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
        parser_.add_argument("--distributed", type=str, default="none", choices=("none", "auto"),
                             help="'auto': this process is one rank of a group started by "
                                  "torchrun or SLURM, read from their environment.")
        parser_.add_argument("--coordinator_address", type=str, default=None,
                             help="host:port of rank 0's rendezvous (multi-host training).")
        parser_.add_argument("--num_processes", type=int, default=None,
                             help="Total number of processes (ranks) of the group.")
        parser_.add_argument("--process_id", type=int, default=None,
                             help="This process's rank in [0, num_processes).")
    temp_args, _ = base_parser.parse_known_args(argv)
    backbone_cls = BackboneRegistry.get_by_name(temp_args.backbone)
    sde_class = SDERegistry.get_by_name(temp_args.sde)

    trainer_parser = parser.add_argument_group("Trainer", description="Trainer")
    trainer_parser.add_argument("--devices", default="auto",
                                help="How many GPUs of this host to train on, one rank each "
                                     "('auto' = all visible); --batch_size is split over "
                                     "them, as the JAX trainer splits it over its devices. "
                                     "Ignored under the bootstrap flags, where each process "
                                     "is one rank and loads --batch_size rows itself.")
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


def _train(argv, device, split_batch: bool = False) -> dict:
    """Build the model, the data and the trainer of ``argv`` on ``device`` and
    fit: alone, or as this process's rank of the running group (with
    ``split_batch``, a rank of ``--devices N``: ``--batch_size`` is split over
    the ranks)."""
    parser, args = build_parser(argv)
    groups = _argument_groups(parser, args)
    model = ScoreModel(backbone=args.backbone, sde=args.sde,
                       **{**groups["ScoreModel"], **groups["SDE"], **groups["Backbone"],
                          **groups["DataModule"]})
    data_module = SpecsDataModule(**groups["DataModule"], seed=args.seed,
                                  split_batch=split_batch)
    logger = make_logger(args.nolog, args.log_dir, args.wandb_name, is_main=parallel.is_main())
    trainer = Trainer(model, data_module, logger, log_dir=args.log_dir,
                      max_epochs=args.max_epochs, max_steps=args.max_steps,
                      accumulate_grad_batches=args.accumulate_grad_batches,
                      save_ckpt_interval=args.save_ckpt_interval, seed=args.seed,
                      device=device)
    t0 = time.time()
    state = trainer.fit(ckpt_path=args.ckpt)
    digest = hashlib.sha256()
    for tree in (state.params, state.ema_params, state.model_state):
        for n, t in tree.items():
            digest.update(n.encode() + t.detach().cpu().numpy().tobytes())
    return dict(step=state.step, num_updates=state.num_updates, ckpt_dir=str(trainer.ckpt_dir),
                history=trainer.history, metrics=trainer.metrics, fit_s=time.time() - t0,
                device=str(torch.device(device)), rank=parallel.rank(), world=parallel.world(),
                state_sha256=digest.hexdigest())


def _rank_main(rank: int, world: int, init_method: str, argv, device_type: str,
               threads: int) -> dict:
    """One rank of ``--devices N`` (:func:`parallel.dist.spawn`'s target), on
    ``threads`` CPU threads."""
    device = pdist.rank_device(device_type, rank)
    torch.set_num_threads(threads)
    parallel.init_process_group(init_method, world, rank, device)
    return _train(argv, device, split_batch=True)


def main(argv=None, device=None, timeout: Optional[float] = None) -> dict:
    """Train. Runs on the card; ``device="cpu"`` (not a command-line flag) runs
    the plain versions on the CPU, for tests. Returns the run's statistics
    (rank 0's, with every rank's under ``ranks`` when this call started them;
    ``state_sha256`` digests the final parameters, EMA and model state).

    Under the bootstrap flags this process joins the group as one rank, on
    ``cuda:<local rank>``. Otherwise ``--devices N`` > 1 starts N ranks here,
    one process per device (N gloo ranks for ``device="cpu"``), each training
    batch_size / N rows of every batch (ValueError where N does not divide
    ``--batch_size``), and waits for them: at most ``timeout`` seconds (a Python-API limit for tests; None:
    none), then every rank is ended and this raises."""
    parser, args = build_parser(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sgmse_tpu_torch.train runs on a CUDA device, and "
                               "torch.cuda.is_available() is false")
        device = "cuda"
    device = torch.device(device)
    boot = pdist.bootstrap(args.coordinator_address, args.num_processes, args.process_id,
                           args.distributed)
    if boot is not None:
        rank_dev = pdist.rank_device(device.type, boot["rank"], boot["local_rank"])
        parallel.init_process_group(boot["init_method"], boot["world_size"], boot["rank"],
                                    rank_dev)
        try:
            return _train(argv, rank_dev)
        finally:
            torch.distributed.destroy_process_group()
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = visible if args.devices == "auto" else int(args.devices)
    if n < 1 or (device.type == "cuda" and n > visible):
        raise ValueError(f"--devices {args.devices}: {visible} visible {device.type} device(s)")
    if n == 1:
        return _train(argv, device)
    if args.batch_size % n:
        raise ValueError(f"--batch_size {args.batch_size} does not split over --devices {n}")
    threads = max(1, torch.get_num_threads() // n)  # this process's threads, shared out
    ranks = pdist.spawn(_rank_main, n, (argv, device.type, threads), timeout)
    return dict(ranks[0], ranks=ranks)


if __name__ == "__main__":
    main(sys.argv[1:])
