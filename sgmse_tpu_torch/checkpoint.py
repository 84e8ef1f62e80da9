"""Checkpoints of the port's training, and the reference's four checkpoint
policies. Counterpart of ``sgmse_tpu/checkpoint.py``.

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
state tree: ``step``, ``params`` and ``ema_params`` as ``{name: tensor}`` in
the port's ``state_dict`` names, ``num_updates``, and, for a model with
buffers (DCUNet's BatchNorm running statistics), ``model_state``) and
``config.json``,
the model's ``config_dict()``, which is what a JAX checkpoint embeds. As in
the JAX package, the optimizer's moments are not saved: a resumed run starts
Adam afresh. The EMA weights export to the JAX tree with
``convert.save_npz(path, convert.jax_tree_from_state_dict(ema_params))``.

Policies, with the JAX package's directory names: ``last`` (every
validation), ``step_<k * interval>`` (kept, every ``save_ckpt_interval``
steps, also when the step counter jumps past a multiple), ``best_pesq`` and
``best_si_sdr`` (when the validation metric improves).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def save_checkpoint(path: os.PathLike, state_tree: Dict[str, Any],
                    config: Dict[str, Any]) -> None:
    """Write ``state_tree`` and ``config`` to the directory ``path``. The write
    goes to a ``.tmp`` sibling first and replaces ``path`` only once complete,
    so a crash mid-save leaves the previous checkpoint whole."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    def to_cpu(v):
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        return v.detach().cpu() if isinstance(v, torch.Tensor) else v

    torch.save(to_cpu(state_tree), tmp / "state.pt")
    with open(tmp / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_checkpoint(path: os.PathLike) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(state_tree, config) of a checkpoint directory; tensors on the CPU."""
    path = Path(path).absolute()
    with open(path / "config.json") as f:
        config = json.load(f)
    state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    return state, config


def load_score_model(path: os.PathLike, **overrides):
    """A ScoreModel rebuilt from a checkpoint's embedded config (updated with
    ``overrides``, e.g. ``precision``), holding its EMA weights (the weights
    the reference evaluates and enhances with) and its model state. On the
    CPU; move it where it should run."""
    from .model import ScoreModel  # local import to avoid a cycle

    state, config = load_checkpoint(path)
    model = ScoreModel.from_config(dict(config, **overrides))
    model.dnn.load_state_dict({**state["ema_params"], **state.get("model_state", {})})
    return model


class CheckpointPolicies:
    """The reference's four checkpoint callbacks as one policy object.

    - 'last'        : overwritten at every validation epoch (save_last)
    - 'step_<n>'    : kept forever, every `save_ckpt_interval` steps
    - 'best_pesq'   : overwritten when the monitored PESQ improves (mode max)
    - 'best_si_sdr' : overwritten when the monitored SI-SDR improves (mode max)
    """

    def __init__(self, log_dir: os.PathLike, save_ckpt_interval: int = 50000,
                 monitor_metrics: bool = True):
        self.log_dir = Path(log_dir)
        self.save_ckpt_interval = save_ckpt_interval
        self.monitor_metrics = monitor_metrics
        self.best = {"pesq": -np.inf, "si_sdr": -np.inf}
        self._last_interval_step: Optional[int] = None
        self._warned = set()

    def start_from(self, step: int) -> None:
        """Prime the interval baseline with the run's starting step (on a
        (re)start, before the first on_train_step), so that a multiple crossed
        inside the first multi-step execution after a resume is saved."""
        self._last_interval_step = step

    def on_train_step(self, step: int, state_tree, config) -> None:
        """Save a kept checkpoint whenever an interval multiple was crossed
        since the previous call (the step counter may advance in jumps), named
        after the multiple crossed."""
        if not self.save_ckpt_interval or step <= 0:
            return
        prev = self._last_interval_step if self._last_interval_step is not None \
            else step - 1
        self._last_interval_step = step
        if step // self.save_ckpt_interval > prev // self.save_ckpt_interval:
            named = (step // self.save_ckpt_interval) * self.save_ckpt_interval
            save_checkpoint(self.log_dir / f"step_{named}", state_tree, config)

    def on_validation(self, step: int, state_tree, config,
                      metrics: Dict[str, float]) -> None:
        save_checkpoint(self.log_dir / "last", state_tree, config)
        if not self.monitor_metrics:
            return
        for name in ("pesq", "si_sdr"):
            value = metrics.get(name)
            if value is not None and not np.isfinite(value):
                if name not in self._warned:
                    self._warned.add(name)
                    warnings.warn(
                        f"validation metric '{name}' is non-finite ({value}); the "
                        f"best_{name} checkpoint policy will not fire.")
                continue
            if value is not None and value > self.best[name]:
                self.best[name] = value
                save_checkpoint(self.log_dir / f"best_{name}", state_tree, config)
