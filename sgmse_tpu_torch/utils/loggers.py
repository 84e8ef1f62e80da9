"""Training loggers: CSV (+ JSONL) and wandb, gated.

The port's copy of ``sgmse_tpu/utils/loggers.py`` (that module cannot be
imported without JAX, because importing ``sgmse_tpu`` imports it):
``CSVLogger`` writes ``{save_dir}/sgmse/version_N/metrics.csv`` and
``metrics.jsonl`` (the reference's ``--nolog`` / lightning_logs CSV path);
``WandbLogger`` wraps wandb (project "sgmse") when the package imports.
"""
from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional


class Logger:
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hparams(self, hparams: Dict) -> None:
        pass

    def finish(self) -> None:
        pass

    @property
    def version(self) -> str:
        return "0"


class CSVLogger(Logger):
    def __init__(self, save_dir: os.PathLike, name: str = "sgmse"):
        self.save_dir = Path(save_dir)
        version = 0
        while (self.save_dir / name / f"version_{version}").exists():
            version += 1
        self._version = f"version_{version}"
        self.log_dir = self.save_dir / name / self._version
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.log_dir / "metrics.csv"
        self._jsonl_path = self.log_dir / "metrics.jsonl"
        self._fieldnames = ["step", "time"]

    @property
    def version(self) -> str:
        return self._version

    def log_hparams(self, hparams: Dict) -> None:
        with open(self.log_dir / "hparams.json", "w") as f:
            json.dump(hparams, f, indent=2, default=str)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            self._fieldnames += new_fields
            # rewrite header by re-writing the file with the union of fields
            rows = []
            if self._csv_path.exists():
                with open(self._csv_path) as f:
                    rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writeheader()
                for r in rows:
                    writer.writerow(r)
                writer.writerow(row)
        else:
            with open(self._csv_path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writerow(row)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")


class WandbLogger(Logger):
    def __init__(self, project: str = "sgmse", name: Optional[str] = None,
                 save_dir: os.PathLike = "logs"):
        import wandb  # gated import

        self._run = wandb.init(project=project, name=name, dir=str(save_dir))
        self.log_dir = Path(save_dir)

    @property
    def version(self) -> str:
        return str(self._run.id)

    def log_hparams(self, hparams: Dict) -> None:
        self._run.config.update(hparams, allow_val_change=True)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._run.log(metrics, step=step)

    def finish(self) -> None:
        self._run.finish()


class NullLogger(Logger):
    """The logger of the ranks other than 0: writes nothing."""

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        pass


def make_logger(nolog: bool, log_dir: os.PathLike, wandb_name: Optional[str] = None,
                is_main: bool = True) -> Logger:
    """The reference's logger selection: wandb unless ``--nolog``, CSV when
    ``--nolog`` is given or wandb is not installed; a :class:`NullLogger` on
    the ranks other than 0 (Lightning makes the logger on rank 0 only)."""
    if not is_main:
        return NullLogger()
    if not nolog:
        try:
            return WandbLogger(project="sgmse", name=wandb_name, save_dir=log_dir)
        except Exception:
            pass
    return CSVLogger(log_dir)
