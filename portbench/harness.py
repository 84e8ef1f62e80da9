"""The benchmark's frame: what to run, found by name, and the one result line.

Everything that belongs to one cell, configuration, traffic driver or
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a model configuration (widths, STFT, SDE,
  sampler, precision, training settings, ``reduced``, ``assumed``);
- ``workloads/<cell>.json``: a cell (its configuration, traffic mix, window
  driver, the traffic's parameters, the limits of its comparison);
- ``traffic/<driver>.py``: a window driver (``Run``: set-up, window, check);
- ``metrics/<metric>.py``: the reader of one per-layer metric (``read``).

So a cell, a configuration or a metric is added by adding files and the
entry in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that must not be loaded: JAX, and the JAX package the
# port was made from (compared whole: sgmse_tpu_torch is not sgmse_tpu).
FORBIDDEN = ("jax", "jaxlib", "flax", "sgmse_tpu")


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} {name!r} ({path} is missing)")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def cell(name: str, base: Path = HERE) -> dict:
    return _json("workloads", name, base)


def _module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} {name!r} ({path} is missing)")
    key = f"portbench._{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def driver(name: str, base: Path = HERE) -> ModuleType:
    return _module("traffic", name, base)


def reader(name: str, base: Path = HERE) -> ModuleType:
    return _module("metrics", name, base)


def listing(base: Path = HERE) -> Dict[str, List[str]]:
    """The names of every configuration, cell, driver and metric on disk."""
    def names(kind, suffix):
        return sorted(p.name[:-len(suffix)] for p in (base / kind).glob(f"*{suffix}")
                      if not p.name.startswith("_"))
    return dict(configs=names("configs", ".json"), workloads=names("workloads", ".json"),
                traffic=names("traffic", ".py"), metrics=names("metrics", ".py"))


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics ``cell_name`` reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics read in ``cell_name``'s traced run: those that list
    it, and those without a list whose end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}

    def reads(m):
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported

    return [m for m in bench["per_layer"] if reads(m)]


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules) if n.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def checks_passed(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                for c in checks.values())


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: Dict[str, dict], breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output; ``checks`` is the last key."""
    out = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
               device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
