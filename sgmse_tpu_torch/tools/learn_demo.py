"""The learn-then-enhance-better demonstration through the port's entry points.

    python -m sgmse_tpu_torch.tools.learn_demo [workdir] \\
        [--num_train 1024 --max_steps 3200 --num_eval_files 8 --max_epochs -1]

The recipe of ``tools/learn_demo.py``, run in one process through the port
alone:

1. ``preprocessing.create_synthetic_speech``: ``--num_train`` train, 16 valid
   and 16 test pairs of 2.2 s, seed 7 (the JAX package's corpus, byte for
   byte);
2. ``train.main``: NCSN++ (nf 32, ch_mult 1 1 2 2, one res-block per level:
   1,377,050 parameters, as in the JAX package) with OUVE, batch 16,
   bfloat16, ``--max_steps`` steps, validation at the end of every epoch
   (64 steps at 1,024 files) with PESQ / SI-SDR / ESTOI of
   ``--num_eval_files`` valid files, which pick the ``best_pesq``
   checkpoint;
3. ``enhance.main`` of the test set with ``best_pesq`` (its EMA weights),
   PC N=30 + ald, batch 8, ``--timeit``;
4. ``calc_metrics`` of the enhanced test set;
5. the noisy-input baseline: the same metrics of noisy against clean.

It prints the enhanced-vs-noisy deltas beside the JAX package's v5e run (a
record of that run, not a figure of this one), the wall time of each stage,
training steps/s and enhancement audio-s/wall-s, and writes all of it, with
the validation journey (``valid_loss`` and the metrics at each validation),
to ``workdir/learn_demo.json``. On the card it also profiles B=16 train steps
of the same net (``nfe_profile.train_step_profile``: steps/s without
validation, and the device's idle share). The default workdir is
``build/learn_demo`` in the checkout.

``main(argv, device="cpu", net_flags=...)`` is the Python-API hook of the
tests: the CPU, and a smaller net and STFT in place of ``NET_FLAGS``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import calc_metrics, enhance, nfe_profile, train
from ..checkpoint import load_checkpoint
from ..data.wav import read_wav
from ..model import ScoreModel
from ..preprocessing import create_synthetic_speech
from ..utils.metrics import mean_std, pesq_wb, si_sdr, stoi

ROOT = Path(__file__).resolve().parents[2]
NET_FLAGS = ["--backbone", "ncsnpp", "--sde", "ouve", "--nf", "32", "--ch_mult", "1", "1", "2",
             "2", "--num_res_blocks", "1"]
# The JAX package's run of this recipe on one TPU v5e (docs/PERFORMANCE.md, "The system
# learns"): (noisy, enhanced) means over the 16 test files. History, for comparison only.
V5E_HISTORY = {"pesq": (1.087, 3.54), "si_sdr": (5.57, 12.9), "estoi": (0.272, 0.52)}
# The band the port's full recipe should reach over noisy (enhanced - noisy); below it, a fault.
BAND = {"pesq": 1.5, "si_sdr": 4.0, "estoi": 0.10}
METRICS = ("pesq", "si_sdr", "estoi")
CORPUS_SEED, ENHANCE_BATCH = 7, 8


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?", default=str(ROOT / "build" / "learn_demo"),
                        help="Where the corpus, logs, checkpoints and enhanced files go")
    parser.add_argument("--num_train", type=int, default=1024)
    parser.add_argument("--num_valid", type=int, default=16)
    parser.add_argument("--num_test", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=2.2, help="Length of each file")
    parser.add_argument("--max_steps", type=int, default=3200)
    parser.add_argument("--max_epochs", type=int, default=-1)
    parser.add_argument("--num_eval_files", type=int, default=8,
                        help="Valid files enhanced and scored at each validation")
    parser.add_argument("--batch_size", type=int, default=16, help="Training batch")
    parser.add_argument("--N", type=int, default=30, help="Reverse steps of the enhancement")
    parser.add_argument("--no_profile", action="store_true",
                        help="Skip the profile of train steps on the card")
    return parser


def scores(clean_dir: Path, other_dir: Path) -> Dict[str, List[float]]:
    """PESQ, SI-SDR and ESTOI of every wav of ``other_dir`` against its clean
    file (the JAX demo's noisy baseline, with the port's metrics)."""
    out = {k: [] for k in METRICS}
    for f in sorted(glob(str(clean_dir / "*.wav"))):
        x, sr = read_wav(f)
        y, _ = read_wav(str(other_dir / Path(f).name))
        x, y = x[0], y[0]
        out["pesq"].append(pesq_wb(16000, x, y))
        out["si_sdr"].append(si_sdr(x, y))
        out["estoi"].append(stoi(x, y, sr, extended=True))
    return out


def means(per_file: Dict[str, list]) -> Dict[str, float]:
    return {k: float(mean_std(np.asarray(per_file[k], dtype=np.float64))[0]) for k in METRICS}


def validation_journey(log_dir: Path, version: str) -> List[dict]:
    """Every validation of the run: its step, ``valid_loss`` and metrics, from
    the CSV logger's ``metrics.jsonl``."""
    path = log_dir / "sgmse" / version / "metrics.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [{k: r[k] for k in ("step", "valid_loss", *METRICS) if k in r}
            for r in rows if "valid_loss" in r]


def train_profile(config: dict, batch: int, out_dir: Path) -> dict:
    """Steps/s and the device's idle share of train steps of the demo's net
    (seeded weights) on the card, without validation."""
    model = ScoreModel.from_config(config)
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last)
    result = nfe_profile.train_step_profile(model, out_dir, batch,
                                            trace_name="learn_demo_train_trace.json")
    (Path(out_dir) / "learn_demo_train_trace.json").unlink(missing_ok=True)
    return {k: result[k] for k in ("steps_per_s", "wall_ms", "busy_ms", "idle_share_traced",
                                   "idle_share_untraced", "launches", "peak_gib", "params")}


def main(argv: Optional[List[str]] = None, device=None,
         net_flags: Optional[List[str]] = None) -> dict:
    """Run the recipe; returns (and writes to ``workdir/learn_demo.json``) its
    numbers. On the card unless ``device`` names another (the tests' CPU)."""
    args = build_parser().parse_args(argv)
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("learn_demo runs on a CUDA device, and torch.cuda.is_available() "
                           "is false")
    work = Path(args.workdir)
    ds, logs, enh = work / "ds", work / "logs", work / "enh"
    stages: Dict[str, float] = {}
    t0 = time.time()
    create_synthetic_speech.main([str(ds), "--num_train", str(args.num_train), "--num_valid",
                                  str(args.num_valid), "--num_test", str(args.num_test),
                                  "--seconds", str(args.seconds), "--seed", str(CORPUS_SEED)])
    stages["corpus_s"] = time.time() - t0

    t0 = time.time()
    run = train.main(["--base_dir", str(ds), *(NET_FLAGS if net_flags is None else net_flags),
                      "--batch_size", str(args.batch_size), "--num_workers", "4",
                      "--num_eval_files", str(args.num_eval_files), "--steps_per_execution", "8",
                      "--precision", "bfloat16", "--max_steps", str(args.max_steps),
                      "--max_epochs", str(args.max_epochs), "--save_ckpt_interval", "0",
                      "--nolog", "--log_dir", str(logs), "--devices", "1"], device=device)
    stages["train_s"] = time.time() - t0
    ckpt_dir = Path(run["ckpt_dir"])
    best = ckpt_dir / "best_pesq"
    if not best.exists():
        raise RuntimeError(f"{best} was not written: no validation gave a finite PESQ "
                           f"(see {logs / 'sgmse' / ckpt_dir.name / 'metrics.jsonl'})")
    best_state, config = load_checkpoint(best)
    journey = validation_journey(logs, ckpt_dir.name)

    t0 = time.time()
    enh_stats = enhance.main(["--test_dir", str(ds / "test" / "noisy"), "--enhanced_dir",
                              str(enh), "--ckpt", str(best), "--N", str(args.N),
                              "--batch_size", str(ENHANCE_BATCH), "--timeit"],
                             device=device)
    stages["enhance_s"] = time.time() - t0

    t0 = time.time()
    per_file = calc_metrics.main(["--clean_dir", str(ds / "test" / "clean"), "--noisy_dir",
                                  str(ds / "test" / "noisy"), "--enhanced_dir", str(enh)])
    enhanced = means(per_file)
    stages["calc_metrics_s"] = time.time() - t0
    t0 = time.time()
    noisy = means(scores(ds / "test" / "clean", ds / "test" / "noisy"))
    stages["noisy_baseline_s"] = time.time() - t0

    delta = {k: enhanced[k] - noisy[k] for k in METRICS}
    result = dict(
        workdir=str(work), device=enh_stats["device"], steps=run["step"],
        train_files=args.num_train, test_files=len(per_file["filename"]),
        max_epochs=args.max_epochs, num_eval_files=args.num_eval_files,
        best_pesq=str(best), best_pesq_step=int(best_state["step"]), noisy=noisy,
        enhanced=enhanced, delta=delta, in_band={k: bool(delta[k] >= BAND[k]) for k in METRICS},
        beats_noisy=all(delta[k] > 0 for k in METRICS), stages=stages,
        train_steps_per_s=run["step"] / stages["train_s"], fit_s=run["fit_s"],
        enhance_audio_s_per_wall_s=enh_stats.get("audio_s_per_wall_s"),
        enhance_nfe=enh_stats["nfe"], enhance_warmup_nfe=enh_stats["warmup_nfe"],
        validations=journey, config=config)
    if torch.device(enh_stats["device"]).type == "cuda" and not args.no_profile:
        t0 = time.time()
        result["train_profile"] = train_profile(config, args.batch_size, work / "profile")
        stages["train_profile_s"] = time.time() - t0

    print("\n| metric | noisy | enhanced | delta | band | v5e history: noisy -> enhanced |")
    print("|---|---|---|---|---|---|")
    for k in METRICS:
        hist = V5E_HISTORY[k]
        print(f"| {k} | {noisy[k]:.3f} | {enhanced[k]:.3f} | {delta[k]:+.3f} | "
              f">= +{BAND[k]} {'yes' if result['in_band'][k] else 'NO'} | "
              f"{hist[0]} -> {hist[1]} ({hist[1] - hist[0]:+.3f}) |")
    first, last = (journey[0], journey[-1]) if journey else ({}, {})
    print(f"validations {len(journey)}: valid_loss {first.get('valid_loss', math.nan):.4f} -> "
          f"{last.get('valid_loss', math.nan):.4f}; best_pesq at step "
          f"{result['best_pesq_step']} of {run['step']}")
    print("stages (s): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    print(f"training {result['train_steps_per_s']:.3f} steps/s over {run['step']} steps "
          f"(validation included); enhancement "
          f"{result['enhance_audio_s_per_wall_s'] or math.nan:.3f} audio-s/wall-s "
          f"(N={args.N}, batch {ENHANCE_BATCH}, {enh_stats['device']})")
    if "train_profile" in result:
        p = result["train_profile"]
        print(f"train steps alone (B={args.batch_size}, bfloat16): "
              f"{p['steps_per_s']:.2f} steps/s, device idle {p['idle_share_untraced']:.1%} "
              f"of the untimed wall ({p['idle_share_traced']:.1%} of the traced span)")
    work.mkdir(parents=True, exist_ok=True)
    (work / "learn_demo.json").write_text(json.dumps(result, indent=1, default=str))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
