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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import calc_metrics, enhance, nfe_profile, train
from ..checkpoint import load_checkpoint
from ..data.wav import read_wav, resample
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


def base_parser(doc: str, name: str, **defaults) -> argparse.ArgumentParser:
    """The options of every learn demo, with this demo's ``defaults``; its
    workdir defaults to ``build/<name>`` in the checkout."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?", default=str(ROOT / "build" / name),
                        help="Where the corpus, logs, checkpoints and enhanced files go")
    parser.add_argument("--num_train", type=int)
    parser.add_argument("--num_valid", type=int)
    parser.add_argument("--num_test", type=int)
    parser.add_argument("--seconds", type=float, default=2.2, help="Length of each file")
    parser.add_argument("--max_steps", type=int)
    parser.add_argument("--num_eval_files", type=int,
                        help="Valid files enhanced and scored at each validation")
    parser.add_argument("--batch_size", type=int, help="Training batch")
    parser.add_argument("--no_profile", action="store_true",
                        help="Skip the profile of train steps on the card")
    parser.set_defaults(**defaults)
    return parser


def build_parser() -> argparse.ArgumentParser:
    parser = base_parser(__doc__, "learn_demo", num_train=1024, num_valid=16, num_test=16,
                         max_steps=3200, num_eval_files=8, batch_size=16)
    parser.add_argument("--max_epochs", type=int, default=-1)
    parser.add_argument("--N", type=int, default=30, help="Reverse steps of the enhancement")
    return parser


def score_pair(x: np.ndarray, y: np.ndarray, sr: int) -> tuple:
    """(PESQ, SI-SDR, ESTOI) of ``y`` against ``x``, both cut to the shorter
    length. PESQ is scored at 16 kHz, both signals resampled where ``sr`` is
    another rate, as ``calc_metrics`` and the reference score it; SI-SDR and
    ESTOI at ``sr``."""
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    return (pesq_wb(16000, resample(x, sr, 16000), resample(y, sr, 16000)), si_sdr(x, y),
            stoi(x, y, sr, extended=True))


def scores(clean_dir: Path, other_dir: Path) -> Dict[str, List[float]]:
    """``score_pair`` of every wav of ``other_dir`` against its clean file (the
    JAX demos' input baselines, with the port's metrics)."""
    out = {k: [] for k in METRICS}
    for f in sorted(glob(str(Path(clean_dir) / "*.wav"))):
        x, sr = read_wav(f)
        y, _ = read_wav(str(Path(other_dir) / Path(f).name))
        for k, v in zip(METRICS, score_pair(x[0], y[0], sr)):
            out[k].append(v)
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
    return {k: result[k] for k in ("batch", "precision", "steps_per_s", "wall_ms", "busy_ms",
                                   "idle_share_traced", "idle_share_untraced", "launches",
                                   "peak_gib", "params")}


def best_pesq(run: dict, logs: Path):
    """The ``best_pesq`` checkpoint of ``train.main``'s run: (its directory,
    its step, its config, the run's validation journey). Raises where no
    validation gave a finite PESQ."""
    ckpt_dir = Path(run["ckpt_dir"])
    best = ckpt_dir / "best_pesq"
    if not best.exists():
        raise RuntimeError(f"{best} was not written: no validation gave a finite PESQ "
                           f"(see {logs / 'sgmse' / ckpt_dir.name / 'metrics.jsonl'})")
    state, config = load_checkpoint(best)
    return best, int(state["step"]), config, validation_journey(logs, ckpt_dir.name)


def delta_table(inputs: Dict[str, float], enhanced: Dict[str, float], band: Dict[str, float],
                history: Dict[str, tuple], name: str = "noisy") -> Dict[str, bool]:
    """Print enhanced against the input (``name``) beside the band and the
    v5e history; returns which deltas are in the band."""
    in_band = {k: bool(enhanced[k] - inputs[k] >= band[k]) for k in METRICS}
    print(f"\n| metric | {name} | enhanced | delta | band | v5e history: {name} -> enhanced |")
    print("|---|---|---|---|---|---|")
    for k in METRICS:
        hist = history[k]
        print(f"| {k} | {inputs[k]:.3f} | {enhanced[k]:.3f} | {enhanced[k] - inputs[k]:+.3f} | "
              f">= {band[k]:+} {'yes' if in_band[k] else 'NO'} | "
              f"{hist[0]} -> {hist[1]} ({hist[1] - hist[0]:+.3f}) |")
    return in_band


def print_run(result: dict) -> None:
    """The validation journey, the stages' seconds, the training and
    enhancement rates and, on the card, the profile of train steps."""
    journey, stages = result["validations"], result["stages"]
    first, last = (journey[0], journey[-1]) if journey else ({}, {})
    print(f"validations {len(journey)}: valid_loss {first.get('valid_loss', math.nan):.4f} -> "
          f"{last.get('valid_loss', math.nan):.4f}; best_pesq at step "
          f"{result['best_pesq_step']} of {result['steps']}")
    print("stages (s): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    print(f"training {result['train_steps_per_s']:.3f} steps/s over {result['steps']} steps "
          f"(validation included); enhancement "
          f"{result['enhance_audio_s_per_wall_s'] or math.nan:.3f} audio-s/wall-s "
          f"({' '.join(result['enhance_flags'])}, {result['device']})")
    if "train_profile" in result:
        p = result["train_profile"]
        print(f"train steps alone (B={p['batch']}, {p['precision']}): "
              f"{p['steps_per_s']:.2f} steps/s, device idle {p['idle_share_untraced']:.1%} "
              f"of the untimed wall ({p['idle_share_traced']:.1%} of the traced span), "
              f"{p['busy_ms']:.1f} ms busy, {p['launches']:.0f} launches, "
              f"peak {p['peak_gib']:.2f} GiB")


def run_recipe(args, name: str, device, net_flags: List[str], corpus: Callable[[Path], None],
               train_flags: List[str], clean: str, test_in: str, enhance_flags: List[str],
               band: Dict[str, float], history: Dict[str, tuple], input_name: str = "noisy",
               calc_metrics_scores: bool = True,
               extra: Optional[Callable[[dict], None]] = None) -> dict:
    """A learn demo's stages, each timed: ``corpus(ds)``; ``train.main`` of
    ``net_flags`` and ``train_flags`` on it, with the flags every demo shares;
    ``enhance.main`` of ``test/<test_in>`` with the ``best_pesq`` checkpoint
    and ``enhance_flags``; the scores of the enhanced files (through
    ``calc_metrics``, else ``scores``) and of the input against
    ``test/<clean>``; ``extra(result)``, a stage of the demo's own; on the
    card, the profile of train steps. Prints the deltas against ``band`` and
    ``history`` and the run, writes ``workdir/<name>.json`` and returns it all.
    Raises without a card unless ``device`` names another (the tests' CPU)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(f"{name} runs on a CUDA device, and torch.cuda.is_available() "
                           f"is false")
    work = Path(args.workdir)
    ds, logs, enh = work / "ds", work / "logs", work / "enh"
    stages: Dict[str, float] = {}

    def timed(stage, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        stages[stage] = time.time() - t0
        return out

    timed("corpus_s", corpus, ds)
    run = timed("train_s", train.main, [
        "--base_dir", str(ds), *net_flags, *train_flags, "--batch_size", str(args.batch_size),
        "--num_workers", "4", "--num_eval_files", str(args.num_eval_files),
        "--steps_per_execution", "8", "--precision", "bfloat16", "--max_steps",
        str(args.max_steps), "--save_ckpt_interval", "0", "--nolog", "--log_dir", str(logs),
        "--devices", "1"], device=device)
    best, best_step, config, journey = best_pesq(run, logs)
    enh_stats = timed("enhance_s", enhance.main, [
        "--test_dir", str(ds / "test" / test_in), "--enhanced_dir", str(enh), "--ckpt",
        str(best), *enhance_flags, "--timeit"], device=device)
    clean_dir = ds / "test" / clean
    if calc_metrics_scores:
        enhanced = timed("scores_s", lambda: means(calc_metrics.main([
            "--clean_dir", str(clean_dir), "--noisy_dir", str(ds / "test" / test_in),
            "--enhanced_dir", str(enh)])))
    else:
        enhanced = timed("scores_s", lambda: means(scores(clean_dir, enh)))
    inputs = timed("baseline_s", lambda: means(scores(clean_dir, ds / "test" / test_in)))

    result = dict(
        workdir=str(work), device=enh_stats["device"], steps=run["step"],
        train_files=args.num_train, test_files=enh_stats["files"],
        num_eval_files=args.num_eval_files, best_pesq=str(best), best_pesq_step=best_step,
        noisy=inputs, enhanced=enhanced, delta={k: enhanced[k] - inputs[k] for k in METRICS},
        stages=stages, train_steps_per_s=run["step"] / stages["train_s"], fit_s=run["fit_s"],
        enhance_flags=enhance_flags, enhance_batches=enh_stats["batches"],
        enhance_audio_s_per_wall_s=enh_stats.get("audio_s_per_wall_s"),
        enhance_nfe=enh_stats["nfe"], enhance_warmup_nfe=enh_stats["warmup_nfe"],
        validations=journey, config=config)
    if extra is not None:
        extra(result)
    if torch.device(enh_stats["device"]).type == "cuda" and not args.no_profile:
        result["train_profile"] = timed("train_profile_s", train_profile, config,
                                        args.batch_size, work / "profile")

    print(f"\n{name}:", end="")
    result["in_band"] = delta_table(inputs, enhanced, band, history, input_name)
    print_run(result)
    work.mkdir(parents=True, exist_ok=True)
    (work / f"{name}.json").write_text(json.dumps(result, indent=1, default=str))
    return result


def main(argv: Optional[List[str]] = None, device=None,
         net_flags: Optional[List[str]] = None) -> dict:
    """Run the recipe; returns (and writes to ``workdir/learn_demo.json``) its
    numbers. On the card unless ``device`` names another (the tests' CPU)."""
    args = build_parser().parse_args(argv)

    def corpus(ds: Path) -> None:
        create_synthetic_speech.main([
            str(ds), "--num_train", str(args.num_train), "--num_valid", str(args.num_valid),
            "--num_test", str(args.num_test), "--seconds", str(args.seconds), "--seed",
            str(CORPUS_SEED)])

    return run_recipe(args, "learn_demo", device, NET_FLAGS if net_flags is None else net_flags,
                      corpus, ["--max_epochs", str(args.max_epochs)], "clean", "noisy",
                      ["--N", str(args.N), "--batch_size", str(ENHANCE_BATCH)], BAND,
                      V5E_HISTORY)


if __name__ == "__main__":
    main(sys.argv[1:])
