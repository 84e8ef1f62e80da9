"""The learn-then-enhance-better demonstration at 48 kHz through the port's entry
points.

    python -m sgmse_tpu_torch.tools.learn_demo_48k [workdir] \\
        [--num_train 768 --max_steps 3000 --num_eval_files 6]

The recipe of ``tools/learn_demo_48k.py`` (the reference's 48 kHz recipe: the
``ncsnpp_48k`` backbone with its DSP and SDE constants ``DSP`` and ``SDE``),
run in one process through the port alone:

1. ``preprocessing.create_synthetic_speech`` at 48 kHz: ``--num_train``
   train, 12 valid and 12 test pairs of 2.2 s, seed 9 (the JAX package's
   corpus, byte for byte);
2. ``train.main``: ``ncsnpp_48k`` at nf 32, ch_mult 1 1 2 2, one res-block
   per level, with OUVE, batch 8, bfloat16, ``--max_steps`` steps, validation
   at the end of every epoch (96 steps at 768 files) with PESQ / SI-SDR /
   ESTOI of ``--num_eval_files`` valid files, which pick ``best_pesq``;
3. ``enhance.main`` of the noisy test set with ``best_pesq`` (its EMA
   weights), PC N=30 + ald, batch 4, ``--timeit``;
4. the scores of the enhanced and of the noisy test files against clean
   (``learn_demo.scores``: PESQ at 16 kHz, SI-SDR and ESTOI at 48 kHz);
5. the long-utterance path: ``long_utterance`` writes a 22-s noisy
   utterance (-5 dB white noise) and its clean copy to ``long/``, and
   ``enhance.main --chunk_seconds 4`` enhances both (``enhance_long``: 6
   overlapping chunks each); only ``long0.wav`` is scored.

It prints both sets of deltas beside their bands and the JAX package's v5e
run (a record of that run, not a figure of this one), the wall time of each
stage, training steps/s and the audio-s/wall-s of both enhancements, and
writes all of it, with the validation journey, to
``workdir/learn_demo_48k.json``. On the card it also profiles B=8 bfloat16
train steps of the net. The default workdir is ``build/learn_demo_48k`` in
the checkout.

``main(argv, device="cpu", net_flags=...)`` is the Python-API hook of the
tests: the CPU, and a smaller net in place of ``NET_FLAGS``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import enhance
from ..data.wav import read_wav, write_wav
from ..preprocessing import create_synthetic_speech
from .learn_demo import METRICS, base_parser, delta_table, run_recipe, score_pair

SR = 48000
DSP = ["--n_fft", "1534", "--hop_length", "384", "--spec_factor", "0.065",
       "--spec_abs_exponent", "0.667"]
SDE = ["--sigma-min", "0.1", "--sigma-max", "1.0", "--theta", "2.0"]
NET_FLAGS = ["--backbone", "ncsnpp_48k", "--sde", "ouve", "--nf", "32", "--ch_mult", "1", "1",
             "2", "2", "--num_res_blocks", "1"]
# The JAX package's run of this recipe on one TPU v5e (docs/PERFORMANCE.md): (noisy,
# enhanced) means over the 12 test files, and of the one 22-s chunked utterance. History,
# for comparison only.
V5E_HISTORY = {"pesq": (1.058, 1.653), "si_sdr": (4.91, 10.36), "estoi": (0.274, 0.480)}
V5E_HISTORY_LONG = {"pesq": (1.053, 1.944), "si_sdr": (5.00, 8.39), "estoi": (0.297, 0.534)}
# The bands of enhanced - noisy, about half of the v5e deltas; below them, a fault.
BAND = {"pesq": 0.30, "si_sdr": 2.7, "estoi": 0.10}
BAND_LONG = {"pesq": 0.45, "si_sdr": 1.7, "estoi": 0.12}
CORPUS_SEED, ENHANCE_BATCH = 9, 4
LONG_SEED, LONG_SECONDS, LONG_SNR_DB, CHUNK_SECONDS = 123, 22.0, -5.0, 4.0


def build_parser():
    parser = base_parser(__doc__, "learn_demo_48k", num_train=768, num_valid=12, num_test=12,
                         max_steps=3000, num_eval_files=6, batch_size=8)
    parser.add_argument("--N", type=int, default=30, help="Reverse steps of the enhancement")
    return parser


def long_utterance(long_dir: Path) -> int:
    """Write ``long0.wav`` (22 s of synthetic speech at 48 kHz in white noise
    at -5 dB, rng seed 123) and ``long0_clean.wav``, scaled together to a peak
    of 0.9, as ``tools/learn_demo_48k.py`` does; returns their length."""
    rng = np.random.default_rng(LONG_SEED)
    long_dir.mkdir(parents=True, exist_ok=True)
    x = create_synthetic_speech.synth_utterance(rng, LONG_SECONDS, SR)
    noise = rng.standard_normal(len(x)).astype(np.float32)
    noise *= np.sqrt((x**2).mean() / (noise**2).mean()) * 10 ** (LONG_SNR_DB / 20)
    y = (x + noise).astype(np.float32)
    peak = max(np.abs(y).max(), np.abs(x).max()) / 0.9
    write_wav(long_dir / "long0.wav", (y / peak).astype(np.float32), SR)
    write_wav(long_dir / "long0_clean.wav", (x / peak).astype(np.float32), SR)
    return len(x)


def long_stage(result: dict, N: int, device) -> None:
    """The long-utterance stage: ``long_utterance`` in ``workdir/long``,
    ``enhance.main --chunk_seconds`` of both its files with ``best_pesq``, and
    the scores of ``long0.wav`` before and after, into ``result["long"]``."""
    work, stages = Path(result["workdir"]), result["stages"]
    long_dir, long_enh = work / "long", work / "long_enh"
    t0 = time.time()
    long_len = long_utterance(long_dir)
    stats = enhance.main(["--test_dir", str(long_dir), "--enhanced_dir", str(long_enh), "--ckpt",
                          result["best_pesq"], "--N", str(N), "--chunk_seconds",
                          str(CHUNK_SECONDS), "--timeit"], device=device)
    stages["long_enhance_s"] = time.time() - t0
    t0 = time.time()
    # Only the noisy utterance is scored (its clean copy was enhanced too, as in JAX's run).
    x, y, x_hat = (read_wav(p)[0][0] for p in (long_dir / "long0_clean.wav",
                                               long_dir / "long0.wav", long_enh / "long0.wav"))
    noisy = dict(zip(METRICS, score_pair(x, y, SR)))
    enhanced = dict(zip(METRICS, score_pair(x, x_hat, SR)))
    stages["long_scores_s"] = time.time() - t0
    print(f"\nthe {LONG_SECONDS:g}-s utterance in {CHUNK_SECONDS:g}-s chunks:", end="")
    result["long"] = lg = dict(
        samples=long_len, seconds=long_len / SR, files=stats["files"],
        chunk_seconds=CHUNK_SECONDS, enhance_nfe=stats["nfe"],
        enhance_warmup_nfe=stats["warmup_nfe"], output_samples=len(x_hat),
        audio_s_per_wall_s=stats.get("audio_s_per_wall_s"), noisy=noisy, enhanced=enhanced,
        delta={k: enhanced[k] - noisy[k] for k in METRICS},
        in_band=delta_table(noisy, enhanced, BAND_LONG, V5E_HISTORY_LONG))
    print(f"chunked: {lg['files']} files of {lg['seconds']:g} s, NFE {lg['enhance_nfe']} "
          f"(+{lg['enhance_warmup_nfe']}), {lg['audio_s_per_wall_s'] or float('nan'):.3f} "
          f"audio-s/wall-s")


def main(argv: Optional[List[str]] = None, device=None,
         net_flags: Optional[List[str]] = None) -> dict:
    """Run the recipe; returns (and writes to ``workdir/learn_demo_48k.json``)
    its numbers. On the card unless ``device`` names another (the tests' CPU)."""
    args = build_parser().parse_args(argv)

    def corpus(ds: Path) -> None:
        # 2.2-s utterances cover the (256 - 1) * 384 = 97,920-sample (2.04-s) training crop.
        create_synthetic_speech.main([
            str(ds), "--num_train", str(args.num_train), "--num_valid", str(args.num_valid),
            "--num_test", str(args.num_test), "--seconds", str(args.seconds), "--sr", str(SR),
            "--seed", str(CORPUS_SEED)])

    return run_recipe(args, "learn_demo_48k", device,
                      NET_FLAGS if net_flags is None else net_flags, corpus,
                      ["--sr", str(SR), *DSP, *SDE], "clean", "noisy",
                      ["--N", str(args.N), "--batch_size", str(ENHANCE_BATCH)], BAND,
                      V5E_HISTORY, calc_metrics_scores=False,
                      extra=lambda result: long_stage(result, args.N, device))


if __name__ == "__main__":
    main(sys.argv[1:])
