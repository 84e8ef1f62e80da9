"""The learn-then-dereverb-better demonstration through the port's entry points.

    python -m sgmse_tpu_torch.tools.learn_demo_reverb [workdir] \\
        [--num_train 768 --max_steps 2500 --num_eval_files 6]

The recipe of ``tools/learn_demo_reverb.py`` (the reference's WSJ0-REVERB
recipe on a synthetic corpus), run in one process through the port alone:

1. ``synthesize``: ``--num_train`` train, 12 valid and 12 test pairs of
   2.2 s, seed 11, in ``{split}/{anechoic,reverb}/``: clean speech from
   ``preprocessing.create_synthetic_speech.synth_utterance``, reverberated by
   the image-source simulator (``data.room``) in shoebox rooms with T60 drawn
   from U[0.4, 0.7] s and at most 3 orders of reflections (the JAX package's
   corpus, byte for byte);
2. ``train.main``: the full-width flagship NCSN++ (65,590,822 parameters)
   with OUVE on ``--format reverb`` (x anechoic, y reverberant), batch 16,
   bfloat16, ``--max_steps`` steps, validation at the end of every epoch (48
   steps at 768 files) with PESQ / SI-SDR / ESTOI of ``--num_eval_files``
   valid files, which pick the ``best_pesq`` checkpoint;
3. ``enhance.main`` of the reverberant test set with ``best_pesq`` (its EMA
   weights), PC N=50 + ald at snr 0.33 (the reference's dereverberation
   settings), batch 4, ``--timeit``;
4. ``calc_metrics`` of the enhanced test set against the anechoic files;
5. the reverberant-input baseline: the same metrics of reverberant against
   anechoic.

It prints the enhanced-vs-reverberant deltas beside the band and the JAX
package's v5e run (a record of that run, not a figure of this one), the wall
time of each stage, training steps/s and enhancement audio-s/wall-s, and
writes all of it, with the validation journey, to
``workdir/learn_demo_reverb.json``. On the card it also profiles B=16
bfloat16 train steps of the flagship (steps/s, busy ms, idle share,
launches, peak memory). The default workdir is ``build/learn_demo_reverb``
in the checkout.

``main(argv, device="cpu", net_flags=...)`` is the Python-API hook of the
tests: the CPU, and a smaller net and STFT in place of ``NET_FLAGS``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data import room
from ..data.wav import write_wav
from ..preprocessing.create_synthetic_speech import synth_utterance
from .learn_demo import base_parser, run_recipe

# The full-width flagship: the training CLI's defaults for the backbone and the SDE.
NET_FLAGS = ["--backbone", "ncsnpp", "--sde", "ouve"]
# The JAX package's run of this recipe on one TPU v5e (docs/PERFORMANCE.md): (reverberant,
# enhanced) means over the 12 test files. History, for comparison only.
V5E_HISTORY = {"pesq": (3.565, 4.47), "si_sdr": (8.36, 7.9), "estoi": (0.933, 0.95)}
# The band of enhanced - reverberant, about half of the v5e deltas; below it, a fault.
# Generative dereverberation re-synthesises the waveform, so SI-SDR may fall a little.
BAND = {"pesq": 0.45, "si_sdr": -2.0, "estoi": 0.0}
CORPUS_SEED, SR = 11, 16000
# The reference's dereverberation settings: PC N=50 + ald at snr 0.33, batch 4.
ENHANCE_FLAGS = ["--N", "50", "--snr", "0.33", "--batch_size", "4"]


def build_parser():
    return base_parser(__doc__, "learn_demo_reverb", num_train=768, num_valid=12, num_test=12,
                       max_steps=2500, num_eval_files=6, batch_size=16)


def synthesize(ds: Path, counts: Dict[str, int], seconds: float, seed: int) -> None:
    """The reverb-format corpus of ``tools/learn_demo_reverb.py``: for each
    split, ``count`` pairs of ``seconds`` of synthetic speech in a random
    shoebox room (T60 from U[0.4, 0.7] s, reflections up to order 3) and its
    direct path alone, scaled together to a peak of 0.9."""
    rng = np.random.default_rng(seed)
    for split, count in counts.items():
        rev_dir, dry_dir = ds / split / "reverb", ds / split / "anechoic"
        rev_dir.mkdir(parents=True, exist_ok=True)
        dry_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            s = synth_utterance(rng, seconds, SR)
            # T60 capped at 0.7 s, so that the 2.04-s training crops keep dry structure.
            t60 = rng.uniform(0.4, 0.7)
            room_dim = rng.uniform([5, 5, 2], [10, 10, 4])
            center = np.array([room_dim[0] / 2, room_dim[1] / 2, 1.5])
            source = center[:2] + rng.uniform(-0.5, 0.5, 2)
            mic = center[:2] + rng.uniform(-0.5, 0.5, 2)
            src_pos = [*source, rng.uniform(1.4, 1.9)]
            mic_pos = [*mic, rng.uniform(1.4, 1.9)]
            e_abs, max_order = room.inverse_sabine(t60, room_dim)
            rev = room.simulate(room_dim, e_abs, src_pos, mic_pos, s, fs=SR,
                                max_order=min(3, max_order))
            dry = room.simulate(room_dim, 0.99, src_pos, mic_pos, s, fs=SR, max_order=0)
            n = min(len(rev), len(dry))
            rev, dry = rev[:n], dry[:n]
            scale = max(np.abs(rev).max(), np.abs(dry).max()) / 0.9
            name = f"rev_{split}_{i:04d}.wav"
            write_wav(rev_dir / name, (rev / scale).astype(np.float32), SR)
            write_wav(dry_dir / name, (dry / scale).astype(np.float32), SR)
        print(f"{split}: {count} reverb pairs", flush=True)


def main(argv: Optional[List[str]] = None, device=None,
         net_flags: Optional[List[str]] = None) -> dict:
    """Run the recipe; returns (and writes to ``workdir/learn_demo_reverb.json``)
    its numbers. On the card unless ``device`` names another (the tests' CPU)."""
    args = build_parser().parse_args(argv)
    counts = {"train": args.num_train, "valid": args.num_valid, "test": args.num_test}
    return run_recipe(args, "learn_demo_reverb", device,
                      NET_FLAGS if net_flags is None else net_flags,
                      lambda ds: synthesize(ds, counts, args.seconds, CORPUS_SEED),
                      ["--format", "reverb"], "anechoic", "reverb", ENHANCE_FLAGS, BAND,
                      V5E_HISTORY, "reverberant")


if __name__ == "__main__":
    main(sys.argv[1:])
