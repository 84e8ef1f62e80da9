"""Enhancement entry point of the PyTorch port: enhance every wav in a directory.

    python -m sgmse_tpu_torch.enhance --test_dir noisy/ --enhanced_dir out/ \\
        --weights model.npz [--nf 128 --ch_mult 1 1 2 2 2 2 2 ...] \\
        [--N 30 --corrector ald --snr 0.5 --batch_size 4 --precision bfloat16 --timeit]

Counterpart of ``cli/enhance.py`` for the ncsnpp + OUVE + PC path. Weights come
from an ``.npz`` of the JAX parameter tree (``convert.save_npz``) plus the
model-config flags, in place of an Orbax checkpoint. ``--batch_size`` groups
utterances whose padded frame counts match and enhances each group in one
batched sampler run.
"""
from __future__ import annotations

import argparse
import sys
import time
from glob import glob
from os import makedirs
from os.path import dirname, join

import numpy as np
import torch

from . import convert
from .data.wav import read_wav, resample, write_wav
from .model import ScoreModel
from .models.ncsnpp import NCSNpp

TARGET_SR = 16000  # the ncsnpp backbone's sample rate; pad mode zero_pad


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--test_dir", type=str, required=True,
                        help="Directory containing the noisy wavs")
    parser.add_argument("--enhanced_dir", type=str, required=True,
                        help="Directory to write the enhanced wavs")
    parser.add_argument("--weights", type=str, required=True,
                        help=".npz of the JAX parameter tree (convert.save_npz)")
    parser.add_argument("--corrector", type=str, choices=("ald", "none"), default="ald",
                        help="Corrector of the PC sampler")
    parser.add_argument("--corrector_steps", type=int, default=1,
                        help="Number of corrector steps")
    parser.add_argument("--snr", type=float, default=0.5,
                        help="SNR value for annealed Langevin dynamics")
    parser.add_argument("--N", type=int, default=30, help="Number of reverse steps")
    parser.add_argument("--t_eps", type=float, default=0.03,
                        help="The minimum process time (0.03 by default)")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Utterances enhanced per sampler run (bucketed by length)")
    parser.add_argument("--seed", type=int, default=0, help="Sampling RNG seed")
    parser.add_argument("--timeit", action="store_true",
                        help="Print the run's real-time factor and audio-s/wall-s; every "
                             "batch shape runs once, one step long, before the clock starts")
    NCSNpp.add_argparse_args(parser)
    return parser


def _load_items(test_dir: str):
    files = sorted(glob(join(test_dir, "*.wav"))) + sorted(glob(join(test_dir, "**", "*.wav")))
    items = []
    for path in dict.fromkeys(files):
        name = path[len(test_dir):].lstrip("/")
        y, sr = read_wav(path)
        y = y[0]
        if sr != TARGET_SR:
            y = resample(y, sr, TARGET_SR)
        items.append((name, y))
    return items


def _chunks(items, batch_size: int, hop: int):
    """Groups of <= batch_size utterances with equal padded frame counts."""
    if batch_size <= 1:
        return [[item] for item in items]
    buckets = {}
    for name, y in items:
        frames = 1 + len(y) // hop
        buckets.setdefault(-(-frames // 64) * 64, []).append((name, y))
    return [group[i:i + batch_size]
            for _, group in sorted(buckets.items())
            for i in range(0, len(group), batch_size)]


def main(argv=None, device=None) -> dict:
    """Enhance every wav of ``--test_dir``. Runs on the card; ``device="cpu"``
    (not a command-line flag) runs the plain versions on the CPU, for tests."""
    args = build_parser().parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sgmse_tpu_torch.enhance runs on a CUDA device, and "
                               "torch.cuda.is_available() is false")
        device = "cuda"
    device = torch.device(device)
    config = dict(nf=args.nf, ch_mult=args.ch_mult, num_res_blocks=args.num_res_blocks,
                  attn_resolutions=args.attn_resolutions, centered=args.centered,
                  precision=args.precision)
    model = ScoreModel("ncsnpp", "ouve", t_eps=args.t_eps, **config)
    model.dnn.load_state_dict(convert.params_from_jax(convert.load_npz(args.weights), **config))
    model = model.to(device, memory_format=torch.channels_last).eval()

    items = _load_items(args.test_dir)
    chunks = _chunks(items, args.batch_size, model.spec.hop_length)
    sampler_kwargs = dict(N=args.N, corrector=args.corrector,
                          corrector_steps=args.corrector_steps, snr=args.snr)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    warm_nfe = 0
    if args.timeit:
        # Kernel build, cuDNN set-up and allocator growth happen outside the
        # clock: one step at every batch shape the timed loop uses.
        for batch, maxlen in sorted({(len(c), max(len(y) for _, y in c)) for c in chunks}):
            model.enhance(np.zeros((batch, maxlen), np.float32), generator=generator,
                          **{**sampler_kwargs, "N": 1})
            warm_nfe += 1 if args.corrector == "none" else 1 + args.corrector_steps

    total_audio_s, nfe_total, all_finite = 0.0, 0, True
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    for chunk in chunks:
        maxlen = max(len(y) for _, y in chunk)
        yb = np.stack([np.pad(y, (0, maxlen - len(y))) for _, y in chunk])
        x_hat, nfe, _ = model.enhance(yb, generator=generator, timeit=True, **sampler_kwargs)
        nfe_total += nfe
        all_finite = all_finite and bool(np.isfinite(x_hat).all())
        for (name, y), xh in zip(chunk, x_hat):
            out = join(args.enhanced_dir, name)
            makedirs(dirname(out), exist_ok=True)
            write_wav(out, xh[:len(y)], TARGET_SR)
            total_audio_s += len(y) / TARGET_SR
            print(name)
    wall = time.time() - t0
    stats = dict(files=len(items), audio_s=total_audio_s, wall_s=wall, nfe=nfe_total,
                 warmup_nfe=warm_nfe, all_finite=all_finite, device=str(device))
    if args.timeit and total_audio_s > 0:
        stats["rtf"] = wall / total_audio_s
        stats["audio_s_per_wall_s"] = total_audio_s / wall
        print(f"RTF: {stats['rtf']:.4f} (wall {wall:.2f}s / audio {total_audio_s:.2f}s, "
              f"{stats['audio_s_per_wall_s']:.3f} audio-s/wall-s, NFE {nfe_total}, "
              f"device {device})")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
