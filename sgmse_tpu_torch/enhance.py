"""Enhancement entry point of the PyTorch port: enhance every wav in a directory.

    python -m sgmse_tpu_torch.enhance --test_dir noisy/ --enhanced_dir out/ \\
        (--ckpt DIR | --weights model.npz [--config config.json | --nf 128 ...]) \\
        [--sampler_type pc --N 30 --corrector ald --snr 0.5 --chunk_seconds S] \\
        [--batch_size 4 --precision bfloat16 --timeit]

Counterpart of ``cli/enhance.py``. ``--ckpt`` takes a checkpoint of the
port's training (``python -m sgmse_tpu_torch.train``): its EMA weights and
its embedded ``config.json``, as the JAX CLI's ``--ckpt`` takes an Orbax one.
Otherwise weights come from an ``.npz`` of the JAX parameter tree
(``convert.save_npz``), and the model is the JAX ``ScoreModel.config_dict()``
given as ``--config`` (the ``config.json`` of a JAX checkpoint: backbone,
SDE, STFT constants, preconditioning), or, without it, the flagship
``ncsnpp`` + OUVE built from the model flags (which ``--config`` overrides,
apart from ``--precision``, which also overrides a checkpoint's).
The backbone sets the sample rate and the pad mode (``utils.inference``).
``--sampler_type`` follows the JAX CLI: ``pc`` or ``ode`` on OUVE; on SBVE the
Schroedinger bridge, ``ode`` (``pc`` maps to it) or ``sde``, over the SDE's own
N steps whatever ``--N`` says.

``--batch_size`` groups utterances whose padded frame counts match and
enhances each group in one batched sampler run. ``--chunk_seconds`` enhances
each utterance alone, in overlapping chunks of that length
(``ScoreModel.enhance_long``). ``--data_parallel`` splits each batch by rows
over every visible GPU, one worker process each (``parallel.pool``; as the JAX
CLI shards it over its mesh): the output equals one GPU's on the batch
zero-padded to a multiple of the GPU count.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import warnings
from glob import glob
from os import makedirs
from os.path import dirname, join

import numpy as np
import torch

from . import checkpoint, convert
from .data.wav import read_wav, resample, write_wav
from .model import ScoreModel
from .models.ncsnpp import NCSNpp
from .parallel import pool
from .utils.inference import target_sr_and_pad


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--test_dir", type=str, required=True,
                        help="Directory containing the noisy wavs")
    parser.add_argument("--enhanced_dir", type=str, required=True,
                        help="Directory to write the enhanced wavs")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--ckpt", type=str, default=None,
                        help="Checkpoint directory of the port's training (EMA weights and "
                             "its config.json)")
    source.add_argument("--weights", type=str, default=None,
                        help=".npz of the JAX parameter tree (convert.save_npz)")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON of the JAX ScoreModel.config_dict() (a JAX checkpoint's "
                             "config.json); without it, the flagship from the model flags")
    parser.add_argument("--sampler_type", type=str, default="pc",
                        help="pc or ode (OUVE); ode or sde (SBVE, where pc means ode)")
    parser.add_argument("--corrector", type=str, choices=("ald", "langevin", "none"),
                        default="ald", help="Corrector of the PC sampler")
    parser.add_argument("--corrector_steps", type=int, default=1,
                        help="Number of corrector steps")
    parser.add_argument("--snr", type=float, default=0.5,
                        help="SNR value for (annealed) Langevin dynamics")
    parser.add_argument("--N", type=int, default=30, help="Number of reverse steps")
    parser.add_argument("--t_eps", type=float, default=0.03,
                        help="The minimum process time (0.03 by default)")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Utterances enhanced per sampler run (bucketed by length)")
    parser.add_argument("--chunk_seconds", type=float, default=None,
                        help="Enhance each file alone in overlapping chunks of this many "
                             "seconds (overlap-add crossfade, bounded memory)")
    parser.add_argument("--seed", type=int, default=0, help="Sampling RNG seed")
    parser.add_argument("--data_parallel", action="store_true",
                        help="Split each utterance batch by rows over every local GPU, one "
                             "worker process each (use with --batch_size >= the GPU count)")
    parser.add_argument("--timeit", action="store_true",
                        help="Print the run's real-time factor and audio-s/wall-s; every "
                             "input shape runs once, one step long, before the clock starts")
    NCSNpp.add_argparse_args(parser)
    parser.set_defaults(precision=None)  # float32, or the --config's
    return parser


def _load_items(test_dir: str, target_sr: int):
    """(name, mono waveform at target_sr) of every ``.wav`` and ``.flac`` under
    ``test_dir``. FLAC is read with ``soundfile`` where it imports; without it a
    ``.flac`` is skipped with a note on stderr, as the JAX CLI does."""
    files = [f for ext in ("wav", "flac")
             for f in sorted(glob(join(test_dir, f"*.{ext}")))
             + sorted(glob(join(test_dir, "**", f"*.{ext}")))]
    items = []
    for path in dict.fromkeys(files):
        name = path[len(test_dir):].lstrip("/")
        if path.endswith(".flac"):
            try:
                import soundfile
            except ImportError:
                print(f"skipping {name}: flac requires the soundfile package",
                      file=sys.stderr)
                continue
            y, sr = soundfile.read(path, dtype="float32")
            y = y.T if y.ndim > 1 else y[None]
        else:
            y, sr = read_wav(path)
        y = y[0]
        if sr != target_sr:
            y = resample(y, sr, target_sr)
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


def build_model(args) -> ScoreModel:
    """The model of ``--ckpt``, or of ``--config`` (or of the flagship flags)
    with ``--weights``."""
    if args.ckpt is not None:
        precision = {} if args.precision is None else {"precision": args.precision}
        return checkpoint.load_score_model(args.ckpt, t_eps=args.t_eps, **precision)
    if args.config is not None:
        with open(args.config) as f:
            cfg = json.load(f)
        if args.precision is not None:
            cfg["precision"] = args.precision
    else:
        cfg = dict(backbone="ncsnpp", sde="ouve", nf=args.nf, ch_mult=args.ch_mult,
                   num_res_blocks=args.num_res_blocks, attn_resolutions=args.attn_resolutions,
                   centered=args.centered, precision=args.precision or "float32")
    cfg["t_eps"] = args.t_eps
    model = ScoreModel.from_config(cfg)
    model.dnn.load_state_dict(convert.state_dict_from_variables(convert.load_npz(args.weights)))
    return model


def warm_up(model: ScoreModel, shapes, generator, sampler_kwargs) -> int:
    """Run every input shape once, one step long, so that kernel builds, cuDNN
    set-up and allocator growth happen before the clock starts. The
    Schroedinger-bridge sampler runs ``sde.N`` steps whatever ``N`` says, so
    a shortened copy of the SDE is passed down (the model's is left as it is);
    rk45 stops after one step. Returns the NFE."""
    nfe, short = 0, dict(sampler_kwargs, N=1, max_steps=1,
                         sde=dataclasses.replace(model.sde, N=1))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="ODE sampler hit max_steps")
        for shape in sorted(shapes):
            nfe += model.enhance(np.zeros(shape, np.float32), generator=generator,
                                 timeit=True, **short)[1]
    return nfe


def load(args, device, entry: str = "sgmse_tpu_torch.enhance"):
    """(model, device) of the parsed flags on ``device``: the model, or with
    ``--data_parallel`` a ``parallel.pool.DataParallelModel`` over every GPU
    (``device`` may then be a list of devices, a Python-API hook for tests),
    which the caller closes. Raises without a card unless ``device`` names one."""
    if isinstance(device, (list, tuple)) and not args.data_parallel:
        raise ValueError("a list of devices is for --data_parallel")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{entry} runs on a CUDA device, and "
                               "torch.cuda.is_available() is false")
        device = "cuda"
    model = build_model(args)
    if not args.data_parallel:
        device = torch.device(device)
        return model.to(device, memory_format=torch.channels_last).eval(), device
    devices = pool.local_devices(device)
    if args.batch_size < len(devices):
        print(f"--data_parallel: batch_size {args.batch_size} < {len(devices)} devices: "
              "batches are zero-padded up to the device count; raise --batch_size for "
              "full use", file=sys.stderr)
    model = pool.DataParallelModel(model.eval(), devices)
    return model, model.device


def main(argv=None, device=None) -> dict:
    """Enhance every wav of ``--test_dir``. Runs on the card; ``device="cpu"``
    (not a command-line flag) runs the plain versions on the CPU, for tests."""
    args = build_parser().parse_args(argv)
    model, device = load(args, device)
    with model if args.data_parallel else contextlib.nullcontext():
        return _run(args, model, device)


def _run(args, model, device) -> dict:
    target_sr, pad_mode = target_sr_and_pad(model.backbone)

    items = _load_items(args.test_dir, target_sr)
    sampler_kwargs = dict(sampler_type=args.sampler_type, N=args.N, corrector=args.corrector,
                          corrector_steps=args.corrector_steps, snr=args.snr, pad_mode=pad_mode)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.chunk_seconds is not None:
        chunk_len = int(args.chunk_seconds * model.sr)
        chunks = [[item] for item in items]
        shapes = {(min(len(y), chunk_len),) for _, y in items}
    else:
        chunks = _chunks(items, args.batch_size, model.spec.hop_length)
        shapes = {(len(c), max(len(y) for _, y in c)) for c in chunks}
    warm_nfe = warm_up(model, shapes, generator, sampler_kwargs) if args.timeit else 0

    total_audio_s, nfe_total, all_finite = 0.0, 0, True
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    for chunk in chunks:
        if args.chunk_seconds is not None:
            x_hat, nfe, _ = model.enhance_long(chunk[0][1], chunk_seconds=args.chunk_seconds,
                                               generator=generator, timeit=True,
                                               **sampler_kwargs)
            x_hat = x_hat[None]
        else:
            maxlen = max(len(y) for _, y in chunk)
            yb = np.stack([np.pad(y, (0, maxlen - len(y))) for _, y in chunk])
            x_hat, nfe, _ = model.enhance(yb, generator=generator, timeit=True, **sampler_kwargs)
        nfe_total += nfe
        all_finite = all_finite and bool(np.isfinite(x_hat).all())
        for (name, y), xh in zip(chunk, x_hat):
            out = join(args.enhanced_dir, name)
            makedirs(dirname(out), exist_ok=True)
            write_wav(out, xh[:len(y)], target_sr)
            total_audio_s += len(y) / target_sr
            print(name)
    wall = time.time() - t0
    stats = dict(files=len(items), batches=len(chunks), audio_s=total_audio_s, wall_s=wall,
                 nfe=nfe_total, warmup_nfe=warm_nfe, all_finite=all_finite, device=str(device),
                 backbone=model.backbone, sde=model.sde_name, sample_rate=target_sr)
    if args.data_parallel:
        stats["devices"] = [str(d) for d in model.devices]
    if args.timeit and total_audio_s > 0:
        stats["rtf"] = wall / total_audio_s
        stats["audio_s_per_wall_s"] = total_audio_s / wall
        print(f"RTF: {stats['rtf']:.4f} (wall {wall:.2f}s / audio {total_audio_s:.2f}s, "
              f"{stats['audio_s_per_wall_s']:.3f} audio-s/wall-s, NFE {nfe_total}, "
              f"device {device})")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
