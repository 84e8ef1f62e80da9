"""Inference helpers: dispatch on the backbone name, and the in-training
evaluation (enhance validation files, score them).

Counterpart of ``sgmse_tpu/utils/inference.py`` (a module that imports jax,
so the port keeps its own copy): ``target_sr_and_pad``, ``select_eval_files``,
``shard_eval_files`` (by rank) and ``evaluate_model`` with the
reference's settings (PC sampler, N=30, snr 0.5, one corrector step; mean
PESQ / SI-SDR / ESTOI).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..data.wav import read_wav, resample
from .metrics import pesq_wb, si_sdr, stoi

EVAL_SNR = 0.5
EVAL_N = 30
EVAL_CORRECTOR_STEPS = 1


def target_sr_and_pad(backbone: str) -> Tuple[int, str]:
    """(target sample rate, spectrogram pad mode) of a backbone: the 48 kHz
    model runs at 48 kHz with reflection padding, ``ncsnpp_v2`` at 16 kHz with
    reflection padding, everything else at 16 kHz with zero padding."""
    if backbone == "ncsnpp_48k":
        return 48000, "reflection"
    if backbone == "ncsnpp_v2":
        return 16000, "reflection"
    return 16000, "zero_pad"


def select_eval_files(clean_files: Sequence[str], noisy_files: Sequence[str],
                      num_eval_files: int) -> Tuple[list, list]:
    """Uniform subsampling across the validation set (reference inference.py:21-25)."""
    indices = np.linspace(0, len(clean_files) - 1, num_eval_files).astype(int)
    return [clean_files[i] for i in indices], [noisy_files[i] for i in indices]


def shard_eval_files(files: list, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> list:
    """This rank's share of the eval files (by default this process's rank in
    the process group, ``parallel``); the last rank takes the remainder."""
    rank = parallel.rank() if process_index is None else process_index
    world = parallel.world() if process_count is None else process_count
    per = len(files) // world
    if rank == world - 1:
        return files[rank * per:]
    return files[rank * per:(rank + 1) * per]


def evaluate_model(model, clean_files: Sequence[str], noisy_files: Sequence[str],
                   num_eval_files: int, generator: Optional[torch.Generator] = None,
                   N: int = EVAL_N, snr: float = EVAL_SNR,
                   corrector_steps: int = EVAL_CORRECTOR_STEPS, sr: Optional[int] = None,
                   batch_size: int = 4, return_sums: bool = False) -> Dict[str, float]:
    """Enhance ``num_eval_files`` files with the model's current weights and
    return the mean pesq / si_sdr / estoi.

    Files are bucketed by padded spectrogram length and enhanced ``batch_size``
    at a time (``model.enhance``: the JAX package's ``enhance_eval``, which
    takes the weights as arguments of one compiled program, has nothing to do
    in eager PyTorch); metrics are computed per file on the host. A NaN score
    (e.g. PESQ of a silent clip) is left out of that metric's mean only. With
    ``return_sums`` the dict holds ``{metric: (sum, count)}`` instead.
    """
    sr = sr if sr is not None else model.sr
    clean_sel, noisy_sel = select_eval_files(clean_files, noisy_files, num_eval_files)
    hop = model.spec.hop_length
    buckets: Dict[int, list] = {}
    for clean_file, noisy_file in zip(clean_sel, noisy_sel):
        x, sr_x = read_wav(clean_file)
        y, sr_y = read_wav(noisy_file)
        assert sr_x == sr_y, "Sample rates of clean and noisy files do not match!"
        x, y = x[0], y[0]
        frames = 1 + len(y) // hop
        buckets.setdefault(-(-frames // 64) * 64, []).append((x, y, sr_x))

    sums = {"pesq": [0.0, 0], "si_sdr": [0.0, 0], "estoi": [0.0, 0]}

    def accumulate(name, value):
        value = float(value)
        if not np.isnan(value):  # +inf SI-SDR (exact reconstruction) is a real score
            sums[name][0] += value
            sums[name][1] += 1

    for padded in sorted(buckets):
        group = buckets[padded]
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            maxlen = max(len(y) for _, y, _ in chunk)
            yb = np.stack([np.pad(y, (0, maxlen - len(y))) for _, y, _ in chunk])
            x_hat_b = model.enhance(yb, generator=generator, N=N, snr=snr,
                                    corrector_steps=corrector_steps)
            for (x, y, sr_x), x_hat_padded in zip(chunk, x_hat_b):
                x_hat = np.asarray(x_hat_padded)[: len(y)]
                x_16k = resample(x, sr_x, 16000) if sr_x != 16000 else x
                x_hat_16k = resample(x_hat, sr, 16000) if sr != 16000 else x_hat
                accumulate("pesq", pesq_wb(16000, x_16k, x_hat_16k, "wb"))
                accumulate("si_sdr", si_sdr(x, x_hat))
                accumulate("estoi", stoi(x, x_hat, sr_x, extended=True))

    if return_sums:
        return {k: (s, c) for k, (s, c) in sums.items()}
    return {k: (s / c if c else float("nan")) for k, (s, c) in sums.items()}
