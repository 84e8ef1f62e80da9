"""The training loader's batches, checked against the corpus on disk.

The port's loader crops, pads and normalises the wav pairs that the
benchmark wrote; the reference's train steps start from the batches it
served, so this checks that stage by itself: every row of every checked
batch is a crop of one pair, the clean and the noisy at one offset, each
divided by the noisy crop's largest magnitude (the recipe's ``normalize
noisy``), and no pair serves two rows. A row is located by normalised
cross-correlation of its noisy crop with each noisy file (FFT on the
device), then compared sample by sample.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def locate(files: Sequence[np.ndarray], rows: np.ndarray, device) -> List[tuple]:
    """(file index, offset, peak correlation) of each row of ``rows`` (R, L)
    in ``files`` (noisy waveforms), by normalised cross-correlation."""
    n_rows, length = rows.shape
    size = 1 << int(np.ceil(np.log2(max(len(f) for f in files) + length)))
    r = torch.as_tensor(rows, dtype=torch.float64, device=device)
    r_hat = torch.fft.rfft(torch.flip(r, [-1]), n=size)
    r_norm = r.norm(dim=-1)
    best = [(-1, -1, -np.inf)] * n_rows
    for i, f in enumerate(files):
        if len(f) < length:
            continue
        x = torch.as_tensor(f, dtype=torch.float64, device=device)
        corr = torch.fft.irfft(torch.fft.rfft(x, n=size)[None] * r_hat, n=size)
        corr = corr[:, length - 1:len(f)]  # offsets 0 .. len(f) - length
        energy = torch.nn.functional.pad(torch.cumsum(x * x, 0), (1, 0))
        window = (energy[length:] - energy[:-length]).clamp_min(1e-30).sqrt()
        score = corr / (window[None] * r_norm[:, None])
        peak, where = score.max(dim=-1)
        for j in range(n_rows):
            if float(peak[j]) > best[j][2]:
                best[j] = (i, int(where[j]), float(peak[j]))
    return best


def check(clean: Sequence[np.ndarray], noisy: Sequence[np.ndarray], batches, device) -> float:
    """The largest gap, over the rows of ``batches`` ((x, y) pairs of (B, L)
    arrays), between a row and the normalised crop it was located at, over
    the crop's scale; inf where two rows come from one pair or a row is
    found nowhere."""
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    found = locate(noisy, ys, device)
    if len({i for i, _, _ in found}) < len(found):
        return float("inf")
    worst = 0.0
    for (i, s, _), x_row, y_row in zip(found, xs, ys):
        if i < 0:
            return float("inf")
        length = len(y_row)
        crop_y, crop_x = noisy[i][s:s + length], clean[i][s:s + length]
        scale = max(float(np.abs(crop_y).max()), 1e-10)
        gap = max(float(np.abs(crop_y / scale - y_row).max()),
                  float(np.abs(crop_x / scale - x_row).max()))
        worst = max(worst, gap)
    return worst
