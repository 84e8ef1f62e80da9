"""Plain chunked enhancement of one long recording, float32.

A frozen copy of the arithmetic of the port's ``ScoreModel.enhance_long``
(``model.py``): chunks of ``chunk_seconds`` at the configuration's ``sr``,
``hop = int(chunk * (1 - overlap))`` samples apart, the recording zero-padded
to ``(n - 1) * hop + chunk`` samples; each chunk through the frozen pipeline
of :mod:`.enhance` (its own max-abs normalisation, STFT and compression,
frame padding, sampler, inverse); a linear crossfade over the ``chunk - hop``
samples two chunks share (none at the start of the first chunk, none at the
end of the last), the chunks overlap-added and divided by their summed
weights.

The noise is given per chunk, as the benchmark hands it to the program:
``noises[i]`` is chunk i's (prior, corrector) pair in :mod:`.enhance`'s
shapes. Only the first ``len(noises)`` chunks are computed; the result is
then the samples those chunks alone determine, ``[0, len(noises) * hop)``
(all of the recording where they are all its chunks).

Departures from the port: ``ncsnpp_48k`` has ``ncsnpp``'s contract
(score = -dnn), so :mod:`.enhance` is handed the configuration with the
flagship's backbone name, which selects that contract and nothing else.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import enhance as ref_enhance


def grid(length: int, sr: int, chunk_seconds: float, overlap: float):
    """(chunk, hop, number of chunks) of a recording of ``length`` samples;
    one chunk of ``length`` where it fits in one."""
    chunk = int(chunk_seconds * sr)
    hop = int(chunk * (1.0 - overlap))
    if length <= chunk:
        return length, hop, 1
    return chunk, hop, 1 + math.ceil((length - chunk) / hop)


def weights(chunk: int, hop: int, i: int, n: int) -> np.ndarray:
    """Chunk i's crossfade weights (float32) of ``n`` chunks."""
    ramp = chunk - hop
    w = np.ones(chunk, dtype=np.float32)
    if ramp > 0:
        w[:ramp] = np.linspace(0.0, 1.0, ramp, endpoint=False)
        w[-ramp:] = np.linspace(1.0, 0.0, ramp, endpoint=False)
        if i == 0:
            w[:ramp] = 1.0
        if i == n - 1:
            w[-ramp:] = 1.0
    return w


@torch.no_grad()
def enhance_long(config: dict, net, sde, y_wav: torch.Tensor, noises, chunk_seconds: float,
                 overlap: float, fault=None) -> torch.Tensor:
    """The enhanced leading samples of the recording ``y_wav`` (L,) that the
    first ``len(noises)`` chunks determine, float32 (``fault``: one of
    :data:`.enhance.FAULTS`, planted in every chunk)."""
    legacy = dict(config, backbone="ncsnpp")
    length = y_wav.shape[-1]
    chunk, hop, n = grid(length, config["sr"], chunk_seconds, overlap)
    if n == 1:
        (prior, corr), = noises
        return ref_enhance.enhance(legacy, net, sde, y_wav[None], prior, corr, fault=fault)[0]
    k = min(len(noises), n)
    total = (n - 1) * hop + chunk
    y_pad = torch.nn.functional.pad(y_wav.float(), (0, total - length))
    out = torch.zeros(total, dtype=torch.float32, device=y_wav.device)
    weight = torch.zeros_like(out)
    for i in range(k):
        prior, corr = noises[i]
        x_hat = ref_enhance.enhance(legacy, net, sde, y_pad[None, i * hop: i * hop + chunk],
                                    prior, corr, fault=fault)[0]
        w = torch.as_tensor(weights(chunk, hop, i, n), device=y_wav.device)
        out[i * hop: i * hop + chunk] += x_hat * w
        weight[i * hop: i * hop + chunk] += w
    keep = length if k == n else k * hop  # the samples those chunks alone determine
    return (out / weight.clamp_min(1e-8))[:keep]
