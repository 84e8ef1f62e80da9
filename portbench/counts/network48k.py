"""Convolution and matmul FLOPs of one ``ncsnpp_48k`` forward, from shapes alone.

As :mod:`.network` counts the flagship's, over the plain 48 kHz network
(``reference/nets48k.py``): one forward on the ``meta`` device under
``torch.utils.flop_counter.FlopCounterMode``, 2 FLOPs per multiply-add of
every convolution (the FIR resampling's depthwise ones too) and every matrix
product (dense layers, the middle attention's projections and its two
products), per forward at the given input shape, cached per shape.
"""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import nets48k


@functools.lru_cache(maxsize=None)
def _forward_flops(config_json: str, batch: int, freq: int, frames: int) -> int:
    config = json.loads(config_json)
    with torch.device("meta"):
        net = nets48k.build(config)
        x = torch.empty(batch, 1, freq, frames, dtype=torch.complex64)
        t = torch.empty(batch)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x, x, t)
    return int(counter.get_total_flops())


def forward_flops(config: dict, batch: int, freq: int, frames: int) -> int:
    """FLOPs of one forward of the 48 kHz ``config``'s network on (batch, 1, freq, frames)."""
    return _forward_flops(json.dumps(config, sort_keys=True), batch, freq, frames)
