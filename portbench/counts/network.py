"""Convolution and matmul FLOPs of one network forward, from shapes alone.

The plain reference network (``reference/nets.py``) of a configuration runs
once on the ``meta`` device, where tensors have shapes and no data, under
``torch.utils.flop_counter.FlopCounterMode``, which counts 2 FLOPs per
multiply-add of every convolution (the FIR resampling's depthwise ones too)
and every matrix product (dense layers, the 1x1 projections, attention's
two products). The count is per forward at the given input shape; the
meta run takes well under a second and is cached per shape.
"""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import nets


@functools.lru_cache(maxsize=None)
def _forward_flops(config_json: str, batch: int, freq: int, frames: int) -> int:
    config = json.loads(config_json)
    with torch.device("meta"):
        net = nets.build(config)
        x = torch.empty(batch, 1, freq, frames, dtype=torch.complex64)
        t = torch.empty(batch)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x, x, t)
    return int(counter.get_total_flops())


def forward_flops(config: dict, batch: int, freq: int, frames: int) -> int:
    """FLOPs of one forward of ``config``'s network on (batch, 1, freq, frames)."""
    return _forward_flops(json.dumps(config, sort_keys=True), batch, freq, frames)
