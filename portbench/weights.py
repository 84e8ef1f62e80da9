"""Seeded weights, made on the card in one draw, handed alike to both sides.

The leaves are the plain reference network's (``reference/nets.py``), whose
names are the port's. One ``torch.randn`` of all their elements, from a
generator on the device seeded by the run's seed, is cut into leaves and
scaled so that every layer passes its signal on at about unit scale, which
the DDPM initialisation (zero-scaled last convolutions) would not:

- convolution and dense weights: N(0, 1 / fan_in);
- NIN projections (in, out): N(0, 1 / in);
- GroupNorm scales 1 + N(0, 0.01), shifts N(0, 0.01);
- biases N(0, 4e-4);
- the Fourier embedding's fixed frequencies N(0, 16^2), as the port draws them.

Float32, as the configurations keep their parameters.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import seeds


def leaf_scale(name: str, shape) -> tuple:
    """(scale, offset) of the standard normal draw of leaf ``name``."""
    last = name.rsplit(".", 1)[-1]
    if name.endswith("fourier.W"):
        return 16.0, 0.0
    if last in ("weight", "W") and len(shape) >= 2:
        fan_in = shape[0] if last == "W" else math.prod(shape[1:])
        return 1.0 / math.sqrt(fan_in), 0.0
    if last == "weight":  # 1-D: a GroupNorm scale
        return 0.1, 1.0
    if ".GroupNorm" in name or "pyramid_norm" in name:  # a GroupNorm shift
        return 0.1, 0.0
    return 0.02, 0.0


def make(net: torch.nn.Module, seed: int, device,
         state_input_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter of ``net``.
    ``state_input_scale`` scales the weights that read the sampler's state
    x_t (input channels 0 and 1 of ``conv_in`` and of each input-pyramid
    ``combine``), which sets how strongly the network's output depends on
    the state."""
    leaves = [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        scale, offset = leaf_scale(name, shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(offset)
        if name == "conv_in.Conv_0.weight" or name.endswith("_combine.Conv_0.Conv_0.weight"):
            out[name][:, :2] *= state_input_scale
        at += n
    return out
