"""The precision of the reference's products: float32, or a control below it.

Every convolution, dense layer and matmul of the reference calls
:func:`conv2d`, :func:`linear` or :func:`matmul` here with the precision its
module holds (``reference.nets.precision`` sets it for a whole network):

- ``"f32"``: float32 products (within :func:`strict_f32`, which turns TF32 off);
- ``"bf16"``: the operands rounded to bfloat16, the product in bfloat16, the
  result back in float32 (the control of a float32 configuration);
- ``"fp8"``: the operands rounded to float8 e4m3 with one scale per tensor
  (its largest magnitude mapped to 448, as an fp8 matmul recipe scales them),
  the product of the rounded values in float32 (the control of a bfloat16
  configuration).

Everything else (normalisation, elementwise arithmetic, the samplers, the
DSP) stays float32 in every mode.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "bf16", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


@contextlib.contextmanager
def strict_f32():
    """Within: float32 products stay float32 on the card, no TF32 in matmuls
    or cuDNN; the settings the process had are back after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor, as float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (t.float() * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    # The rounding passes the gradient straight through, as a quantised matmul's does.
    return t.float() + (q.float() / scale - t.float()).detach()


def _operands(mode, *ts):
    if mode == "bf16":
        return tuple(None if t is None else t.to(torch.bfloat16) for t in ts)
    if mode == "fp8":
        return tuple(None if t is None else fp8_round(t) for t in ts[:2]) + tuple(
            None if t is None else t.float() for t in ts[2:])
    return tuple(None if t is None else t.float() for t in ts)


def conv2d(mode, x, w, b=None, stride=1, padding=0):
    x, w, b = _operands(mode, x, w, b)
    return F.conv2d(x, w, b, stride, padding).float()


def linear(mode, x, w, b=None):
    x, w, b = _operands(mode, x, w, b)
    return F.linear(x, w, b).float()


def matmul(mode, a, b):
    a, b = _operands(mode, a, b)
    return torch.matmul(a, b).float()
