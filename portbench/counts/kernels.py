"""Bytes, operations and bound of one call of a hand-written kernel.

A frozen copy of the arithmetic of the port's ``kernel_times.py`` at commit
d7fbb27 (``make_case``, ``make_k6_case``): each input read once, each output
written once; the operations of the function the kernel computes, in float32
on the CUDA cores (67 TFLOP/s) but K6's convolution, on the tensor cores at
the rate of its type. A call's bound is the larger of its bytes over 3.35
TB/s and its operations over their peak, in seconds.

A signature is what :mod:`portbench.trace` records at a dispatcher:

- ``upfirdn2d`` / ``upfirdn2d_adjoint``: (x shape, up, down, pad, taps, tensors, dtype);
- ``group_norm_act`` / ``group_norm_act_bwd``: (x shape, groups, eps, silu, pre_bias?, dtype);
- ``fir_conv``: ("up" | "down", x shape, w shape, taps, factor, gain, bias?, dtype).
"""
from __future__ import annotations

import math

from . import peaks

ESIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def _out_size(n, k, up, down, pad0, pad1):
    return (n * up + pad0 + pad1 - k) // down + 1


def upfirdn2d(sig):
    shape, up, down, pad, taps, tensors, dtype = sig
    k = int(round(math.sqrt(len(taps))))
    b, c, h, w = shape
    out = b * c * _out_size(h, k, up, down, *pad) * _out_size(w, k, up, down, *pad)
    esize = ESIZE[dtype]
    nbytes = tensors * (math.prod(shape) + out) * esize
    ops = tensors * out * (k * k // (up * up)) * 2
    return nbytes, ops, ops / peaks.F32_FLOPS


def group_norm_act(sig):
    shape, groups, _eps, silu, has_bias, dtype = sig
    b, c = shape[:2]
    n = math.prod(shape)
    esize = ESIZE[dtype]
    nbytes = 2 * n * esize + 2 * c * 4 + (b * c * esize if has_bias else 0)
    ops = n * (5 + int(has_bias) + (3 if silu else 0))
    return nbytes, ops, ops / peaks.F32_FLOPS


def group_norm_act_bwd(sig):
    shape, groups, _eps, silu, has_bias, dtype = sig
    b, c = shape[:2]
    n = math.prod(shape)
    esize = ESIZE[dtype]
    nbytes = 3 * n * esize + 4 * c * 4 + b * groups * 2 * 4 + (2 * b * c * esize
                                                              if has_bias else 0)
    ops = n * (13 + (16 if silu else 0) + (2 if has_bias else 0))
    return nbytes, ops, ops / peaks.F32_FLOPS


def fir_conv(sig, tf32: bool = True):
    kind, x_shape, w_shape, _taps, factor, _gain, has_bias, dtype = sig
    b, c_in, h, w = x_shape
    o = w_shape[0]
    up = kind == "up"
    y_shape = (b, o, h * factor, w * factor) if up else (b, o, h // factor, w // factor)
    if up:
        conv_ops = 2 * b * c_in * h * w * o * 9
        fir_ops = 2 * 8 * math.prod(y_shape)
    else:
        conv_ops = 2 * math.prod(y_shape) * c_in * 9
        fir_ops = 2 * 8 * b * c_in * (h + 1) * (w + 1)
    esize = ESIZE[dtype]
    nbytes = ((math.prod(x_shape) + math.prod(y_shape) + math.prod(w_shape)) * esize
              + (o * 4 if has_bias else 0))
    rate = (peaks.BF16_FLOPS if dtype == "bfloat16"
            else peaks.TF32_FLOPS if tf32 else peaks.F32_FLOPS)
    return nbytes, conv_ops + fir_ops, conv_ops / rate + fir_ops / peaks.F32_FLOPS


COUNTS = {"upfirdn2d": upfirdn2d, "upfirdn2d_adjoint": upfirdn2d,
          "group_norm_act": group_norm_act, "group_norm_act_bwd": group_norm_act_bwd,
          "fir_conv": fir_conv}


def bound_s(name: str, sig) -> float:
    """The least seconds one call of kernel ``name`` at ``sig`` can take."""
    nbytes, _ops, ops_s = COUNTS[name](sig)
    return max(nbytes / peaks.BYTES_PER_S, ops_s)
