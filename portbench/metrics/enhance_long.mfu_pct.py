"""enhance_long.mfu_pct (%): the 48 kHz network's convolution and matmul FLOPs
at each chunk's shape (``counts/network48k.py``) times its evaluations, over
the wall time of the untraced run of the traced stretch, against 989 TFLOP/s
(bfloat16, H100 SXM)."""
from portbench.counts import network48k, peaks


def read(ctx):
    w = ctx["untraced"]
    flops = sum(k * network48k.forward_flops(ctx["config"], r, f, t) for r, f, t, k in w["work"])
    if not flops or w["wall_s"] <= 0:
        return None
    return 100.0 * flops / w["wall_s"] / peaks.FLOPS["bfloat16"]
