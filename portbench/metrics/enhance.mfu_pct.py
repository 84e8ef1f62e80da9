"""enhance.mfu_pct (%): the network's convolution and matmul FLOPs at each
batch's shape (``counts/network.py``) times its evaluations, over the wall
time of the untraced run of the traced stretch, against 989 TFLOP/s
(bfloat16, H100 SXM)."""
from portbench import readers


def read(ctx):
    return readers.mfu_pct(ctx, "bfloat16")
