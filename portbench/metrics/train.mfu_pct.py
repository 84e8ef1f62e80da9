"""train.mfu_pct (%): three times the forward's convolution and matmul
FLOPs per crop (``counts/network.py``; forward, and backward to inputs and
to weights), times the crops of the untraced run of the traced stretch, over
its wall time, against 495 TFLOP/s (TF32, H100 SXM: the step runs in float32
with TF32 on)."""
from portbench import readers


def read(ctx):
    return readers.mfu_pct(ctx, "tf32")
