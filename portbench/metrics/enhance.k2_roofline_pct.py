"""enhance.k2_roofline_pct (%): the frozen bounds of the window's K2 calls
(``group_norm_act``, ``counts/kernels.py``) over the traced time of the K2
kernels."""
from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, ("group_norm_act",), "K2")
