"""train.k2b_roofline_pct (%): the frozen bounds of the window's K2b calls
(``group_norm_act_bwd``) over the traced time of the K2b kernels."""
from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, ("group_norm_act_bwd",), "K2b")
