"""enhance.k1_roofline_pct (%): the frozen bounds of the window's K1 calls
(``upfirdn2d``, ``counts/kernels.py``) over the traced time of the K1
kernels."""
from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, ("upfirdn2d",), "K1")
