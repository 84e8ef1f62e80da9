"""enhance.busy_ms_per_nfe (ms): the traced window's device busy time
(kernel intervals merged) over its network evaluations."""
from portbench import readers


def read(ctx):
    return readers.per(ctx, ctx["analysis"]["busy_s"], "nfe", 1e3)
