"""train.busy_ms_per_step (ms): the traced window's device busy time over
its train steps."""
from portbench import readers


def read(ctx):
    return readers.per(ctx, ctx["analysis"]["busy_s"], "steps", 1e3)
