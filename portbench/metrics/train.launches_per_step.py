"""train.launches_per_step (launches): the traced window's kernel launches
over its train steps."""
from portbench import readers


def read(ctx):
    return readers.per(ctx, ctx["analysis"]["launches"], "steps")
