"""enhance.launches_per_nfe (launches): the traced window's kernel launches
over its network evaluations."""
from portbench import readers


def read(ctx):
    return readers.per(ctx, ctx["analysis"]["launches"], "nfe")
