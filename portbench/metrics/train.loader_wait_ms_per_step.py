"""train.loader_wait_ms_per_step (ms): the benchmark's own span around the
training loader's ``next()``, per step of the traced window."""
from portbench import readers


def read(ctx):
    return readers.per(ctx, ctx["window"]["loader_wait_s"], "steps", 1e3)
