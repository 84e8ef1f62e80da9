"""enhance.device_idle_pct (%): 1 - busy / span over the traced window."""
from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
