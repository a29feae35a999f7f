"""idle_pct.train (%, device): 1 - the union of the device's operation intervals over the traced steps' wall time."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
