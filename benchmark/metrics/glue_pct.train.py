"""glue_pct.train (%, model glue): device time in kernels that are neither the port's own nor matrix products, over the traced steps' busy time."""

from benchmark.harness import readers


def read(ctx):
    return readers.glue_pct(ctx)
