"""remat_repeat_x.train (x, checkpointing): kernel A's runs per micro-step and layer over the timed window, from the port's launch counter; 1 without recompute."""

from benchmark.harness import readers


def read(ctx):
    return readers.remat_repeat_x(ctx)
