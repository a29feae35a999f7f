"""conv_roofline.train (%, kernels): the traced calls of kernels B and C, the sum of their bounds (counts/roofline.py) over their device time."""

from benchmark.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, ("kernel_b", "kernel_c"))
