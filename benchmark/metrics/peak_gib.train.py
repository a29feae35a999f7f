"""peak_gib.train (GiB, device): torch.cuda.max_memory_allocated over the timed window, after a reset at its start."""

from benchmark.harness import readers


def read(ctx):
    return readers.peak_gib(ctx)
