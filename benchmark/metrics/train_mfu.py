"""train_mfu (%, step / optimizer): the benchmark's model operations of a step (counts/flops.py) times the timed window's train_tokens_per_s, over the chips' bf16 dense peak."""

from benchmark.harness import readers


def read(ctx):
    return readers.train_mfu(ctx)
