"""score_mfu (%, entry): the forward's model operations (counts/flops.py) times the timed window's score_tokens_per_s, over the card's bf16 dense peak."""

from benchmark.harness import readers


def read(ctx):
    return readers.score_mfu(ctx)
