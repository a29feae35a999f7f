"""Model operations of the Hyena LM, the numerator of the MFU metrics.

Convention (stated in PERF.md):
* every matrix product counts 2 m n k: in_proj, out_proj, the MLP's two,
  the tied LM head, and the implicit filter's MLP once per layer and step
  (its bank does not depend on the batch);
* the depthwise short conv counts 2 per tap, the gates (v x1, y x0) and
  the D skip (a multiply and an add) as written;
* each long conv counts per channel as three real transforms of N points
  (N the FFT size, at least 2L) at 2.5 N log2 N each, plus the pointwise
  complex product at 3 N (N/2 + 1 products of 6 operations);
* the backward counts twice the forward; recompute is not counted.
LN, GeLU, the softmax, the embedding lookup and the optimizer are not
counted.
"""

from __future__ import annotations

import math


def fft_size(L: int) -> int:
    return max(16, 1 << (2 * L - 1).bit_length())


def forward_per_token(cfg: dict, L: int) -> float:
    """Forward operations per token of a row of L tokens (the filter
    excluded)."""
    d, di = cfg["d_model"], cfg["d_inner"]
    k = cfg["layer"].get("short_filter_order", 3)
    vocab = cfg["vocab_size"] + (-cfg["vocab_size"]) % cfg.get("pad_vocab_size_multiple", 1)
    n = fft_size(L)
    conv = d * (3 * 2.5 * n * math.log2(n) + 3 * n) / L
    layer = (2 * d * 3 * d + 2 * 3 * d * k + 2 * d + 2 * d + conv + 2 * d * d
             + 2 * 2 * d * di)
    return cfg["n_layer"] * layer + 2 * d * vocab


def filter_forward(cfg: dict, L: int) -> float:
    """Forward operations of the implicit filters of every layer at length L."""
    lay = cfg["layer"]
    e, o, d = lay["emb_dim"], lay["filter_order"], cfg["d_model"]
    return cfg["n_layer"] * 2 * L * (e * o + 2 * o * o + o * d)


def train_step_flops(cfg: dict, rows: int, L: int) -> float:
    """Forward and backward of one optimizer step over `rows` rows of L."""
    return 3 * (rows * L * forward_per_token(cfg, L) + filter_forward(cfg, L))


def forward_flops(cfg: dict, rows: int, L: int) -> float:
    """One forward over `rows` rows of L (a scored window)."""
    return rows * L * forward_per_token(cfg, L) + filter_forward(cfg, L)
