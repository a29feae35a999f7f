"""Inputs made from the seed, handed to the program and to the reference
alike: token rows, scoring windows and the dropout masks' stream.

Tokens are the character tokenizer's A, C, G, T (ids 7-10). Each row or
window draws its GC share uniformly from the mix's `gc_range`, then its
bases independently: A and T each (1 - gc) / 2, C and G each gc / 2. Every
seed gives rows of the same sizes; only the bases differ.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, List, Tuple

import numpy as np
import torch

A, C, G, T = 7, 8, 9, 10
SEP = 1  # the eos the hg38 eval appends to a window


def mix(*parts) -> int:
    """A 63-bit seed from any seed and stream names."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _bases(u: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    at = (1 - gc) / 2
    return torch.where(u < at, A, torch.where(u < 2 * at, T,
                       torch.where(u < 1 - gc / 2, C, G)))


def train_batch(seed: int, step: int, rows: int, length: int, gc_range, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step `step`'s (x, y): `rows` rows of `length` tokens drawn on the
    device, x the first length - 1, y the last length - 1 (int64)."""
    g = torch.Generator(device=device).manual_seed(mix(seed, "train", step))
    lo, hi = gc_range
    gc = lo + (hi - lo) * torch.rand(rows, 1, generator=g, device=device)
    ids = _bases(torch.rand(rows, length, generator=g, device=device), gc)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def score_pool(seed: int, count: int, window: int, gc_range) -> List[Tuple[np.ndarray, np.ndarray]]:
    """`count` windows (x, y) of (1, window) int64 host arrays, as the hg38
    eval's loader yields them: x the bases, y the bases shifted by one with
    the eos last."""
    rng = np.random.default_rng(mix(seed, "score"))
    out = []
    for _ in range(count):
        gc = rng.uniform(*gc_range)
        ids = _bases(torch.from_numpy(rng.random(window)), torch.tensor(gc)).numpy()
        ids = ids.astype(np.int64)
        out.append((ids[None], np.concatenate([ids[1:], [SEP]])[None].astype(np.int64)))
    return out


def dropout_seed(seed: int) -> int:
    return mix(seed, "dropout")


def dropout_masks(seed: int, shape, dtype: torch.dtype, p: float, device) -> Iterator[torch.Tensor]:
    """The keep masks a generator on `device` seeded with `dropout_seed(seed)`
    draws, one Bernoulli(1 - p) tensor of `shape` and `dtype` per draw: the
    stream the program's embedding dropout draws from the generator the
    benchmark hands it (one draw per micro-batch, contiguous, of the
    activation dtype)."""
    g = torch.Generator(device=device).manual_seed(dropout_seed(seed))
    while True:
        yield torch.empty(shape, dtype=dtype, device=device).bernoulli_(1.0 - p, generator=g)
