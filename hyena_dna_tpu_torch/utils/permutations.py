"""Permutation index utilities of block-FFT / monarch decompositions (the
port's copy of `hyena_dna_tpu/utils/permutations.py`, numpy): bit reversal
(power of 2 and general n), transpose and snake orders."""

from __future__ import annotations

import math

import numpy as np


def bitreversal_po2(n: int) -> np.ndarray:
    """The bit-reversal permutation of a power of 2."""
    perm = np.arange(n).reshape(n, 1)
    for _ in range(int(math.log2(n))):
        n1 = perm.shape[0] // 2
        perm = np.hstack((perm[:n1], perm[n1:]))
    return perm.squeeze(0)


def bitreversal_permutation(n: int) -> np.ndarray:
    """Bit reversal for any n: the next power of 2's, entries below n kept."""
    perm = bitreversal_po2(1 << int(math.ceil(math.log2(n))))
    return np.extract(perm < n, perm)


def transpose_permutation(h: int, w: int) -> np.ndarray:
    """Row-major (h, w) indices in column-major order."""
    return np.arange(h * w).reshape(h, w).T.reshape(h * w)


def snake_permutation(h: int, w: int) -> np.ndarray:
    """Boustrophedon order: every other row reversed."""
    indices = np.arange(h * w).reshape(h, w)
    indices[1::2, :] = indices[1::2, ::-1]
    return indices.reshape(h * w)
