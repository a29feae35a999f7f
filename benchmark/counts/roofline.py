"""The least time the card could take for one call of a port kernel.

Copied from `chip_smoke.py` (`bound`, `HBM_BYTES_PER_S`, `BF16_FLOPS` and
the byte and operation counts of `check_front`, `check_front_bwd`,
`check_conv` and `check_conv_bwd`), with two changes:

* one peak for operations, the bf16 dense tensor-core rate, whatever the
  dtype: a float32-accurate product may be built from bf16 products on this
  card, and nothing that computes the operation beats that peak, so a share
  of this bound never passes 100% whatever implements the kernel;
* each matrix product counts once (`chip_smoke.py` counts a float32
  product of kernels A and A' three times, as the bf16 split issues it).

Bytes: each input read once and each output written once, at its dtype.
Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12  # bf16 dense tensor-core rate


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)


def front_fwd(B: int, L: int, d: int, d_c: int, u_size: int):
    """Kernel A: u (B, L, d) -> vx, x0 (B, d_c, L) in u's dtype; W (d, 3 d_c),
    biases and the (3, 3 d_c) short conv in float32. (bytes, operations)."""
    nbytes = u_size * (B * L * d + 2 * B * d_c * L) + 4 * (d * 3 * d_c + 3 * 3 * d_c + 2 * 3 * d_c)
    flops = 2 * B * L * d * 3 * d_c + B * L * (3 * d_c * 7 + d_c)
    return nbytes, flops


def front_bwd(B: int, L: int, d: int, d_c: int, u_size: int):
    """Kernel A': u, dvx, dx0 in -> du, dW, the biases' and the short conv's
    gradients out; three products (the projection again, du, dW)."""
    nbytes = u_size * (2 * B * L * d + 2 * B * d_c * L) + 4 * (2 * d * 3 * d_c + 11 * 3 * d_c)
    flops = 3 * 2 * B * L * d * 3 * d_c + B * L * 3 * d_c * 16
    return nbytes, flops


def fft_size(L: int) -> int:
    return max(16, 1 << (2 * L - 1).bit_length())


def conv_fwd(B: int, C: int, L: int, size: int):
    """Kernel B: u (B, C, L), k (C, L), D (C,) -> y (B, C, L)."""
    n = fft_size(L)
    log_n = int(math.log2(n))
    nbytes = size * (2 * B * C * L + C * L) + 4 * C
    flops = B * C * (5 * n * log_n + 3 * n + 2 * L) + C * 2.5 * n * log_n
    return nbytes, flops


def conv_bwd(B: int, C: int, L: int, size: int, dk_size: int):
    """Kernel C on the retransform route: u, dy, k, D -> du, dk, dD."""
    n = fft_size(L)
    log_n = int(math.log2(n))
    nbytes = size * (3 * B * C * L + C * L) + dk_size * C * L + 8 * C
    flops = (3 * B * C + 2 * C) * 2.5 * n * log_n + B * C * 4 * n
    return nbytes, flops
