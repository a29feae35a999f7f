"""DCT-II and DCT-III along the last axis (mirrors `hyena_dna_tpu/models/dxt.py`).

`dct` by a dense matrix, a 4N zero-interleaved rfft or a 2N reflected FFT
with a phase shift, "backward" or "ortho" normalisation (scipy's type 2);
`idct` the unnormalised DCT-III (scipy's type 3) or, with "ortho", the
exact inverse of the orthonormal DCT-II. Plain `torch.fft` and products.
"""

from __future__ import annotations

import math

import torch


def dct_matrix(n: int, norm: str = "backward", device=None) -> torch.Tensor:
    """Dense DCT-II matrix: X[k] = 2 sum_j x[j] cos(pi k (2j+1) / (2N))."""
    j = torch.arange(n, device=device, dtype=torch.float64)[None, :]
    k = torch.arange(n, device=device, dtype=torch.float64)[:, None]
    m = 2.0 * torch.cos(math.pi * k * (2 * j + 1) / (2 * n))
    if norm == "ortho":
        m = m * _ortho_scale(n, device, torch.float64)[:, None]
    return m.float()


def _ortho_scale(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    scale = torch.full((n,), math.sqrt(1.0 / (2 * n)), device=device, dtype=dtype)
    scale[0] = math.sqrt(1.0 / (4 * n))
    return scale


def dct(x: torch.Tensor, norm: str = "backward", mode: str = "2n") -> torch.Tensor:
    """DCT-II along the last axis, by `mode` "dense", "2n" or "4n"."""
    n = x.shape[-1]
    if mode == "dense":
        return torch.einsum("...j,kj->...k", x, dct_matrix(n, norm, x.device))
    if mode == "4n":
        z = x.new_zeros(*x.shape[:-1], 4 * n)
        z[..., 1:2 * n:2] = x
        z[..., 2 * n + 1::2] = x.flip(-1)
        out = torch.fft.rfft(z)[..., :n].real
    else:
        z = torch.cat([x, x.flip(-1)], dim=-1)
        k = torch.arange(n, device=x.device, dtype=torch.float32)
        phase = torch.exp(-1j * math.pi * k / (2 * n))
        out = (torch.fft.fft(z)[..., :n] * phase).real
    return out * _ortho_scale(n, x.device) if norm == "ortho" else out


def idct(x: torch.Tensor, norm: str = "backward") -> torch.Tensor:
    """DCT-III along the last axis: with "ortho" the inverse of the
    orthonormal DCT-II, else y[j] = x0 + 2 sum_{k>=1} x_k cos(pi k (2j+1) / (2N))."""
    n = x.shape[-1]
    if norm == "ortho":
        return torch.einsum("...k,kj->...j", x, dct_matrix(n, "ortho", x.device))
    y = torch.einsum("...k,kj->...j", x, dct_matrix(n, "backward", x.device))
    return y - x[..., :1]
