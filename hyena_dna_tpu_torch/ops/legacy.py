"""Legacy S4-support ops in plain PyTorch (the port's copy of
`hyena_dna_tpu/ops/legacy.py`): Toeplitz / causal-convolution views,
Krylov construction, binary powers and Vandermonde contractions.

HyenaDNA does not call them at run time; they complete the ops inventory
of the S4 family (the reference's `src/ops/toeplitz.py`, `krylov.py` and
`vandermonde.py`, the last without its pykeops path). None of them has a
kernel of its own: each is a few tensor ops on any device, and the FFT
views run `torch.fft` (cuFFT on the card).
"""

from __future__ import annotations

from typing import Optional

import torch


# ---- toeplitz ------------------------------------------------------------------

def construct_toeplitz(v: torch.Tensor, f: float = 0.0) -> torch.Tensor:
    """Krylov matrix [v, Av, A^2 v, ...] of the f-circulant shift A = Z_f.
    v (..., n) -> (..., n, n)."""
    n = v.shape[-1]
    a = torch.arange(n, device=v.device)
    indices = a[:, None] - a[None, :]
    K = v[..., indices % n]
    return torch.where(indices < 0, f * K, K)


def triangular_toeplitz_multiply(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The product of two lower-triangular Toeplitz matrices: the causal
    convolution of u and v over the last axis, by a 2n-point FFT."""
    n = u.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(u, n=2 * n) * torch.fft.rfft(v, n=2 * n),
                           n=2 * n)[..., :n]


def triangular_toeplitz_multiply_padded(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same on inputs already zero-padded to n = 2 * length; the upper
    half of the result is zero."""
    n = u.shape[-1]
    if n % 2:
        raise ValueError(f"the padded inputs need an even length, got {n}")
    out = torch.fft.irfft(torch.fft.rfft(u, n=n) * torch.fft.rfft(v, n=n), n=n)
    out[..., n // 2:] = 0.0
    return out


def causal_convolution(u: torch.Tensor, v: torch.Tensor, fast: bool = True,
                       pad: bool = False) -> torch.Tensor:
    """Causal convolution: by explicit Toeplitz matrices (`fast=False`, the
    oracle), on padded inputs (`pad`), or by the FFT."""
    if not pad and not fast:
        return torch.einsum("...ij,...j->...i", construct_toeplitz(u), v)
    if pad:
        return triangular_toeplitz_multiply_padded(u, v)
    return triangular_toeplitz_multiply(u, v)


# ---- krylov --------------------------------------------------------------------

def krylov_sequential(L: int, A: torch.Tensor, b: torch.Tensor,
                      c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[b, Ab, A^2 b, ...] by L sequential products. A (..., N, N), b
    (..., N) -> (..., N, L), or (..., L) contracted with c."""
    x, ys = b, []
    for _ in range(L):
        ys.append((c * x).sum(-1) if c is not None else x)
        x = torch.einsum("...ij,...j->...i", A, x)
    return torch.stack(ys, dim=-1)


def krylov(L: int, A: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
           return_power: bool = False):
    """The Krylov matrix by the squaring trick: O(log L) products of
    doubling width; with `return_power` also the last power of A formed."""
    x, A_ = b[..., None], A
    while x.shape[-1] < L:
        x = torch.cat([x, A_ @ x], dim=-1)
        A_ = A_ @ A_
    x = x[..., :L]
    if c is not None:
        x = torch.einsum("...n,...nl->...l", c, x)
    return (x, A_) if return_power else x


def power(L: int, A: torch.Tensor, v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A^L by binary exponentiation, or A^L v."""
    result = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    powers, l = A, L
    while l > 0:
        if l % 2 == 1:
            result = powers @ result
        l //= 2
        if l > 0:
            powers = powers @ powers
    if v is None:
        return result
    return torch.einsum("...ij,...j->...i", result, v)


# ---- vandermonde ---------------------------------------------------------------

def vandermonde_naive(v: torch.Tensor, x: torch.Tensor, L: int,
                      conj: bool = True) -> torch.Tensor:
    """sum_n v_n x_n^l for l < L. v, x (..., N) complex -> (..., L) (2 Re
    with `conj`)."""
    vand = x[..., None] ** torch.arange(L, device=x.device)
    out = torch.einsum("...n,...nl->...l", v, vand)
    return 2 * out.real if conj else out


def log_vandermonde(v: torch.Tensor, x: torch.Tensor, L: int,
                    conj: bool = True) -> torch.Tensor:
    """sum_n v_n exp(x_n l), the numerically preferred form."""
    vand = torch.exp(x[..., None] * torch.arange(L, device=x.device))
    out = torch.einsum("...n,...nl->...l", v, vand)
    return 2 * out.real if conj else out


def log_vandermonde_transpose(u: torch.Tensor, v: torch.Tensor, x: torch.Tensor,
                              L: int) -> torch.Tensor:
    """sum_l u_l v_n exp(x_n l)."""
    vand = torch.exp(x[..., None] * torch.arange(L, device=x.device))
    return torch.einsum("...l,...n,...nl->...n", u.to(vand.dtype), v, vand)
