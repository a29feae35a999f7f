"""Block (monarch) FFT (mirrors `hyena_dna_tpu/models/block_fft.py`).

The H3 block FFT: reshape to (m, n), m-point DFT products, a twiddle
multiply, recurse on n, with base blocks of at most `max_m`. `BlockFFT`
makes the base DFT matrices of its plan at `N` parameters (`mat_<s>_re`,
`mat_<s>_im`, one pair per block size, started at the true DFT, or at
N(0, 0.01) offsets from it with `learn_additive`); with
`learn_dft_matrices=False` it is the exact FFT. The inverse is
conj(fft(conj(x))) / N. Plain complex64 torch products: no kernel sits
behind them, as no Pallas kernel sat behind the JAX module.
`LongConv(block_fft_conv=True)` uses it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn


def ref_dft_matrix(n: int, device=None) -> torch.Tensor:
    a = torch.arange(n, device=device, dtype=torch.float64)
    return torch.exp(-2j * math.pi * a[:, None] * a[None, :] / n).to(torch.complex64)


def compute_twiddle_factors(n: int, m: int, device=None) -> torch.Tensor:
    a = torch.arange(n, device=device, dtype=torch.float64)[:, None]
    b = torch.arange(m, device=device, dtype=torch.float64)[None, :]
    return torch.exp(-2j * math.pi * a * b / (n * m)).to(torch.complex64)


def _cooley_tukey(k: torch.Tensor, n: int, m: int, mats: List[torch.Tensor], max_m: int,
                  depth: int = 0) -> torch.Tensor:
    """k (..., m*n) complex; mats[depth] the base matrix at each depth."""
    shape = k.shape[:-1]
    k = k.reshape(*shape, m, n)
    k_f = torch.einsum("mo,...on->...mn", mats[depth], k)
    twi = compute_twiddle_factors(n, m, k.device)
    k_f = torch.einsum("nm,...mn->...nm", twi, k_f)
    if n <= max_m:
        k_f = torch.einsum("no,...om->...nm", mats[depth + 1], k_f)
    else:
        k_f = k_f.transpose(-1, -2).reshape(*shape, m, n)
        k_f = _cooley_tukey(k_f, n // max_m, max_m, mats, max_m, depth + 1)
        k_f = k_f.reshape(*shape, m, n).transpose(-1, -2)
    return k_f.reshape(*shape, n * m)


def _plan(size: int, max_m: int) -> List[int]:
    """The base DFT size at each recursion depth."""
    sizes = []
    while size > max_m:
        sizes.append(max_m)
        size //= max_m
    sizes.append(size)
    return sizes


def _pow2(n: int) -> int:
    return 1 << math.ceil(math.log2(n))


def block_fft(k: torch.Tensor, size: int, max_m: int = 16,
              mats: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The length-`size` FFT of k's last axis (zero-padded; `size` rounded
    up to a power of two) by block Cooley-Tukey."""
    size = _pow2(size)
    if k.shape[-1] != size:
        k = torch.nn.functional.pad(k, (0, size - k.shape[-1]))
    k = k.to(torch.complex64)
    sizes = _plan(size, max_m)
    if mats is None:
        mats = [ref_dft_matrix(s, k.device) for s in sizes]
    if len(sizes) == 1:
        return torch.einsum("no,...o->...n", mats[0], k)
    return _cooley_tukey(k, size // sizes[0], sizes[0], mats, max_m)


class BlockFFT(nn.Module):
    """The learnable block FFT of length N (by default `N`, else the call's).
    Its parameters are those of the plan at `N`, one pair per block size
    (shared across depths): a call whose plan needs another size raises, as
    the flax module's call does for a parameter its init did not make."""

    def __init__(self, N: int = 1024, max_m: int = 16, learn_dft_matrices: bool = True,
                 learn_additive: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.N = N
        self.max_m = max_m
        self.learn_dft_matrices = learn_dft_matrices
        self.learn_additive = learn_additive
        if not learn_dft_matrices:
            return
        for s in _plan(_pow2(N), max_m):
            if hasattr(self, f"mat_{s}_re"):
                continue
            if learn_additive:
                re = torch.randn(s, s, generator=generator) * 0.01
                im = torch.randn(s, s, generator=generator) * 0.01
            else:
                base = ref_dft_matrix(s)
                re, im = base.real.clone(), base.imag.clone()
            self.register_parameter(f"mat_{s}_re", nn.Parameter(re))
            self.register_parameter(f"mat_{s}_im", nn.Parameter(im))

    def _mats(self, sizes: List[int], device) -> List[torch.Tensor]:
        mats = []
        for s in sizes:
            base = ref_dft_matrix(s, device)
            if not self.learn_dft_matrices:
                mats.append(base)
                continue
            if not hasattr(self, f"mat_{s}_re"):
                raise ValueError(
                    f"BlockFFT(N={self.N}, max_m={self.max_m}) has no block of size {s}: "
                    f"its parameters are those of the plan {_plan(_pow2(self.N), self.max_m)}")
            mat = torch.complex(getattr(self, f"mat_{s}_re"), getattr(self, f"mat_{s}_im"))
            mats.append(base + mat if self.learn_additive else mat)
        return mats

    def forward(self, x: torch.Tensor, N: Optional[int] = None,
                forward: bool = True) -> torch.Tensor:
        n = _pow2(N or self.N)
        mats = self._mats(_plan(n, self.max_m), x.device)
        if forward:
            return block_fft(x, n, max_m=self.max_m, mats=mats)
        out = block_fft(torch.conj(x.to(torch.complex64)), n, max_m=self.max_m, mats=mats)
        return torch.conj(out) / n
