"""Long FFT convolution: dispatch layer (mirrors `hyena_dna_tpu/ops/fftconv.py`).

Causal only: y = irfft(rfft(u, n) * rfft(k, n), n)[..., :L] + u * D with the
power-of-two size n = next_fast_fft_size(2L). FFTs run in float32 whatever
the input dtype; the result is cast back to u's dtype.

On a CUDA tensor every conv, at every size from 16 to 2^21, goes to kernel B
(`ops/fused_fftconv.py`); on the TPU sizes below 2^16 ran XLA's FFT, but on
the card no library FFT sits on the main path. On a CPU tensor the same
calls run `fftconv_ref`, kernel B's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch


def next_fast_fft_size(n: int) -> int:
    """Round up to a power of two, at least 16 (JAX `next_fast_fft_size`)."""
    return max(16, 1 << (n - 1).bit_length())


def fftconv_ref(u: torch.Tensor, k: torch.Tensor,
                D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain causal FFT conv on `torch.fft`: u (..., C, L), k (C, Lk <= L),
    D (C,) or None. Returns u's shape and dtype."""
    seqlen = u.shape[-1]
    n = next_fast_fft_size(2 * seqlen)
    k_f = torch.fft.rfft(k.float(), n=n)
    u_f = torch.fft.rfft(u.float(), n=n)
    y = torch.fft.irfft(u_f * k_f, n=n)[..., :seqlen]
    if D is not None:
        y = y + u.float() * D.float()[..., None]
    return y.to(u.dtype)


def fftconv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Causal conv with skip: (B, C, L) in, (B, C, L) out in u's dtype."""
    from hyena_dna_tpu_torch.ops.fused_fftconv import fftconv_fused

    return fftconv_fused(u, k, D)


def fftconv_chunked(u: torch.Tensor, k: torch.Tensor,
                    D: torch.Tensor) -> torch.Tensor:
    """JAX `fftconv_chunked` scans channel blocks to bound XLA's FFT
    workspace; kernel B bounds its own, so on the port it is one call."""
    return fftconv(u, k, D)


def fftconv_gated(u: torch.Tensor, x0: torch.Tensor, k: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """(causal_conv(u, k) + u * D) * x0 on (B, C, L), the composite route of
    JAX `fftconv_gated` (its gate-fused Pallas kernels are default off)."""
    v = fftconv_chunked(u, k, D)
    return (v * x0).to(u.dtype)
