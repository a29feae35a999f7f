"""Long FFT convolution: dispatch layer (mirrors `hyena_dna_tpu/ops/fftconv.py`).

Causal only: y = irfft(rfft(u, n) * rfft(k, n), n)[..., :L] + u * D with the
power-of-two size n = next_fast_fft_size(2L). FFTs run in float32 whatever
the input dtype; the result is cast back to u's dtype.

`fftconv` is the `torch.autograd.Function` `FFTConv`, with the
frequency-domain backward of the JAX `_fftconv_bwd`: du in dy's dtype, dk
(the batch reduced on the spectrum first) in k's, dD in float32. On a CUDA
tensor every conv, at every size from 16 to 2^21, goes to kernel B forward
and kernel C backward (`ops/fused_fftconv.py`); on the TPU sizes below 2^16
ran XLA's FFT, but on the card no library FFT sits on the path. Where the
JAX package saved u's spectrum for the backward (`saves_spectrum`), kernel B
saves it and kernel C reads it; elsewhere kernel C transforms u again. On a
CPU tensor the same calls run the kernels' plain versions.
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


def fftconv_bwd_ref(u: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                    D: torch.Tensor):
    """Plain backward (JAX `ops/fftconv.py::_fftconv_bwd`) on `torch.fft`:
    u, dy (B, C, L); k (C, Lk); D (C,). Returns du in dy's dtype, dk in k's,
    dD float32; the batch is reduced on the spectrum before dk's inverse."""
    return fftconv_bwd_from_rfft(
        torch.fft.rfft(u.float(), n=next_fast_fft_size(2 * u.shape[-1])), dy, k, D,
        dD=(dy.float() * u.float()).sum((0, 2)))


def fftconv_bwd_from_rfft(u_f: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                          D: torch.Tensor, dD: Optional[torch.Tensor] = None):
    """`fftconv_bwd_ref` given u's rfft (B, C, n//2+1) in place of u; without
    `dD`, dD is read off dk's lag 0 (Parseval), as the spectrum route does."""
    length = dy.shape[-1]
    n = next_fast_fft_size(2 * length)
    dy_f = torch.fft.rfft(dy.float(), n=n)
    k_f = torch.fft.rfft(k.float(), n=n)
    du = torch.fft.irfft(dy_f * k_f.conj(), n=n)[..., :length] + dy.float() * D.float()[:, None]
    dk_full = torch.fft.irfft((dy_f * u_f.conj()).sum(0), n=n)
    if dD is None:
        dD = dk_full[:, 0]  # lag 0: sum_{b,t} dy u
    return du.to(dy.dtype), dk_full[:, :k.shape[-1]].to(k.dtype), dD.float()


class FFTConv(torch.autograd.Function):
    """Kernel B forward, kernel C backward. Saves u's spectrum (spectrum
    route) or u itself (retransform route), with k and D."""

    @staticmethod
    def forward(ctx, u, k, D, save_spectrum):
        from hyena_dna_tpu_torch.ops import fused_fftconv as FB

        ctx.spectrum = save_spectrum
        if save_spectrum:
            y, spec = FB.fftconv_fused(u, k, D, save_spectrum=True)
            ctx.save_for_backward(spec, k, D)
        else:
            y = FB.fftconv_fused(u, k, D)
            ctx.save_for_backward(u, k, D)
        return y

    @staticmethod
    def backward(ctx, dy):
        from hyena_dna_tpu_torch.ops import fused_fftconv as FB

        saved, k, D = ctx.saved_tensors
        bwd = FB.fftconv_bwd_spectrum if ctx.spectrum else FB.fftconv_bwd_retransform
        du, dk, dD = bwd(saved, dy.contiguous(), k, D)
        return du, dk, dD, None


def fftconv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Causal conv with skip: (B, C, L) in, (B, C, L) out in u's dtype."""
    from hyena_dna_tpu_torch.ops.fused_fftconv import saves_spectrum

    training = torch.is_grad_enabled() and (u.requires_grad or k.requires_grad
                                            or D.requires_grad)
    return FFTConv.apply(u, k, D, training and saves_spectrum(*u.shape))


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
