"""Fused causal FFT conv: kernel B (`csrc/fftconv.cu`) and its plain version.

Counterpart of the forward conv kernels of the JAX package:
`ops/pallas_fftconv.py::fftconv_fused_fwd_packed` and `fftconv_fused_fwd`
and `ops/pallas_fftconv_n3.py::fftconv_outer_fwd` (forward only; the
backward kernels come with the training slice). One kernel covers them all
and every power-of-two FFT size from 16 to 2^21:

  y[b, c] = irfft(rfft(u[b, c], n) * rfft(k[c], n), n)[:L] + u[b, c] * D[c]

with n = next_fast_fft_size(2L). u, k and y share one dtype (float32, or
bfloat16 at the long lengths where the model keeps its conv I/O in bf16);
D is float32; the transforms and products run in float32. k may be shorter
than u (zero-padded), as when a sequence outgrows the filter's `l_max`.

On a CUDA tensor the wrapper launches kernel B or raises; on a CPU tensor
it runs `fftconv_ref` on `torch.fft`.
"""

from __future__ import annotations

import ctypes

import torch

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size

MAX_FFT_SIZE = 1 << 21

KERNEL = _cuda.Kernel("fftconv", {
    "hyena_fftconv_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p],
})


def _check(u, k, D):
    if u.dim() != 3 or k.dim() != 2 or D.dim() != 1:
        raise ValueError(f"need u (B, C, L), k (C, Lk), D (C,); got "
                         f"{tuple(u.shape)}, {tuple(k.shape)}, {tuple(D.shape)}")
    b, c, length = u.shape
    if k.shape[0] != c or not 1 <= k.shape[1] <= length or D.shape[0] != c:
        raise ValueError(f"k {tuple(k.shape)} / D {tuple(D.shape)} do not fit "
                         f"u {tuple(u.shape)}")
    if u.dtype not in (torch.float32, torch.bfloat16) or k.dtype != u.dtype:
        raise TypeError(f"kernel B takes u and k both float32 or both bfloat16; "
                        f"got {u.dtype}, {k.dtype}")
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    for name, t in (("u", u), ("k", k), ("D", D)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if next_fast_fft_size(2 * length) > MAX_FFT_SIZE:
        raise ValueError(f"L={length} needs an FFT above 2^21")


def fftconv_fused(u: torch.Tensor, k: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """Causal conv with skip on (B, C, L); returns (B, C, L) in u's dtype."""
    if u.device.type == "cpu":
        return fftconv_ref(u, k, D)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    _check(u, k, D)
    b, c, length = u.shape
    n = next_fast_fft_size(2 * length)
    pairs = (c + 1) // 2
    y = torch.empty_like(u)
    # complex64 working space: u's transform per (batch, channel pair) and
    # k's per channel pair, as interleaved (re, im) float32
    scratch = torch.empty((b, pairs, n, 2), device=u.device, dtype=torch.float32)
    kspec = torch.empty((pairs, n, 2), device=u.device, dtype=torch.float32)
    KERNEL.launch("hyena_fftconv_fwd", *map(_cuda.ptr, (u, k, D, y, scratch, kspec)),
                  b, c, length, k.shape[1], n, int(u.dtype == torch.bfloat16),
                  _cuda.stream_handle(u))
    return y
