"""Fused causal FFT conv: kernels B and C and their plain versions.

Kernel B (`csrc/fftconv.cu`) is the forward of the JAX package's conv
kernels (`ops/pallas_fftconv.py::fftconv_fused_fwd_packed` and
`fftconv_fused_fwd`, `ops/pallas_fftconv_n3.py::fftconv_outer_fwd`); kernel
C (`csrc/fftconv_bwd.cu`) their backward (`fftconv_fused_bwd_spec_packed`,
`fftconv_fused_bwd_spec`, `fftconv_fused_bwd_du` + `fftconv_fused_dk_from_specs`,
`fftconv_fused_bwd_packed`, `fftconv_fused_bwd`, `fftconv_outer_bwd`). One
kernel each covers every power-of-two FFT size from 16 to 2^21:

  y[b, c]  = irfft(rfft(u[b, c], n) * rfft(k[c], n), n)[:L] + u[b, c] * D[c]
  du[b, c] = irfft(DY[b, c] * conj(K[c]), n)[:L] + dy[b, c] * D[c]
  dk[c]    = irfft(sum_b DY[b, c] * conj(U[b, c]), n)[:Lk]
  dD[c]    = sum_{b, t} dy[b, c, t] u[b, c, t]

with n = next_fast_fft_size(2L). u, dy, k, y, du and dk share one dtype
(float32, or bfloat16 at the long lengths where the model keeps its conv
I/O in bf16); D and dD are float32; the transforms and products run in
float32. k may be shorter than u (zero-padded), as when a sequence
outgrows the filter's `l_max`.

The backward has two routes, as on the TPU:
  * spectrum: kernel B's forward also stores u's pair spectrum
    (`save_spectrum=True`) and kernel C transforms only dy
    (`fftconv_bwd_spectrum`);
  * retransform: kernel C transforms u again (`fftconv_bwd_retransform`).
`saves_spectrum` picks the route the way the JAX package does.

The saved spectrum is u's channel pairs z = u[2p] + i u[2p+1] (a zero
channel after an odd C) transformed at size n and stored in the four-step
order of the kernels: Z[f1 + N1 f2] at f1 * N2 + f2, as (B, ceil(C/2), n, 2)
float32. It is private to kernels B and C and their plain versions.

The 4-D entries `fftconv_outer_fwd4` and `fftconv_outer_bwd4` are the torch
entry points of the JAX `pallas_fftconv_n3.py` functions of the same names,
which the `HYENA_FRONT4` route calls: operands (B, C, h1 * r, m) and k
(C, h1 * r, m) for an outer plan (n1, r, m) with h1 = n1 / 2, returning y,
or (du4, dk4, dD), in the same layout. The 4-D array is the flat padded
(B, C, lp) array, lp = h1 * r * m = n / 2, so they run kernel B and kernel
C's retransform route on views of it; next_fast_fft_size(2 lp) is the
outer plan's n, the flat route's own size, so both routes run the same
transforms. `plan_outer` and `OUTER_BY_N` are the port's copy of the JAX
outer plan table (`pallas_fftconv_n3.py::plan_outer`, `_OUTER_BY_N`): the
fft sizes and batch parities the outer route covered, and its factors.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version on `torch.fft`.
"""

from __future__ import annotations

import ctypes

import torch

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.fftconv import (fftconv_bwd_from_rfft, fftconv_bwd_ref, fftconv_ref,
                                             next_fast_fft_size)

MAX_FFT_SIZE = 1 << 21
# Largest saved spectrum per conv call (B * ceil(C/2) * n complex64 bytes);
# above it the backward retransforms u. 1 GiB covers the training shapes
# that save (4 x 32768 x 256: 256 MiB; 2 x 131072 x 256: 512 MiB per layer).
SAVE_SPECTRUM_MAX_BYTES = 1 << 30
# FFT sizes whose backward reads the saved spectrum, mirroring the JAX
# routing: the packed (even B) kernels at 2^16-2^18 and the unpacked one at
# 2^16 saved it; below 2^16 nothing was saved (`SAVE_SPECTRA_MAX_BYTES = 0`)
# and the outer route (odd B at 2^17-2^18, any B from 2^19) recomputed u's
# transform in its backward.
_SPECTRUM_FFT_SIZES = (1 << 16, 1 << 17, 1 << 18)

KERNEL = _cuda.Kernel("fftconv", {
    "hyena_fftconv_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p],
})
KERNEL_BWD = _cuda.Kernel("fftconv_bwd", {
    "hyena_fftconv_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p],
})


def saves_spectrum(batch: int, channels: int, length: int) -> bool:
    """Whether the forward saves u's spectrum for the backward."""
    n = next_fast_fft_size(2 * length)
    if n not in _SPECTRUM_FFT_SIZES or (n > 1 << 16 and batch % 2):
        return False
    return batch * ((channels + 1) // 2) * n * 8 <= SAVE_SPECTRUM_MAX_BYTES


def _four_step(n: int):
    """(N1, N2) of the kernels' four-step split (`make_plan` in fft_common.cuh)."""
    log_n1 = min((n.bit_length() - 1) // 2, 9)
    return 1 << log_n1, n >> log_n1


def pair_spectrum_ref(u: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of kernel B's saved spectrum: (B, ceil(C/2), n, 2)."""
    b, c, _ = u.shape
    x = u.float()
    if c % 2:
        x = torch.cat([x, x.new_zeros(b, 1, x.shape[-1])], dim=1)
    z = torch.fft.fft(torch.complex(x[:, 0::2], x[:, 1::2]), n=n)
    n1, n2 = _four_step(n)
    spec = z.reshape(b, -1, n2, n1).transpose(-1, -2).reshape(b, -1, n)
    return torch.view_as_real(spec).contiguous()


def _channel_spectra(spec: torch.Tensor, channels: int, n: int) -> torch.Tensor:
    """Per-channel rfft (B, C, n//2+1) from a saved pair spectrum."""
    b, pairs = spec.shape[:2]
    n1, n2 = _four_step(n)
    z = torch.view_as_complex(spec.contiguous()).reshape(b, pairs, n1, n2)
    z = z.transpose(-1, -2).reshape(b, pairs, n)
    zm = z[..., (-torch.arange(n, device=z.device)) % n].conj()
    x = torch.stack([(z + zm) / 2, (z - zm) / 2j], dim=2).reshape(b, 2 * pairs, n)
    return x[:, :channels, :n // 2 + 1]


def fftconv_bwd_spectrum_ref(spec: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                             D: torch.Tensor):
    """Plain version of kernel C's spectrum route: (du, dk, dD) from u's
    saved pair spectrum on `torch.fft`, dD read off dk's lag 0 as the kernel
    does."""
    return fftconv_bwd_from_rfft(_channel_spectra(spec, dy.shape[1], spec.shape[2]), dy, k, D)


def check_args(kernels: str, signals, k, D, spec=None) -> None:
    """Raise unless the arguments fit the conv kernels: `signals` is a list
    of (name, (B, C, L) tensor or None), the first one given setting the
    shape, device and dtype (float32 or bfloat16) that the others and k
    (C, Lk <= L) share; D (C,) float32; u's saved pair spectrum, if given,
    (B, ceil(C/2), n, 2) float32; all contiguous."""
    ref_name, ref = next((nm, t) for nm, t in signals if t is not None)
    if ref.dim() != 3 or k.dim() != 2 or D.dim() != 1:
        raise ValueError(f"need (B, C, L) signals, k (C, Lk), D (C,); got "
                         f"{tuple(ref.shape)}, {tuple(k.shape)}, {tuple(D.shape)}")
    b, c, length = ref.shape
    if k.shape[0] != c or not 1 <= k.shape[1] <= length or D.shape[0] != c:
        raise ValueError(f"k {tuple(k.shape)} / D {tuple(D.shape)} do not fit {ref_name} "
                         f"{tuple(ref.shape)}")
    n = next_fast_fft_size(2 * length)
    if n > MAX_FFT_SIZE:
        raise ValueError(f"L={length} needs an FFT above 2^21")
    given = [(nm, t) for nm, t in signals if t is not None]
    if ref.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != ref.dtype for _, t in given + [("k", k)]):
        raise TypeError(f"{kernels} take {', '.join(nm for nm, _ in signals)} and k all "
                        "float32 or all bfloat16; got "
                        + ", ".join(f"{nm} {t.dtype}" for nm, t in given + [("k", k)]))
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    for name, t in given + [("k", k), ("D", D), ("spectrum", spec)]:
        if t is None:
            continue
        if t.dim() == 3 and tuple(t.shape) != (b, c, length):
            raise ValueError(f"{name} must be {(b, c, length)}, got {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref.device} expected")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if spec is not None and (spec.dtype != torch.float32
                             or tuple(spec.shape) != (b, (c + 1) // 2, n, 2)):
        raise ValueError(f"spectrum must be float32 {(b, (c + 1) // 2, n, 2)}, "
                         f"got {spec.dtype} {tuple(spec.shape)}")


def fftconv_fused(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor,
                  save_spectrum: bool = False):
    """Causal conv with skip on (B, C, L); returns y (B, C, L) in u's dtype,
    or (y, u's saved spectrum) with `save_spectrum`."""
    if not _cuda.on_card(u):
        y = fftconv_ref(u, k, D)
        if save_spectrum:
            return y, pair_spectrum_ref(u, next_fast_fft_size(2 * u.shape[-1]))
        return y
    check_args("kernels B and C", [("u", u)], k, D)
    b, c, length = u.shape
    n = next_fast_fft_size(2 * length)
    pairs = (c + 1) // 2
    y = torch.empty_like(u)
    # complex64 working space: u's transform per (batch, channel pair) and
    # k's per channel pair, as interleaved (re, im) float32
    scratch = torch.empty((b, pairs, n, 2), device=u.device, dtype=torch.float32)
    kspec = torch.empty((pairs, n, 2), device=u.device, dtype=torch.float32)
    spec = torch.empty_like(scratch) if save_spectrum else None
    KERNEL.launch("hyena_fftconv_fwd",
                  *map(_cuda.ptr, (u, k, D, y, scratch, kspec)), _cuda.ptr_or_null(spec),
                  b, c, length, k.shape[1], n, int(u.dtype == torch.bfloat16),
                  _cuda.stream_handle(u))
    return (y, spec) if save_spectrum else y


def _bwd_kernel(u, spec, dy, k, D):
    check_args("kernels B and C", [("u", u), ("dy", dy)], k, D, spec)
    b, c, length = dy.shape
    n = next_fast_fft_size(2 * length)
    pairs = (c + 1) // 2
    f32 = dict(device=dy.device, dtype=torch.float32)
    du, dk, dD = torch.empty_like(dy), torch.empty_like(k), torch.empty(c, **f32)
    sdy = torch.empty((b, pairs, n, 2), **f32)
    su = torch.empty_like(sdy) if spec is None else None
    kspec, sdk = torch.empty((pairs, n, 2), **f32), torch.empty((pairs, n, 2), **f32)
    KERNEL_BWD.launch("hyena_fftconv_bwd",
                      _cuda.ptr_or_null(u), _cuda.ptr_or_null(spec),
                      *map(_cuda.ptr, (dy, k, D, du, dk, dD, sdy)), _cuda.ptr_or_null(su),
                      *map(_cuda.ptr, (kspec, sdk)),
                      b, c, length, k.shape[1], n, int(dy.dtype == torch.bfloat16),
                      _cuda.stream_handle(dy))
    return du, dk, dD


def fftconv_bwd_retransform(u: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                            D: torch.Tensor):
    """(du, dk, dD) from u itself: kernel C's retransform route on a CUDA
    tensor, `fftconv_bwd_ref` on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_bwd_ref(u, dy, k, D)
    return _bwd_kernel(u, None, dy, k, D)


def fftconv_bwd_spectrum(spec: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                         D: torch.Tensor):
    """(du, dk, dD) from u's saved spectrum: kernel C's spectrum route on a
    CUDA tensor, `fftconv_bwd_spectrum_ref` on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_bwd_spectrum_ref(spec, dy, k, D)
    return _bwd_kernel(None, spec, dy, k, D)


def _tpu_entry(name: str, spectrum: bool, fft_sizes, even_batch):
    """The torch entry point of one backward Pallas entry of the JAX package:
    the route of kernel C it took on the TPU, at the FFT sizes and batch
    parity that the JAX routing gave it (None: either parity)."""
    route = fftconv_bwd_spectrum if spectrum else fftconv_bwd_retransform

    def entry(x, dy, k, D):
        n, b = next_fast_fft_size(2 * dy.shape[-1]), dy.shape[0]
        if n not in fft_sizes or (even_batch is not None and (b % 2 == 0) != even_batch):
            parity = {True: " with even B", False: " with odd B", None: ""}[even_batch]
            raise ValueError(f"{name}: the TPU route took fft sizes {sorted(fft_sizes)}"
                             f"{parity}; got fft {n}, B={b}")
        return route(x, dy, k, D)

    entry.__name__ = entry.__qualname__ = name
    entry.spectrum = spectrum
    entry.__doc__ = (f"(du, dk, dD) from {'u spectrum' if spectrum else 'u'}, dy, k, D: "
                     f"the JAX `{name}` route, on kernel C.")
    return entry


# fft size n -> outer plan (n1, r, m) with n1 * r * m = n (the JAX
# `pallas_fftconv_n3._OUTER_BY_N`); below 2^19 the outer route took odd B
# only (`_OUTER_NEEDS_ODD_BATCH_BELOW`). The tests patch this table.
OUTER_BY_N = {
    1 << 17: (4, 256, 128),
    1 << 18: (16, 128, 128),
    1 << 19: (16, 128, 256),
    1 << 20: (16, 256, 256),
    1 << 21: (16, 512, 256),
}
OUTER_NEEDS_ODD_BATCH_BELOW = 1 << 19
_OUTER_SIZES = tuple(OUTER_BY_N)
# pallas_fftconv.py:1344 / :519 / :687 + :775 (saved spectrum), :1222 / :398 (u)
fftconv_fused_bwd_spec_packed = _tpu_entry("fftconv_fused_bwd_spec_packed", True,
                                           (1 << 16, 1 << 17), True)
fftconv_fused_bwd_spec = _tpu_entry("fftconv_fused_bwd_spec", True, (1 << 16,), False)
fftconv_fused_bwd_split = _tpu_entry("fftconv_fused_bwd_split", True, (1 << 18,), True)
fftconv_fused_bwd_packed = _tpu_entry("fftconv_fused_bwd_packed", False,
                                      (1 << 16, 1 << 17), True)
fftconv_fused_bwd = _tpu_entry("fftconv_fused_bwd", False, (1 << 16,), False)
# pallas_fftconv_n3.py:629: odd B below 2^19, any B from 2^19
fftconv_outer_bwd = _tpu_entry("fftconv_outer_bwd", False, _OUTER_SIZES, None)


def plan_outer(n: int, channels: int, length: int, batch: int):
    """(n1, r, m) if the outer route covers a conv of `length` at fft size
    n and batch `batch`, else None (JAX `plan_outer`; `channels` is unused
    there too)."""
    spec = OUTER_BY_N.get(n)
    if spec is None or (n < OUTER_NEEDS_ODD_BATCH_BELOW and batch % 2 == 0):
        return None
    n1, r, m = spec
    return None if length > (n1 // 2) * r * m else spec


def _outer_rows(n1: int, r: int, m: int, *tensors) -> int:
    """lp = (n1 / 2) r m, after checking each (.., C, h1 r, m) operand."""
    rows = (n1 // 2) * r
    for t in tensors:
        if t.dim() < 3 or tuple(t.shape[-2:]) != (rows, m):
            raise ValueError(f"4-D operands must end in ({rows}, {m}) for the plan "
                             f"{(n1, r, m)}; got {tuple(t.shape)}")
    return rows * m


def fftconv_outer_fwd4(u4: torch.Tensor, k4: torch.Tensor, D: torch.Tensor,
                       n1: int, r: int, m: int) -> torch.Tensor:
    """y4 (B, C, h1 r, m) = the causal conv with skip of the flat padded
    (B, C, lp) u against k (C, lp): kernel B on a CUDA tensor, its plain
    version on a CPU one (JAX `fftconv_outer_fwd4`)."""
    lp = _outer_rows(n1, r, m, u4, k4)
    b, c = u4.shape[:2]
    return fftconv_fused(u4.reshape(b, c, lp), k4.reshape(c, lp), D).reshape(u4.shape)


def fftconv_outer_bwd4(u4: torch.Tensor, dy4: torch.Tensor, k4: torch.Tensor,
                       D: torch.Tensor, n1: int, r: int, m: int):
    """(du4, dk4, dD) of `fftconv_outer_fwd4`, du4 and dk4 in the 4-D
    layout and dD (C,): kernel C's retransform route on a CUDA tensor, its
    plain version on a CPU one (JAX `fftconv_outer_bwd4`)."""
    lp = _outer_rows(n1, r, m, u4, dy4, k4)
    b, c = u4.shape[:2]
    du, dk, dD = fftconv_bwd_retransform(u4.reshape(b, c, lp), dy4.reshape(b, c, lp),
                                         k4.reshape(c, lp), D)
    return du.reshape(u4.shape), dk.reshape(k4.shape), dD
