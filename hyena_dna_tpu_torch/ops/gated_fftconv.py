"""Gate-fused causal FFT conv: kernels E and E' and their plain versions.

The Hyena post-gate folded into the long conv, as the reference's CUDA
kernel (`csrc/fftconv/fftconv_cuda.cu`) and the JAX package's gated Pallas
kernels (`ops/pallas_fftconv.py`) fold it:

  v[b, c]   = irfft(rfft(u[b, c], n) * rfft(k[c], n), n)[:L] + u[b, c] * D[c]
  y[b, c]   = v[b, c] * x0[b, c]

and, for the cotangent dy, with dv = dy * x0 in float32:

  dx0[b, c] = dy[b, c] * v[b, c]
  du[b, c]  = irfft(DV[b, c] * conj(K[c]), n)[:L] + dv[b, c] * D[c]
  dk[c]     = irfft(sum_b DV[b, c] * conj(U[b, c]), n)[:Lk]
  dD[c]     = sum_{b, t} dv[b, c, t] u[b, c, t]   (dk's lag 0)

Kernel E (`csrc/fftconv_gated.cu`) is the forward, writing y rounded once
from the float32 v and, on request, the ungated v and u's pair spectrum
(kernel B's layout, `fused_fftconv.pair_spectrum_ref`). Kernel E'
(`csrc/fftconv_gated_bwd.cu`, on kernel C's row pass) is the backward,
with the three routes of the JAX modes:

  specv        from u's saved spectrum and the saved v; dx0 = dy * v;
  spec         from u's saved spectrum; v = inv(U * (K + D)) recomputed;
  retransform  from u; U and v = inv(U * (K + D)) recomputed.

Both kernels carry the skip term in the spectrum, as the TPU kernels' ks
trick does: K + D, so that inv(U * (K + D)) is the whole v and
inv(DV * conj(K + D)) the whole du. The plain versions keep each JAX
route's own form (the skip term in time but on the spec route).

u, x0, k, y, v, dy, du, dx0 and dk share one dtype (float32, or bfloat16 at
the lengths where the model keeps its conv I/O in bf16); D and dD are
float32; the transforms and products run in float32. k may be shorter than
u. On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version on `torch.fft`.

The four `fftconv_fused_*_gated` functions at the bottom are the torch
entry points of the four Pallas entries, with the shapes their TPU routes
took (fft 2^16-2^17, even B, C % 8 == 0).
"""

from __future__ import annotations

import ctypes

import torch

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size
from hyena_dna_tpu_torch.ops.fused_fftconv import (_channel_spectra, check_args,
                                                   pair_spectrum_ref)

ROUTES = ("specv", "spec", "retransform")

KERNEL = _cuda.Kernel("fftconv_gated", {
    "hyena_fftconv_gated_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p],
})
KERNEL_BWD = _cuda.Kernel("fftconv_gated_bwd", {
    "hyena_fftconv_gated_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                               + [ctypes.c_void_p],
    "hyena_fftconv_gated_bwd_ws_slabs": [ctypes.c_int] * 3,
})


# plain versions

def _rfft(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.rfft(x.float(), n=n)


def fftconv_gated_ref(u: torch.Tensor, x0: torch.Tensor, k: torch.Tensor, D: torch.Tensor,
                      save_v: bool = False, save_spectrum: bool = False):
    """Plain version of kernel E: y, then v with `save_v`, then u's pair
    spectrum with `save_spectrum`; y rounded once from the float32 v."""
    length = u.shape[-1]
    n = next_fast_fft_size(2 * length)
    v = torch.fft.irfft(_rfft(u, n) * _rfft(k, n), n=n)[..., :length]
    v = v + u.float() * D.float()[:, None]
    out = [(v * x0.float()).to(u.dtype)]
    if save_v:
        out.append(v.to(u.dtype))
    if save_spectrum:
        out.append(pair_spectrum_ref(u, n))
    return out[0] if len(out) == 1 else tuple(out)


def _bwd_from_spectra(u_f, dy, x0, k_f, dv_D, dk_len, dtype):
    """du, dk and dD from U, with du = inv(DV conj(K)) + dv * dv_D."""
    length = dy.shape[-1]
    n = next_fast_fft_size(2 * length)
    dv = dy.float() * x0.float()
    dv_f = torch.fft.rfft(dv, n=n)
    du = torch.fft.irfft(dv_f * k_f.conj(), n=n)[..., :length]
    if dv_D is not None:
        du = du + dv * dv_D.float()[:, None]
    dk_full = torch.fft.irfft((dv_f * u_f.conj()).sum(0), n=n)
    return du.to(dtype), dk_full[:, :dk_len].to(dtype), dk_full[:, 0].float()


def fftconv_gated_bwd_specv_ref(spec, v, dy, x0, k, D):
    """Plain specv route: (du, dx0, dk, dD) from u's saved pair spectrum and
    the saved v; du's skip term dv * D added in time."""
    n = spec.shape[2]
    u_f = _channel_spectra(spec, dy.shape[1], n)
    du, dk, dD = _bwd_from_spectra(u_f, dy, x0, _rfft(k, n), D, k.shape[-1], dy.dtype)
    return du, (dy.float() * v.float()).to(dy.dtype), dk, dD


def fftconv_gated_bwd_spec_ref(spec, dy, x0, k, D):
    """Plain spec route: v = irfft(U (K + D)) recomputed from u's saved
    spectrum, and du = irfft(DV conj(K + D))."""
    n, length = spec.shape[2], dy.shape[-1]
    u_f = _channel_spectra(spec, dy.shape[1], n)
    ks = _rfft(k, n) + D.float()[:, None]
    v = torch.fft.irfft(u_f * ks, n=n)[..., :length]
    du, dk, dD = _bwd_from_spectra(u_f, dy, x0, ks, None, k.shape[-1], dy.dtype)
    return du, (dy.float() * v).to(dy.dtype), dk, dD


def fftconv_gated_bwd_retransform_ref(u, dy, x0, k, D):
    """Plain retransform route: U from u again, v = irfft(U K) + u D."""
    length = dy.shape[-1]
    n = next_fast_fft_size(2 * length)
    u_f, k_f = _rfft(u, n), _rfft(k, n)
    v = torch.fft.irfft(u_f * k_f, n=n)[..., :length] + u.float() * D.float()[:, None]
    du, dk, dD = _bwd_from_spectra(u_f, dy, x0, k_f, D, k.shape[-1], dy.dtype)
    return du, (dy.float() * v).to(dy.dtype), dk, dD


# wrappers

def fftconv_gated_fused(u: torch.Tensor, x0: torch.Tensor, k: torch.Tensor, D: torch.Tensor,
                        save_v: bool = False, save_spectrum: bool = False):
    """y = (conv(u, k) + u * D) * x0 on (B, C, L) in u's dtype; with
    `save_v` also v, with `save_spectrum` also u's pair spectrum (in that
    order). Kernel E on a CUDA tensor, `fftconv_gated_ref` on a CPU one."""
    if not _cuda.on_card(u):
        return fftconv_gated_ref(u, x0, k, D, save_v, save_spectrum)
    check_args("kernels E and E'", [("u", u), ("x0", x0)], k, D)
    b, c, length = u.shape
    n = next_fast_fft_size(2 * length)
    pairs = (c + 1) // 2
    f32 = dict(device=u.device, dtype=torch.float32)
    y = torch.empty_like(u)
    v = torch.empty_like(u) if save_v else None
    scratch = torch.empty((b, pairs, n, 2), **f32)
    kspec = torch.empty((pairs, n, 2), **f32)
    spec = torch.empty_like(scratch) if save_spectrum else None
    KERNEL.launch("hyena_fftconv_gated_fwd",
                  *map(_cuda.ptr, (u, x0, k, D, y)), _cuda.ptr_or_null(v),
                  _cuda.ptr(scratch), _cuda.ptr(kspec), _cuda.ptr_or_null(spec),
                  b, c, length, k.shape[1], n, int(u.dtype == torch.bfloat16),
                  _cuda.stream_handle(u), device=u.device)
    out = [y] + ([v] if save_v else []) + ([spec] if save_spectrum else [])
    return out[0] if len(out) == 1 else tuple(out)


def _bwd_workspace(b: int, c: int, n: int, route: str, device):
    """(kernel E''s complex64 workspace as (slabs, n, 2) float32, slabs), its
    size from the library's `hyena_fftconv_gated_bwd_ws_slabs`: dv's
    scratch, u's on the retransform route, and k's slab."""
    slabs = KERNEL_BWD.query("hyena_fftconv_gated_bwd_ws_slabs", b, c, ROUTES.index(route),
                             device=device)
    if slabs < 1:
        raise ValueError(f"kernel E' takes no workspace for B={b}, C={c}, route {route}")
    return torch.empty((slabs, n, 2), device=device, dtype=torch.float32), slabs


def _bwd_kernel(route, u, spec, v, dy, x0, k, D):
    check_args("kernels E and E'", [("dy", dy), ("x0", x0), ("u", u), ("v", v)], k, D, spec)
    b, c, length = dy.shape
    n = next_fast_fft_size(2 * length)
    du, dx0 = torch.empty_like(dy), torch.empty_like(dy)
    dk, dD = torch.empty_like(k), torch.empty(c, device=dy.device, dtype=torch.float32)
    ws, slabs = _bwd_workspace(b, c, n, route, dy.device)
    KERNEL_BWD.launch("hyena_fftconv_gated_bwd",
                      *map(_cuda.ptr_or_null, (u, spec, v)),
                      *map(_cuda.ptr, (dy, x0, k, D, du, dx0, dk, dD, ws)), slabs,
                      ROUTES.index(route), b, c, length, k.shape[1], n,
                      int(dy.dtype == torch.bfloat16), _cuda.stream_handle(dy), device=dy.device)
    return du, dx0, dk, dD


def fftconv_gated_bwd_specv(spec, v, dy, x0, k, D):
    """(du, dx0, dk, dD) from u's saved spectrum and the saved v: kernel
    E''s specv route on a CUDA tensor, its plain version on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_gated_bwd_specv_ref(spec, v, dy, x0, k, D)
    return _bwd_kernel("specv", None, spec, v, dy, x0, k, D)


def fftconv_gated_bwd_spec(spec, dy, x0, k, D):
    """(du, dx0, dk, dD) from u's saved spectrum, v recomputed: kernel E''s
    spec route on a CUDA tensor, its plain version on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_gated_bwd_spec_ref(spec, dy, x0, k, D)
    return _bwd_kernel("spec", None, spec, None, dy, x0, k, D)


def fftconv_gated_bwd_retransform(u, dy, x0, k, D):
    """(du, dx0, dk, dD) from u itself: kernel E''s retransform route on a
    CUDA tensor, its plain version on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_gated_bwd_retransform_ref(u, dy, x0, k, D)
    return _bwd_kernel("retransform", u, None, None, dy, x0, k, D)


# the torch entry points of the JAX package's gated Pallas entries

TPU_FFT_SIZES = (1 << 16, 1 << 17)


def _tpu_shape(name: str, shape) -> None:
    """Raise unless (B, C, L) is a shape the packed gated TPU route took:
    fft 2^16-2^17, even B (rows packed in pairs), C % 8 == 0 (its channel
    block)."""
    b, c, length = shape
    n = next_fast_fft_size(2 * length)
    if n not in TPU_FFT_SIZES or b % 2 or c % 8:
        raise ValueError(f"{name}: the TPU route took fft sizes {list(TPU_FFT_SIZES)} with "
                         f"even B and C % 8 == 0; got fft {n}, B={b}, C={c}")


def fftconv_fused_fwd_packed_gated(u, x0, k, D, save_spectrum: bool = False,
                                   save_v: bool = False):
    """The JAX `fftconv_fused_fwd_packed_gated` (pallas_fftconv.py:1534) on
    kernel E: y[, v][, spectrum] on unpadded (B, C, L)."""
    _tpu_shape("fftconv_fused_fwd_packed_gated", u.shape)
    return fftconv_gated_fused(u, x0, k, D, save_v=save_v, save_spectrum=save_spectrum)


def fftconv_fused_bwd_spec_packed_gated(spec, dy, x0, k, D):
    """The JAX `fftconv_fused_bwd_spec_packed_gated` (pallas_fftconv.py:1662)
    on kernel E''s spec route: (du, dx0, dk, dD), dk in time."""
    _tpu_shape("fftconv_fused_bwd_spec_packed_gated", dy.shape)
    return fftconv_gated_bwd_spec(spec, dy, x0, k, D)


def fftconv_fused_bwd_specv_packed_gated(spec, v, dy, x0, k, D):
    """The JAX `fftconv_fused_bwd_specv_packed_gated` (pallas_fftconv.py:1796)
    on kernel E''s specv route: (du, dx0, dk, dD), dk in time."""
    _tpu_shape("fftconv_fused_bwd_specv_packed_gated", dy.shape)
    return fftconv_gated_bwd_specv(spec, v, dy, x0, k, D)


def fftconv_fused_bwd_packed_gated(u, dy, x0, k, D):
    """The JAX `fftconv_fused_bwd_packed_gated` (pallas_fftconv.py:1932) on
    kernel E''s retransform route: (du, dx0, dk, dD), dk in time (the JAX
    caller inverted the returned spectrum)."""
    _tpu_shape("fftconv_fused_bwd_packed_gated", dy.shape)
    return fftconv_gated_bwd_retransform(u, dy, x0, k, D)
