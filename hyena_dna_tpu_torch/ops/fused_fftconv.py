"""Fused causal FFT conv: kernels B and C and their plain versions.

Kernel B (`csrc/fftconv.cu`) is the forward of the JAX package's conv
kernels (`ops/pallas_fftconv.py::fftconv_fused_fwd_packed` and
`fftconv_fused_fwd`, `ops/pallas_fftconv_n3.py::fftconv_outer_fwd`); kernel
C (`csrc/fftconv_bwd.cu`) their backward (`fftconv_fused_bwd_spec_packed`,
`fftconv_fused_bwd_spec`, `fftconv_fused_bwd_du` + `fftconv_fused_dk_from_specs`,
`fftconv_fused_bwd_packed`, `fftconv_fused_bwd`, `fftconv_outer_bwd`). One
kernel each covers every power-of-two FFT size from 16 to 2^21, on two
paths chosen inside the C entry:

  * the short path (`csrc/fft_short.cuh`) at n <= 2^kShortMaxLogN (2^13,
    every shipped Hyena config at L <= 4096): each channel pair's row whole
    in one block's shared memory, the batch spread over the grid. Kernel B
    is two launches (the filter's spectrum with D folded in, K + D, once a
    call; the conv), kernel C three (K + D; one block per (pair, batch
    slice) writing du and the slice's dk partial; one block per pair
    summing the partials in a fixed order and transforming dk back);
  * the four-step passes (`csrc/fft_common.cuh`) above the cut, and at any
    size for the saved-spectrum modes (B's `save_spectrum`, C's spectrum
    route, the dk-spectrum mode), whose spectra are in the four-step layout.
    No route of the model saves a spectrum below 2^16.

The functions:

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

Every Pallas conv entry of the JAX package has a torch entry of the same
name and contract (padded operands, the plan's arguments): the forward
`fftconv_fused_fwd_packed`, `fftconv_fused_fwd`, `fftconv_outer_fwd`,
`fftconv_fused_fwd_narrow` and `fftconv3_fwd` on kernel B; the backward
ones on kernel C's routes, the narrow and 3-factor ones returning a float32
dk as their JAX twins do; and `fftconv_fused_dk_spec`, kernel C's
dk-spectrum mode (dy's and u's transforms and the batch sum only). The
JAX forward entries' `conj_filter=True` (a product with conj(K)) has no
caller in the JAX package, so the port's entries take the flag and refuse
True. `plan`, `plan3` and `nat_chain` are the port's copies of the JAX plan
rules, with their tables.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version on `torch.fft`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re

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
    "hyena_fftconv_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "hyena_fftconv_bwd_ws_slabs": [ctypes.c_int] * 4,
    "hyena_fftconv_bwd_short_slices": [ctypes.c_int] * 4,
})


def saves_spectrum(batch: int, channels: int, length: int) -> bool:
    """Whether the forward saves u's spectrum for the backward."""
    n = next_fast_fft_size(2 * length)
    if n not in _SPECTRUM_FFT_SIZES or (n > 1 << 16 and batch % 2):
        return False
    return batch * ((channels + 1) // 2) * n * 8 <= SAVE_SPECTRUM_MAX_BYTES


@functools.cache
def _plan_log_n1() -> tuple[int, ...]:
    """log2 N1 at each n = 2^log_n, read from the kernels' own table
    (`kPlanLogN1` in csrc/fft_common.cuh, where the plan rule is stated)."""
    text = (_cuda.CSRC / "fft_common.cuh").read_text()
    body = re.search(r"kPlanLogN1\[kMaxLogN \+ 1\] = \{([^}]*)\}", text).group(1)
    return tuple(int(v) for v in body.split(","))


@functools.cache
def short_max_log_n() -> int:
    """log2 of the largest FFT size of the kernels' short path, read from
    the kernels' own constant (`kShortMaxLogN` in csrc/fft_short.cuh)."""
    text = (_cuda.CSRC / "fft_short.cuh").read_text()
    return int(re.search(r"constexpr int kShortMaxLogN = (\d+);", text).group(1))


def short_path(n: int, saved_spectrum: bool = False) -> bool:
    """Whether kernels B and C run a conv of FFT size n on their short path
    (no device scratch): n at or below the cut, and no saved spectrum
    written or read (those modes keep the four-step layout)."""
    return n <= 1 << short_max_log_n() and not saved_spectrum


def short_slices(b: int, c: int, n: int, dtype: torch.dtype, device) -> int:
    """The dk partials a channel pair that kernel C's short path sums for a
    (b, c, L) conv at FFT size n on the CUDA `device` (its batch slices; 0
    above the cut), from the library (`hyena_fftconv_bwd_short_slices`): a
    property of that card."""
    slices = KERNEL_BWD.query("hyena_fftconv_bwd_short_slices", b, c, n,
                              int(dtype == torch.bfloat16), device=device)
    if slices < 0:
        raise ValueError(f"kernel C takes no conv of B={b}, C={c} at fft {n}")
    return slices


def _four_step(n: int):
    """(N1, N2) of the kernels' four-step split n = N1 N2."""
    log_n1 = _plan_log_n1()[n.bit_length() - 1]
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


def _split_pairs(spec: torch.Tensor, channels: int, n: int) -> torch.Tensor:
    """Per-channel spectra (B, C, n), natural frequency order, from pair
    spectra (B, pairs, n, 2) in the kernels' four-step layout: the Hermitian
    split X_c = (Z[f] + conj Z[-f]) / 2, X_c+1 = (Z[f] - conj Z[-f]) / 2i."""
    b, pairs = spec.shape[:2]
    n1, n2 = _four_step(n)
    z = torch.view_as_complex(spec.contiguous()).reshape(b, pairs, n1, n2)
    z = z.transpose(-1, -2).reshape(b, pairs, n)
    zm = z[..., (-torch.arange(n, device=z.device)) % n].conj()
    x = torch.stack([(z + zm) / 2, (z - zm) / 2j], dim=2).reshape(b, 2 * pairs, n)
    return x[:, :channels]


def _channel_spectra(spec: torch.Tensor, channels: int, n: int) -> torch.Tensor:
    """Per-channel rfft (B, C, n//2+1) from a saved pair spectrum."""
    return _split_pairs(spec, channels, n)[..., :n // 2 + 1]


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
    # complex64 working space, as interleaved (re, im) float32: k's spectrum
    # per channel pair, and on the four-step passes u's transform per
    # (batch, channel pair), which the short path does not take
    f32 = dict(device=u.device, dtype=torch.float32)
    kspec = torch.empty((pairs, n, 2), **f32)
    scratch = (None if short_path(n, save_spectrum)
               else torch.empty((b, pairs, n, 2), **f32))
    spec = torch.empty((b, pairs, n, 2), **f32) if save_spectrum else None
    KERNEL.launch("hyena_fftconv_fwd", *map(_cuda.ptr, (u, k, D, y)),
                  _cuda.ptr_or_null(scratch), _cuda.ptr(kspec), _cuda.ptr_or_null(spec),
                  b, c, length, k.shape[1], n, int(u.dtype == torch.bfloat16),
                  _cuda.stream_handle(u), device=u.device)
    return (y, spec) if save_spectrum else y


def _bwd_workspace(b: int, c: int, n: int, retransform: bool, with_k: bool, device):
    """(kernel C's complex64 workspace as (slabs, n, 2) float32, slabs), its
    size from the library's `hyena_fftconv_bwd_ws_slabs`."""
    slabs = KERNEL_BWD.query("hyena_fftconv_bwd_ws_slabs", b, c, int(retransform), int(with_k),
                             device=device)
    if slabs < 1:
        raise ValueError(f"kernel C takes no workspace for B={b}, C={c}")
    return torch.empty((slabs, n, 2), device=device, dtype=torch.float32), slabs


def _bwd_kernel(u, spec, dy, k, D, dk_dtype=None):
    check_args("kernels B and C", [("u", u), ("dy", dy)], k, D, spec)
    b, c, length = dy.shape
    n = next_fast_fft_size(2 * length)
    f32 = dict(device=dy.device, dtype=torch.float32)
    dk_f32 = dk_dtype == torch.float32
    dk = torch.empty(k.shape, **f32) if dk_f32 else torch.empty_like(k)
    du, dD = torch.empty_like(dy), torch.empty(c, **f32)
    ws, slabs = _bwd_workspace(b, c, n, spec is None, True, dy.device)
    KERNEL_BWD.launch("hyena_fftconv_bwd",
                      _cuda.ptr_or_null(u), _cuda.ptr_or_null(spec),
                      *map(_cuda.ptr, (dy, k, D, du, dk, dD, ws)), slabs,
                      b, c, length, k.shape[1], n, int(dy.dtype == torch.bfloat16), int(dk_f32),
                      _cuda.stream_handle(dy), device=dy.device)
    return du, dk, dD


def fftconv_bwd_retransform(u: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                            D: torch.Tensor, dk_dtype: torch.dtype | None = None):
    """(du, dk, dD) from u itself: kernel C's retransform route on a CUDA
    tensor, `fftconv_bwd_ref` on a CPU one. dk in k's dtype, or float32
    with `dk_dtype=torch.float32`."""
    if dk_dtype not in (None, torch.float32, k.dtype):
        raise TypeError(f"dk comes out in k's dtype or float32, not {dk_dtype}")
    if not _cuda.on_card(dy):
        return fftconv_bwd_ref(u, dy, k, D, dk_dtype=dk_dtype)
    return _bwd_kernel(u, None, dy, k, D, dk_dtype)


def fftconv_bwd_spectrum(spec: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                         D: torch.Tensor):
    """(du, dk, dD) from u's saved spectrum: kernel C's spectrum route on a
    CUDA tensor, `fftconv_bwd_spectrum_ref` on a CPU one."""
    if not _cuda.on_card(dy):
        return fftconv_bwd_spectrum_ref(spec, dy, k, D)
    return _bwd_kernel(None, spec, dy, k, D)


# ---------------------------------------------------------------------------
# One torch entry per Pallas conv entry of the JAX package, on its contract:
# padded operands (B, C, Lp) and k (C, Lp), with Lp = n / 2 for the plan's
# fft size n, and the plan's arguments. Each checks its plan and, for the
# default routes, the fft sizes and batch parity the JAX routing gave it,
# then runs kernel B or C (or their plain versions on a CPU tensor). The
# tables below are the port's copies of the JAX plan tables; the tests
# patch them as the JAX tests patch theirs.

# fft size -> channel block of the fused 2-factor kernels
# (`pallas_fftconv._CB_BY_N`); from SPLIT_BWD_MIN the TPU ran the unpacked
# forward and the split backward (`_SPLIT_BWD_MIN`).
CB_BY_N = {1 << 16: 8, 1 << 17: 8, 1 << 18: 8}
SPLIT_BWD_MIN = 1 << 18
# single-channel plans (`_CB_BY_N_NARROW`), off the default route (the outer
# route is tried first at 2^19)
CB_BY_N_NARROW = {1 << 19: 1}
# fft size -> ((f1, f2, f3), cb) of the 3-factor kernels
# (`pallas_fftconv3._PLAN3_BY_N`), gated off in the JAX package
PLAN3_BY_N = {
    1 << 19: ((64, 64, 128), 2),
    1 << 20: ((128, 64, 128), 1),
    1 << 21: ((128, 128, 128), 1),
}
# fft size n -> outer plan (n1, r, m) with n1 * r * m = n
# (`pallas_fftconv_n3._OUTER_BY_N`); below 2^19 the outer route took odd B
# only (`_OUTER_NEEDS_ODD_BATCH_BELOW`).
OUTER_BY_N = {
    1 << 17: (4, 256, 128),
    1 << 18: (16, 128, 128),
    1 << 19: (16, 128, 256),
    1 << 20: (16, 256, 256),
    1 << 21: (16, 512, 256),
}
OUTER_NEEDS_ODD_BATCH_BELOW = 1 << 19


def nat_chain(n: int) -> tuple:
    """The balanced factor chain of a power-of-two n (JAX
    `ops/fftconv.py::_nat_chain`, without its override table)."""
    if n <= 1 << 10:
        return (n,)
    e = n.bit_length() - 1
    parts = 2 if e <= 19 else 3 if e <= 25 else 4
    base, rem = divmod(e, parts)
    return tuple(1 << x for x in [base] * (parts - rem) + [base + 1] * rem)


def plan(n: int, c: int, seqlen: int, chain):
    """(r, m, cb) if a fused 2-factor kernel covers this conv, else None;
    cb < 8 marks a narrow plan (JAX `pallas_fftconv.plan`)."""
    cb = CB_BY_N.get(n)
    if cb is not None:
        if len(chain) != 2:
            return None
        r, m = chain
        if r * m != n or r % 2 or c % cb or seqlen > (r // 2) * m:
            return None
        return r, m, cb
    cb = CB_BY_N_NARROW.get(n)
    if cb is None or c % cb:
        return None
    r = 1 << ((n.bit_length() - 1 + 1) // 2)  # balanced 2-factor; r even
    m = n // r
    return None if seqlen > (r // 2) * m else (r, m, cb)


def plan3(n: int, c: int, seqlen: int):
    """((f1, f2, f3), cb) if the 3-factor kernels cover this conv (JAX
    `pallas_fftconv3.plan3`)."""
    ent = PLAN3_BY_N.get(n)
    if ent is None:
        return None
    (f1, f2, f3), cb = ent
    while cb > 1 and c % cb:
        cb //= 2
    if c % cb or seqlen > (f1 // 2) * f2 * f3:
        return None
    return (f1, f2, f3), cb


def plan_outer(n: int, channels: int, length: int, batch: int):
    """(n1, r, m) if the outer route covers a conv of `length` at fft size
    n and batch `batch`, else None (JAX `plan_outer`; `channels` is unused
    there too)."""
    spec = OUTER_BY_N.get(n)
    if spec is None or (n < OUTER_NEEDS_ODD_BATCH_BELOW and batch % 2 == 0):
        return None
    n1, r, m = spec
    return None if length > (n1 // 2) * r * m else spec


def fwd_route(n: int, batch: int):
    """The forward Pallas entry the JAX routing (`ops/fftconv.py::
    _fftconv_fwd`) took at fft size n and batch `batch`: "outer",
    "packed", "unpacked", or None (below 2^16: XLA's FFT)."""
    if n in OUTER_BY_N and (n >= OUTER_NEEDS_ODD_BATCH_BELOW or batch % 2):
        return "outer"
    if n in CB_BY_N:
        return "packed" if batch % 2 == 0 and n < SPLIT_BWD_MIN else "unpacked"
    return None


def _check_plan(name: str, factors, cb, k, *signals):
    """(n, B) after checking that the plan's factors multiply to the fft
    size n, that each signal (B, C, Lp) and k (C, Lp), if given, are
    padded to Lp = (factors[0] / 2) * the rest, and that cb divides C."""
    first, rest = factors[0], math.prod(factors[1:])
    n, lp = first * rest, (first // 2) * rest
    if first % 2 or next_fast_fft_size(2 * lp) != n:
        raise ValueError(f"{name}: the plan {tuple(factors)} does not split an fft size of "
                         "2 Lp into an even first factor and the rest")
    b, c = signals[0].shape[:2]
    for t in signals:
        if t.dim() != 3 or tuple(t.shape) != (b, c, lp):
            raise ValueError(f"{name}: the plan {tuple(factors)} takes operands padded to "
                             f"(B, C, {lp}); got {tuple(t.shape)}")
    if k is not None and tuple(k.shape) != (c, lp):
        raise ValueError(f"{name}: k must be ({c}, {lp}), got {tuple(k.shape)}")
    if cb is not None and (cb < 1 or c % cb):
        raise ValueError(f"{name}: the channel block {cb} does not divide C={c}")
    return n, b


def _refuse_conj(name: str, conj_filter: bool) -> None:
    if conj_filter:
        raise NotImplementedError(f"{name}: conj_filter=True has no caller in the JAX package "
                                  "and no kernel here")


def _check_route(name: str, route: str, n: int, batch: int) -> None:
    took = fwd_route(n, batch)
    if took != route:
        raise ValueError(f"{name}: the TPU took the {route} route; fft {n} with B={batch} "
                         f"took {took or 'no fused kernel'}")


def fftconv_fused_fwd_packed(u, k, D, r: int, m: int, cb: int, conj_filter: bool = False,
                             save_spectrum: bool = False):
    """JAX `pallas_fftconv.py::fftconv_fused_fwd_packed` (TPU row 2: even B,
    fft sizes of `CB_BY_N` below `SPLIT_BWD_MIN`) on kernel B: y (B, C, Lp)
    in u's dtype, or (y, u's pair spectrum) with `save_spectrum`, the
    port's layout in place of the TPU's packed (B/2, r, C, m) pair.
    `conj_filter=True` is refused."""
    _refuse_conj("fftconv_fused_fwd_packed", conj_filter)
    n, b = _check_plan("fftconv_fused_fwd_packed", (r, m), cb, k, u)
    _check_route("fftconv_fused_fwd_packed", "packed", n, b)
    return fftconv_fused(u, k, D, save_spectrum=save_spectrum)


def fftconv_fused_fwd(u, k, D, r: int, m: int, cb: int, conj_filter: bool = False,
                      save_spectrum: bool = False):
    """JAX `pallas_fftconv.py::fftconv_fused_fwd` (TPU row 3: odd B at
    2^16, any parity from `SPLIT_BWD_MIN` where the outer route does not
    take it) on kernel B; returns as `fftconv_fused_fwd_packed`."""
    _refuse_conj("fftconv_fused_fwd", conj_filter)
    n, b = _check_plan("fftconv_fused_fwd", (r, m), cb, k, u)
    _check_route("fftconv_fused_fwd", "unpacked", n, b)
    return fftconv_fused(u, k, D, save_spectrum=save_spectrum)


def fftconv_outer_fwd(u, k, D, n1: int, r: int, m: int):
    """JAX `pallas_fftconv_n3.py::fftconv_outer_fwd` (the flat entry over TPU
    row 4: the outer route's sizes and parities) on kernel B: y (B, C, Lp),
    Lp = (n1 / 2) r m."""
    n, b = _check_plan("fftconv_outer_fwd", (n1, r, m), None, k, u)
    _check_route("fftconv_outer_fwd", "outer", n, b)
    return fftconv_fused(u, k, D)


def _tpu_entry(name: str, spectrum: bool, fft_sizes, even_batch, outer: bool = False):
    """The torch entry point of one backward Pallas entry of the JAX package:
    the route of kernel C it took on the TPU, at the FFT sizes and batch
    parity that the JAX routing gave it (None: either parity), with the
    entry's plan arguments, (r, m, cb) or for the outer route (n1, r, m)."""
    route = fftconv_bwd_spectrum if spectrum else fftconv_bwd_retransform

    def entry(x, dy, k, D, *plan_args):
        if len(plan_args) != 3:
            raise TypeError(f"{name} takes its plan: {'(n1, r, m)' if outer else '(r, m, cb)'}")
        factors, cb = (plan_args, None) if outer else (plan_args[:2], plan_args[2])
        signals = (dy,) if spectrum else (dy, x)
        n, b = _check_plan(name, factors, cb, k, *signals)
        if n not in fft_sizes or (even_batch is not None and (b % 2 == 0) != even_batch):
            parity = {True: " with even B", False: " with odd B", None: ""}[even_batch]
            raise ValueError(f"{name}: the TPU route took fft sizes {sorted(fft_sizes)}"
                             f"{parity}; got fft {n}, B={b}")
        return route(x, dy, k, D)

    entry.__name__ = entry.__qualname__ = name
    entry.spectrum = spectrum
    entry.__doc__ = (f"(du, dk, dD) from {'u spectrum' if spectrum else 'u'}, dy, k, D and "
                     f"the plan: the JAX `{name}` route, on kernel C.")
    return entry


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
fftconv_outer_bwd = _tpu_entry("fftconv_outer_bwd", False, _OUTER_SIZES, None, outer=True)


def fftconv_fused_fwd_narrow(u, k, D, r: int, m: int, cb: int = 1):
    """JAX `pallas_fftconv.py::fftconv_fused_fwd_narrow` (TPU row 11, the
    single-channel plan of `CB_BY_N_NARROW`) on kernel B: y (B, C, Lp)."""
    _check_plan("fftconv_fused_fwd_narrow", (r, m), cb, k, u)
    return fftconv_fused(u, k, D)


def fftconv_fused_bwd_narrow(u, dy, k, D, r: int, m: int, cb: int = 1):
    """JAX `fftconv_fused_bwd_narrow` (TPU row 12) on kernel C's retransform
    route: (du in dy's dtype, dk (C, Lp) float32, dD (C,) float32)."""
    _check_plan("fftconv_fused_bwd_narrow", (r, m), cb, k, u, dy)
    return fftconv_bwd_retransform(u, dy, k, D, dk_dtype=torch.float32)


def fftconv3_fwd(u, k, D, f1: int, f2: int, f3: int, cb: int, conj_filter: bool = False):
    """JAX `pallas_fftconv3.py::fftconv3_fwd` (TPU row 19, the 3-factor split
    n = f1 f2 f3, Lp = (f1 / 2) f2 f3) on kernel B, whose own four-step
    split computes the same conv. `conj_filter=True` is refused."""
    _refuse_conj("fftconv3_fwd", conj_filter)
    _check_plan("fftconv3_fwd", (f1, f2, f3), cb, k, u)
    return fftconv_fused(u, k, D)


def fftconv3_bwd(u, dy, k, D, f1: int, f2: int, f3: int, cb: int):
    """JAX `fftconv3_bwd` (TPU row 20) on kernel C's retransform route:
    (du, dk (C, Lp) float32, dD (C,) float32); kernel C reads dD off dk's
    lag 0 where the JAX wrapper contracted u and dy."""
    _check_plan("fftconv3_bwd", (f1, f2, f3), cb, k, u, dy)
    return fftconv_bwd_retransform(u, dy, k, D, dk_dtype=torch.float32)


def fftconv_dk_spec_ref(u: torch.Tensor, dy: torch.Tensor, n: int):
    """Plain version of the dk-spectrum mode: sum_b fft(dy) conj(fft(u)) at
    size n, as (re, im), each (C, n) float32 in natural frequency order."""
    spec = (torch.fft.fft(dy.float(), n=n) * torch.fft.fft(u.float(), n=n).conj()).sum(0)
    return spec.real.contiguous(), spec.imag.contiguous()


def fftconv_fused_dk_spec(u, dy, r: int, m: int, cb: int):
    """JAX `pallas_fftconv.py::fftconv_fused_dk_spec` (TPU row 8): the batch
    sum of DY conj(U) at fft size n = r m, as (re, im), each (C, n) float32.
    On a CUDA tensor kernel C's dk-spectrum mode builds it as channel-pair
    spectra, split here with the Hermitian mirror. Returned in natural
    frequency order, where the TPU returned its permuted (r, C, m) layout
    (f = p + r q at [p, c, q]): a divergence by design."""
    n, b = _check_plan("fftconv_fused_dk_spec", (r, m), cb, None, u, dy)
    if not _cuda.on_card(u):
        return fftconv_dk_spec_ref(u, dy, n)
    c, length = u.shape[1:]
    for name, t in (("u", u), ("dy", dy)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != u.dtype:
            raise TypeError(f"kernel C takes u and dy both float32 or both bfloat16; "
                            f"got {u.dtype}, {dy.dtype}")
        if t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {u.device}")
    sdk = torch.empty(((c + 1) // 2, n, 2), device=u.device, dtype=torch.float32)
    ws, slabs = _bwd_workspace(b, c, n, True, False, u.device)
    null = _cuda.ptr_or_null(None)
    KERNEL_BWD.launch("hyena_fftconv_bwd", _cuda.ptr(u), null, _cuda.ptr(dy), null, null, null,
                      _cuda.ptr(sdk), null, _cuda.ptr(ws), slabs,
                      b, c, length, length, n, int(u.dtype == torch.bfloat16), 0,
                      _cuda.stream_handle(u), device=u.device)
    spec = _split_pairs(sdk[None], c, n)[0]
    return spec.real.contiguous(), spec.imag.contiguous()


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
