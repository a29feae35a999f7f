"""Fused Hyena front end: kernels A and A' and their plain versions.

Counterpart of `hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate`
and its custom VJP:

  u (B, L, d_in) --u @ W + bp--> (B, L, 3 d_c) --causal k=3 depthwise conv + bc-->
  split [x0 | x1 | v] --> vx = v * x1, x0, both channel-major (B, d_c, L).

Two widths: d_in, u's width, and d_c, the width of one output chunk, read
off W (d_in, 3 d_c). The whole model runs d_in == d_c == d. Under tensor
parallelism (`models/hyena.py`) a rank of a model axis of M holds in_proj's
columns of its d / M channels of each chunk, so it projects the whole u onto
d_c = d / M channels; its du is a partial sum that the model axis reduces.
Every kernel of the module, A4 and A4' included, takes both widths.

`fused_proj_conv_gate` is the `torch.autograd.Function` `FusedProjConvGate`:
its forward is kernel A (`csrc/fused_front.cu`) and its backward kernel A'
(`csrc/fused_front_bwd.cu`), which recomputes the projection and conv and
emits du, dW, dbp, dwc and dbc. On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version: `reference_fwd`
(the math of the JAX `_reference_fwd`) and `reference_bwd` (the math of the
JAX `_fpcg_bwd_xla`, written out, not autograd). Unlike the Pallas kernels,
which need L % tile == 0, kernels A and A' take any L.

`fused_proj_conv_gate4` (JAX `fused_proj_conv_gate4`, the `HYENA_FRONT4`
route) is the same front end writing the 4-D conv layout: vx and x0 come
out as (B, d, rows_pad, m), which is the flat (B, d, lp) with lp =
rows_pad * m >= L zero past L, as the 4-D conv entries of
`ops/fused_fftconv.py` read it. Its forward is kernel A4
(`csrc/fused_front4.cu`), its backward kernel A4'
(`csrc/fused_front4_bwd.cu`), which reads the cotangents over the L real
times only (the tail is a constant zero). Both share their tile bodies with
kernels A and A' (`csrc/fused_front_common.cuh`,
`csrc/fused_front_bwd_common.cuh`). Their plain versions are
`reference_fwd4` (`reference_fwd` plus the zero pad) and `reference_bwd4`
(`reference_bwd` on the sliced cotangents). The kernels take any L; the
wrapper still holds every call to the tiling contract of the Pallas
kernels (`check_plan4`), which the JAX wrapper left unchecked.

u and the activations (vx, x0, dvx, dx0, du) are float32 or bfloat16, one
dtype for all; the parameters and their gradients are float32. Both the
kernels and the plain versions compute in float32 on the widened inputs and
round each output once, as the Pallas kernel does in interpret mode (u bf16
against float32 W). The JAX `_reference_fwd` instead rounds the projection
to bf16 (`u @ w.astype(u.dtype)`); `reference_fwd` keeps it float32, the
math the model runs on both devices, so the card is held to it at the
tolerance of one bf16 rounding of the outputs.

On either dtype of u the kernels run their products on the tensor cores
(`csrc/wgmma.cuh`, `csrc/fused_front_tc.cuh`) with W, dproj and float32 u
split into bf16 pairs, hi + lo, each product the float32 sum of two or
three pair products (`PROJ_TERMS`, `DU_TERMS`, `DW_TERMS`);
`split_reference_fwd` / `split_reference_bwd` are that scheme in plain
PyTorch, held to the plain versions on the CPU
(`tests/test_torch_port_front_split.py`). Kernel A' keeps dproj out of
device memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d

_P, _I = ctypes.c_void_p, ctypes.c_int
# each entry, float32 or bf16 u: the pointers (the split-W scratch `ws` among
# them), B, L, d_in, d_c and, backward, the dW run count; then the stream
_FWD_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 13 + [_I] * 5 + [_P]
# the entries' scratch sizes, from the C layout (host functions, not
# launches): ws_numel(d_in, d_c), bwd_runs(B, L, d_in, d_c)
_SIZES = {"hyena_front_ws_numel": [_I] * 2}
_BWD_SIZES = {**_SIZES, "hyena_front_bwd_runs": [_I] * 4}
KERNEL = _cuda.Kernel("fused_front", {"hyena_fused_front_fwd": _FWD_ARGS,
                                      "hyena_fused_front_fwd_bf16": _FWD_ARGS,
                                      "hyena_front_wgmma_probe": [_P] * 3 + [_I, _P], **_SIZES})
KERNEL_BWD = _cuda.Kernel("fused_front_bwd", {"hyena_fused_front_bwd": _BWD_ARGS,
                                              "hyena_fused_front_bwd_bf16": _BWD_ARGS,
                                              **_BWD_SIZES})
# kernels A4 and A4': kernel A's and A''s arguments plus lp after L
_FWD4_ARGS = [_P] * 8 + [_I] * 5 + [_P]
_BWD4_ARGS = [_P] * 13 + [_I] * 6 + [_P]
KERNEL4 = _cuda.Kernel("fused_front4", {"hyena_fused_front4_fwd": _FWD4_ARGS,
                                        "hyena_fused_front4_fwd_bf16": _FWD4_ARGS, **_SIZES})
KERNEL4_BWD = _cuda.Kernel("fused_front4_bwd", {"hyena_fused_front4_bwd": _BWD4_ARGS,
                                                "hyena_fused_front4_bwd_bf16": _BWD4_ARGS,
                                                **_BWD_SIZES})
# the C entry point's suffix for each activation dtype the kernels take
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
# wgmma_probe's modes and the width N of each one's product
# (csrc/fused_front.cu::hyena_front_wgmma_probe)
PROBE_MODES = {0: 48, 1: 32, 2: 24, 3: 64, 4: 48}


def reference_fwd(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (JAX `pallas_hyena._reference_fwd`, with the
    projection kept in float32: see the module docstring). The chunk width
    is W's columns over 3."""
    proj = u.float() @ w.float() + bp.float()  # (B, L, 3 d_c)
    proj_t = proj.transpose(-1, -2)  # (B, 3 d_c, L)
    conv = short_conv_1d(proj_t, wc.float().transpose(0, 1), bc.float())
    d = w.shape[1] // 3
    x0, x1, v = conv[:, :d], conv[:, d:2 * d], conv[:, 2 * d:]
    return (v * x1).to(u.dtype), x0.to(u.dtype)


def reference_bwd(u, w, bp, wc, bc, dvx, dx0):
    """Plain PyTorch backward (JAX `pallas_hyena._fpcg_bwd_xla`): recompute
    the conv, form dconv = [dx0 | dvx * v | dvx * x1], apply the transposed
    conv, then the parameter and input grads. Returns (du in u's dtype; dw,
    dbp, dwc, dbc in float32)."""
    f32 = torch.float32
    proj = u.to(f32) @ w.to(f32) + bp.to(f32)  # (B, L, 3 d_c)
    proj_t = proj.transpose(1, 2)  # (B, 3 d_c, L)
    conv = short_conv_1d(proj_t, wc.t().to(f32), bc.to(f32))
    d = w.shape[1] // 3
    x1, v = conv[:, d:2 * d], conv[:, 2 * d:]
    dvx = dvx.to(f32)
    dconv = torch.cat([dx0.to(f32), dvx * v, dvx * x1], dim=1)  # (B, 3 d_c, L)
    # transpose of conv[t] = sum_j wc[j] proj[t-2+j]: dproj[s] = sum_j wc[j] dconv[s+2-j]
    # (dconv zero past L); dwc[j] = sum_t dconv[t] proj[t-2+j] (proj zero before 0)
    wc = wc.to(f32)
    length = dconv.shape[-1]
    dconv_r, proj_l = F.pad(dconv, (0, 2)), F.pad(proj_t, (2, 0))
    dproj_t = sum(dconv_r[..., 2 - j:2 - j + length] * wc[j][None, :, None] for j in range(3))
    dwc = torch.stack([(dconv * proj_l[..., j:j + length]).sum((0, 2)) for j in range(3)])
    dbc = dconv.sum((0, 2))
    dproj = dproj_t.transpose(1, 2)  # (B, L, 3 d_c)
    du = (dproj @ w.to(f32).t()).to(u.dtype)
    dw = u.to(f32).reshape(-1, u.shape[-1]).t() @ dproj.reshape(-1, dproj.shape[-1])
    return du, dw, dproj.sum((0, 1)), dwc, dbc


def split_bf16(x):
    """(hi, lo), both bfloat16: hi = bf16(x), lo = bf16(x - hi), so
    |x - hi - lo| <= 2^-17 |x|. The kernels split W, dproj and float32 u so."""
    hi = x.float().to(torch.bfloat16)
    return hi, (x.float() - hi.float()).to(torch.bfloat16)


# The pair products the kernels issue, per u dtype (a's part first, as
# `_pair_mm` names them): bf16 u enters exactly (its hi part), float32 u as
# a pair. du's products do not involve u.
PROJ_TERMS = {torch.bfloat16: "hh hl", torch.float32: "hh hl lh"}
DU_TERMS = "hh lh hl"
DW_TERMS = {torch.bfloat16: "hh hl", torch.float32: "hh hl lh"}


def _u_parts(u):
    """u as the kernels' products take it: bf16 u whole, float32 u as its
    bf16 pair."""
    return u if u.dtype == torch.bfloat16 else split_bf16(u)


def _pair_mm(a, b, terms: str):
    """The float32 sum of the products of a's and b's bf16 pair parts named
    in `terms` ("hh", "lh", "hl", "ll": a's part first); a tensor that is not
    split enters as its hi part."""
    a_parts = dict(zip("hl", a)) if isinstance(a, tuple) else {"h": a}
    b_parts = dict(zip("hl", b)) if isinstance(b, tuple) else {"h": b}
    return sum(a_parts[t[0]].float() @ b_parts[t[1]].float() for t in terms.split())


def split_reference_fwd(u, w, bp, wc, bc, proj_terms=None):
    """Kernel A's arithmetic in plain PyTorch, unrounded (float32 vx, x0):
    proj as the pair products `proj_terms` (default: the kernels', by u's
    dtype) of u and W's pair, then `reference_fwd`'s conv and gate. Not
    called by the kernels."""
    proj_terms = proj_terms or PROJ_TERMS[u.dtype]
    proj = _pair_mm(_u_parts(u), split_bf16(w), proj_terms) + bp.float()
    conv = short_conv_1d(proj.transpose(-1, -2), wc.float().transpose(0, 1), bc.float())
    d = w.shape[1] // 3
    return conv[:, 2 * d:] * conv[:, d:2 * d], conv[:, :d]


def split_reference_bwd(u, w, bp, wc, bc, dvx, dx0, proj_terms=None, du_terms=DU_TERMS,
                        dw_terms=None):
    """Kernel A''s arithmetic in plain PyTorch, du unrounded: proj, du =
    dproj W^T and dW = u^T dproj as the named pair products (W and dproj
    split, u split when float32; proj_terms and dw_terms default to the
    kernels' by u's dtype), the rest as `reference_bwd`. Returns (du, dw,
    dbp, dwc, dbc), all float32. Not called by the kernels."""
    f32 = torch.float32
    proj_terms = proj_terms or PROJ_TERMS[u.dtype]
    dw_terms = dw_terms or DW_TERMS[u.dtype]
    up, wp = _u_parts(u), split_bf16(w)
    proj = _pair_mm(up, wp, proj_terms) + bp.float()
    proj_t = proj.transpose(1, 2)
    wc = wc.to(f32)
    conv = short_conv_1d(proj_t, wc.t(), bc.to(f32))
    d = w.shape[1] // 3
    x1, v = conv[:, d:2 * d], conv[:, 2 * d:]
    dvx = dvx.to(f32)
    dconv = torch.cat([dx0.to(f32), dvx * v, dvx * x1], dim=1)
    length = dconv.shape[-1]
    dconv_r, proj_l = F.pad(dconv, (0, 2)), F.pad(proj_t, (2, 0))
    dproj_t = sum(dconv_r[..., 2 - j:2 - j + length] * wc[j][None, :, None] for j in range(3))
    dwc = torch.stack([(dconv * proj_l[..., j:j + length]).sum((0, 2)) for j in range(3)])
    dproj = dproj_t.transpose(1, 2)  # (B, L, 3 d_c)
    dp = split_bf16(dproj)
    du = _pair_mm(dp, tuple(t.t() for t in wp), du_terms)
    rows_t = lambda t: t.reshape(-1, t.shape[-1]).t()
    u_rows = tuple(map(rows_t, up)) if isinstance(up, tuple) else rows_t(up)
    dw = _pair_mm(u_rows, tuple(t.reshape(-1, t.shape[-1]) for t in dp), dw_terms)
    return du, dw, dproj.sum((0, 1)), dwc, dconv.sum((0, 2))


def wgmma_probe(a, b, mode: int):
    """`csrc/wgmma.cuh` alone on the card: a (64, 64) @ b[:, :N] for bf16 a,
    b (64, 64), as `hyena_front_wgmma_probe` loads and multiplies them in
    the layout of one of the kernels' products (`mode`, `PROBE_MODES`).
    Returns the (64, N) float32 product."""
    if not (_cuda.on_card(a) and a.shape == b.shape == (64, 64) and b.device == a.device
            and a.dtype == b.dtype == torch.bfloat16 and a.is_contiguous()
            and b.is_contiguous() and mode in PROBE_MODES):
        raise ValueError("wgmma_probe takes two contiguous (64, 64) bf16 CUDA tensors and a "
                         "PROBE_MODES key")
    c = torch.empty(64, PROBE_MODES[mode], device=a.device, dtype=torch.float32)
    KERNEL.launch("hyena_front_wgmma_probe", _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(c), mode,
                  _cuda.stream_handle(a), device=a.device)
    return c


def _check(out_shape=None, **tensors) -> str:
    """Raise on what kernels A, A', A4 and A4' do not take; return the C
    entry point's dtype suffix. u is (B, L, d_in) and W (d_in, 3 d_c), any
    d_c; the activations (u, dvx, dx0) are all float32 or all bfloat16, the
    parameters float32; the cotangents have `out_shape` per batch row,
    (d_c, L) when None."""
    u, w = tensors["u"], tensors["w"]
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, d_in), got {tuple(u.shape)}")
    if u.dtype not in _SUFFIX:
        raise TypeError(f"kernels A and A' take float32 or bfloat16 u; u is {u.dtype}")
    b, length, d_in = u.shape
    if w.dim() != 2 or w.shape[0] != d_in or w.shape[1] % 3 or w.shape[1] == 0:
        raise ValueError(f"w must be (d_in, 3 d_c) with d_in={d_in}, got {tuple(w.shape)}")
    d = w.shape[1] // 3
    cot = (b,) + tuple(out_shape or (d, length))
    expect = {"bp": (3 * d,), "wc": (3, 3 * d), "bc": (3 * d,), "dvx": cot, "dx0": cot}
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        want = u.dtype if name in ("u", "dvx", "dx0") else torch.float32
        if t.dtype != want:
            raise TypeError(f"kernels A and A' take {name} in {want} with u in {u.dtype}; "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _SUFFIX[u.dtype]


def front_fwd(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx, x0): kernel A on a CUDA tensor, `reference_fwd` on a CPU one."""
    if not _cuda.on_card(u):
        return reference_fwd(u, w, bp, wc, bc)
    suffix = _check(u=u, w=w, bp=bp, wc=wc, bc=bc)
    b, length, d_in = u.shape
    d = w.shape[1] // 3
    vx = torch.empty((b, d, length), device=u.device, dtype=u.dtype)
    x0 = torch.empty_like(vx)
    KERNEL.launch("hyena_fused_front_fwd" + suffix,
                  *map(_cuda.ptr, (u, w, bp, wc, bc, vx, x0) + _w_split(KERNEL, u, d)),
                  b, length, d_in, d, _cuda.stream_handle(u), device=u.device)
    return vx, x0


def front_bwd(u, w, bp, wc, bc, dvx, dx0):
    """(du, dw, dbp, dwc, dbc): kernel A' on a CUDA tensor, `reference_bwd`
    on a CPU one."""
    if not _cuda.on_card(u):
        return reference_bwd(u, w, bp, wc, bc, dvx, dx0)
    suffix = _check(u=u, w=w, bp=bp, wc=wc, bc=bc, dvx=dvx, dx0=dx0)
    b, length, d_in = u.shape
    d = w.shape[1] // 3
    du = torch.empty_like(u)
    dw, dparams, scratch, sizes = _bwd_buffers(KERNEL_BWD, u, d)
    KERNEL_BWD.launch("hyena_fused_front_bwd" + suffix,
                      *map(_cuda.ptr, (u, w, bp, wc, bc, dvx, dx0, du, dw, dparams) + scratch),
                      b, length, d_in, d, *sizes, _cuda.stream_handle(u), device=u.device)
    return du, dw, dparams[0], dparams[1:4], dparams[4]


def _w_split(kernel, u, d) -> tuple:
    """The kernels' split-W scratch for W (d_in, 3 d), d_in u's width, as a
    1-tuple, sized by `kernel`'s C helper (the layout lives in
    `csrc/fused_front_tc.cuh`)."""
    numel = kernel.query("hyena_front_ws_numel", u.shape[-1], d, device=u.device)
    return (torch.empty(numel, device=u.device, dtype=torch.bfloat16),)


def _bwd_buffers(kernel, u, d):
    """Kernel A' (A4')'s outputs dw (d_in, 3d) and dparams (5, 3d) for a
    chunk width d, its scratch in its C entry's order, (ws, part, dwpart),
    and its trailing sizes, (runs,): runs from `kernel`'s C helper (it
    depends on B, L, d_in and d alone, not on u's dtype)."""
    b, length, d_in = u.shape
    new = lambda *shape: torch.empty(shape, device=u.device, dtype=torch.float32)
    dw, dparams = new(d_in, 3 * d), new(5, 3 * d)
    runs = kernel.query("hyena_front_bwd_runs", b, length, d_in, d, device=u.device)
    scratch = _w_split(kernel, u, d) + (new(runs * 5 * 3 * d), new(runs, d_in, 3 * d))
    return dw, dparams, scratch, (runs,)


class FusedProjConvGate(torch.autograd.Function):
    """Kernel A forward, kernel A' backward; saves (u, w, bp, wc, bc)."""

    @staticmethod
    def forward(ctx, u, w, bp, wc, bc):
        ctx.save_for_backward(u, w, bp, wc, bc)
        return front_fwd(u, w, bp, wc, bc)

    @staticmethod
    def backward(ctx, dvx, dx0):
        u, w, bp, wc, bc = ctx.saved_tensors
        return front_bwd(u, w, bp, wc, bc, dvx.contiguous(), dx0.contiguous())


def fused_proj_conv_gate(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx, x0) of the fused front end, differentiable in every input.

    u: (B, L, d_in); w: (d_in, 3 d_c); bp: (3 d_c,); wc: (3, 3 d_c) conv
    taps, time-major (wc[j] multiplies proj[t-2+j]); bc: (3 d_c,). Returns
    two (B, d_c, L) tensors in u's dtype.
    """
    return FusedProjConvGate.apply(u, w, bp, wc, bc)


def check_plan4(length: int, rows_pad: int, m: int, tile_l: int) -> None:
    """Raise unless (rows_pad, m, tile_l) fit L as the Pallas kernels
    `_fwd_pallas4` / `_bwd_pallas4` needed: whole length tiles
    (L % tile_l == 0), tiles of whole rows (tile_l % m == 0) that divide the
    padded length lp = rows_pad * m >= L, and 8-row output blocks
    (8 % (tile_l // m) == 0, rows_pad % 8 == 0)."""
    lp = rows_pad * m
    for ok, what in ((tile_l > 0 and length % tile_l == 0, "L % tile_l == 0"),
                     (m > 0 and tile_l % m == 0, "tile_l % m == 0"),
                     (lp % tile_l == 0, "(rows_pad * m) % tile_l == 0"),
                     (lp >= length, "rows_pad * m >= L"),
                     (tile_l >= m and 8 % (tile_l // m) == 0, "8 % (tile_l // m) == 0"),
                     (rows_pad % 8 == 0, "rows_pad % 8 == 0")):
        if not ok:
            raise ValueError(f"the 4-D front end needs {what}; got L={length}, "
                             f"rows_pad={rows_pad}, m={m}, tile_l={tile_l}")


def reference_fwd4(u, w, bp, wc, bc, rows_pad: int, m: int):
    """Plain version of kernel A4: `reference_fwd`, zero-padded to
    lp = rows_pad * m and viewed as (B, d_c, rows_pad, m)."""
    vx, x0 = reference_fwd(u, w, bp, wc, bc)
    pad = lambda t: F.pad(t, (0, rows_pad * m - t.shape[-1])).reshape(
        *t.shape[:2], rows_pad, m)
    return pad(vx), pad(x0)


def reference_bwd4(u, w, bp, wc, bc, dvx4, dx04):
    """Plain version of kernel A4': `reference_bwd` on the cotangents'
    first L times (W (d_in, 3 d_c), the cotangents (B, d_c, rows_pad, m))."""
    b, length = u.shape[:2]
    d = w.shape[1] // 3
    cut = lambda t: t.reshape(b, d, -1)[..., :length]
    return reference_bwd(u, w, bp, wc, bc, cut(dvx4), cut(dx04))


def front4_fwd(u, w, bp, wc, bc, rows_pad: int, m: int):
    """(vx4, x04) (B, d_c, rows_pad, m): kernel A4 on a CUDA tensor,
    `reference_fwd4` on a CPU one."""
    if not _cuda.on_card(u):
        return reference_fwd4(u, w, bp, wc, bc, rows_pad, m)
    suffix = _check(u=u, w=w, bp=bp, wc=wc, bc=bc)
    b, length, d_in = u.shape
    d = w.shape[1] // 3
    vx4 = torch.empty((b, d, rows_pad, m), device=u.device, dtype=u.dtype)
    x04 = torch.empty_like(vx4)
    KERNEL4.launch("hyena_fused_front4_fwd" + suffix,
                   *map(_cuda.ptr, (u, w, bp, wc, bc, vx4, x04) + _w_split(KERNEL4, u, d)),
                   b, length, rows_pad * m, d_in, d, _cuda.stream_handle(u), device=u.device)
    return vx4, x04


def front4_bwd(u, w, bp, wc, bc, dvx4, dx04):
    """(du, dw, dbp, dwc, dbc) from 4-D cotangents: kernel A4' on a CUDA
    tensor, `reference_bwd4` on a CPU one."""
    if not _cuda.on_card(u):
        return reference_bwd4(u, w, bp, wc, bc, dvx4, dx04)
    suffix = _check(dvx4.shape[1:], u=u, w=w, bp=bp, wc=wc, bc=bc, dvx=dvx4, dx0=dx04)
    b, length, d_in = u.shape
    d = w.shape[1] // 3
    lp = dvx4.shape[2] * dvx4.shape[3]
    if lp < length:
        raise ValueError(f"cotangents hold {lp} times, fewer than L={length}")
    du = torch.empty_like(u)
    dw, dparams, scratch, sizes = _bwd_buffers(KERNEL4_BWD, u, d)
    KERNEL4_BWD.launch("hyena_fused_front4_bwd" + suffix,
                       *map(_cuda.ptr, (u, w, bp, wc, bc, dvx4, dx04, du, dw, dparams) + scratch),
                       b, length, lp, d_in, d, *sizes, _cuda.stream_handle(u), device=u.device)
    return du, dw, dparams[0], dparams[1:4], dparams[4]


class FusedProjConvGate4(torch.autograd.Function):
    """Kernel A4 forward, kernel A4' backward; saves (u, w, bp, wc, bc)."""

    @staticmethod
    def forward(ctx, u, w, bp, wc, bc, rows_pad, m):
        ctx.save_for_backward(u, w, bp, wc, bc)
        return front4_fwd(u, w, bp, wc, bc, rows_pad, m)

    @staticmethod
    def backward(ctx, dvx4, dx04):
        u, w, bp, wc, bc = ctx.saved_tensors
        return (*front4_bwd(u, w, bp, wc, bc, dvx4.contiguous(), dx04.contiguous()),
                None, None)


def fused_proj_conv_gate4(u, w, bp, wc, bc, rows_pad: int, m: int,
                          tile_l: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx4, x04), each (B, d_c, rows_pad, m) in u's dtype and zero past L,
    differentiable in every tensor input; the arguments otherwise as
    `fused_proj_conv_gate`. Raises unless `check_plan4` accepts
    (L, rows_pad, m, tile_l)."""
    check_plan4(u.shape[1], rows_pad, m, tile_l)
    return FusedProjConvGate4.apply(u, w, bp, wc, bc, rows_pad, m)
