"""Fused Hyena front end: kernels A and A' and their plain versions.

Counterpart of `hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate`
and its custom VJP:

  u (B, L, d) --u @ W + bp--> (B, L, 3d) --causal k=3 depthwise conv + bc-->
  split [x0 | x1 | v] --> vx = v * x1, x0, both channel-major (B, d, L).

`fused_proj_conv_gate` is the `torch.autograd.Function` `FusedProjConvGate`:
its forward is kernel A (`csrc/fused_front.cu`) and its backward kernel A'
(`csrc/fused_front_bwd.cu`), which recomputes the projection and conv and
emits du, dW, dbp, dwc and dbc. On a CUDA tensor each wrapper launches its
kernel (float32 only) or raises; on a CPU tensor it runs the plain version:
`reference_fwd` (the math of the JAX `_reference_fwd`) and `reference_bwd`
(the math of the JAX `_fpcg_bwd_xla`, written out, not autograd). Unlike the
Pallas kernels, which need L % tile == 0, kernels A and A' take any L.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d

KERNEL = _cuda.Kernel("fused_front", {
    "hyena_fused_front_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p],
})
KERNEL_BWD = _cuda.Kernel("fused_front_bwd", {
    "hyena_fused_front_bwd": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p],
})
# output times per length tile of kernel A' (`kOut` in csrc/fused_front_bwd.cu)
BWD_TILE = 60
# rows of B*L per split-K slice of kernel A''s dW product (at most 64 slices)
BWD_ROWS_PER_SLICE = 2048


def reference_fwd(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (JAX `pallas_hyena._reference_fwd`)."""
    proj = u @ w.to(u.dtype) + bp.to(u.dtype)  # (B, L, 3d)
    proj_t = proj.transpose(-1, -2).float()  # (B, 3d, L)
    conv = short_conv_1d(proj_t, wc.transpose(0, 1), bc)
    d = conv.shape[1] // 3
    x0, x1, v = conv[:, :d], conv[:, d:2 * d], conv[:, 2 * d:]
    return (v * x1).to(u.dtype), x0.to(u.dtype)


def reference_bwd(u, w, bp, wc, bc, dvx, dx0):
    """Plain PyTorch backward (JAX `pallas_hyena._fpcg_bwd_xla`): recompute
    the conv, form dconv = [dx0 | dvx * v | dvx * x1], apply the transposed
    conv, then the parameter and input grads. Returns (du in u's dtype; dw,
    dbp, dwc, dbc in float32)."""
    f32 = torch.float32
    proj = u.to(f32) @ w.to(f32) + bp.to(f32)  # (B, L, 3d)
    proj_t = proj.transpose(1, 2)  # (B, 3d, L)
    conv = short_conv_1d(proj_t, wc.t().to(f32), bc.to(f32))
    d = conv.shape[1] // 3
    x1, v = conv[:, d:2 * d], conv[:, 2 * d:]
    dvx = dvx.to(f32)
    dconv = torch.cat([dx0.to(f32), dvx * v, dvx * x1], dim=1)  # (B, 3d, L)
    # transpose of conv[t] = sum_j wc[j] proj[t-2+j]: dproj[s] = sum_j wc[j] dconv[s+2-j]
    # (dconv zero past L); dwc[j] = sum_t dconv[t] proj[t-2+j] (proj zero before 0)
    wc = wc.to(f32)
    length = dconv.shape[-1]
    dconv_r, proj_l = F.pad(dconv, (0, 2)), F.pad(proj_t, (2, 0))
    dproj_t = sum(dconv_r[..., 2 - j:2 - j + length] * wc[j][None, :, None] for j in range(3))
    dwc = torch.stack([(dconv * proj_l[..., j:j + length]).sum((0, 2)) for j in range(3)])
    dbc = dconv.sum((0, 2))
    dproj = dproj_t.transpose(1, 2)  # (B, L, 3d)
    du = (dproj @ w.to(f32).t()).to(u.dtype)
    dw = u.to(f32).reshape(-1, u.shape[-1]).t() @ dproj.reshape(-1, dproj.shape[-1])
    return du, dw, dproj.sum((0, 1)), dwc, dbc


def _check(**tensors):
    u = tensors["u"]
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, d), got {tuple(u.shape)}")
    b, length, d = u.shape
    expect = {"w": (d, 3 * d), "bp": (3 * d,), "wc": (3, 3 * d), "bc": (3 * d,),
              "dvx": (b, d, length), "dx0": (b, d, length)}
    for name, t in tensors.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernels A and A' take float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def front_fwd(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx, x0): kernel A on a CUDA tensor, `reference_fwd` on a CPU one."""
    if not _cuda.on_card(u):
        return reference_fwd(u, w, bp, wc, bc)
    _check(u=u, w=w, bp=bp, wc=wc, bc=bc)
    b, length, d = u.shape
    vx = torch.empty((b, d, length), device=u.device, dtype=u.dtype)
    x0 = torch.empty_like(vx)
    KERNEL.launch("hyena_fused_front_fwd", *map(_cuda.ptr, (u, w, bp, wc, bc, vx, x0)),
                  b, length, d, _cuda.stream_handle(u))
    return vx, x0


def front_bwd(u, w, bp, wc, bc, dvx, dx0):
    """(du, dw, dbp, dwc, dbc): kernel A' on a CUDA tensor, `reference_bwd`
    on a CPU one."""
    if not _cuda.on_card(u):
        return reference_bwd(u, w, bp, wc, bc, dvx, dx0)
    _check(u=u, w=w, bp=bp, wc=wc, bc=bc, dvx=dvx, dx0=dx0)
    b, length, d = u.shape
    tiles = -(-length // BWD_TILE)
    slices = max(1, min(64, b * length // BWD_ROWS_PER_SLICE))
    new = lambda *shape: torch.empty(shape, device=u.device, dtype=torch.float32)
    du, dw, dparams = new(b, length, d), new(d, 3 * d), new(5, 3 * d)
    dproj, part, dwpart = new(b * length * 3 * d), new(b * tiles * 5 * 3 * d), new(slices, d, 3 * d)
    KERNEL_BWD.launch("hyena_fused_front_bwd",
                      *map(_cuda.ptr, (u, w, bp, wc, bc, dvx, dx0, du, dw, dparams,
                                       dproj, part, dwpart)),
                      b, length, d, tiles, slices, _cuda.stream_handle(u))
    return du, dw, dparams[0], dparams[1:4], dparams[4]


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

    u: (B, L, d); w: (d, 3d); bp: (3d,); wc: (3, 3d) conv taps, time-major
    (wc[j] multiplies proj[t-2+j]); bc: (3d,). Returns two (B, d, L) tensors
    in u's dtype.
    """
    return FusedProjConvGate.apply(u, w, bp, wc, bc)
