"""Fused Hyena front end: kernel A (`csrc/fused_front.cu`) and its plain version.

Counterpart of `hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate`
(forward only; the backward comes with the training slice):

  u (B, L, d) --u @ W + bp--> (B, L, 3d) --causal k=3 depthwise conv + bc-->
  split [x0 | x1 | v] --> vx = v * x1, x0, both channel-major (B, d, L).

On a CUDA tensor the wrapper launches kernel A (float32 only) or raises; on a
CPU tensor it runs `reference_fwd`, the math of the JAX `_reference_fwd`.
Unlike the Pallas kernel, which needs L % tile == 0, kernel A takes any L.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d

KERNEL = _cuda.Kernel("fused_front", {
    "hyena_fused_front_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p],
})


def reference_fwd(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (JAX `pallas_hyena._reference_fwd`)."""
    proj = u @ w.to(u.dtype) + bp.to(u.dtype)  # (B, L, 3d)
    proj_t = proj.transpose(-1, -2).float()  # (B, 3d, L)
    conv = short_conv_1d(proj_t, wc.transpose(0, 1), bc)
    d = conv.shape[1] // 3
    x0, x1, v = conv[:, :d], conv[:, d:2 * d], conv[:, 2 * d:]
    return (v * x1).to(u.dtype), x0.to(u.dtype)


def _check(u, w, bp, wc, bc):
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, d), got {tuple(u.shape)}")
    d = u.shape[-1]
    expect = {"w": (d, 3 * d), "bp": (3 * d,), "wc": (3, 3 * d), "bc": (3 * d,)}
    for name, t in {"u": u, "w": w, "bp": bp, "wc": wc, "bc": bc}.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel A takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_proj_conv_gate(u, w, bp, wc, bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx, x0) of the fused front end.

    u: (B, L, d); w: (d, 3d); bp: (3d,); wc: (3, 3d) conv taps, time-major
    (wc[j] multiplies proj[t-2+j]); bc: (3d,). Returns two (B, d, L) tensors
    in u's dtype.
    """
    if u.device.type == "cpu":
        return reference_fwd(u, w, bp, wc, bc)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    _check(u, w, bp, wc, bc)
    b, length, d = u.shape
    vx = torch.empty((b, d, length), device=u.device, dtype=u.dtype)
    x0 = torch.empty_like(vx)
    KERNEL.launch("hyena_fused_front_fwd", *map(_cuda.ptr, (u, w, bp, wc, bc, vx, x0)),
                  b, length, d, _cuda.stream_handle(u))
    return vx, x0
