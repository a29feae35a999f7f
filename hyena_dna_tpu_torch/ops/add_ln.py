"""Fused residual-add + LayerNorm: kernels D and D' and their plain versions.

Counterpart of `hyena_dna_tpu/ops/pallas_ln.py` (the TPU analog of
flash-attn's `dropout_add_layer_norm`), the "add -> LN" unit of every
prenorm block after the first and of the final `ln_f`:

  res_out = (f32(h) + f32(res)) rounded once to the residual dtype
  y       = LN(res_out) with float32 statistics of the ROUNDED res_out,
            times scale plus bias, in `out_dtype`

`add_ln` is the dispatcher. It takes the fused unit exactly where the JAX
dispatcher could: a bfloat16 residual stream with bfloat16 output. There it
runs `AddLayerNorm`, a `torch.autograd.Function` whose forward is kernel D
and whose backward is kernel D' (`csrc/add_ln.cu`, `csrc/add_ln_bwd.cu`)
on a CUDA tensor, and on a CPU tensor their plain versions `add_ln_ref` and
`add_ln_bwd_ref` (the JAX `_bwd`, written out, not autograd). Every other call (a float32
residual, as in every hg38 config) takes `add_ln_ref` under autograd, as
the JAX dispatcher takes `_add_ln_ref`; the route is chosen from dtypes
before anything launches. The JAX knob `HYENA_FUSED_ADD_LN` records a TPU
measurement against XLA's fusion and is not read here: eager PyTorch has no
such fusion.

The backward recomputes mean and rstd from res_out and emits one d_total,
the gradient of both h and res (res_out = h + res); dscale and dbias are
float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from hyena_dna_tpu_torch import _cuda

KERNEL = _cuda.Kernel("add_ln", {
    "hyena_add_ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_void_p],
})
KERNEL_BWD = _cuda.Kernel("add_ln_bwd", {
    "hyena_add_ln_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_void_p],
})
WIDTHS = (64, 128, 256, 512, 768, 1024)  # d that kernels D and D' take
BWD_MAX_BLOCKS = 1024  # kernel D''s fixed grid: partial dscale/dbias rows
ROWS_PER_BLOCK = 8  # one row per warp, eight warps per block


def add_ln_ref(h, res, weight, bias, eps: float = 1e-5, out_dtype=torch.bfloat16,
               res_dtype=torch.bfloat16):
    """Plain version (JAX `pallas_ln._add_ln_ref`): (y, res_out)."""
    res_out = (h.float() + res.float()).to(res_dtype)
    y = F.layer_norm(res_out.float(), res_out.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(out_dtype), res_out


def add_ln_bwd_ref(res_out, dy, dres_up, weight, eps: float = 1e-5):
    """Plain backward (JAX `pallas_ln._bwd`): (d_total in res_out's dtype,
    dscale, dbias float32). dy and dres_up are first cast to res_out's
    dtype, as the TPU kernel's inputs were."""
    x = res_out.float()
    dy = dy.to(res_out.dtype).float()
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    x_hat = xc * rstd
    dyw = dy * weight.float()
    m1 = dyw.mean(-1, keepdim=True)
    m2 = (dyw * x_hat).mean(-1, keepdim=True)
    d_total = rstd * (dyw - m1 - x_hat * m2) + dres_up.to(res_out.dtype).float()
    rows = tuple(range(dy.dim() - 1))
    return d_total.to(res_out.dtype), (dy * x_hat).sum(rows), dy.sum(rows)


def _check(x, weight, bias=None, **rows):
    n, d = x.shape
    if d not in WIDTHS:
        raise ValueError(f"kernels D and D' take d in {WIDTHS}, got {d}")
    for name, t in {"x": x, **rows}.items():
        if t.shape != (n, d) or t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 {(n, d)}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (d,) or t.dtype != torch.float32):
            raise TypeError(f"{name} must be float32 ({d},), got {t.dtype} {tuple(t.shape)}")
    for name, t in {"x": x, **rows, "weight": weight, "bias": bias}.items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def add_ln_fwd(h, res, weight, bias, eps: float):
    """(y, res_out), both bf16 (N, d): kernel D on a CUDA tensor,
    `add_ln_ref` on a CPU one."""
    if not _cuda.on_card(h):
        return add_ln_ref(h, res, weight, bias, eps)
    _check(h, weight, bias, res=res)
    n, d = h.shape
    y, res_out = torch.empty_like(h), torch.empty_like(h)
    KERNEL.launch("hyena_add_ln_fwd", *map(_cuda.ptr, (h, res, weight, bias, y, res_out)),
                  n, d, eps, _cuda.stream_handle(h), device=h.device)
    return y, res_out


def add_ln_bwd(res_out, dy, dres_up, weight, eps: float):
    """(d_total bf16 (N, d), dscale, dbias float32 (d,)): kernel D' on a
    CUDA tensor, `add_ln_bwd_ref` on a CPU one."""
    if not _cuda.on_card(res_out):
        return add_ln_bwd_ref(res_out, dy, dres_up, weight, eps)
    _check(res_out, weight, dy=dy, dres_up=dres_up)
    n, d = res_out.shape
    blocks = min(-(-n // ROWS_PER_BLOCK), BWD_MAX_BLOCKS)
    d_total = torch.empty_like(res_out)
    new = lambda *shape: torch.empty(shape, device=res_out.device, dtype=torch.float32)
    dparams, part = new(2, d), new(blocks, 2, d)
    KERNEL_BWD.launch("hyena_add_ln_bwd",
                      *map(_cuda.ptr, (res_out, dy, dres_up, weight, d_total, dparams, part)),
                      n, d, blocks, eps, _cuda.stream_handle(res_out), device=res_out.device)
    return d_total, dparams[0], dparams[1]


class AddLayerNorm(torch.autograd.Function):
    """Kernel D forward, kernel D' backward on bf16 (N, d) rows; saves
    (res_out, weight)."""

    @staticmethod
    def forward(ctx, h, res, weight, bias, eps):
        y, res_out = add_ln_fwd(h, res, weight, bias, eps)
        ctx.save_for_backward(res_out, weight)
        ctx.eps = eps
        return y, res_out

    @staticmethod
    def backward(ctx, dy, dres_up):
        res_out, weight = ctx.saved_tensors
        cast = lambda g: g.to(res_out.dtype).contiguous()
        d_total, dscale, dbias = add_ln_bwd(res_out, cast(dy), cast(dres_up), weight, ctx.eps)
        return d_total, d_total, dscale, dbias, None


def add_ln(h, res, weight, bias, eps: float = 1e-5, out_dtype=torch.bfloat16,
           res_dtype=torch.bfloat16):
    """(y, res_out) over the last axis, differentiable in h, res, weight and
    bias. A bf16 residual with bf16 output goes through `AddLayerNorm`
    (kernels D and D'), the rest through `add_ln_ref`."""
    if not (res_dtype == torch.bfloat16 and out_dtype == torch.bfloat16):
        return add_ln_ref(h, res, weight, bias, eps, out_dtype, res_dtype)
    lead, d = h.shape[:-1], h.shape[-1]
    y, res_out = AddLayerNorm.apply(h.reshape(-1, d).to(torch.bfloat16).contiguous(),
                                    res.reshape(-1, d).to(torch.bfloat16).contiguous(),
                                    weight, bias, eps)
    return y.reshape(*lead, d), res_out.reshape(*lead, d)


def add_ln_fused(h, res, scale, bias, eps: float, out_dtype=torch.bfloat16):
    """JAX `pallas_ln.py::add_ln_fused` (TPU rows 24-25) on its contract:
    2-D (N, d) h and res, (y in `out_dtype`, res_out in res's dtype),
    differentiable through `AddLayerNorm` (kernels D and D' on a CUDA
    tensor). Kernels D and D' take bfloat16 h, res and y; other dtypes
    raise here on every device."""
    if h.dim() != 2 or res.shape != h.shape:
        raise ValueError(f"add_ln_fused takes 2-D (N, d) h and res; got {tuple(h.shape)}, "
                         f"{tuple(res.shape)}")
    if not h.dtype == res.dtype == out_dtype == torch.bfloat16:
        raise TypeError(f"kernels D and D' take bfloat16 h, res and output; got h {h.dtype}, "
                        f"res {res.dtype}, out {out_dtype}")
    return AddLayerNorm.apply(h.contiguous(), res.contiguous(), scale.float(), bias.float(), eps)
