"""Fused transformer MLP: kernels F and F' and their plain versions.

Counterpart of `hyena_dna_tpu/ops/pallas_mlp.py::mlp_fused` (TPU rows
26-27), on the JAX layout:

  y = gelu_tanh(x @ w1 + b1) @ w2 + b2,  x (N, d), w1 (d, dh), w2 (dh, d_out)

y comes out in x's dtype. Every product rounds its inputs to bf16 and sums
in float32, as the JAX `_mm` does, also for float32 x; the bias adds, the
tanh-GeLU and its derivative run in float32, and db1 sums the unrounded
float32 dh. The backward recomputes pre and h; dw1, db1, dw2 and db2 are
float32 (cast to the parameters' dtype), dx is in x's dtype.

`mlp_fused` is the `torch.autograd.Function` `MlpFused`: on a CUDA tensor
kernel F (`csrc/mlp_fused.cu`) forward and kernel F' (`csrc/mlp_fused_bwd.cu`)
backward, which keep the (N, dh) hidden out of device memory and run every
product on the tensor cores (`wgmma`); on a CPU tensor their plain versions
`mlp_fused_ref` and `mlp_fused_bwd_ref`. Float32 x and dy are rounded to
bf16 once per call, by the C entry, into scratch this module allocates
(`_bf16_scratch`); F''s partial-sum workspace is sized by its library's C
helper `hyena_mlp_bwd_ws_numel`. db2 = sum(dy) is a torch reduction on both,
as the JAX wrapper computes it outside its kernel.
`models/blocks.py::Mlp(use_fused=True)` takes this route under the JAX rule
(`applies`).
"""

from __future__ import annotations

import ctypes

import torch

from hyena_dna_tpu_torch import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _cuda.Kernel("mlp_fused", {"hyena_mlp_fwd": [_P] * 7 + [_I] * 5 + [_P],
                                    "hyena_mlp_wgmma_probe": [_P] * 3 + [_I, _P]})
KERNEL_BWD = _cuda.Kernel("mlp_fused_bwd", {"hyena_mlp_bwd": [_P] * 10 + [_I] * 5 + [_P],
                                            "hyena_mlp_bwd_ws_numel": [_I] * 3})
TILE = 64  # the unit of N, d, dh and d_out in kernels F and F'
# wgmma_probe's modes and the width N of each one's product: form m // 3 (0:
# b MN-major across panels, 1: b K-major, 2: a and b MN-major) at N = 64 (2 +
# m % 3) (csrc/mlp_fused.cu::hyena_mlp_wgmma_probe)
PROBE_MODES = {m: 64 * (2 + m % 3) for m in range(9)}
_C0 = 0.7978845608028654  # sqrt(2 / pi)
_C1 = 0.044715


def applies(n: int, d: int, dh: int, d_out: int) -> bool:
    """The JAX `Mlp` rule for the fused kernel (`blocks.py:150-165`): N a
    multiple of 128 (`_pick_tile`), and d, dh, d_out multiples of 128."""
    return n % 128 == 0 and d % 128 == 0 and dh % 128 == 0 and d_out % 128 == 0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_C0 * (x + _C1 * x * x * x)))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_C0 * (x + _C1 * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _C0 * (1.0 + 3.0 * _C1 * x * x)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 inputs, float32 sums (JAX `pallas_mlp._mm`): the bf16 values
    multiplied in float32, which holds their products exactly."""
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def mlp_fused_ref(x, w1, b1, w2, b2):
    """Plain version of kernel F: y (N, d_out) in x's dtype."""
    h = gelu_tanh(_mm(x, w1) + b1.float())
    return (_mm(h, w2) + b2.float()).to(x.dtype)


def mlp_fused_bwd_ref(x, dy, w1, b1, w2):
    """Plain version of kernel F' and the db2 sum: (dx in x's dtype, dw1,
    db1, dw2, db2 float32)."""
    pre = _mm(x, w1) + b1.float()
    dh = _mm(dy, w2.t()) * gelu_tanh_grad(pre)
    dx = _mm(dh, w1.t()).to(x.dtype)
    return (dx, _mm(x.t(), dh), dh.sum(0), _mm(gelu_tanh(pre).t(), dy),
            dy.float().sum(0))


def _check(x, w1, b1, w2, b2=None, dy=None):
    """Raise unless the arguments fit kernels F and F'."""
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"need x (N, d), w1 (d, dh), w2 (dh, d_out); got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    n, d = x.shape
    dh, d_out = w1.shape[1], w2.shape[1]
    want = {"w1": (d, dh), "b1": (dh,), "w2": (dh, d_out), "b2": (d_out,), "dy": (n, d_out)}
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2), ("dy", dy)):
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or (dy is not None and dy.dtype != x.dtype):
        raise TypeError(f"kernels F and F' take x (and dy) float32 or bfloat16 alike; got "
                        f"{x.dtype}{'' if dy is None else ', ' + str(dy.dtype)}")
    if n % TILE or d % TILE or dh % TILE or d_out % TILE:
        raise ValueError(f"kernels F and F' take N, d, dh, d_out in multiples of {TILE}; got "
                         f"{n}, {d}, {dh}, {d_out}")


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16).contiguous()


def _bf16_scratch(t: torch.Tensor):
    """Scratch for the C entry's bf16 copy of a float32 x or dy, rounded once
    per call on the card; None for a bf16 tensor, which the kernels read as
    it is."""
    if t.dtype == torch.bfloat16:
        return None
    return torch.empty(t.shape, device=t.device, dtype=torch.bfloat16)


def _workspace(numel: int, d: int, dh: int, d_out: int, device):
    """F''s partial-sum workspace, `numel` floats as `hyena_mlp_bwd_ws_numel`
    gives it (a whole number of (d dh + dh d_out + dh) sums of dw1, dw2 and
    db1), and the buffer the kernel sums them into; raises for a size the C
    helper refuses (-1: past an int)."""
    total = d * dh + dh * d_out + dh
    if numel <= 0 or numel % total:
        raise ValueError(f"kernel F' has no workspace of {numel} floats for d={d}, dh={dh}, "
                         f"d_out={d_out}")
    f32 = dict(device=device, dtype=torch.float32)
    return torch.empty(numel, **f32), torch.empty(total, **f32)


def _aligned(*tensors) -> None:
    """The kernels move 16 bytes at a time: raise for a misaligned pointer."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernels F and F' need 16-byte aligned tensors")


def wgmma_probe(a, b, mode: int):
    """The `wgmma` product forms kernels F and F' add to `csrc/wgmma.cuh`,
    alone on the card: a (64, 64) @ b[:, :N] for bf16 a (64, 64) and b (64,
    256), as `hyena_mlp_wgmma_probe` loads and multiplies them in the layout
    of one of the kernels' products (`mode`, `PROBE_MODES`). Returns the
    (64, N) float32 product."""
    if not (_cuda.on_card(a) and a.shape == (64, 64) and b.shape == (64, 256)
            and b.device == a.device and a.dtype == b.dtype == torch.bfloat16
            and a.is_contiguous() and b.is_contiguous() and mode in PROBE_MODES):
        raise ValueError("wgmma_probe takes contiguous bf16 CUDA tensors a (64, 64), b (64, 256) "
                         "and a PROBE_MODES key")
    c = torch.empty(64, PROBE_MODES[mode], device=a.device, dtype=torch.float32)
    KERNEL.launch("hyena_mlp_wgmma_probe", _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(c), mode,
                  _cuda.stream_handle(a), device=a.device)
    return c


def mlp_fused_fwd(x, w1, b1, w2, b2):
    """y (N, d_out) in x's dtype: kernel F on a CUDA tensor, `mlp_fused_ref`
    on a CPU one."""
    if not _cuda.on_card(x):
        return mlp_fused_ref(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    x = x.contiguous()
    n, d = x.shape
    dh, d_out = w1.shape[1], w2.shape[1]
    y = torch.empty((n, d_out), device=x.device, dtype=x.dtype)
    w1b, w2b = _bf16(w1), _bf16(w2)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    _aligned(x, w1b, w2b, b1f, b2f, y)
    KERNEL.launch("hyena_mlp_fwd", *map(_cuda.ptr, (x, w1b, b1f, w2b, b2f, y)),
                  _cuda.ptr_or_null(_bf16_scratch(x)), n, d, dh, d_out,
                  int(x.dtype == torch.bfloat16), _cuda.stream_handle(x), device=x.device)
    return y


def mlp_fused_bwd(x, dy, w1, b1, w2):
    """(dx in x's dtype, dw1, db1, dw2, db2 float32): kernel F' on a CUDA
    tensor (db2 a torch sum), `mlp_fused_bwd_ref` on a CPU one."""
    if not _cuda.on_card(x):
        return mlp_fused_bwd_ref(x, dy, w1, b1, w2)
    _check(x, w1, b1, w2, dy=dy)
    x, dy = x.contiguous(), dy.contiguous()
    n, d = x.shape
    dh, d_out = w1.shape[1], w2.shape[1]
    dx = torch.empty_like(x)
    numel = KERNEL_BWD.query("hyena_mlp_bwd_ws_numel", d, dh, d_out, device=x.device)
    part, grads = _workspace(numel, d, dh, d_out, x.device)
    w1b, w2b = _bf16(w1), _bf16(w2)
    b1f = b1.float().contiguous()
    _aligned(x, dy, w1b, w2b, b1f)
    KERNEL_BWD.launch("hyena_mlp_bwd", *map(_cuda.ptr, (x, dy, w1b, b1f, w2b, dx)),
                      *map(_cuda.ptr_or_null, (_bf16_scratch(x), _bf16_scratch(dy))),
                      _cuda.ptr(part), _cuda.ptr(grads), n, d, dh, d_out,
                      int(x.dtype == torch.bfloat16), _cuda.stream_handle(x), device=x.device)
    dw1, dw2, db1 = grads.split((d * dh, dh * d_out, dh))
    # db2 summed in float32 straight from dy, with no float32 copy of a bf16 dy
    return dx, dw1.view(d, dh), db1, dw2.view(dh, d_out), dy.sum(0, dtype=torch.float32)


class MlpFused(torch.autograd.Function):
    """Kernel F forward, kernel F' backward; saves (x, w1, b1, w2)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return mlp_fused_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_fused_bwd(x, dy.to(x.dtype), w1, b1, w2)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype)


def mlp_fused(x, w1, b1, w2, b2):
    """y = gelu_tanh(x @ w1 + b1) @ w2 + b2 on the JAX layout (x (N, d),
    w1 (d, dh), w2 (dh, d_out)), differentiable in all five."""
    return MlpFused.apply(x, w1, b1, w2, b2)
