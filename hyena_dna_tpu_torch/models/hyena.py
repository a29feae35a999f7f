"""HyenaOperator, order 2 (mirrors `hyena_dna_tpu/models/hyena.py`).

The path is the JAX package's fused-front route (`_try_pallas_front`):

  u (B, L, d) --kernel A: in_proj + causal k=3 conv + first gate-->
  vx = v * x1, x0 (B, d, L) --dropout on vx--> --filter bank k (d, L)-->
  y = (causal_conv(vx, k) + vx * bias) * x0 --kernel B-->
  (B, L, d) --activation, out_proj--> (B, L, d)

Activations run in `dtype`: in bfloat16, u enters kernel A in bf16 and vx,
x0 come out in bf16 (the Pallas kernel's `out_dtype = u.dtype`), the gated
conv's result is cast back to bf16 and `out_proj` is a bf16 product; the
parameters stay float32.

On a CUDA tensor kernels A and B run forward and kernels A' and C backward
(`ops/fused_front.py`, `ops/fused_fftconv.py`, through their
`autograd.Function`s); the second gate is a plain multiply that autograd
differentiates, as in the JAX composite route. With `gated_conv` set to a
mode of `ops.fftconv.GATED_MODES` ("specv", "spec", "retransform"), the
post-gate rides the conv instead: kernel E forward and kernel E' backward
on that mode's route, where `gated_plan` covers the shape (as
`HYENA_GATED_CONV=1` and `HYENA_GATED_MODE` do for the JAX package; off by
default there and here). On a CPU tensor the same calls run their plain
versions. Kernel A takes any L (the Pallas front
needed L % 32 == 0). Whatever `dtype`, from L = 2^15 the conv I/O (signal,
gate, filter bank) is bfloat16 as on the TPU (`CONV_IO_BF16_MIN_L`), and
below it float32; the transforms run in float32. When L exceeds
`l_max` only the filter is cut to `l_max` (a causal conv with a shorter
filter), as in the JAX package.

Parameter names are the reference torch names: `in_proj`, `out_proj`,
`short_filter` (a depthwise Conv1d weight (3d, 1, 3)) and `filter_fn`.
"""

from __future__ import annotations

import torch
from torch import nn

from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.nn import activation_fn, dropout, linear
from hyena_dna_tpu_torch.ops.fftconv import GATED_MODES, fftconv_gated
from hyena_dna_tpu_torch.ops.fused_front import fused_proj_conv_gate

CONV_IO_BF16_MIN_L = 1 << 15


class HyenaOperator(nn.Module):
    def __init__(self, d_model: int, l_max: int, order: int = 2,
                 filter_order: int = 64, short_filter_order: int = 3,
                 activation: str = "id", filter_cfg: dict | None = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 gated_conv: str | None = None):
        super().__init__()
        self.dtype = dtype
        if gated_conv not in (None,) + GATED_MODES:
            raise ValueError(f"gated_conv={gated_conv!r} is not None or one of {GATED_MODES}")
        self.gated_conv = gated_conv
        if order != 2:
            raise NotImplementedError(
                "only order-2 Hyena is ported (ROADMAP.md Queue 1 item 4)")
        if short_filter_order != 3:
            raise NotImplementedError("kernel A fuses a k=3 short conv only")
        self.d_model = d_model
        self.l_max = l_max
        width = 3 * d_model
        self.in_proj = nn.Linear(d_model, width)
        self.out_proj = nn.Linear(d_model, d_model)
        self.short_filter = nn.Conv1d(width, width, 3, groups=width, padding=2)
        self.filter_fn = HyenaFilter(d_model, order=filter_order, seq_len=l_max,
                                     **(filter_cfg or {}))
        self.act = activation_fn(activation)
        self.dropout = dropout

    def forward(self, u: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """u: (B, L, d) in `dtype` -> (B, L, d) in `dtype`; `generator`
        draws the dropout mask in training."""
        l_filter = min(u.shape[1], self.l_max)
        w = self.in_proj.weight.float().t().contiguous()          # (d, 3d)
        bp = self.in_proj.bias.float().contiguous()
        wc = self.short_filter.weight[:, 0, :].float().t().contiguous()  # (3, 3d)
        bc = self.short_filter.bias.float().contiguous()
        vx, x0 = fused_proj_conv_gate(u.contiguous(), w, bp, wc, bc)
        vx = dropout(vx, self.dropout, self.training, generator)
        conv_dt = torch.bfloat16 if l_filter >= CONV_IO_BF16_MIN_L else torch.float32
        k = self.filter_fn.filter(l_filter, out_dtype=conv_dt)[0].t().contiguous()
        y = fftconv_gated(vx.to(conv_dt), x0.to(conv_dt), k,
                          self.filter_fn.bias.float().contiguous(),
                          self.gated_conv).to(u.dtype)
        return linear(self.act(y.transpose(1, 2)), self.out_proj, self.dtype)
