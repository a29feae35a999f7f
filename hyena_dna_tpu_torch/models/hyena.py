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

With `front4` (the layer-config key `front4`; the JAX `HYENA_FRONT4=1`,
off by default there and here) the layer takes the 4-D conv-layout route
of the JAX `_try_front4` where it engages: order 2, the whole sequence
filtered (L <= l_max), an outer plan (n1, r, m) for the conv's fft size
(`ops/fused_fftconv.py::plan_outer`: fft 2^17-2^18 at odd B, 2^19-2^21 at
any B), a length tile in (512, 256, 128) that fits the plan
(`ops/fused_front.py::check_plan4`), L <= lp and rows_pad % 8 == 0. There
kernel A4 writes vx and x0 as (B, d, rows_pad, m), the zero-padded flat
(B, d, lp) with lp = rows_pad * m = n / 2; the filter bank is padded to lp
and laid out the same way; the conv runs on that layout
(`ops/fftconv.py::fftconv_outer_4d`, kernels B and C), the gate multiplies
the padded tensors, and the result is flattened, cut to L and transposed.
Backward: kernel A4', kernel C. Elsewhere the flat route runs. The math is
the flat route's; the conv transforms and writes lp >= L times.

For activation checkpointing (`ops/remat.py`) the conv output is tagged
(the ungated one of the composite route, and v4), and so is the filter
bank (the (d, L) bank, and k4 on the 4-D route), as the JAX package tags
them.

Parameter names are the reference torch names: `in_proj`, `out_proj`,
`short_filter` (a depthwise Conv1d weight (3d, 1, 3)) and `filter_fn`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.nn import activation_fn, dropout, linear
from hyena_dna_tpu_torch.ops import remat
from hyena_dna_tpu_torch.ops.fftconv import (GATED_MODES, fftconv_gated, fftconv_outer_4d,
                                             next_fast_fft_size)
from hyena_dna_tpu_torch.ops.fused_fftconv import plan_outer
from hyena_dna_tpu_torch.ops.fused_front import fused_proj_conv_gate, fused_proj_conv_gate4

CONV_IO_BF16_MIN_L = 1 << 15
FRONT4_TILES = (512, 256, 128)  # the JAX route's length tiles, in order of preference


def front4_tile(length: int, lp: int, m: int):
    """The 4-D route's length tile for L = `length` on rows of m times
    padded to lp (the first of `FRONT4_TILES` that `check_plan4` accepts),
    or None."""
    return next((t for t in FRONT4_TILES if length % t == 0 and t % m == 0
                 and lp % t == 0 and 8 % (t // m) == 0), None)


class HyenaOperator(nn.Module):
    def __init__(self, d_model: int, l_max: int, order: int = 2,
                 filter_order: int = 64, short_filter_order: int = 3,
                 activation: str = "id", filter_cfg: dict | None = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 gated_conv: str | None = None, front4: bool = False):
        super().__init__()
        self.dtype = dtype
        self.front4 = front4
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

    def front4_plan(self, batch: int, length: int):
        """(n1, r, m, rows_pad, tile_l) where the 4-D route engages for a
        (batch, length) input (JAX `_try_front4`), else None."""
        if not self.front4 or length > self.l_max:
            return None
        spec = plan_outer(next_fast_fft_size(2 * length), self.d_model, length, batch)
        if spec is None:
            return None
        n1, r, m = spec
        rows_pad = (n1 // 2) * r
        lp = rows_pad * m
        tile_l = front4_tile(length, lp, m)
        if tile_l is None or length > lp or rows_pad % 8:
            return None
        return n1, r, m, rows_pad, tile_l

    def _filter_bank(self, length: int, dtype: torch.dtype, rows: int = 0, m: int = 0):
        """The (d, L) filter bank, or with (rows, m) its (d, rows, m) 4-D
        form, zero past L; tagged for checkpointing (`ops/remat.py`)."""
        def build():
            k = self.filter_fn.filter(length, out_dtype=dtype)[0]  # (L, d)
            if not rows:
                return k.t().contiguous()
            kp = F.pad(k, (0, 0, 0, rows * m - length))  # the time axis, as JAX pads it
            return kp.reshape(rows, m, -1).permute(2, 0, 1).contiguous()

        params = (p for name, p in self.filter_fn.named_parameters() if name != "bias")
        return remat.filter_bank(build, params)

    def forward(self, u: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """u: (B, L, d) in `dtype` -> (B, L, d) in `dtype`; `generator`
        draws the dropout mask in training."""
        b, length = u.shape[:2]
        l_filter = min(length, self.l_max)
        w = self.in_proj.weight.float().t().contiguous()          # (d, 3d)
        bp = self.in_proj.bias.float().contiguous()
        wc = self.short_filter.weight[:, 0, :].float().t().contiguous()  # (3, 3d)
        bc = self.short_filter.bias.float().contiguous()
        conv_dt = torch.bfloat16 if l_filter >= CONV_IO_BF16_MIN_L else torch.float32
        D = self.filter_fn.bias.float().contiguous()
        plan = self.front4_plan(b, length)
        if plan is not None:
            n1, r, m, rows_pad, tile_l = plan
            vx4, x04 = fused_proj_conv_gate4(u.contiguous(), w, bp, wc, bc, rows_pad, m, tile_l)
            vx4 = dropout(vx4, self.dropout, self.training, generator)
            k4 = self._filter_bank(l_filter, conv_dt, rows_pad, m)
            v4 = fftconv_outer_4d(vx4.to(conv_dt), k4, D, n1, r, m)
            y4 = (v4 * x04.to(conv_dt)).to(u.dtype)
            # flatten and cut before the transpose (JAX transposes first): the
            # same values, and the gate's cotangent comes back channel-major
            # through one copy instead of as a 4-D strided view
            y = y4.reshape(b, -1, rows_pad * m)[..., :length].transpose(1, 2)
            return linear(self.act(y), self.out_proj, self.dtype)
        vx, x0 = fused_proj_conv_gate(u.contiguous(), w, bp, wc, bc)
        vx = dropout(vx, self.dropout, self.training, generator)
        k = self._filter_bank(l_filter, conv_dt)
        y = fftconv_gated(vx.to(conv_dt), x0.to(conv_dt), k, D, self.gated_conv).to(u.dtype)
        return linear(self.act(y.transpose(1, 2)), self.out_proj, self.dtype)
