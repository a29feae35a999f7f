"""Multi-head causal attention mixer (mirrors `hyena_dna_tpu/models/attention.py`).

A packed `Wqkv` (d -> 3d) and `out_proj` (d -> d), each with a bias unless
`use_bias` is off, the reference torch names (flash-attn's `MHA`), so a
reference state dict loads as it is. Init: N(0, `init_std`) for `Wqkv` and
N(0, `init_std` / sqrt(2 n_layer)) for `out_proj`, zero biases.

  qkv (B, L, 3, H, hd) -> [rotary on q, k] -> SDPA on (B, H, L, hd), causal,
  scale `softmax_scale` or 1/sqrt(hd) -> (B, L, H, hd) -> dropout -> out_proj

The JAX module calls `jax.nn.dot_product_attention` (XLA's fused
attention, not a Pallas kernel); the port calls
`F.scaled_dot_product_attention`, which takes its flash backend on the card
in bf16. Its `dropout_p` would drop attention probabilities; the JAX module
drops the attention output instead, after the product and before the
reshape, so SDPA runs with `dropout_p=0` and `models/nn.py::dropout` acts on
its output with the generator handed to `forward`.

The products run in `dtype` (flax `Dense(dtype)`); the rotary embedding
(GPT-NeoX, non-interleaved, over the first `rotary_emb_dim` features of
each head) is computed in float32 and cast back to the input dtype, as
JAX's promotion does.

Tensor parallelism (a `mesh` whose model axis M divides `num_heads`; the
JAX rule `Wqkv` column-parallel, the reference's `ParallelMHA`): the rank
holds its H / M heads of each of q, k and v (rows of `Wqkv`'s weight and
bias) and the matching columns of `out_proj`'s weight; x enters through
`copy_to_model`, SDPA runs on the local heads, the dropout mask is drawn
for every head and sliced (`models/nn.py::dropout_slice`), and
`out_proj`'s partial products are summed by `reduce_from_model` before its
bias is added once. A head count that does not divide by M runs whole on
each rank.

Sequence parallelism (a `mesh` whose seq axis S is above 1; the JAX
package shards the batch P("data", "seq") and lets GSPMD run attention on
the global view): rank r holds the queries of its L / S columns, q stays
local, and k and v are gathered over the seq group
(`ops/distributed.py::seq_gather`, one all-gather of the stacked pair; the
gradient comes back reduce-scattered). Under `causal` the rank needs only
the first (r + 1) L / S keys; its queries sit at an offset, so the causal
mask is aligned to the lower-right corner
(`torch.nn.attention.bias.causal_lower_right`, which keeps SDPA's fused
backends; `is_causal=True` would align it to the top-left). Rotary
embeddings use the global positions, and the dropout mask is drawn for the
whole (B, L, H, hd) output and sliced at the rank's columns (and heads).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention.bias import causal_lower_right

from hyena_dna_tpu_torch.models.nn import dropout_slice, linear, row_parallel
from hyena_dna_tpu_torch.ops.distributed import copy_to_model, seq_gather
from hyena_dna_tpu_torch.parallel.sharding import model_axis


def apply_rotary(q: torch.Tensor, k: torch.Tensor, rotary_dim: int, start: int = 0):
    """Rotary embeddings on q, k (B, L, H, hd) over their first `rotary_dim`
    features: halves x1, x2 -> (x1 cos - x2 sin, x1 sin + x2 cos) with the
    frequencies 10000^(-2i / rotary_dim) at positions start..start+L-1."""
    length = q.shape[1]
    inv_freq = 1.0 / (10000 ** (torch.arange(0, rotary_dim, 2, device=q.device,
                                             dtype=torch.float32) / rotary_dim))
    positions = torch.arange(start, start + length, device=q.device, dtype=torch.float32)
    freqs = torch.outer(positions, inv_freq)
    cos, sin = freqs.cos()[None, :, None], freqs.sin()[None, :, None]

    def rot(x):
        x_rot, x_pass = x[..., :rotary_dim].float(), x[..., rotary_dim:]
        x1, x2 = x_rot.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return torch.cat([out.to(x.dtype), x_pass], dim=-1)

    return rot(q), rot(k)


class MHA(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 1, causal: bool = True,
                 dropout: float = 0.0, use_bias: bool = True, rotary_emb_dim: int = 0,
                 softmax_scale: Optional[float] = None, n_layer: int = 1,
                 init_std: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of num_heads={num_heads}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.causal = causal
        self.dropout = dropout
        self.rotary_emb_dim = rotary_emb_dim
        self.softmax_scale = softmax_scale
        self.n_layer = n_layer
        self.init_std = init_std
        self.dtype = dtype
        self.tp = model_axis(mesh, num_heads)
        self.seq = mesh if mesh is not None and mesh.seq > 1 else None
        m = self.tp.model if self.tp is not None else 1
        self.local_heads = num_heads // m
        self.head0 = self.local_heads * (self.tp.model_index if self.tp is not None else 0)
        width = d_model // m
        self.Wqkv = nn.Linear(d_model, 3 * width, bias=use_bias)
        self.out_proj = nn.Linear(width, d_model, bias=use_bias)
        if self.tp is not None:  # `parallel/sharding.py::tp_layout`
            self.tp_rules = {"Wqkv.weight": (0, 3), "out_proj.weight": (1, 1)}
            if use_bias:
                self.tp_rules["Wqkv.bias"] = (0, 3)
        self.init_weights(generator)

    @property
    def d_output(self) -> int:
        return self.d_model

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, init_std) for Wqkv, N(0, init_std / sqrt(2 n_layer)) for
        out_proj, zero biases."""
        for layer, std in ((self.Wqkv, self.init_std),
                           (self.out_proj, self.init_std / math.sqrt(2 * self.n_layer))):
            layer.weight.normal_(0.0, std, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, L, d) -> (B, L, d) in `dtype`."""
        b, length, d = x.shape
        h = self.local_heads
        hd = d // self.num_heads
        x = copy_to_model(x, self.tp)
        qkv = linear(x, self.Wqkv, self.dtype).reshape(b, length, 3, h, hd)
        q, k, v = qkv.unbind(2)
        r, s = (self.seq.seq_index, self.seq.seq) if self.seq is not None else (0, 1)
        if self.rotary_emb_dim > 0:
            q, k = apply_rotary(q, k, self.rotary_emb_dim, r * length)
        mask = {"is_causal": self.causal}
        if s > 1:  # every rank's keys and values, up to this rank's last column if causal
            keys = (r + 1) * length if self.causal else s * length
            k, v = seq_gather(torch.stack([k, v]), self.seq, dim=2)[:, :, :keys].unbind(0)
            if self.causal and r > 0:
                mask = {"attn_mask": causal_lower_right(length, keys)}
        scale = self.softmax_scale or 1.0 / math.sqrt(hd)
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), dropout_p=0.0, scale=scale,
                                             **mask)
        out = dropout_slice(out.transpose(1, 2), self.dropout, self.training, generator,
                            (1, s * length, r * length), (2, self.num_heads, self.head0))
        return row_parallel(out.reshape(b, length, h * hd), self.out_proj, self.dtype, self.tp)
