"""Implicit Hyena filter (mirrors `hyena_dna_tpu/models/filters.py`).

positional embedding z -> Sin MLP (one `freq` shared by every Sin) -> bank
h (1, L, d) -> cast to `out_dtype` -> exponential modulation window
[-> L1 normalisation over the channels, in float32, with `normalized`].
With `linear_mixer` the MLP is one bias-free Linear (emb_dim -> d) and
there is no Sin.

`forward(x, L, k, bias)` is the long conv of the JAX `HyenaFilter.__call__`
on the general Hyena path: x (N, C, L) or the 5-D (B, H, C, Z, L) layout
(flattened to (B*H*Z, C, L)) against the (C, L) bank `k` (by default this
filter's) plus the skip term x * bias (zeros without `use_bias`). The conv
runs in float32 on the I/O (the bank is float32, as JAX's default
`out_dtype`) through `ops/fftconv.py::fftconv_chunked`, kernels B and C on
the card, and is cast back to x's dtype; a bank longer than the signal
(`num_blocks > 1`) takes `fftconv_aliased`, the reference's circular conv
at exactly 2L, in plain `torch.fft`, as the JAX package computes it.
`bidirectional` is accepted and, as in the JAX module, changes nothing.

Parameters carry the reference torch names, so a reference state dict loads
with `load_state_dict` as it is: `bias`, `pos_emb.z` (and the buffer
`pos_emb.t`), `implicit_filter.{0,2,4,...}` Linear layers with the shared
Sin module at the odd indices (its `freq` appears once per index in the
state dict, as in the reference), and `modulation.deltas`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hyena_dna_tpu_torch.ops.fftconv import fftconv_aliased, fftconv_tagged


def positional_embedding_init(emb_dim: int, seq_len: int) -> torch.Tensor:
    """The (1, seq_len, emb_dim) z tensor: [t, Re e^{-i f w}, Im e^{-i f w}]."""
    if emb_dim % 2 == 0 or emb_dim < 3:
        raise ValueError("emb_dim must be odd and >= 3")
    bands = (emb_dim - 1) // 2
    t = torch.linspace(0.0, 1.0, seq_len)[None, :, None]
    t_rescaled = torch.linspace(0.0, seq_len - 1, seq_len)[None, :, None]
    w = 2.0 * math.pi * t_rescaled / seq_len
    f = torch.linspace(1e-4, bands - 1, bands)[None, None]
    z = torch.exp(-1j * f * w)
    return torch.cat([t, z.real, z.imag], dim=-1)


def modulation_deltas_init(d_model: int, fast_decay_pct: float = 0.3,
                           slow_decay_pct: float = 1.5,
                           target: float = 1e-2) -> torch.Tensor:
    max_decay = math.log(target) / fast_decay_pct
    min_decay = math.log(target) / slow_decay_pct
    return torch.linspace(min_decay, max_decay, d_model)[None, None]


class Sin(nn.Module):
    def __init__(self, order: int, w: float):
        super().__init__()
        self.freq = nn.Parameter(w * torch.ones(1, order))

    def forward(self, x):
        return torch.sin(self.freq * x)


class PositionalEmbedding(nn.Module):
    def __init__(self, emb_dim: int, seq_len: int):
        super().__init__()
        self.z = nn.Parameter(positional_embedding_init(emb_dim, seq_len))
        self.register_buffer("t", torch.linspace(0.0, 1.0, seq_len)[None, :, None])


class ExponentialModulation(nn.Module):
    def __init__(self, d_model: int, fast_decay_pct: float, slow_decay_pct: float,
                 target: float, shift: float):
        super().__init__()
        self.shift = shift
        self.deltas = nn.Parameter(
            modulation_deltas_init(d_model, fast_decay_pct, slow_decay_pct, target))


class HyenaFilter(nn.Module):
    """Filter generator. d_model is the filter channel count (d for order 2)."""

    def __init__(self, d_model: int, emb_dim: int = 3, order: int = 16,
                 seq_len: int = 1024, w: float = 1.0, num_inner_mlps: int = 2,
                 modulate: bool = True, modulation_shift: float = 0.0,
                 fast_decay_pct: float = 0.3, slow_decay_pct: float = 1.5,
                 modulation_target: float = 1e-2, use_bias: bool = True,
                 linear_mixer: bool = False, normalized: bool = False,
                 bidirectional: bool = False):
        super().__init__()
        self.d_model = d_model
        self.seq_len = seq_len
        self.use_bias = use_bias
        self.normalized = normalized
        self.bidirectional = bidirectional  # accepted; no effect, as in the JAX module
        self.bias = nn.Parameter(torch.zeros(d_model))
        self.pos_emb = PositionalEmbedding(emb_dim, seq_len)
        if linear_mixer:
            layers = [nn.Linear(emb_dim, d_model, bias=False)]
        else:
            sin = Sin(order, w)  # one instance at every odd index, as in the reference
            layers = [nn.Linear(emb_dim, order), sin]
            for _ in range(num_inner_mlps):
                layers += [nn.Linear(order, order), sin]
            layers.append(nn.Linear(order, d_model, bias=False))
        self.implicit_filter = nn.Sequential(*layers)
        self.modulation = (ExponentialModulation(d_model, fast_decay_pct, slow_decay_pct,
                                                 modulation_target, modulation_shift)
                           if modulate else None)

    def filter(self, length: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The (1, length, d) filter bank in `out_dtype`. The MLP runs in
        float32; the bank is cast before the modulation, as in the JAX
        package, so every (L, d) buffer past the MLP is `out_dtype`."""
        z = self.pos_emb.z[:, :length].float()
        h = self.implicit_filter(z).to(out_dtype)
        if self.modulation is not None:
            t = self.pos_emb.t[:, :length]
            decay = torch.exp(-t * self.modulation.deltas.abs())
            h = h * (decay + self.modulation.shift).to(out_dtype)
        if self.normalized:
            h = h / torch.linalg.vector_norm(h.float(), ord=1, dim=-1, keepdim=True).to(out_dtype)
        return h

    def forward(self, x: torch.Tensor, length: int, k: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """The long conv x * k + x * bias over the last axis of x, (N, C, L)
        or (B, H, C, Z, L), with k (C, Lk) and bias (C,) (by default this
        filter's bank at `length` and `bias`); x's shape and dtype."""
        if k is None:
            k = self.filter(length)[0].t()
        if bias is None:
            bias = self.bias
        c = k.shape[0]
        bias = (bias if self.use_bias else torch.zeros_like(bias)).float().reshape(c)
        if x.dim() == 3 and x.shape[1] == c:
            return self._conv(x, k, bias)
        if x.dim() == 5 and x.shape[2] == c:
            b, ho, _, z, l_blk = x.shape
            xt = x.transpose(2, 3).reshape(b * ho * z, c, l_blk)
            y = self._conv(xt, k, bias)
            return y.reshape(b, ho, z, c, l_blk).transpose(2, 3)
        raise ValueError(f"the filter conv takes (N, {c}, L) or (B, H, {c}, Z, L), "
                         f"got {tuple(x.shape)}")

    @staticmethod
    def _conv(x: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        if k.shape[-1] > x.shape[-1]:
            return fftconv_aliased(x, k, bias)
        return fftconv_tagged(x.float().contiguous(), k.float().contiguous(),
                              bias.contiguous()).to(x.dtype)
