"""Prenorm residual block and MLP (mirrors `hyena_dna_tpu/models/blocks.py`).

Block, in the flash-attn "dropout -> add -> LN" order (dropout is the
identity in eval mode):

  residual = dropout1(hidden) + residual   (dropout1(hidden) alone in the first block)
  hidden   = mixer(norm1(residual))
  residual = dropout2(hidden) + residual
  hidden   = mlp(norm2(residual))

Activations run in `dtype` (float32, or bfloat16 as every hg38 config
trains); parameters stay float32 and are cast where they are used, as flax's
`dtype` does. The residual stream is float32 when `residual_in_fp32`,
else the dtype of the hidden states; the adds run in float32 and round once
to it. The LNs keep float32 statistics and emit `dtype`; a bf16 residual
with bf16 output takes kernels D and D' on the card (`ops/add_ln.py`). The MLP's products are cuBLAS calls in `dtype`, as
the JAX package left them to XLA.

`pre` and `post` cut the block at its post-mixer residual, as the JAX
`Block.pre` / `Block.post` do for the LM's residual-only checkpoint cells:
`pre` runs from the block boundary to that residual (dropout, add + norm1,
mixer, dropout, add), `post` runs norm2 and the MLP from it. The second
add is a plain float32 add rounded once to the residual dtype and norm2 a
plain LN of the residual: the forward values are those of `forward`, and so
are the gradients with a float32 residual. With a bf16 residual `forward`
takes kernel D' for the second unit, whose gradient rounds once where the
split rounds twice, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.models.nn import dropout, linear
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32

# Hyena config keys that do not change the computation: optimizer settings
# (the optimizer labels parameters itself), the filter dropout (unimplemented
# in the JAX package and the reference too) and reference CUDA switches.
_TRAINING_ONLY_KEYS = ("lr", "lr_pos_emb", "wd", "filter_dropout",
                       "fused_bias_fc", "fused_fft_conv", "jit_filter")
_FILTER_KEYS = {"emb_dim": "emb_dim", "w": "w", "num_inner_mlps": "num_inner_mlps",
                "modulate": "modulate", "shift": "modulation_shift",
                "fast_decay_pct": "fast_decay_pct", "slow_decay_pct": "slow_decay_pct",
                "target": "modulation_target"}
# (key, value the ported path takes, ROADMAP.md item that ports the rest)
_UNPORTED = (("num_heads", 1, "Queue 1 item 4"), ("num_blocks", 1, "Queue 1 item 4"),
             ("inner_factor", 1, "Queue 1 item 4"), ("outer_mixing", False, "Queue 1 item 4"),
             ("post_order_ffn", False, "Queue 1 item 4"), ("bias", True, "Queue 1 item 4"),
             ("normalized", False, "Queue 1 item 4"), ("linear_mixer", False, "Queue 1 item 4"),
             ("bidirectional", False, "Queue 1 item 4"))


def make_mixer(d_model: int, layer_cfg: dict | None,
               dtype: torch.dtype = torch.float32) -> HyenaOperator:
    """Hyena mixer from a reference-style layer config (`_name_: hyena`)."""
    cfg = dict(layer_cfg or {})
    name = cfg.pop("_name_", "hyena")
    if name != "hyena":
        raise NotImplementedError(
            f"mixer {name!r} is not ported yet (ROADMAP.md Queue 1 item 12)")
    for key in _TRAINING_ONLY_KEYS:
        cfg.pop(key, None)
    for key, value, item in _UNPORTED:
        if key in cfg and cfg.pop(key) != value:
            raise NotImplementedError(
                f"Hyena {key}={layer_cfg[key]!r} is not ported yet (ROADMAP.md {item})")
    filter_cfg = {_FILTER_KEYS[k]: cfg.pop(k) for k in list(cfg) if k in _FILTER_KEYS}
    return HyenaOperator(d_model=d_model, filter_cfg=filter_cfg, dtype=dtype, **cfg)


class Mlp(nn.Module):
    """fc1 -> tanh-approximate GeLU -> fc2, in `dtype`."""

    def __init__(self, d_model: int, hidden_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(d_model, hidden_features)
        self.fc2 = nn.Linear(hidden_features, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1, self.dtype), approximate="tanh")
        return linear(x, self.fc2, self.dtype)


class Block(nn.Module):
    def __init__(self, d_model: int, d_inner: int, layer_cfg: dict | None,
                 residual_in_fp32: bool = False, layer_norm_epsilon: float = 1e-5,
                 resid_dropout1: float = 0.0, resid_dropout2: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resid_dropout1 = resid_dropout1
        self.resid_dropout2 = resid_dropout2
        self.resid_dtype = torch.float32 if residual_in_fp32 else None
        self.norm1 = LayerNormF32(d_model, eps=layer_norm_epsilon, out_dtype=dtype)
        self.mixer = make_mixer(d_model, layer_cfg, dtype)
        self.norm2 = LayerNormF32(d_model, eps=layer_norm_epsilon, out_dtype=dtype)
        self.mlp = Mlp(d_model, d_inner, dtype)

    def _add_norm(self, norm: LayerNormF32, hidden: torch.Tensor, residual):
        if residual is None:
            residual = hidden if self.resid_dtype is None else hidden.to(self.resid_dtype)
            return norm(residual), residual
        if self.resid_dtype is not None:
            residual = residual.to(self.resid_dtype)
        return norm(hidden, residual)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        dropped = dropout(hidden, self.resid_dropout1, self.training, generator)
        hidden, residual = self._add_norm(self.norm1, dropped, residual)
        hidden = self.mixer(hidden, generator)
        dropped = dropout(hidden, self.resid_dropout2, self.training, generator)
        hidden, residual = self._add_norm(self.norm2, dropped, residual)
        return self.mlp(hidden), residual

    def pre(self, hidden: torch.Tensor, residual: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
        """dropout -> add -> norm1 -> mixer -> dropout -> add: the block
        boundary to the post-mixer residual (JAX `Block.pre`)."""
        dropped = dropout(hidden, self.resid_dropout1, self.training, generator)
        hidden, residual = self._add_norm(self.norm1, dropped, residual)
        hidden = self.mixer(hidden, generator)
        dropped = dropout(hidden, self.resid_dropout2, self.training, generator)
        return (dropped.float() + residual.float()).to(self.resid_dtype or self.dtype)

    def post(self, residual: torch.Tensor) -> torch.Tensor:
        """norm2 -> mlp from the post-mixer residual (JAX `Block.post`)."""
        return self.mlp(self.norm2(residual))
