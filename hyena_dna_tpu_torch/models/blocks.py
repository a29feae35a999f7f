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
with bf16 output takes kernels D and D' on the card (`ops/add_ln.py`). The
MLP's products are cuBLAS calls in `dtype`, as the JAX package left them to
XLA; `Mlp(use_fused=True)` takes the fused kernels F and F'
(`ops/mlp_fused.py`) under the JAX rule, and `Block` does not set it, as
the JAX `Block` does not.

Tensor parallelism (a `mesh` whose model axis M divides the hidden width,
the JAX rules `mlp/fc1` and `mlp/fc2`): `fc1` is column-parallel (the
rank's hidden_features / M rows of its weight and bias) and `fc2`
row-parallel (its weight's matching columns); x enters through
`copy_to_model`, the rank's partial output is summed by
`reduce_from_model`, and fc2's bias is added once after the sum. With
`use_fused`, kernels F and F' run on the rank's hidden slice (they take any
width), with no second bias. The mixers split themselves (`models/hyena.py`,
`models/attention.py`); the norms and the residual stream are replicated.

The residual stream's dtype: `residual_dtype` when given (a torch dtype
or its name, e.g. "float16"; it overrides `residual_in_fp32`, as in the JAX
`Block`), else float32 under `residual_in_fp32`, else the hidden states'.
With `identity_mlp` the block has no norm2 and no MLP: it returns the
mixer's output and the residual after the first add (JAX
`Block(identity_mlp=True)`), and it cannot be cut by `pre` / `post`.

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

from hyena_dna_tpu_torch.models.attention import MHA
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.models.nn import dropout, linear, row_parallel
from hyena_dna_tpu_torch.ops.distributed import copy_to_model, reduce_from_model
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32
from hyena_dna_tpu_torch.ops.mlp_fused import applies as mlp_fused_applies
from hyena_dna_tpu_torch.ops.mlp_fused import mlp_fused
from hyena_dna_tpu_torch.parallel.sharding import model_axis

# Hyena config keys that do not change the computation: optimizer settings
# (the optimizer labels parameters itself), the filter dropout (unimplemented
# in the JAX package and the reference too), reference CUDA switches and
# the JAX module's init and routing switches.
_TRAINING_ONLY_KEYS = ("lr", "lr_pos_emb", "wd", "filter_dropout",
                       "fused_bias_fc", "fused_fft_conv", "jit_filter", "filter_cls",
                       # JAX module switches: init scales, Pallas routing, the seq axis name
                       "n_layer", "init_std", "use_pallas_front", "pallas_interpret",
                       "return_state", "seq_axis")
# layer-config key -> HyenaFilter argument (JAX `make_mixer`'s filter keys)
_FILTER_KEYS = {"emb_dim": "emb_dim", "w": "w", "num_inner_mlps": "num_inner_mlps",
                "modulate": "modulate", "shift": "modulation_shift",
                "fast_decay_pct": "fast_decay_pct", "slow_decay_pct": "slow_decay_pct",
                "target": "modulation_target", "bias": "use_bias", "normalized": "normalized",
                "linear_mixer": "linear_mixer", "bidirectional": "bidirectional"}
# attention-config keys of the reference's flash-attn switches
_ATTN_DROPPED = ("use_flash_attn", "fused_bias_fc")


def make_mixer(d_model: int, layer_cfg: dict | None, dtype: torch.dtype = torch.float32,
               attn_cfg: dict | None = None, is_attn: bool = False,
               n_layer: int = 1, mesh=None) -> nn.Module:
    """The block's mixer (JAX `make_mixer`): `MHA` from `attn_cfg` where
    `is_attn` (a layer index in `attn_layer_idx`), else the Hyena operator
    from a reference-style layer config (`_name_: hyena`; `_name_: mha`
    builds `MHA` from the layer config itself). `mesh` goes to the mixer
    (the Hyena operator's and MHA's seq and model axes)."""
    cfg = dict(attn_cfg or {}) if is_attn else dict(layer_cfg or {})
    name = "mha" if is_attn else cfg.pop("_name_", "hyena")
    cfg.pop("mesh", None)  # a layer config's own mesh key: the model's mesh is used
    if name == "mha":
        for key in _ATTN_DROPPED:
            cfg.pop(key, None)
        return MHA(d_model=d_model, n_layer=n_layer, dtype=dtype, mesh=mesh, **cfg)
    if name != "hyena":
        raise ValueError(f"unknown mixer {name!r} (hyena or mha)")
    for key in _TRAINING_ONLY_KEYS:
        cfg.pop(key, None)
    filter_cfg = dict(cfg.pop("filter_args", None) or {})
    for key in ("seq_len", "order", "modulation_lr"):  # from l_max / filter_order; frozen
        filter_cfg.pop(key, None)
    filter_cfg.update({_FILTER_KEYS[k]: cfg.pop(k) for k in list(cfg) if k in _FILTER_KEYS})
    filter_cfg.update(cfg.pop("filter_cfg", None) or {})
    return HyenaOperator(d_model=d_model, filter_cfg=filter_cfg, dtype=dtype, mesh=mesh, **cfg)


class Mlp(nn.Module):
    """fc1 -> tanh-approximate GeLU -> fc2 (d_model -> hidden_features ->
    out_features, default d_model), in `dtype`.

    With `use_fused`, x cast to `dtype` goes through `ops.mlp_fused.mlp_fused`
    (kernels F and F' on the card) where the JAX `Mlp` takes its Pallas
    kernel: N = x.numel() / d a multiple of 128 and d, hidden_features and
    out_features multiples of 128 (under a model axis, the rank's hidden
    slice). Other shapes keep the two products, as in the JAX package."""

    def __init__(self, d_model: int, hidden_features: int, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False, out_features: int | None = None, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.use_fused = use_fused
        self.tp = model_axis(mesh, hidden_features)
        hidden = hidden_features // (self.tp.model if self.tp is not None else 1)
        self.fc1 = nn.Linear(d_model, hidden)
        self.fc2 = nn.Linear(hidden, out_features or d_model)
        if self.tp is not None:  # `parallel/sharding.py::tp_layout`
            self.tp_rules = {"fc1.weight": (0, 1), "fc1.bias": (0, 1), "fc2.weight": (1, 1)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        n = x.numel() // d
        d_out = self.fc2.out_features
        x = copy_to_model(x, self.tp)
        if not (self.use_fused and mlp_fused_applies(n, d, self.fc1.out_features, d_out)):
            h = F.gelu(linear(x, self.fc1, self.dtype), approximate="tanh")
            return row_parallel(h, self.fc2, self.dtype, self.tp)
        # under a model axis fc2's bias joins once, after the sum of the ranks' outputs
        b2 = self.fc2.bias if self.tp is None else torch.zeros_like(self.fc2.bias)
        y = mlp_fused(x.reshape(n, d).to(self.dtype), self.fc1.weight.t(), self.fc1.bias,
                      self.fc2.weight.t(), b2).reshape(*x.shape[:-1], d_out)
        if self.tp is None:
            return y
        return reduce_from_model(y, self.tp) + self.fc2.bias.to(self.dtype)


def torch_dtype(value) -> torch.dtype | None:
    """A torch dtype from a dtype, its name ("bfloat16", "float16", ...) or None."""
    if value is None or isinstance(value, torch.dtype):
        return value
    dt = getattr(torch, str(value), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {value!r}")
    return dt


class Block(nn.Module):
    def __init__(self, d_model: int, d_inner: int, layer_cfg: dict | None,
                 residual_in_fp32: bool = False, layer_norm_epsilon: float = 1e-5,
                 resid_dropout1: float = 0.0, resid_dropout2: float = 0.0,
                 dtype: torch.dtype = torch.float32, identity_mlp: bool = False,
                 residual_dtype=None, attn_cfg: dict | None = None, is_attn: bool = False,
                 n_layer: int = 1, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.identity_mlp = identity_mlp
        self.resid_dropout1 = resid_dropout1
        self.resid_dropout2 = resid_dropout2
        self.resid_dtype = (torch_dtype(residual_dtype) if residual_dtype is not None
                            else torch.float32 if residual_in_fp32 else None)
        self.norm1 = LayerNormF32(d_model, eps=layer_norm_epsilon, out_dtype=dtype)
        self.mixer = make_mixer(d_model, layer_cfg, dtype, attn_cfg, is_attn, n_layer, mesh)
        if not identity_mlp:
            self.norm2 = LayerNormF32(d_model, eps=layer_norm_epsilon, out_dtype=dtype)
            self.mlp = Mlp(d_model, d_inner, dtype, mesh=mesh)

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
        if self.identity_mlp:
            return hidden, residual
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
