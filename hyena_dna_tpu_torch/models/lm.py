"""LMBackbone and ConvLMHeadModel (mirrors `hyena_dna_tpu/models/lm.py`).

GPT2Embeddings -> n_layer x Block -> final dropout + add + LN -> tied LM
head, with the vocabulary padded up to `pad_vocab_size_multiple` and
float32 logits. Dropout as in the JAX `LMBackbone`: block 0's first
dropout is `embed_dropout` (default 0.1), every other residual dropout and
`drop_f` before the final LN are `resid_dropout` (default 0.0). It acts in
`train()` mode only (JAX `deterministic=False`), with masks drawn from the
`generator` handed to `forward`.
Module names are the reference torch names (`backbone.embeddings...`,
`backbone.layers.{i}...`, `backbone.ln_f`), so a reference state dict loads
with `load_state_dict` and no key surgery.

Weights start from the GPT-2 init, drawn from an explicit `torch.Generator`:
Linear and Embedding weights N(0, 0.02) with zero biases, `out_proj` and
`fc2` scaled by 1/sqrt(2 n_layer); the depthwise short conv U(-1/sqrt(3),
1/sqrt(3)) as torch's Conv1d default; the filter's skip bias N(0, 1). The
positional features, Sin frequency and modulation rates are fixed at
construction. The remat options of the JAX model come with a later slice
(ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hyena_dna_tpu_torch.models.blocks import Block
from hyena_dna_tpu_torch.models.embeddings import GPT2Embeddings
from hyena_dna_tpu_torch.models.nn import dropout
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32


def _pad_vocab(vocab_size: int, multiple: int) -> int:
    if vocab_size % multiple != 0:
        vocab_size += multiple - (vocab_size % multiple)
    return vocab_size


class LMBackbone(nn.Module):
    def __init__(self, d_model: int, n_layer: int, d_inner: int, vocab_size: int,
                 layer: dict | None = None, residual_in_fp32: bool = False,
                 layer_norm_epsilon: float = 1e-5, resid_dropout: float = 0.0,
                 embed_dropout: float = 0.1):
        super().__init__()
        self.embeddings = GPT2Embeddings(d_model, vocab_size)
        self.layers = nn.ModuleList(
            Block(d_model, d_inner, layer, residual_in_fp32, layer_norm_epsilon,
                  resid_dropout1=embed_dropout if i == 0 else resid_dropout,
                  resid_dropout2=resid_dropout)
            for i in range(n_layer))
        self.resid_dropout = resid_dropout
        self.ln_f = LayerNormF32(d_model, eps=layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        hidden = self.embeddings(input_ids)
        residual = None
        for layer in self.layers:
            hidden, residual = layer(hidden, residual, generator)
        dropped = dropout(hidden, self.resid_dropout, self.training, generator)
        if residual is None:
            return self.ln_f(dropped)
        return self.ln_f(dropped, residual)[0]


class ConvLMHeadModel(nn.Module):
    """Causal LM: forward(input_ids (B, L)) -> float32 logits (B, L, V_padded)."""

    def __init__(self, d_model: int, n_layer: int, d_inner: int, vocab_size: int,
                 layer: dict | None = None, pad_vocab_size_multiple: int = 1,
                 residual_in_fp32: bool = False, layer_norm_epsilon: float = 1e-5,
                 attn_layer_idx=None, max_position_embeddings: int = 0,
                 resid_dropout: float = 0.0, embed_dropout: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if attn_layer_idx:
            raise NotImplementedError(
                "attention layers are not ported yet (ROADMAP.md Queue 1 item 12)")
        if max_position_embeddings:
            raise NotImplementedError(
                "learned position embeddings are not ported yet (ROADMAP.md Queue 1 item 12)")
        self.n_layer = n_layer
        self.backbone = LMBackbone(d_model, n_layer, d_inner,
                                   _pad_vocab(vocab_size, pad_vocab_size_multiple),
                                   layer, residual_in_fp32, layer_norm_epsilon,
                                   resid_dropout, embed_dropout)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """GPT-2 init from `generator` (see the module docstring)."""
        std = 0.02
        resid_std = std / math.sqrt(2 * self.n_layer)
        bound = 1.0 / math.sqrt(3)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                out = name.endswith(("mixer.out_proj", "mlp.fc2"))
                mod.weight.normal_(0.0, resid_std if out else std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, std, generator=generator)
            elif isinstance(mod, nn.Conv1d):
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif name.endswith("filter_fn"):
                mod.bias.normal_(0.0, 1.0, generator=generator)

    def forward(self, input_ids: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        hidden = self.backbone(input_ids, generator)
        return self.backbone.embeddings.attend(hidden.float())
