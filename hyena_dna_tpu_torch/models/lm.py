"""LMBackbone, ConvLMHeadModel and DNAEmbeddingModel (mirrors
`hyena_dna_tpu/models/lm.py`).

GPT2Embeddings -> n_layer x Block -> final dropout + add + LN -> tied LM
head, with the vocabulary padded up to `pad_vocab_size_multiple`.
Activations run in `dtype` (float32, or bfloat16 as every hg38 config
trains) with float32 parameters, and the residual stream in float32 when
`residual_in_fp32`, else in `dtype` (see `models/blocks.py`); `ln_f` emits
`dtype` through the fused add+LN unit. The logits come out of the tied head
in `dtype`, as flax's `Embed.attend` promotes to the module dtype; the loss
casts them to float32. Dropout as in the JAX `LMBackbone`: block 0's first
dropout is `embed_dropout` (default 0.1), every other residual dropout and
`drop_f` before the final LN are `resid_dropout` (default 0.0). It acts in
`train()` mode only (JAX `deterministic=False`), with masks drawn from the
`generator` handed to `forward`.
Module names are the reference torch names (`backbone.embeddings...`,
`backbone.layers.{i}...`, `backbone.ln_f`), so a reference state dict loads
with `load_state_dict` and no key surgery.

`DNAEmbeddingModel` is the same backbone without the head: it returns the
final hidden states (B, L, d_model) in `dtype` for a downstream decoder
(`models/heads.py`), so its `d_output` is d_model. Both models take
`inputs_embeds` (B, L, d_model) in place of `input_ids`, which skips the
embedding lookup (the soft-prompting evals splice trainable vectors in this
way). `identity_mlp` and `residual_dtype` pass to every `Block`; with
`identity_mlp` the residual cells of checkpointing fall back to block cells
(a block without an MLP cannot be cut at its post-mixer residual), as in
the JAX `LMBackbone`.

Attention: the blocks at the indices of `attn_layer_idx` take `MHA` built
from `attn_cfg` (`models/attention.py`) as their mixer, the others the
Hyena operator of `layer`; with `max_position_embeddings` > 0 the
embeddings add a learned position table (`models/embeddings.py`). Remat
cells, `residual_dtype` and `identity_mlp` take either mixer.

Sequence parallelism: with `mesh` (a `parallel.sharding.Mesh`) whose seq
axis S is above 1, each rank runs the model on its contiguous L / S
columns and every Hyena mixer takes the sequence-sharded route
(`models/hyena.py`); learned positions start at the rank's first column
(`models/embeddings.py`) and attention gathers the keys and values over
the seq group (`models/attention.py`); the norms, MLPs and head are per
token and need no collective. The data axis needs nothing of the model:
each data rank runs it on its rows.

Tensor parallelism: with a model axis M above 1, the mesh reaches every
module that splits (`parallel/sharding.py`): the vocab-parallel embedding
and tied head (`models/embeddings.py`; the logits come back over the whole
padded vocabulary, as the JAX model returns them), each Hyena mixer
(`models/hyena.py`: kernels A, A', B and C on the rank's d / M channels of
each chunk), each MHA (`models/attention.py`: its heads split) and each MLP
(`models/blocks.py`: fc1 column- and fc2 row-parallel); the norms and the
residual stream are replicated. Build a tensor-parallel model with
`parallel/sharding.py::build_sharded`, which draws the weights whole and
gives the rank its slices, as the trainer does.

Weights start from the GPT-2 init, drawn from an explicit `torch.Generator`:
Linear weights N(0, 0.02) and Embedding weights N(0, `init_std`) with zero
biases (the JAX `LMBackbone` passes `init_std` to its embeddings only; every
other module keeps 0.02), `out_proj` and
`fc2` scaled by 1/sqrt(2 n_layer); the depthwise short conv U(-1/sqrt(3),
1/sqrt(3)) as torch's Conv1d default (1/sqrt(k) for a k-tap filter); the
filter's skip bias N(0, 1); `MHA` its own (N(0, its `init_std`),
`out_proj` rescaled); a Hyena `ord_proj_w` N(0, std 1/sqrt(head_dim)). The
positional features, Sin frequency and modulation rates are fixed at
construction.

Activation checkpointing, the JAX model's remat options
(`ops/remat.py` has the mechanism): `checkpoint_mixer` or `checkpoint_mlp`
turns it on (both only turn it on, as in the JAX package). By default every
block is one cell (`Block.forward`). With `remat_residual_only` the cells
are cut at the residual stream instead: cell 0 is block 0's `pre`, cell i
is block i-1's `post` then block i's `pre`, and a last cell runs block
n-1's `post` (`final_post`), so a cell keeps only its input residual (a
float32 one with `residual_in_fp32`). With `remat_group_size` g > 1 an
outer cell spans g such cells (the last group has min(g, n_layer - i0)),
keeping n_layer / g residuals. `remat_save_conv` (default on) saves each
layer's conv output across its cell and `remat_save_filter` (default off)
its filter bank, as the JAX policy `save_only_these_names` does. Dropout
draws the same masks with and without checkpointing, so a seed gives the
same loss; with a float32 residual stream (or block cells) the logits and
gradients are the same bits as without checkpointing.

Runs per train step of an n-layer model (forward and backward, dropout
active or not), counted as the CPU tests count them; a ragged group
counts with its own size g_j:
  * block cells: kernel A (A4 on the 4-D route) 2n; the conv forward (B)
    n with `remat_save_conv`, else 2n; the filter bank 2n;
  * residual cells, g = 1: the same;
  * residual cells, groups: an outer recompute runs again the first
    g_j - 1 cells of its group, so kernel A runs 2n + sum_j (g_j - 1)
    times (2.5 per layer at g = 2); the conv forward n with
    `remat_save_conv` (the outer recompute replays the saved output), else
    as kernel A; the filter bank as kernel A;
  * `remat_save_filter`: the filter bank 2n in every mode (the forward,
    then once in its own backward), and never in a recompute;
  * kernels A' and C: n, once in the backward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hyena_dna_tpu_torch.models.attention import MHA
from hyena_dna_tpu_torch.models.blocks import Block
from hyena_dna_tpu_torch.models.embeddings import GPT2Embeddings
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.models.nn import dropout
from hyena_dna_tpu_torch.ops import remat
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32


def _pad_vocab(vocab_size: int, multiple: int) -> int:
    if vocab_size % multiple != 0:
        vocab_size += multiple - (vocab_size % multiple)
    return vocab_size


class LMBackbone(nn.Module):
    def __init__(self, d_model: int, n_layer: int, d_inner: int, vocab_size: int,
                 layer: dict | None = None, residual_in_fp32: bool = False,
                 layer_norm_epsilon: float = 1e-5, resid_dropout: float = 0.0,
                 embed_dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 checkpoint_mixer: bool = False, checkpoint_mlp: bool = False,
                 remat_residual_only: bool = False, remat_group_size: int = 1,
                 remat_save_conv: bool = True, remat_save_filter: bool = False,
                 identity_mlp: bool = False, residual_dtype=None, attn_layer_idx=None,
                 attn_cfg: dict | None = None, max_position_embeddings: int = 0, mesh=None):
        super().__init__()
        self.remat = checkpoint_mixer or checkpoint_mlp
        self.residual_cells = self.remat and remat_residual_only and not identity_mlp
        self.remat_group_size = max(1, remat_group_size)
        self.remat_names = ((remat.CONV_OUT_TAG,) * remat_save_conv
                            + (remat.FILTER_K_TAG,) * remat_save_filter)
        self.embeddings = GPT2Embeddings(d_model, vocab_size, dtype, max_position_embeddings,
                                         mesh)
        attn_idx = set(attn_layer_idx or ())
        self.layers = nn.ModuleList(
            Block(d_model, d_inner, layer, residual_in_fp32, layer_norm_epsilon,
                  resid_dropout1=embed_dropout if i == 0 else resid_dropout,
                  resid_dropout2=resid_dropout, dtype=dtype, identity_mlp=identity_mlp,
                  residual_dtype=residual_dtype, attn_cfg=attn_cfg, is_attn=i in attn_idx,
                  n_layer=n_layer, mesh=mesh)
            for i in range(n_layer))
        self.resid_dropout = resid_dropout
        self.ln_f = LayerNormF32(d_model, eps=layer_norm_epsilon, out_dtype=dtype)

    def _cell(self, fn, *args, generator=None):
        return remat.checkpoint_cell(fn, *args, generator=generator, names=self.remat_names)

    def _residual_cell(self, carry, i: int, generator=None):
        """Cell i of the residual cut: [post of block i-1, pre of block i]."""
        if i == 0:
            return self.layers[0].pre(carry, None, generator)
        return self.layers[i].pre(self.layers[i - 1].post(carry), carry, generator)

    def _residual_group(self, carry, i0: int, g: int, generator=None):
        """An outer cell over the g residual cells from i0, each a cell."""
        for i in range(i0, i0 + g):
            carry = self._cell(self._residual_cell, carry, i, generator=generator)
        return carry

    def _final_post(self, residual, generator=None):
        return self.layers[-1].post(residual)

    def forward(self, input_ids: torch.Tensor | None,
                generator: torch.Generator | None = None,
                inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        hidden = self.embeddings(input_ids) if inputs_embeds is None else inputs_embeds
        n, g = len(self.layers), self.remat_group_size
        if self.residual_cells:
            residual = hidden
            if g > 1:
                for i0 in range(0, n, g):
                    residual = self._cell(self._residual_group, residual, i0, min(g, n - i0),
                                          generator=generator)
            else:
                for i in range(n):
                    residual = self._cell(self._residual_cell, residual, i, generator=generator)
            hidden = self._cell(self._final_post, residual)
        else:
            residual = None
            for layer in self.layers:
                if self.remat:
                    hidden, residual = self._cell(layer, hidden, residual, generator=generator)
                else:
                    hidden, residual = layer(hidden, residual, generator)
        dropped = dropout(hidden, self.resid_dropout, self.training, generator)
        if residual is None:
            return self.ln_f(dropped)
        return self.ln_f(dropped, residual)[0]


class _LMBase(nn.Module):
    """The backbone and the GPT-2 init shared by both models."""

    def __init__(self, d_model: int, n_layer: int, d_inner: int, vocab_size: int,
                 layer: dict | None = None, pad_vocab_size_multiple: int = 1,
                 residual_in_fp32: bool = False, layer_norm_epsilon: float = 1e-5,
                 attn_layer_idx=None, attn_cfg: dict | None = None,
                 max_position_embeddings: int = 0,
                 resid_dropout: float = 0.0, embed_dropout: float = 0.1,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32, checkpoint_mixer: bool = False,
                 checkpoint_mlp: bool = False, remat_residual_only: bool = False,
                 remat_group_size: int = 1, remat_save_conv: bool = True,
                 remat_save_filter: bool = False, identity_mlp: bool = False,
                 residual_dtype=None, init_std: float = 0.02, mesh=None):
        super().__init__()
        self.n_layer = n_layer
        self.d_model = d_model
        self.init_std = init_std
        self.backbone = LMBackbone(d_model, n_layer, d_inner,
                                   _pad_vocab(vocab_size, pad_vocab_size_multiple),
                                   layer, residual_in_fp32, layer_norm_epsilon,
                                   resid_dropout, embed_dropout, dtype,
                                   checkpoint_mixer, checkpoint_mlp, remat_residual_only,
                                   remat_group_size, remat_save_conv, remat_save_filter,
                                   identity_mlp, residual_dtype, attn_layer_idx, attn_cfg,
                                   max_position_embeddings, mesh)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """GPT-2 init from `generator` (see the module docstring), in module
        order; each mixer draws its own (`HyenaOperator.init_weights`,
        `MHA.init_weights`)."""
        resid_std = 0.02 / math.sqrt(2 * self.n_layer)
        mixers = [m for m in self.modules() if isinstance(m, (HyenaOperator, MHA))]
        inside = {id(sub) for m in mixers for sub in m.modules()}
        for name, mod in self.named_modules():
            if isinstance(mod, HyenaOperator):
                mod.init_weights(generator, self.n_layer)
            elif isinstance(mod, MHA):
                mod.init_weights(generator)
            elif id(mod) in inside:
                continue
            elif isinstance(mod, nn.Linear):
                std = resid_std if name.endswith("mlp.fc2") else 0.02
                mod.weight.normal_(0.0, std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, self.init_std, generator=generator)


class ConvLMHeadModel(_LMBase):
    """Causal LM: forward(input_ids (B, L)) -> logits (B, L, V_padded) in `dtype`."""

    @property
    def d_output(self) -> int:
        return self.backbone.embeddings.vocab_size

    def forward(self, input_ids: torch.Tensor | None,
                generator: torch.Generator | None = None,
                inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        hidden = self.backbone(input_ids, generator, inputs_embeds)
        return self.backbone.embeddings.attend(hidden.float())


class DNAEmbeddingModel(_LMBase):
    """The backbone for downstream heads: forward(input_ids (B, L)) -> final
    hidden states (B, L, d_model) in `dtype` (registered `dna_embedding`)."""

    @property
    def d_output(self) -> int:
        return self.d_model

    def forward(self, input_ids: torch.Tensor | None,
                generator: torch.Generator | None = None,
                inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return self.backbone(input_ids, generator, inputs_embeds)
