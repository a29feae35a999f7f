"""GPT-2 style token embeddings (mirrors `hyena_dna_tpu/models/embeddings.py`).

HyenaDNA uses no position table (`max_position_embeddings=0`); positions
come from the causal convolutions. The attention configs learn one:
`position_embeddings` (max_position_embeddings, d), added after the token
lookup at `position_ids`, by default 0..L-1 (then the table's first L
rows, a slice, whose backward is a plain add). The LM head is tied to the table:
`attend` is logits = hidden @ E^T, with no `lm_head.weight` of its own (the
reference ties it, and its state dicts may omit it).

Both run in `dtype`, as flax's `Embed(dtype=...)` does. For a vocabulary of
at most `ONE_HOT_MAX_VOCAB` (every hg38 config: 16 after padding) the
lookup is the JAX package's one-hot product, one_hot(ids) @ E in `dtype`:
exact (one nonzero term per row), and its backward is a matrix product
(cuBLAS on the card, which sums in a fixed order, so two identical steps
give the same bits; `nn.Embedding`'s CUDA backward does not). Larger
vocabularies index the table. Either way the table stays the float32
parameter `word_embeddings.weight`, so reference state dicts load
unchanged. `attend` casts the query and the table to `dtype` before the
product (flax `Embed.attend` promotes both), so a bfloat16 model has
bfloat16 logits.

Tensor parallelism (a `mesh` whose model axis M divides the padded
vocabulary; the JAX rule `word_embeddings` P("model", None), the
reference's `ParallelGPT2Embeddings`): the rank holds the table's rows of
its V / M tokens. The lookup is the one-hot product (or the index) over
those rows, zero for the other tokens, summed over the ranks by
`reduce_from_model`; the tied head takes the rank's logits over its
tokens from `copy_to_model`'s hidden states and joins the ranks' logits
with `gather_from_model`, so the model returns the whole padded
vocabulary. The position table stays whole (P(None, None)).

Sequence parallelism (a `mesh` whose seq axis S is above 1): the rank holds
its contiguous L / S columns, so its default positions start at its first
global column, seq_index * L / S, not at 0; an explicit `position_ids` is
already global. The lookup and the table's gradient need no collective
(the train step sums the ranks' gradients).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.ops.distributed import (copy_to_model, gather_from_model,
                                                 reduce_from_model)
from hyena_dna_tpu_torch.parallel.sharding import model_axis

ONE_HOT_MAX_VOCAB = 64  # JAX `GPT2Embeddings`: vocab_size <= 64 looks up by one-hot product


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int, dtype: torch.dtype = torch.float32,
                 max_position_embeddings: int = 0, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.tp = model_axis(mesh, vocab_size)
        self.seq = mesh if mesh is not None and mesh.seq > 1 else None
        rows = vocab_size // (self.tp.model if self.tp is not None else 1)
        self.vocab0 = rows * (self.tp.model_index if self.tp is not None else 0)
        self.word_embeddings = nn.Embedding(rows, embed_dim)
        if self.tp is not None:  # `parallel/sharding.py::tp_layout`
            self.tp_rules = {"word_embeddings.weight": (0, 1)}
        self.position_embeddings = (nn.Embedding(max_position_embeddings, embed_dim)
                                    if max_position_embeddings > 0 else None)

    def forward(self, input_ids: torch.Tensor,
                position_ids: torch.Tensor | None = None) -> torch.Tensor:
        table = self.word_embeddings.weight
        if self.vocab_size > ONE_HOT_MAX_VOCAB:
            if self.tp is None:
                emb = self.word_embeddings(input_ids).to(self.dtype)
            else:  # the rank's tokens; zero rows for the others
                local = input_ids - self.vocab0
                mine = (local >= 0) & (local < table.shape[0])
                emb = self.word_embeddings(torch.where(mine, local, 0)).to(self.dtype)
                emb = emb * mine[..., None].to(self.dtype)
        else:
            vocab = torch.arange(self.vocab0, self.vocab0 + table.shape[0],
                                 device=input_ids.device)
            one_hot = (input_ids[..., None] == vocab).to(self.dtype)
            emb = one_hot @ table.to(self.dtype)
        emb = reduce_from_model(emb, self.tp)
        if self.position_embeddings is None:
            return emb
        positions = self.position_embeddings.weight.to(self.dtype)
        if position_ids is None:
            length = input_ids.shape[1]
            start = self.seq.seq_index * length if self.seq is not None else 0
            return emb + positions[start:start + length]
        return emb + positions[position_ids]

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        hidden = copy_to_model(hidden.to(self.dtype), self.tp)
        logits = F.linear(hidden, self.word_embeddings.weight.to(self.dtype))
        return gather_from_model(logits, self.tp)
