"""GPT-2 style token embeddings (mirrors `hyena_dna_tpu/models/embeddings.py`).

HyenaDNA uses no position table (`max_position_embeddings=0`); positions
come from the causal convolutions. The LM head is tied to the table:
`attend` is logits = hidden @ E^T, with no `lm_head.weight` of its own (the
reference ties it, and its state dicts may omit it).

Both run in `dtype`, as flax's `Embed(dtype=...)` does: the lookup returns
the float32 table's rows cast to `dtype` (the JAX one-hot lookup multiplies
by the table cast to `dtype`, exact either way), and `attend` casts the
query and the table to `dtype` before the product (flax `Embed.attend`
promotes both), so a bfloat16 model has bfloat16 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(vocab_size, embed_dim)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings(input_ids).to(self.dtype)

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden.to(self.dtype), self.word_embeddings.weight.to(self.dtype))
