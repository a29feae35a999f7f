"""Activation registry (mirrors `hyena_dna_tpu/models/nn.py::activation_fn`),
the dropout every module of the port uses, and `linear`, a Linear layer run
in the block dtype as flax's `Dense(dtype=...)` runs it.

Only the identity, the Hyena operator's activation on the ported path, is
here; the rest of the JAX registry comes with ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in (None, "id", "identity", "linear", "none"):
        return lambda x: x
    raise NotImplementedError(
        f"activation {name!r} is not ported yet (ROADMAP.md Queue 1 item 12)")


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`): zero with probability p and
    scale the rest by 1/(1-p), only in training. The mask comes from
    `generator` (on x's device), so one seed gives one mask; the identity
    when not training or p == 0, as `deterministic=True` is in JAX."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype`: the input, the float32 weight and the
    bias are cast to it first (flax `Dense(dtype)` promotes all three), so
    in bfloat16 it is one cuBLAS bf16 product with float32 accumulation and
    its gradients reach the float32 parameters through the casts."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)
