"""Activation registry (mirrors `hyena_dna_tpu/models/nn.py::activation_fn`)
and the dropout every module of the port uses.

Only the identity, the Hyena operator's activation on the ported path, is
here; the rest of the JAX registry comes with ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


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
