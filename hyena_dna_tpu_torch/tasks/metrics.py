"""LM metrics of the train and eval paths (mirrors `hyena_dna_tpu/tasks/metrics.py`).

`cross_entropy` is the training loss; `cross_entropy_stats` gives the (sum
of NLL, token count) sufficient statistics; `Perplexity` accumulates them so
the result is exact under any batching. The other metrics of the JAX
registry come with the trainer (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import math

import torch


def _masked_nll(logits: torch.Tensor, y: torch.Tensor, ignore_index: int):
    logits = logits.reshape(-1, logits.shape[-1]).float()
    y = y.reshape(-1)
    logz = torch.logsumexp(logits, dim=-1)
    mask = y != ignore_index
    y_safe = torch.where(mask, y, torch.zeros_like(y))
    nll = logz - logits.gather(-1, y_safe[:, None].long())[:, 0]
    return nll, mask.float()


def cross_entropy(logits: torch.Tensor, y: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean NLL over the targets that are not `ignore_index` (float32)."""
    nll, mask = _masked_nll(logits, y, ignore_index)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy_stats(logits: torch.Tensor, y: torch.Tensor,
                        ignore_index: int = -100):
    """(sum of NLL, count of non-ignored targets), both float32 scalars."""
    nll, mask = _masked_nll(logits, y, ignore_index)
    return (nll * mask).sum(), mask.sum()


class Perplexity:
    """exp(sum NLL / count) over every update."""

    def __init__(self):
        self.total_nll = 0.0
        self.count = 0.0

    def update(self, nll_sum, count) -> None:
        self.total_nll += float(nll_sum)
        self.count += float(count)

    def compute(self) -> float:
        return math.exp(self.total_nll / self.count) if self.count else float("nan")
