"""Task layer of the LM path (mirrors `hyena_dna_tpu/tasks/tasks.py`).

A task bundles the loss and the perplexity statistics that the train and
eval steps (`train/step.py`) call: `LMTask` flattens (B, L, V) logits and
(B, L) targets for the vocabulary cross-entropy, `HG38Task` is the same for
hg38 pretraining. Other losses, device metrics (`last_k_ppl`,
`per_token_ppl`) and the rest of the JAX `TASK_REGISTRY` come with the
trainer (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hyena_dna_tpu_torch.tasks import metrics as M


class LMTask:
    """Next-token LM: cross-entropy over (B·L, V), ignore_index -100."""

    def __init__(self, loss: str = "cross_entropy", metrics=None, **_):
        if loss != "cross_entropy":
            raise NotImplementedError(
                f"loss {loss!r} is not ported yet (ROADMAP.md Queue 1 item 8)")
        if metrics:
            raise NotImplementedError(
                f"device metrics {list(metrics)} are not ported yet (ROADMAP.md Queue 1 item 8)")

    def prepare(self, logits: torch.Tensor, y: torch.Tensor):
        return logits.reshape(-1, logits.shape[-1]), y.reshape(-1)

    def compute_loss(self, logits: torch.Tensor, y: torch.Tensor,
                     train: bool = True) -> torch.Tensor:
        return M.cross_entropy(*self.prepare(logits, y))

    def compute_metrics(self, logits: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def loss_stats(self, logits: torch.Tensor, y: torch.Tensor):
        """(sum of NLL, token count) for exact perplexity."""
        return M.cross_entropy_stats(*self.prepare(logits, y))


class HG38Task(LMTask):
    """LMTask for hg38 pretraining. Its perplexity diagnostics are not
    ported yet, so asking for them raises."""

    def __init__(self, *args, last_k_ppl: Optional[int] = None, per_token_ppl=None,
                 seq_len: int = 1024, **kwargs):
        if last_k_ppl is not None or per_token_ppl is not None:
            raise NotImplementedError(
                "last_k_ppl / per_token_ppl are not ported yet (ROADMAP.md Queue 1 item 8)")
        super().__init__(*args, **kwargs)
