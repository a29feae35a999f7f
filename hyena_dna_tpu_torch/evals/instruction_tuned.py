"""Instruction-tuned ICL eval (mirrors
`hyena_dna_tpu/evals/instruction_tuned.py`): fine-tune the whole pretrained
LM on k-shot prompts, then measure label-token accuracy.

The data are soft prompting's (`soft_prompting.py`), but every parameter
trains, with AdamW (`torch.optim.AdamW`, the update of `optax.adamw`) at
weight decay 0 by default; the loss is the cross-entropy of the last
position's logits against the label token. The LM is tuned in place, in
eval mode (no dropout), as the JAX eval runs it deterministic.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
from torch import nn

from hyena_dna_tpu_torch.evals.soft_prompting import (batches, evaluate_soft_prompt,
                                                      last_token_loss, to_device)


def instruction_tune(lm: nn.Module, train_loader, *, lr: float = 1e-4, steps: int = 200,
                     weight_decay: float = 0.0, log_every: int = 50
                     ) -> Tuple[nn.Module, Callable, List[float]]:
    """Tune `lm` in place; returns (lm, predict_fn, the loss of every step)."""
    lm.eval()
    device = next(lm.parameters()).device
    opt = torch.optim.AdamW(lm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    losses = []
    for done, batch in enumerate(batches(train_loader, steps), 1):
        x, y = to_device(batch, device)
        loss = last_token_loss(lm(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())  # read at the end: no sync a step
        if log_every and done % log_every == 0:
            print(f"[instruction-tune step {done}] loss={float(losses[-1]):.4f}", flush=True)

    @torch.no_grad()
    def predict(x) -> torch.Tensor:
        return lm(torch.as_tensor(np.asarray(x), dtype=torch.long, device=device))[:, -1] \
            .argmax(-1)

    return lm, predict, [float(v) for v in losses]


evaluate = evaluate_soft_prompt  # label-token accuracy, as the JAX `evaluate`
