"""Soft-prompting ICL eval (mirrors `hyena_dna_tpu/evals/soft_prompting.py`):
trainable soft tokens spliced in front of the embedded prompt, and only
those tuned.

`SoftPromptModel` embeds the ids with the frozen LM's table, prepends the
(n_soft, d_model) soft matrix and runs the LM on `inputs_embeds`.
`tune_soft_prompt` trains the matrix alone on (prompt, label token)
batches with AdamW (`torch.optim.AdamW`, the update of `optax.adamw`, at
its default weight decay 1e-4): the loss is the cross-entropy of the last
position's logits against the label token, and only the soft matrix is
handed to the optimizer and receives gradients (`backward(inputs=...)`),
so the LM's parameters never change. The LM runs in eval mode (no
dropout), as the JAX eval runs it deterministic. On the card every step
runs kernels A and B forward and A' and C backward in each layer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class SoftPromptModel(nn.Module):
    """logits = lm([soft_tokens; embed(ids)]): (B, n_soft + L, V).

    The soft matrix starts from `soft` when given, else N(0, init_std)
    drawn from `generator` (default: a CPU generator seeded 0, as the JAX
    eval's default key is 0); it lives on the LM's device."""

    def __init__(self, lm: nn.Module, n_soft: int, d_model: int, init_std: float = 0.02,
                 generator: Optional[torch.Generator] = None,
                 soft: Optional[torch.Tensor] = None):
        super().__init__()
        self.lm = lm
        device = next(lm.parameters()).device
        if soft is None:
            generator = generator or torch.Generator().manual_seed(0)
            soft = torch.empty(n_soft, d_model).normal_(0.0, init_std, generator=generator)
        self.soft_tokens = nn.Parameter(torch.as_tensor(soft, dtype=torch.float32).to(device))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        embeds = self.lm.backbone.embeddings(input_ids)
        soft = self.soft_tokens[None].expand(embeds.shape[0], -1, -1).to(embeds.dtype)
        return self.lm(None, inputs_embeds=torch.cat([soft, embeds], dim=1))


def last_token_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the last position's logits against the label token."""
    return F.cross_entropy(logits[:, -1].float(), y.reshape(-1))


def batches(loader, steps: int):
    """`steps` batches, restarting the loader when an epoch ends (the JAX
    evals' loop)."""
    done, it = 0, iter(loader)
    while done < steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        done += 1
        yield batch


def to_device(batch, device) -> Tuple[torch.Tensor, torch.Tensor]:
    x = torch.as_tensor(np.asarray(batch[0]), dtype=torch.long, device=device)
    y = torch.as_tensor(np.asarray(batch[1]), dtype=torch.long, device=device).reshape(-1)
    return x, y


def tune_soft_prompt(lm: nn.Module, train_loader, *, n_soft: int = 16, d_model: int,
                     lr: float = 1e-3, steps: int = 200,
                     generator: Optional[torch.Generator] = None,
                     soft: Optional[torch.Tensor] = None, log_every: int = 50
                     ) -> Tuple[SoftPromptModel, Callable, List[float]]:
    """Train the soft tokens; returns (soft-prompt model, predict_fn, the
    loss of every step). predict_fn maps (B, L) ids to the last position's
    argmax token."""
    lm.eval()
    model = SoftPromptModel(lm, n_soft, d_model, generator=generator, soft=soft)
    device = model.soft_tokens.device
    opt = torch.optim.AdamW([model.soft_tokens], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)  # optax.adamw's default, as the JAX eval takes it
    losses = []
    for done, batch in enumerate(batches(train_loader, steps), 1):
        x, y = to_device(batch, device)
        loss = last_token_loss(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward(inputs=[model.soft_tokens])
        opt.step()
        losses.append(loss.detach())  # read at the end: no sync a step
        if log_every and done % log_every == 0:
            print(f"[soft-prompt step {done}] loss={float(losses[-1]):.4f}", flush=True)

    @torch.no_grad()
    def predict(x) -> torch.Tensor:
        return model(torch.as_tensor(np.asarray(x), dtype=torch.long, device=device))[:, -1] \
            .argmax(-1)

    return model, predict, [float(v) for v in losses]


def evaluate_soft_prompt(predict_fn: Callable, loader) -> float:
    """Label-token accuracy over a loader of (prompt, label) batches."""
    correct = total = 0
    for batch in loader:
        preds = predict_fn(batch[0]).cpu().numpy()
        y = np.asarray(batch[1]).reshape(-1)
        correct += int((preds == y).sum())
        total += len(y)
    return correct / max(total, 1)
