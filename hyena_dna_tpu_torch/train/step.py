"""Train and eval steps with in-step gradient accumulation (mirrors
`hyena_dna_tpu/train/step.py`).

`make_train_step(task, accumulate_grad_batches)` returns
`train_step(state, batch, generator=None) -> metrics`: the batch (x, y) of
leading size accum * micro is cut into `accum` microbatches; each runs
forward and backward in training mode, gradients are summed over them and
divided by `accum`, and the state applies them (clip + AdamW). Metrics, as
tensors on the batch's device (no host sync): `loss` (the mean of the
microbatch losses), `grad_norm` (the global norm before the clip),
`nll_sum` and `token_count` (exact perplexity statistics). Dropout masks
come from `generator`, so one seed gives one loss.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hyena_dna_tpu_torch.train.state import TrainState


def make_train_step(task, accumulate_grad_batches: int = 1) -> Callable:
    accum = accumulate_grad_batches

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None
                   ) -> Dict[str, torch.Tensor]:
        x, y = batch[0], batch[1]
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} does not split into {accum} microbatches")
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        micro = x.shape[0] // accum
        loss_sum = nll_sum = count = 0.0
        for i in range(accum):
            xm, ym = x[i * micro:(i + 1) * micro], y[i * micro:(i + 1) * micro]
            logits = model(xm, generator=generator)
            loss = task.compute_loss(logits, ym, train=True)
            loss.backward()
            nll, cnt = task.loss_stats(logits.detach(), ym)
            loss_sum, nll_sum, count = loss_sum + loss.detach(), nll_sum + nll, count + cnt
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        grad_norm = state.apply_gradients()
        return {"loss": loss_sum / accum, "grad_norm": grad_norm,
                "nll_sum": nll_sum, "token_count": count}

    return train_step


def make_eval_step(task) -> Callable:
    """(state, batch) -> {"loss", "nll_sum", "token_count"} in eval mode."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        x, y = batch[0], batch[1]
        state.model.eval()
        logits = state.model(x)
        metrics = {"loss": task.compute_loss(logits, y, train=False)}
        metrics.update(task.compute_metrics(logits, y))
        metrics["nll_sum"], metrics["token_count"] = task.loss_stats(logits, y)
        return metrics

    return eval_step


def make_multistep_train_step(task, steps_per_call: int,
                              accumulate_grad_batches: int = 1) -> Callable:
    """K train steps per call over batches stacked on a leading K axis;
    metrics come back stacked per step (the JAX `lax.scan` form, as a loop)."""
    one = make_train_step(task, accumulate_grad_batches)

    def multistep(state: TrainState, batches, generator: torch.Generator | None = None):
        xs, ys = batches[0], batches[1]
        if xs.shape[0] != steps_per_call:
            raise ValueError(f"expected {steps_per_call} stacked batches, got {xs.shape[0]}")
        per_step = [one(state, (xs[i], ys[i]), generator) for i in range(steps_per_call)]
        return {k: torch.stack([torch.as_tensor(m[k]) for m in per_step]) for k in per_step[0]}

    return multistep
