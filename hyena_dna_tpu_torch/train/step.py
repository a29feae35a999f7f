"""Train and eval steps with in-step gradient accumulation (mirrors
`hyena_dna_tpu/train/step.py`).

`make_train_step(task, accumulate_grad_batches)` returns
`train_step(state, batch, generator=None) -> metrics`: the batch (x, y) or
(x, y, extra) of leading size accum * micro is cut into `accum`
microbatches (`extra`, a dict of per-row tensors such as a classification
`mask`, is cut the same way and passed to the model as keywords); each runs
forward and backward in training mode, gradients are summed over them and
divided by `accum`, and the state applies them (clip + the optimizer).
Metrics, as tensors on the batch's device (no host sync): `loss` (the mean
of the microbatch losses), `grad_norm` (the global norm before the clip),
and for an LM task `nll_sum` and `token_count` (exact perplexity
statistics). Dropout masks come from `generator`, so one seed gives one
loss.

`make_eval_step(task, return_logits)` returns `eval_step(state, batch)`:
the loss, the task's device metrics and the perplexity statistics in eval
mode, and with `return_logits` also the logits, which the trainer gathers
for the host metrics (mcc, f1, ROC-AUC).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hyena_dna_tpu_torch.train.state import TrainState


def _model_out(model, x, extra, **kw):
    """The model's output; a sequence model's (y, state) gives y."""
    out = model(x, **kw, **extra)
    return out[0] if isinstance(out, tuple) else out


def make_train_step(task, accumulate_grad_batches: int = 1) -> Callable:
    accum = accumulate_grad_batches

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None
                   ) -> Dict[str, torch.Tensor]:
        x, y = batch[0], batch[1]
        extra = batch[2] if len(batch) > 2 else {}
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} does not split into {accum} microbatches")
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        micro = x.shape[0] // accum
        loss_sum, stats = 0.0, None
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            logits = _model_out(model, x[rows], {k: v[rows] for k, v in extra.items()},
                                generator=generator)
            loss = task.compute_loss(logits, y[rows], train=True)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            s = task.loss_stats(logits.detach(), y[rows])
            if s is not None:
                stats = s if stats is None else (stats[0] + s[0], stats[1] + s[1])
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        metrics = {"loss": loss_sum / accum, "grad_norm": state.apply_gradients()}
        if stats is not None:
            metrics["nll_sum"], metrics["token_count"] = stats
        return metrics

    return train_step


def make_eval_step(task, return_logits: bool = False) -> Callable:
    """(state, batch) -> metrics {"loss", device metrics, "nll_sum",
    "token_count"} in eval mode, or (metrics, logits) with `return_logits`."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        x, y = batch[0], batch[1]
        extra = batch[2] if len(batch) > 2 else {}
        state.model.eval()
        logits = _model_out(state.model, x, extra)
        metrics = {"loss": task.compute_loss(logits, y, train=False)}
        metrics.update(task.compute_metrics(logits, y))
        stats = task.loss_stats(logits, y)
        if stats is not None:
            metrics["nll_sum"], metrics["token_count"] = stats
        return (metrics, logits) if return_logits else metrics

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
