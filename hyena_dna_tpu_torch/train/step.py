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

Under a mesh of several ranks (`make_train_step(task, accum, mesh)`), each
rank runs its rows (and, with a seq axis, its columns) of every
microbatch, and the step's gradient is the single-process gradient of the
global batch's mean loss: each rank's microbatch loss is weighted by its
share of the global microbatch (`task.loss_weight`: its targets for an LM
task, its rows otherwise; one all-reduce of the weights per step), and the
gradients, summed over the microbatches and divided by `accum`, are
all-reduced over every rank (`mesh.grad_group`, a missing gradient as
zero) in one flat float32 buffer that also carries the loss and the
perplexity statistics. The clip then sees the global norm, and every rank
applies the same update. Under a seq axis a per-sequence target (a decoder
head's label) is whole on each of the S seq ranks, which each compute the
same loss: its rows count S times in the all-reduced total, so each copy
carries 1 / S of its data rank's share, the shares still sum to one global
loss, and the heads' collectives (`ops/distributed.py`), whose backwards
are exact adjoints, return to each rank its columns' part of the
gradient.

Under a model axis (tensor parallelism, `parallel/sharding.py`) the ranks
of a model group run the same rows and columns and compute the same loss,
so the loss weights, the loss and the statistics are reduced over
`mesh.grad_group` (the data x seq ranks of this rank's model index) with
the sharded parameters' gradients, in one flat buffer; the whole
parameters' gradients go over every rank (the world group) in a second
one: a replicated parameter's identical gradient is counted once (scaled
by 1 / M first), a partial one (`tp_partial`, the filter MLP of a split
Hyena operator) summed over the model axis.

`make_eval_step(task, return_logits)` returns `eval_step(state, batch)`:
the loss, the task's device metrics and the perplexity statistics in eval
mode, and with `return_logits` also the logits, which the trainer gathers
for the host metrics (mcc, f1, ROC-AUC).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from hyena_dna_tpu_torch.parallel.launch import timed
from hyena_dna_tpu_torch.parallel.sharding import PARTIAL, SHARDED, tp_layout
from hyena_dna_tpu_torch.train.state import TrainState


def _model_out(model, x, extra, **kw):
    """The model's output; a sequence model's (y, state) gives y."""
    out = model(x, **kw, **extra)
    return out[0] if isinstance(out, tuple) else out


def _all_reduce_flat(params, extras, group, scale=None):
    """Sum the gradients of `params` (None as zero; each times its `scale`,
    where given) and the `extras` scalars over `group` in one flat float32
    buffer; returns the extras."""
    grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
             for p in params]
    if scale is not None:
        grads = [g * c if c != 1 else g for g, c in zip(grads, scale)]
    flat = torch.cat(grads + [e.reshape(1).float() for e in extras])
    timed("all_reduce", flat, lambda: dist.all_reduce(flat, group=group))
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    return list(flat[offset:])


def reduce_gradients(model, extras, mesh):
    """Every gradient of the global batch's loss on every rank, from each
    rank's own (`extras`, scalars summed with them); returns the summed
    extras. Without a model axis, one flat sum over every rank; with one,
    the sharded parameters' and the extras over `mesh.grad_group` (skipped
    when the model axis is the whole mesh), the whole ones over every rank,
    a replicated gradient scaled by 1 / M first."""
    if mesh.model == 1:
        return _all_reduce_flat(list(model.parameters()), extras, mesh.grad_group)
    layout = tp_layout(model)
    named = list(model.named_parameters())
    kind = lambda name: layout.get(name, ("",))[0]
    sharded = [p for n, p in named if kind(n) == SHARDED]
    whole = [(n, p) for n, p in named if kind(n) != SHARDED]
    if mesh.replicas > 1:
        extras = _all_reduce_flat(sharded, extras, mesh.grad_group)
    _all_reduce_flat([p for _, p in whole], [], dist.group.WORLD,
                     [1.0 if kind(n) == PARTIAL else 1.0 / mesh.model for n, _ in whole])
    return list(extras)


def make_train_step(task, accumulate_grad_batches: int = 1, mesh=None) -> Callable:
    accum = accumulate_grad_batches
    tp = mesh is not None and mesh.model > 1
    # the loss weights' group: the ranks of this rank's model index
    group = mesh.grad_group if mesh is not None and mesh.replicas > 1 else None

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
        if group is not None:  # each rank's share of each global microbatch
            w = torch.stack([task.loss_weight(y[i * micro:(i + 1) * micro])
                             for i in range(accum)])
            total = w.clone()
            timed("all_reduce", total, lambda: dist.all_reduce(total, group=group))
            share = torch.where(total > 0, w / total.clamp(min=1e-30), torch.zeros_like(w))
        loss_sum, stats = 0.0, None
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            logits = _model_out(model, x[rows], {k: v[rows] for k, v in extra.items()},
                                generator=generator)
            loss = task.compute_loss(logits, y[rows], train=True)
            if group is not None:
                loss = loss * share[i]
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            s = task.loss_stats(logits.detach(), y[rows])
            if s is not None:
                stats = s if stats is None else (stats[0] + s[0], stats[1] + s[1])
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        if group is not None or tp:
            extras = [torch.as_tensor(loss_sum)] + (list(stats) if stats is not None else [])
            loss_sum, *rest = reduce_gradients(model, extras, mesh)
            stats = tuple(rest) if stats is not None else None
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
