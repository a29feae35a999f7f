"""Optimizer: AdamW over per-parameter groups, global-norm clip, step-wise
schedules (mirrors `hyena_dna_tpu/train/optim.py`).

Parameters are labelled by name with the rules of the JAX
`_label_for_path`, applied to the reference torch names the port carries:

  * `filter_fn.pos_emb.z` -> "pos_emb" (lr `lr_pos_emb`, wd 0);
  * `filter_fn.modulation.deltas` -> "modulation" (lr `modulation_lr`, wd 0);
  * `filter_fn.bias` (the conv's D skip) -> "no_decay";
  * the rest of `filter_fn` (implicit-MLP weights, biases, Sin `freq`) ->
    "filter" (lr `filter_lr`, wd `filter_wd`);
  * biases (but not `short_filter.bias`, which flax names
    `short_filter_bias` and so decays), `norm1`, `norm2`, `ln_f` and the
    embeddings -> "no_decay";
  * everything else -> "main".

Each label is one AdamW group (`torch.optim.AdamW`, the update of
`optax.adamw`). A group whose lr is 0 is frozen, as optax's
`set_to_zero`: no update and no weight decay, yet its gradients still count
in the clip norm, because optax chains the clip before `multi_transform`.
The clip is written out: every gradient is scaled by c / ||g|| when the
global norm ||g|| over all parameters exceeds c (`clip_grad_norm_` adds
1e-6 to the norm, which optax does not). Each group's lr is its schedule
evaluated at the step count before the increment, as optax does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

NO_DECAY_SUBSTRINGS = ("norm1", "norm2", "ln_f", "word_embeddings", "position_embeddings")


# schedules (step -> lr), as the JAX SCHEDULE_REGISTRY

def timm_cosine(base_lr: float, t_initial: int, lr_min: float = 0.0, warmup_t: int = 0,
                warmup_lr_init: float = 0.0, cycle_limit: int = 1, t_in_epochs: bool = False,
                **_) -> Callable[[int], float]:
    """timm CosineLRScheduler: linear warmup from warmup_lr_init to base_lr
    over warmup_t steps, then cosine to lr_min by t_initial; lr_min after."""
    t_initial = max(int(t_initial), 1)
    warmup_t = int(warmup_t)
    span = max(t_initial - warmup_t, 1)

    def schedule(step: int) -> float:
        if step < warmup_t:
            return warmup_lr_init + step * ((base_lr - warmup_lr_init) / max(warmup_t, 1))
        frac = min(max(step - warmup_t, 0), span) / span
        return lr_min + 0.5 * (base_lr - lr_min) * (1 + math.cos(math.pi * frac))

    return schedule


def cosine_warmup(base_lr: float, T_max: int, eta_min: float = 0.0, warmup_step: int = 0, **_):
    """Linear warmup, then torch CosineAnnealingLR."""
    span = max(int(T_max) - int(warmup_step), 1)

    def schedule(step: int) -> float:
        if step < warmup_step:
            return base_lr * (step + 1) / max(warmup_step, 1)
        t = min(max(step - warmup_step, 0), span)
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * t / span))

    return schedule


def invsqrt(base_lr: float, warmup_step: int = 0, **_):
    """Inverse square root with linear warmup."""

    def schedule(step: int) -> float:
        if step <= warmup_step:
            return base_lr * (step + 1) / max(warmup_step, 1) ** 1.5
        return base_lr / math.sqrt(max(step, 1))

    return schedule


def constant_warmup(base_lr: float, warmup_step: int = 0, **_):
    def schedule(step: int) -> float:
        return base_lr * (step + 1) / max(warmup_step, 1) if step < warmup_step else base_lr

    return schedule


def constant(base_lr: float, **_):
    return lambda step: base_lr


SCHEDULE_REGISTRY: Dict[str, Callable] = {
    "cosine_warmup_timm": timm_cosine,
    "cosine_warmup": cosine_warmup,
    "invsqrt": invsqrt,
    "constant_warmup": constant_warmup,
    "constant": constant,
}


def label_for_name(name: str) -> str:
    """The JAX optimizer label of a reference-named parameter."""
    parts = name.split(".")
    leaf = parts[-1]
    if "filter_fn" in parts:
        if parts[-2:] == ["pos_emb", "z"]:
            return "pos_emb"
        if parts[-2:] == ["modulation", "deltas"]:
            return "modulation"
        if parts[-2:] == ["filter_fn", "bias"]:
            return "no_decay"
        return "filter"
    if leaf == "bias" and parts[-2] != "short_filter":
        return "no_decay"
    if any(s in name for s in NO_DECAY_SUBSTRINGS):
        return "no_decay"
    return "main"


def label_params(model: nn.Module) -> Dict[str, str]:
    """{parameter name: label} over `model.named_parameters()`."""
    return {name: label_for_name(name) for name, _ in model.named_parameters()}


class Optimizer:
    """Clip, then one AdamW step per label group under its schedule.

    `step()` reads the gradients in `p.grad` (a missing one counts as
    zero, as a JAX gradient would be), returns the global gradient norm
    before the clip, and advances the step count.
    """

    def __init__(self, model: nn.Module, labels: Dict[str, str],
                 hparams: Dict[str, tuple], schedules: Dict[str, Callable],
                 betas, eps: float, gradient_clip_val: Optional[float]):
        self.params = [p for _, p in model.named_parameters()]
        self.gradient_clip_val = gradient_clip_val
        self.schedules = schedules
        self.count = 0
        groups = []
        for label, (lr, wd) in hparams.items():
            ps = [p for name, p in model.named_parameters() if labels[name] == label]
            if ps and lr != 0.0:  # lr 0: frozen, no update at all
                groups.append({"params": ps, "lr": lr, "weight_decay": wd, "label": label})
        self.adamw = torch.optim.AdamW(groups, betas=tuple(betas), eps=eps)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        if self.gradient_clip_val:
            c = float(self.gradient_clip_val)
            factor = torch.where(norm > c, c / norm, torch.ones_like(norm))
            for g in grads:
                g.mul_(factor.to(g.dtype))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.adamw.step()
        self.count += 1
        return norm


def build_optimizer(model: nn.Module, lr: float = 6e-4, weight_decay: float = 0.1,
                    betas=(0.9, 0.999), eps: float = 1e-8,
                    filter_lr: Optional[float] = 1e-3, filter_wd: float = 0.0,
                    lr_pos_emb: float = 1e-5, modulation_lr: float = 0.0,
                    scheduler: Optional[dict] = None,
                    gradient_clip_val: Optional[float] = 1.0,
                    optimizer_name: str = "adamw"):
    """(Optimizer, labels) with the JAX `build_optimizer` defaults.

    `scheduler` is e.g. {"_name_": "cosine_warmup_timm", "t_initial": ...};
    each group's schedule has that shape anchored at the group's own lr.
    """
    if optimizer_name != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer_name!r} is not ported yet; adam and lamb wait "
            "(ROADMAP.md Queue 1 item 5)")
    sched_cfg = dict(scheduler or {"_name_": "constant"})
    sched_fn = SCHEDULE_REGISTRY[sched_cfg.pop("_name_", "constant")]
    hparams = {
        "main": (lr, weight_decay),
        "no_decay": (lr, 0.0),
        "filter": (lr if filter_lr is None else filter_lr, filter_wd),
        "pos_emb": (lr_pos_emb, 0.0),
        "modulation": (modulation_lr, 0.0),
    }
    schedules = {label: sched_fn(base, **sched_cfg) for label, (base, _) in hparams.items()}
    labels = label_params(model)
    return Optimizer(model, labels, hparams, schedules, betas, eps, gradient_clip_val), labels
