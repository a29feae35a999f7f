"""Optimizer: AdamW, Adam or LAMB over per-parameter groups, global-norm
clip, step-wise schedules (mirrors `hyena_dna_tpu/train/optim.py`).

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

Each label is one group of the chosen optimizer: `adamw` is
`torch.optim.AdamW` (the update of `optax.adamw`); `adam` is
`torch.optim.Adam`, whose weight decay is coupled L2 (wd * p added to the
gradient before the moments), as the JAX package chains
`add_decayed_weights` before `optax.adam`; `lamb` is `Lamb` below, the
reference JITLamb the JAX `lamb` transform reproduces. A group whose lr is 0
is frozen, as optax's `set_to_zero`: no update and no weight decay, yet its
gradients still count in the clip norm, because optax chains the clip
before `multi_transform`. `frozen` ({name: "frozen" | None}, from the
`load_backbone` hook's `freeze_backbone`) relabels parameters "frozen",
which is such a group.
The clip is written out: every gradient is scaled by c / ||g|| when the
global norm ||g|| over all parameters exceeds c (`clip_grad_norm_` adds
1e-6 to the norm, which optax does not). Each group's lr is its schedule
evaluated at the step count before the increment, as optax does.

Under a model axis (`mesh`, tensor parallelism: `parallel/sharding.py`) a
rank holds slices of the sharded parameters and their moments. The global
norm sums a sharded parameter's squares over the model group (one
all-reduce) and counts a whole one once; LAMB's per-tensor ||w|| and ||a||
of a sharded tensor are summed over the model group the same way (one
all-reduce a step), so both equal the values without a model axis.
`state_dict` gathers the moments whole (a collective: every rank calls it)
and `load_state_dict` takes the rank's slices, so a checkpoint's optimizer
state resumes under any mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from hyena_dna_tpu_torch.parallel.launch import timed
from hyena_dna_tpu_torch.parallel.sharding import (SHARDED, gather_tensor, shard_tensor,
                                                   tp_layout)

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


class Lamb(torch.optim.Optimizer):
    """LAMB with the reference JITLamb's semantics (the JAX `optim.lamb`): no
    bias correction, the weight decay added to the normalised Adam step
    before the trust ratio, the weight norm clamped to [0, 10], the trust
    ratio 1 where either norm is 0. Per parameter tensor:

      m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
      a = m / (sqrt(v) + eps) + wd p
      p -= lr * (min(|p|, 10) / (|a| + eps)) * a
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps,
                                  "weight_decay": weight_decay})
        # under a model axis: the sharded tensors and the group over which
        # their norms sum (`Optimizer` sets both)
        self.sharded, self.model_group = set(), None

    @torch.no_grad()
    def step(self, closure=None):
        """One step; under a model axis a sharded tensor's ||w||^2 and
        ||a||^2 are summed over the model group, in one all-reduce of every
        tensor's pair."""
        items = []
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                v.mul_(b2).add_(p.grad * p.grad, alpha=1.0 - b2)
                a = m.float() / (v.float().sqrt() + eps) + wd * p.float()
                items.append((p, a, lr, eps))
        if not items:
            return
        sq = torch.stack([torch.stack([p.float().pow(2).sum(), a.pow(2).sum()])
                          for p, a, _, _ in items])
        if self.model_group is not None:
            mine = torch.tensor([id(p) in self.sharded for p, _, _, _ in items],
                                device=sq.device)[:, None]
            part = sq * mine
            timed("tp_all_reduce", part, lambda: dist.all_reduce(part, group=self.model_group))
            sq = torch.where(mine, part, sq)
        for (p, a, lr, eps), (w2, a2) in zip(items, sq):
            wn, an = w2.sqrt().clamp(0.0, 10.0), a2.sqrt()
            trust = torch.where((wn == 0) | (an == 0), torch.ones_like(wn), wn / (an + eps))
            p.add_((-lr * trust * a).to(p.dtype))


OPTIMIZERS = {"adamw": torch.optim.AdamW, "adam": torch.optim.Adam, "lamb": Lamb}


class Optimizer:
    """Clip, then one step of the chosen optimizer per label group under its
    schedule.

    `step()` reads the gradients in `p.grad` (a missing one counts as
    zero, as a JAX gradient would be), returns the global gradient norm
    before the clip, and advances the step count. `state_dict` /
    `load_state_dict` carry the step count and the moments (whole tensors
    under a model axis).
    """

    def __init__(self, model: nn.Module, labels: Dict[str, str],
                 hparams: Dict[str, tuple], schedules: Dict[str, Callable],
                 betas, eps: float, gradient_clip_val: Optional[float],
                 optimizer_name: str = "adamw", mesh=None):
        self.params = [p for _, p in model.named_parameters()]
        self.gradient_clip_val = gradient_clip_val
        self.schedules = schedules
        self.count = 0
        groups, self.slots = [], []  # slots: (layout entry or None) per state index
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        layout = tp_layout(model) if self.mesh is not None else {}
        sharded = lambda name: layout.get(name, ("",))[0] == SHARDED
        for label, (lr, wd) in hparams.items():
            named = [(name, p) for name, p in model.named_parameters() if labels[name] == label]
            if named and lr != 0.0:  # lr 0: frozen, no update at all
                groups.append({"params": [p for _, p in named], "lr": lr, "weight_decay": wd,
                               "label": label})
                self.slots += [layout[name] if sharded(name) else None for name, _ in named]
        self.inner = OPTIMIZERS[optimizer_name](groups, betas=tuple(betas), eps=eps)
        self.sharded = [p for name, p in model.named_parameters() if sharded(name)]
        if self.mesh is not None and isinstance(self.inner, Lamb):
            self.inner.sharded = {id(p) for p in self.sharded}
            self.inner.model_group = self.mesh.model_group

    def _moments(self, state: dict, fn) -> dict:
        """The inner state with `fn(tensor, layout entry)` applied to each
        sharded parameter's moments, in index order (the same on every rank)."""
        out = {}
        for i in sorted(state):
            slot = self.slots[i]
            out[i] = {k: (fn(v, slot) if slot is not None and torch.is_tensor(v) and v.dim()
                          else v) for k, v in state[i].items()}
        return out

    def state_dict(self) -> dict:
        """The step count and the moments, whole; under a model axis a
        collective."""
        inner = self.inner.state_dict()
        if self.mesh is not None:
            inner["state"] = self._moments(inner["state"],
                                           lambda v, s: gather_tensor(v, *s[1:], self.mesh))
        return {"count": self.count, "inner": inner}

    def load_state_dict(self, state: dict) -> None:
        """From whole moments; under a model axis each rank takes its slices."""
        self.count = int(state["count"])
        inner = state["inner"]
        if self.mesh is not None:
            inner = {**inner, "state": self._moments(
                inner["state"], lambda v, s: shard_tensor(v, *s[1:], self.mesh))}
        self.inner.load_state_dict(inner)

    def _global_norm(self, grads) -> torch.Tensor:
        """||g|| over every parameter; a sharded one's squares summed over
        the model group."""
        ids = {id(p) for p in self.sharded}
        square = lambda sel: sum((g.float().pow(2).sum() for p, g in zip(self.params, grads)
                                  if (id(p) in ids) == sel), torch.zeros((), device=grads[0].device))
        part = square(True)
        if self.mesh is not None:
            timed("tp_all_reduce", part,
                  lambda: dist.all_reduce(part, group=self.mesh.model_group))
        return torch.sqrt(part + square(False))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = self._global_norm(grads)
        if self.gradient_clip_val:
            c = float(self.gradient_clip_val)
            factor = torch.where(norm > c, c / norm, torch.ones_like(norm))
            for g in grads:
                g.mul_(factor.to(g.dtype))
        for group in self.inner.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.inner.step()
        self.count += 1
        return norm


def build_optimizer(model: nn.Module, lr: float = 6e-4, weight_decay: float = 0.1,
                    betas=(0.9, 0.999), eps: float = 1e-8,
                    filter_lr: Optional[float] = 1e-3, filter_wd: float = 0.0,
                    lr_pos_emb: float = 1e-5, modulation_lr: float = 0.0,
                    scheduler: Optional[dict] = None,
                    gradient_clip_val: Optional[float] = 1.0,
                    frozen: Optional[Dict[str, Optional[str]]] = None,
                    optimizer_name: str = "adamw", mesh=None):
    """(Optimizer, labels) with the JAX `build_optimizer` defaults.

    `scheduler` is e.g. {"_name_": "cosine_warmup_timm", "t_initial": ...};
    each group's schedule has that shape anchored at the group's own lr.
    `frozen`: {parameter name: "frozen" | None} overrides; "frozen"
    parameters get no update. `mesh`: under a model axis, the norms and the
    moments' checkpoint form as the `Optimizer` docstring says.
    """
    if optimizer_name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer_name!r}")
    sched_cfg = dict(scheduler or {"_name_": "constant"})
    sched_fn = SCHEDULE_REGISTRY[sched_cfg.pop("_name_", "constant")]
    hparams = {
        "main": (lr, weight_decay),
        "no_decay": (lr, 0.0),
        "filter": (lr if filter_lr is None else filter_lr, filter_wd),
        "pos_emb": (lr_pos_emb, 0.0),
        "modulation": (modulation_lr, 0.0),
        "frozen": (0.0, 0.0),
    }
    schedules = {label: sched_fn(base, **sched_cfg) for label, (base, _) in hparams.items()}
    labels = label_params(model)
    for name, label in (frozen or {}).items():
        if label == "frozen" and name in labels:
            labels[name] = "frozen"
    return (Optimizer(model, labels, hparams, schedules, betas, eps, gradient_clip_val,
                      optimizer_name, mesh), labels)
