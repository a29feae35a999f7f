"""Task layer (mirrors `hyena_dna_tpu/tasks/tasks.py`).

A task bundles the loss, the device metrics and the host metric names that
the train and eval steps (`train/step.py`) and the trainer's evaluation call:

  * `BaseTask`: the loss and metrics by name from `tasks/metrics.py`
    (a name or {"_name_": ..., **kwargs}); host metric names from
    `host_metrics` or from `metrics` entries the streaming evaluator knows;
  * `LMTask`: flattens (B, L, V) logits and (B, L) targets for the
    vocabulary cross-entropy and gives the perplexity statistics;
  * `HG38Task`: `LMTask` with the `last_k_ppl` and `per_token_ppl`
    diagnostics at the dataset's sequence length (under a seq axis, the
    trainer sets the task's `mesh`, and the metrics gather the per-position
    NLL over the seq group, `tasks/metrics.py`);
  * `ICLTask`: k-shot in-context learning, the LM's last-position logits
    (B, V) against the 1-token label target (B, 1) that `data/icl.py`
    emits;
  * `MulticlassTask`: sequence classification, targets (B,) or (B, 1)
    against logits (B, C).

  * `AdaptiveLMTask`: `LMTask` over `adaptive_lm` models
    (`models/adaptive_softmax.py::AdaptiveLMModel`), which emit normalised
    log-probabilities, so the plain cross-entropy on them is the adaptive
    loss; the reference task's encoder and loss arguments are accepted and
    ignored (the model's config carries them).

The input encoders are in `tasks/encoders.py`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence

import torch

from hyena_dna_tpu_torch.tasks import metrics as M


def _get_metric(name_or_cfg) -> tuple:
    """(name, function) of a metric name or {"_name_": ..., **kwargs}."""
    if isinstance(name_or_cfg, str):
        name, kwargs = name_or_cfg, {}
    else:
        kwargs = dict(name_or_cfg)
        name = kwargs.pop("_name_")
    if name not in M.METRIC_FNS:
        raise KeyError(f"unknown device metric {name!r}")
    fn = M.METRIC_FNS[name]
    return name, (partial(fn, **kwargs) if kwargs else fn)


class BaseTask:
    def __init__(self, dataset=None, model=None, loss="cross_entropy", loss_val=None,
                 metrics: Optional[Sequence] = None,
                 host_metrics: Optional[Sequence[str]] = None, torchmetrics=None):
        _, self.loss = _get_metric(loss)
        self.loss_name = loss if isinstance(loss, str) else loss.get("_name_")
        self.loss_val = _get_metric(loss_val)[1] if loss_val is not None else None
        self.metric_names = []
        self.metric_fns: Dict[str, Callable] = {}
        self.host_metric_names = list(host_metrics or [])
        for m in metrics or []:
            name = m if isinstance(m, str) else m.get("_name_")
            if name in M.STREAMING_HOST_METRICS:
                self.host_metric_names.append(name)
                continue
            if name in M.LOSS_METRIC_FNS:
                self.metric_fns[name] = partial(M.LOSS_METRIC_FNS[name], loss_fn=self.loss)
                self.metric_names.append(name)
                continue
            name, fn = _get_metric(m)
            self.metric_fns[name] = fn
            self.metric_names.append(name)

    def prepare(self, logits: torch.Tensor, y: torch.Tensor):
        """Reshape the model output and targets before the loss (identity here)."""
        return logits, y

    def compute_loss(self, logits: torch.Tensor, y: torch.Tensor, train: bool = True,
                     **kw) -> torch.Tensor:
        logits, y = self.prepare(logits, y)
        fn = self.loss if (train or self.loss_val is None) else self.loss_val
        return fn(logits, y, **kw)

    def compute_metrics(self, logits: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, y = self.prepare(logits, y)
        return {name: fn(logits, y) for name, fn in self.metric_fns.items()}

    def loss_stats(self, logits: torch.Tensor, y: torch.Tensor):
        """(sum of NLL, count) for an exact epoch perplexity; None for non-LM tasks."""
        return None

    def loss_weight(self, y: torch.Tensor) -> torch.Tensor:
        """What this batch's loss is a mean over, as a float32 scalar: its
        rows. Ranks of a mesh weight their losses by it (`train/step.py`)."""
        return torch.tensor(float(y.shape[0]), device=y.device)


class LMTask(BaseTask):
    """Next-token LM: cross-entropy over (B·L, V), ignore_index -100."""

    def prepare(self, logits: torch.Tensor, y: torch.Tensor):
        return logits.reshape(-1, logits.shape[-1]), y.reshape(-1)

    def loss_stats(self, logits: torch.Tensor, y: torch.Tensor):
        return M.cross_entropy_stats(*self.prepare(logits, y))

    def loss_weight(self, y: torch.Tensor) -> torch.Tensor:
        """The count of targets that are not the cross-entropy's ignore index (-100)."""
        return (y != -100).sum().float()


class HG38Task(LMTask):
    """LMTask with the genomics perplexity diagnostics at `seq_len` (the
    global length; `mesh`, set by the trainer under a seq axis, says how the
    logits are split)."""

    mesh = None

    def __init__(self, *args, last_k_ppl: Optional[int] = None, per_token_ppl=None,
                 seq_len: int = 1024, **kwargs):
        super().__init__(*args, **kwargs)
        if last_k_ppl is not None:
            self.metric_fns["last_k_ppl"] = lambda logits, y: M.last_k_ppl(
                logits, y, seq_len=seq_len, k=last_k_ppl, mesh=self.mesh)
            self.metric_names.append("last_k_ppl")
        if per_token_ppl is not None:
            ks = list(per_token_ppl)
            self.metric_fns["per_token_ppl"] = lambda logits, y: M.per_token_ppl(
                logits, y, seq_len=seq_len, ks=ks, mesh=self.mesh)
            self.metric_names.append("per_token_ppl")


class ICLTask(LMTask):
    """k-shot ICL over label tokens: the LM's last-position logits against
    the label token (the JAX `ICLTask`, the trainable completion of the
    reference's `hg38_hyena_icl` experiment)."""

    def prepare(self, logits: torch.Tensor, y: torch.Tensor):
        return logits[:, -1, :], y.reshape(-1)


class MulticlassTask(BaseTask):
    """Sequence-level classification: targets (B,) or (B, 1), logits (B, C)."""

    def prepare(self, logits: torch.Tensor, y: torch.Tensor):
        return logits, y.reshape(-1)


class AdaptiveLMTask(LMTask):
    """`LMTask` under its own name for `adaptive_lm` models (the JAX
    `AdaptiveLMTask`); the reference task's encoder and loss arguments are
    accepted and ignored."""

    def __init__(self, *args, div_val=None, cutoffs=None, tie_weights=None, tie_projs=None,
                 init_scale=None, bias_scale=None, dropemb=None, dropsoft=None, **kwargs):
        super().__init__(*args, **kwargs)


TASK_REGISTRY: Dict[str, Callable] = {
    "base": BaseTask,
    "lm": LMTask,
    "hg38": HG38Task,
    "multiclass": MulticlassTask,
    "masked_multiclass": MulticlassTask,
    "icl": ICLTask,
    "adaptive_lm": AdaptiveLMTask,
}
