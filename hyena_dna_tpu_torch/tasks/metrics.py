"""Metric functions (mirrors `hyena_dna_tpu/tasks/metrics.py`).

Two tiers, as in the JAX module:

  * device metrics (`METRIC_FNS`, `LOSS_METRIC_FNS`): torch functions of
    (logits or outputs, targets) computed by the train and eval steps on the
    batch's device: cross-entropy (ignore_index by masking), accuracy (and
    @k), mse / mae, last-k and per-token perplexity, the Student-t and
    Gaussian likelihood losses, and the metrics that wrap the task loss
    (loss, bpb, ppl);
  * host metrics (`HOST_METRIC_FNS`, `StreamingHostMetrics`): whole-epoch
    numpy metrics over gathered logits (mcc, f1, ROC-AUC). They use no
    scikit-learn: mcc and f1 come from the confusion matrix, ROC-AUC from
    the ranks of the positive class's scores (the Mann-Whitney statistic,
    ties at their average rank), which is what scikit-learn computes for a
    binary target.

`cross_entropy_stats` gives the (sum of NLL, token count) sufficient
statistics, and `Perplexity` accumulates them, so the epoch perplexity is
exact under any batching.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hyena_dna_tpu_torch.ops.distributed import seq_gather


# device metrics: (logits or outputs, y) -> a scalar tensor

def _flatten_logits(logits: torch.Tensor) -> torch.Tensor:
    return logits.reshape(-1, logits.shape[-1])


def _masked_nll(logits: torch.Tensor, y: torch.Tensor, ignore_index: int):
    logits = _flatten_logits(logits).float()
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


def padded_cross_entropy(logits, y, pad_mask=None, pad_value: int = -1):
    """Cross-entropy that ignores the positions `pad_mask` marks."""
    if pad_mask is not None:
        y = torch.where(pad_mask.bool(), torch.full_like(y, pad_value), y)
    return cross_entropy(logits, y, ignore_index=pad_value)


def soft_cross_entropy(logits, y, label_smoothing: float = 0.0):
    logits = _flatten_logits(logits).float()
    n = logits.shape[-1]
    if y.dim() == logits.dim() - 1 or tuple(y.shape) == tuple(logits.shape[:-1]):
        y = F.one_hot(y.reshape(-1).long(), n).float()
    else:
        y = y.reshape(-1, n).float()
    if label_smoothing:
        y = y * (1 - label_smoothing) + label_smoothing / n
    return -(y * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def _squeeze_binary(logits):
    return logits[..., 0] if logits.shape[-1] == 1 else logits


def binary_cross_entropy(logits, y):
    logits = _squeeze_binary(logits).float()
    y = y.float()
    return (logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()


def binary_accuracy(logits, y):
    return ((_squeeze_binary(logits) >= 0) == y).float().mean()


def accuracy(logits, y):
    logits = _flatten_logits(logits)
    preds = logits.argmax(dim=-1)
    if y.numel() > logits.shape[0]:  # soft labels
        y = y.argmax(dim=-1)
    return (preds == y.reshape(-1)).float().mean()


def accuracy_ignore_index(logits, y, ignore_index: int = -100):
    logits = _flatten_logits(logits)
    y = y.reshape(-1)
    mask = (y != ignore_index).float()
    return ((logits.argmax(dim=-1) == y).float() * mask).sum() / mask.sum().clamp(min=1.0)


def accuracy_at_k(logits, y, k: int = 1):
    logits = _flatten_logits(logits)
    if y.numel() > logits.shape[0]:
        y = y.argmax(dim=-1)
    topk = logits.topk(k, dim=-1).indices
    return (topk == y.reshape(-1)[:, None]).any(dim=-1).float().mean()


def mse(outs, y, len_batch=None):
    if y.dim() < outs.dim():
        outs = outs.squeeze(-1)
    return ((outs - y) ** 2).mean()


def mae(outs, y, len_batch=None):
    if y.dim() < outs.dim():
        outs = outs.squeeze(-1)
    return (outs - y).abs().mean()


def forecast_rmse(outs, y, len_batch=None):
    return ((outs - y) ** 2).mean(dim=1).sqrt().mean()


def _position_nll(logits, y, seq_len: int, mesh=None):
    """(rows, seq_len) NLL at each global position. Under a seq axis
    (`mesh`) the rank's logits hold its seq_len / S columns of each row: its
    NLL is computed there and gathered over the seq group
    (`ops/distributed.py::seq_gather`), V times fewer bytes than the logits."""
    if mesh is None or mesh.seq == 1:
        local = seq_len
    else:
        local = seq_len // mesh.seq
    logits = logits.reshape(-1, local, logits.shape[-1]).float()
    y = y.reshape(-1, local)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None].long())[..., 0]
    return seq_gather(nll, mesh)


def last_k_ppl(logits, y, seq_len: int = 1024, k: Optional[int] = None, mesh=None):
    """Perplexity over the last k tokens of each sequence (k None: all)."""
    nll = _position_nll(logits, y, seq_len, mesh)
    return torch.exp(nll[:, seq_len - (k or seq_len):].mean())


def per_token_ppl(logits, y, seq_len: int = 1024, ks=None, mesh=None):
    """Perplexity at the 1-based positions `ks`: a vector over ks."""
    idx = torch.as_tensor(ks if ks is not None else [seq_len], device=logits.device) - 1
    return torch.exp(_position_nll(logits, y, seq_len, mesh)[:, idx].mean(dim=0))


def student_t_loss(outs, y):
    """Negative log-likelihood of a Student-t head (mu, sigma, nu)."""
    mu, sigma, nu = outs[..., 0], F.softplus(outs[..., 1]), 2.0 + F.softplus(outs[..., 2])
    y = y.squeeze(-1)
    nup1_half = (nu + 1.0) / 2.0
    part1 = 1.0 / nu * ((y - mu) / sigma) ** 2
    z = (torch.lgamma(nup1_half) - torch.lgamma(nu / 2.0)
         - 0.5 * torch.log(math.pi * nu) - torch.log(sigma))
    return -(z - nup1_half * torch.log1p(part1)).mean()


def gaussian_ll_loss(outs, y):
    """Gaussian NLL head (mu, sigma)."""
    mu, sigma = outs[..., 0], F.softplus(outs[..., 1])
    y = y.squeeze(-1)
    ll = -(torch.log(sigma) + 0.5 * math.log(2 * math.pi) + 0.5 * ((y - mu) / sigma) ** 2)
    return -ll.mean()


def loss_metric(x, y, loss_fn):
    return loss_fn(x, y)


def bpb(x, y, loss_fn):
    return loss_fn(x, y) / math.log(2)


def ppl(x, y, loss_fn):
    return torch.exp(loss_fn(x, y))


METRIC_FNS: Dict[str, Callable] = {
    "cross_entropy": cross_entropy,
    "padded_cross_entropy": padded_cross_entropy,
    "soft_cross_entropy": soft_cross_entropy,
    "binary_cross_entropy": binary_cross_entropy,
    "binary_accuracy": binary_accuracy,
    "accuracy": accuracy,
    "accuracy_ignore_index": accuracy_ignore_index,
    "accuracy@3": partial(accuracy_at_k, k=3),
    "accuracy@5": partial(accuracy_at_k, k=5),
    "accuracy@10": partial(accuracy_at_k, k=10),
    "mse": mse,
    "mae": mae,
    "forecast_rmse": forecast_rmse,
    "last_k_ppl": last_k_ppl,
    "per_token_ppl": per_token_ppl,
    "student_t": student_t_loss,
    "gaussian_ll": gaussian_ll_loss,
}

LOSS_METRIC_FNS: Dict[str, Callable] = {"loss": loss_metric, "bpb": bpb, "ppl": ppl}


# host metrics: whole-epoch numpy over gathered logits

def _host_flatten(logits, y):
    logits = np.asarray(logits)
    return logits.reshape(-1, logits.shape[-1]), np.asarray(y).reshape(-1)


def _confusion(y: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Confusion counts over the labels present in y or pred (as scikit-learn)."""
    labels, idx = np.unique(np.concatenate([y, pred]), return_inverse=True)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (idx[:len(y)], idx[len(y):]), 1)
    return cm, labels


def _mcc_from_confusion(cm: np.ndarray) -> float:
    """Multiclass MCC from the confusion matrix: cov(t, p) / sqrt(cov(t, t) cov(p, p))."""
    cm = cm.astype(np.float64)
    t = cm.sum(axis=1)
    p = cm.sum(axis=0)
    c = np.trace(cm)
    s = cm.sum()
    cov_tp = c * s - t @ p
    cov_pp = s * s - p @ p
    cov_tt = s * s - t @ t
    denom = math.sqrt(cov_pp) * math.sqrt(cov_tt)
    return float(cov_tp / denom) if denom else 0.0


def _f1_from_confusion(cm: np.ndarray, average: str) -> float:
    cm = cm.astype(np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    if average == "binary":
        denom = 2 * tp[1] + fp[1] + fn[1]
        return float(2 * tp[1] / denom) if denom else 0.0
    if average == "micro":
        denom = 2 * tp.sum() + fp.sum() + fn.sum()
        return float(2 * tp.sum() / denom) if denom else 0.0
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    return float(f1.mean())


def mcc(logits, y) -> float:
    logits, y = _host_flatten(logits, y)
    return _mcc_from_confusion(_confusion(y, logits.argmax(axis=-1))[0])


def f1_binary(logits, y) -> float:
    """F1 of label 1 (targets in {0, 1})."""
    logits, y = _host_flatten(logits, y)
    pred = logits.argmax(axis=-1)
    tp = float(np.sum((pred == 1) & (y == 1)))
    denom = float(np.sum(pred == 1)) + float(np.sum(y == 1))  # 2 tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def f1_macro(logits, y) -> float:
    logits, y = _host_flatten(logits, y)
    return _f1_from_confusion(_confusion(y, logits.argmax(axis=-1))[0], "macro")


def f1_micro(logits, y) -> float:
    logits, y = _host_flatten(logits, y)
    return _f1_from_confusion(_confusion(y, logits.argmax(axis=-1))[0], "micro")


def _softmax_np(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _average_ranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of s, ties at their average rank."""
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    return ((ends - counts + 1 + ends) / 2.0)[inv]


def roc_auc_binary(score: np.ndarray, positive: np.ndarray) -> float:
    """Area under the ROC curve of `score` for the boolean `positive`."""
    n_pos = int(positive.sum())
    n_neg = len(positive) - n_pos
    if not n_pos or not n_neg:
        raise ValueError("ROC-AUC needs both classes among the targets")
    ranks = _average_ranks(np.asarray(score, np.float64))
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_macro(logits, y) -> float:
    """ROC-AUC of softmax class 1 against targets == 1 (a binary target, for
    which macro and micro averages agree)."""
    logits, y = _host_flatten(logits, y)
    return roc_auc_binary(_softmax_np(logits)[:, 1], y == 1)


roc_auc_micro = roc_auc_macro

HOST_METRIC_FNS: Dict[str, Callable] = {
    "mcc": mcc,
    "f1_binary": f1_binary,
    "f1_macro": f1_macro,
    "f1_micro": f1_micro,
    "roc_auc_macro": roc_auc_macro,
    "roc_auc_micro": roc_auc_micro,
}


class StreamingHostMetrics:
    """Per-batch sufficient statistics for the epoch host metrics (the JAX
    class, in numpy).

    Two layouts, detected from each update:
      * multiclass: logits (N, C), integer targets (N,): a C x C confusion
        matrix (mcc and f1 exact) and histograms of softmax[:, 1] for the
        positives and negatives (binary ROC-AUC);
      * multilabel: targets shaped as the logits: per-class sigmoid-score
        histograms (per-class AUROC) and per-class 2 x 2 counts at 0.5.

    The AUC from histograms counts ranks over `n_bins` equal score bins,
    half credit for a tie within a bin.
    """

    def __init__(self, names, n_bins: int = 8192):
        self.names = list(names)
        self.n_bins = n_bins
        self.cm: Optional[np.ndarray] = None
        self.pos_hist: Optional[np.ndarray] = None
        self.neg_hist: Optional[np.ndarray] = None
        self.multilabel = False
        self._want_cm = bool({"mcc", "f1_binary", "f1_macro", "f1_micro",
                              "accuracy_host"} & set(self.names))
        self._want_auc = bool({"roc_auc_macro", "roc_auc_micro",
                               "auroc_macro", "auroc_median"} & set(self.names))

    def _bins(self, scores: np.ndarray) -> np.ndarray:
        return np.minimum((scores * self.n_bins).astype(np.int64), self.n_bins - 1)

    def update(self, logits: np.ndarray, y: np.ndarray) -> None:
        logits = np.asarray(logits, np.float32)
        y = np.asarray(y)
        self.multilabel = y.shape == logits.shape and y.ndim >= 2
        n_cls = logits.shape[-1]
        logits = logits.reshape(-1, n_cls)
        if self.multilabel:
            y = y.reshape(-1, n_cls)
            scores = 1.0 / (1.0 + np.exp(-logits))
            pos = y > 0.5
            if self._want_cm:
                if self.cm is None:
                    self.cm = np.zeros((n_cls, 4), np.int64)  # tp fp fn tn
                pred = scores > 0.5
                self.cm[:, 0] += (pred & pos).sum(0)
                self.cm[:, 1] += (pred & ~pos).sum(0)
                self.cm[:, 2] += (~pred & pos).sum(0)
                self.cm[:, 3] += (~pred & ~pos).sum(0)
            if self._want_auc:
                if self.pos_hist is None:
                    self.pos_hist = np.zeros((n_cls, self.n_bins), np.int64)
                    self.neg_hist = np.zeros((n_cls, self.n_bins), np.int64)
                bins = self._bins(scores)
                for c in range(n_cls):
                    self.pos_hist[c] += np.bincount(bins[pos[:, c], c], minlength=self.n_bins)
                    self.neg_hist[c] += np.bincount(bins[~pos[:, c], c], minlength=self.n_bins)
            return
        y = y.reshape(-1)
        if self._want_cm:
            if self.cm is None:
                self.cm = np.zeros((n_cls, n_cls), np.int64)
            np.add.at(self.cm, (y, logits.argmax(-1)), 1)
        if self._want_auc:
            if self.pos_hist is None:
                self.pos_hist = np.zeros((1, self.n_bins), np.int64)
                self.neg_hist = np.zeros((1, self.n_bins), np.int64)
            bins = self._bins(_softmax_np(logits)[:, 1])
            self.pos_hist[0] += np.bincount(bins[y == 1], minlength=self.n_bins)
            self.neg_hist[0] += np.bincount(bins[y != 1], minlength=self.n_bins)

    def _auc_per_class(self) -> np.ndarray:
        pos = self.pos_hist.astype(np.float64)
        neg = self.neg_hist.astype(np.float64)
        neg_below = np.cumsum(neg, axis=1) - neg
        num = (pos * (neg_below + 0.5 * neg)).sum(axis=1)
        denom = pos.sum(axis=1) * neg.sum(axis=1)
        return np.where(denom > 0, num / np.maximum(denom, 1), np.nan)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        auc = (self._auc_per_class() if self._want_auc and self.pos_hist is not None
               else None)
        for name in self.names:
            if name in ("roc_auc_macro", "roc_auc_micro") and not self.multilabel:
                if auc is not None:
                    out[name] = float(auc[0])
            elif name in ("auroc_macro", "roc_auc_macro") and self.multilabel:
                if auc is not None:
                    out[name] = float(np.nanmean(auc))
            elif name == "auroc_median" and auc is not None:
                out[name] = float(np.nanmedian(auc))
            elif self.cm is None:
                continue
            elif self.multilabel:
                tp, fp, fn, _ = self.cm.astype(np.float64).T
                if name == "f1_macro":
                    d = 2 * tp + fp + fn
                    out[name] = float(np.where(d > 0, 2 * tp / np.maximum(d, 1), 0.0).mean())
                elif name == "f1_micro":
                    d = 2 * tp.sum() + fp.sum() + fn.sum()
                    out[name] = float(2 * tp.sum() / d) if d else 0.0
            elif name == "mcc":
                out[name] = _mcc_from_confusion(self.cm)
            elif name.startswith("f1_"):
                out[name] = _f1_from_confusion(self.cm, name[3:])
            elif name == "accuracy_host":
                out[name] = float(np.trace(self.cm) / max(self.cm.sum(), 1))
        return out

    @property
    def confusion_matrix(self) -> Optional[np.ndarray]:
        return None if self.multilabel else self.cm


STREAMING_HOST_METRICS = {
    "mcc", "f1_binary", "f1_macro", "f1_micro", "accuracy_host",
    "roc_auc_macro", "roc_auc_micro", "auroc_macro", "auroc_median",
}


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

    def reset(self) -> None:
        self.total_nll = 0.0
        self.count = 0.0


class NumTokens:
    """Tokens seen; persists across epochs."""

    def __init__(self):
        self.count = 0

    def update(self, n) -> None:
        self.count += int(n)

    def compute(self) -> int:
        return self.count

    def reset(self) -> None:  # persistent by design
        pass
