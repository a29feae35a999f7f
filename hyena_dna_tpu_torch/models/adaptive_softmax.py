"""Adaptive embedding and projected adaptive log-softmax (mirrors
`hyena_dna_tpu/models/adaptive_softmax.py`).

  * `AdaptiveEmbedding`: per-cluster tables of width d_embed / div_val^i
    (`emb_layers_i`), each projected to d_proj (`emb_projs_i`, bias-free),
    scaled by sqrt(d_proj);
  * `ProjectedAdaptiveLogSoftmax`: a shortlist head (`head_out`, after
    `head_proj` when d_embed != d_proj) over the shortlist and one logit
    per tail cluster, and per cluster a tail (`tail_i_proj`, `tail_i_out`);
    log p(token in cluster i) = log p_head(cluster i) + log p_tail(token);
  * `AdaptiveLMModel` (registered `adaptive_lm`): the assembly of the
    reference's `AdaptiveLMTask` as one module, adaptive embedding ->
    `SequenceModel` backbone -> adaptive log-softmax, with `tie_weights`
    sharing each cluster's table between input and output and `tie_projs`
    sharing its projection (default: the head's untied, the tails' tied).
    Its parameters carry the JAX module's names (`emb_i`, `proj_i`,
    `out_proj_i`, `bias_i`, `out_emb_i`, `cluster_weight`, `core`), so a
    flax tree converts by name. It returns normalised log-probabilities
    (B, L, n_token), so the plain cross-entropy on them is the adaptive
    loss (log-softmax is idempotent).

Every cluster computes its dense logits and each token takes its own
cluster's through a mask, as in the JAX module (static shapes, a few small
products of extra work). Parameters are drawn from `generator`:
N(0, init_std * init_scale) for the adaptive model's tables and
projections, zero biases.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.nn import dropout, linear
from hyena_dna_tpu_torch.models.sequence_model import SequenceModel, _dense


def _normal(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


def _embed(n: int, d: int, std: float, generator) -> nn.Embedding:
    emb = nn.Embedding(n, d)
    with torch.no_grad():
        emb.weight.normal_(0.0, std, generator=generator)
    return emb


class AdaptiveEmbedding(nn.Module):
    def __init__(self, n_token: int, d_embed: int, d_proj: int, cutoffs: Sequence[int] = (),
                 div_val: int = 1, init_std: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.div_val = div_val
        self.d_proj = d_proj
        self.cutoff_ends = [0] + list(cutoffs) + [n_token]
        n_tables = 1 if div_val == 1 else len(self.cutoff_ends) - 1
        for i in range(n_tables):
            lo, hi = (0, n_token) if div_val == 1 else self.cutoff_ends[i:i + 2]
            d_emb = d_embed // div_val ** i
            setattr(self, f"emb_layers_{i}", _embed(hi - lo, d_emb, init_std, generator))
            if div_val > 1 or d_proj != d_embed:
                setattr(self, f"emb_projs_{i}", _dense(d_emb, d_proj, generator, bias=False))
        self.n_tables = n_tables

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        scale = self.d_proj ** 0.5
        if self.div_val == 1:
            emb = self.emb_layers_0.weight.to(self.dtype)[inp]
            if hasattr(self, "emb_projs_0"):
                emb = linear(emb, self.emb_projs_0, self.dtype)
            return emb * scale
        out = torch.zeros(*inp.shape, self.d_proj, dtype=self.dtype, device=inp.device)
        for i in range(self.n_tables):
            lo, hi = self.cutoff_ends[i:i + 2]
            mask = (inp >= lo) & (inp < hi)
            emb = getattr(self, f"emb_layers_{i}").weight.to(self.dtype)[
                torch.where(mask, inp - lo, 0)]
            emb = linear(emb, getattr(self, f"emb_projs_{i}"), self.dtype)
            out = out + torch.where(mask[..., None], emb, 0)
        return out * scale


class ProjectedAdaptiveLogSoftmax(nn.Module):
    def __init__(self, n_token: int, d_embed: int, d_proj: int, cutoffs: Sequence[int] = (),
                 div_val: int = 1, init_std: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_token = n_token
        self.dtype = dtype
        self.cutoffs = list(cutoffs) + [n_token]
        self.cutoff_ends = [0] + self.cutoffs
        n_clusters = len(self.cutoffs) - 1
        head_size = n_token if not cutoffs else self.cutoffs[0] + n_clusters
        self._cluster("head", head_size, d_embed, d_proj, init_std, generator)
        for i in range(1, len(self.cutoffs)):
            d_emb = d_embed // div_val ** i if div_val > 1 else d_embed
            size = self.cutoff_ends[i + 1] - self.cutoff_ends[i]
            self._cluster(f"tail_{i}", size, d_emb, d_proj, init_std, generator)

    def _cluster(self, name, size, d_emb, d_proj, init_std, generator):
        if d_emb != d_proj:
            setattr(self, f"{name}_proj", _dense(d_proj, d_emb, generator, bias=False))
        out = nn.Linear(d_emb, size)
        with torch.no_grad():
            out.weight.normal_(0.0, init_std, generator=generator)
            out.bias.zero_()
        setattr(self, f"{name}_out", out)

    def _logprob(self, hidden: torch.Tensor, name: str) -> torch.Tensor:
        h = hidden
        if hasattr(self, f"{name}_proj"):
            h = linear(h, getattr(self, f"{name}_proj"), self.dtype)
        return F.log_softmax(linear(h, getattr(self, f"{name}_out"), self.dtype).float(), -1)

    def forward(self, hidden: torch.Tensor, target: Optional[torch.Tensor] = None):
        """hidden (N, d_proj) -> (N, n_token) log-probs, or with `target`
        the per-token NLL (N,)."""
        head = self._logprob(hidden, "head")
        if len(self.cutoffs) == 1:
            logprob = head
        else:
            shortlist = self.cutoffs[0]
            pieces = [head[:, :shortlist]]
            for i in range(1, len(self.cutoffs)):
                cluster = head[:, shortlist + i - 1:shortlist + i]
                pieces.append(cluster + self._logprob(hidden, f"tail_{i}"))
            logprob = torch.cat(pieces, dim=-1)
        if target is None:
            return logprob
        return -logprob.gather(-1, target[:, None])[:, 0]


class AdaptiveLMModel(nn.Module):
    """`vocab_size` (the name the trainer gives every model its dataset's
    vocabulary under) stands for `n_token` when `n_token` is not given."""

    def __init__(self, n_token: Optional[int] = None, d_model: Optional[int] = None,
                 cutoffs: Sequence[int] = (), div_val: int = 1, tie_weights: bool = True,
                 tie_projs: Optional[Sequence[bool]] = None, dropemb: float = 0.0,
                 backbone: Optional[dict] = None, init_scale: float = 1.0,
                 init_std: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 vocab_size: Optional[int] = None):
        super().__init__()
        n_token = vocab_size if n_token is None else n_token
        if n_token is None or d_model is None:
            raise TypeError("AdaptiveLMModel needs d_model and n_token (or vocab_size)")
        self.n_token = n_token
        self.d_model = d_model
        self.div_val = div_val
        self.dtype = dtype
        self.dropemb = dropemb
        self.cutoff_ends = [0] + list(cutoffs) + [n_token]
        self.n_clusters = len(self.cutoff_ends) - 2
        tie_projs = (list(tie_projs) if tie_projs is not None
                     else [False] + [True] * self.n_clusters)
        std = init_std * init_scale
        self.has_proj, self.has_out_proj = [], []
        for i in range(self.n_clusters + 1):
            lo, hi = self.cutoff_ends[i:i + 2]
            d_emb = d_model // div_val ** i
            setattr(self, f"emb_{i}", _normal((hi - lo, d_emb), std, generator))
            need_proj = d_emb != d_model or div_val > 1
            self.has_proj.append(need_proj)
            if need_proj:
                setattr(self, f"proj_{i}", _normal((d_emb, d_model), std, generator))
            untied = need_proj and not (tie_projs[i] if i < len(tie_projs) else False)
            self.has_out_proj.append(untied)
            if untied:
                setattr(self, f"out_proj_{i}", _normal((d_emb, d_model), std, generator))
            n_out = (hi - lo) + (self.n_clusters if i == 0 else 0)
            setattr(self, f"bias_{i}", nn.Parameter(torch.zeros(n_out)))
        self.tie_weights = tie_weights
        if not tie_weights:
            for i in range(self.n_clusters + 1):
                shape = getattr(self, f"emb_{i}").shape
                setattr(self, f"out_emb_{i}", _normal(shape, std, generator))
        if self.n_clusters:
            self.cluster_weight = _normal((self.n_clusters, d_model), std, generator)
        self.core = SequenceModel(d_model=d_model, dtype=dtype, generator=generator,
                                  **(backbone or {}))

    @property
    def d_output(self) -> int:
        return self.n_token

    def _embed(self, inp: torch.Tensor) -> torch.Tensor:
        scale = self.d_model ** 0.5
        if self.n_clusters == 0 and not self.has_proj[0]:
            return self.emb_0[inp] * scale
        out = torch.zeros(*inp.shape, self.d_model, device=inp.device)
        for i in range(self.n_clusters + 1):
            lo, hi = self.cutoff_ends[i:i + 2]
            mask = (inp >= lo) & (inp < hi)
            emb = getattr(self, f"emb_{i}")[torch.where(mask, inp - lo, 0)]
            if self.has_proj[i]:
                emb = emb @ getattr(self, f"proj_{i}")
            out = out + torch.where(mask[..., None], emb, 0)
        return out * scale

    def _tail_weight(self, i: int) -> torch.Tensor:
        """(d_model, size_i) logit matrix of cluster i, with its ties."""
        emb = getattr(self, f"{'emb' if self.tie_weights else 'out_emb'}_{i}")
        if not self.has_proj[i]:
            return emb.t()
        proj = getattr(self, f"{'out_proj' if self.has_out_proj[i] else 'proj'}_{i}")
        return proj.t() @ emb.t()

    def forward(self, inp: torch.Tensor, state=None,
                generator: Optional[torch.Generator] = None, **kwargs):
        """ids (B, L) -> ((B, L, n_token) log-probs, None)."""
        x = dropout(self._embed(inp).to(self.dtype), self.dropemb, self.training, generator)
        hidden, _ = self.core(x, generator=generator)
        h = hidden.float()
        if self.n_clusters == 0:
            return F.log_softmax(h @ self._tail_weight(0) + self.bias_0, -1), None
        shortlist = self.cutoff_ends[1]
        head_w = torch.cat([self._tail_weight(0), self.cluster_weight.t()], dim=1)
        head = F.log_softmax(h @ head_w + self.bias_0, -1)
        pieces = [head[..., :shortlist]]
        for i in range(1, self.n_clusters + 1):
            tail = F.log_softmax(h @ self._tail_weight(i) + getattr(self, f"bias_{i}"), -1)
            pieces.append(head[..., shortlist + i - 1:shortlist + i] + tail)
        return torch.cat(pieces, dim=-1), None
