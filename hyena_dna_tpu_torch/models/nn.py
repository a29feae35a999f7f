"""Small building blocks (mirrors `hyena_dna_tpu/models/nn.py`): the
activation registry, the `Normalization` picker, row-mode
`stochastic_depth` and `Gate`; plus the dropout every module of the port
uses, and `linear`, a Linear layer run in the block dtype as flax's
`Dense(dtype=...)` runs it.

Randomness comes from an explicit `torch.Generator` (dropout masks, the
stochastic-depth rows, `Gate`'s initial "UR" offsets), so one seed gives
one draw.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.ops.distributed import reduce_from_model


def _laplace(x: torch.Tensor) -> torch.Tensor:
    mu, sigma = math.sqrt(0.5), math.sqrt(0.25)
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * math.sqrt(2.0))))


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "sqrelu": lambda x: F.relu(x).square(),
    "laplace": _laplace,
    "sin": torch.sin,
    "glu": lambda x: F.glu(x, dim=-1),
}


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation of the JAX registry named `name` (None and "id" are
    the identity; "gelu" is the exact GeLU, "gelu_tanh" the tanh one)."""
    if name in (None, "id", "identity", "linear", "none"):
        return lambda x: x
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} not implemented")
    return _ACTIVATIONS[name]


class Normalization(nn.Module):
    """Norm picker on (..., d): layer, rms, group (min(d, 32) groups, each
    over its channels and the length, as flax's `GroupNorm` on (B, L, d))
    or none. The parameters are `norm.weight` (flax `scale`) and
    `norm.bias`."""

    def __init__(self, d: int, norm_type: Optional[str] = "layer", eps: float = 1e-5):
        super().__init__()
        self.norm_type = norm_type
        if norm_type in ("layer", "layernorm"):
            self.norm = nn.LayerNorm(d, eps=eps)
        elif norm_type in ("rms", "rmsnorm"):
            self.norm = nn.RMSNorm(d, eps=eps)
        elif norm_type == "group":
            self.norm = nn.GroupNorm(min(d, 32), d, eps=eps)
        elif norm_type in ("none", "id", None):
            self.norm = None
        else:
            raise NotImplementedError(f"norm {norm_type!r} not implemented")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is None:
            return x
        if self.norm_type == "group":
            return self.norm(x.transpose(1, -1)).transpose(1, -1)
        return self.norm(x)


def stochastic_depth(x: torch.Tensor, p: float, mode: str = "row", training: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop whole rows (mode "row", one draw per batch
    element) or the whole tensor (any other mode) with probability p,
    scaling survivors by 1/(1-p); the identity outside training."""
    if not training or p == 0.0:
        return x
    survival = 1.0 - p
    shape = (x.shape[0],) + (1,) * (x.dim() - 1) if mode == "row" else (1,) * x.dim()
    keep = torch.empty(shape, device=x.device).bernoulli_(survival, generator=generator)
    return torch.where(keep.bool(), x / survival, torch.zeros_like(x))


class Gate(nn.Module):
    """The gate mechanisms of the JAX `Gate`: N (ones), G/FS (sigmoid), BE
    (exp), BR (relu), TE, TR, TS, and UR/R (refine) of a Linear
    preactivation `W_g` (and `W_r` for the refine gates)."""

    MECHANISMS = ("N", "G", "FS", "BE", "BR", "TE", "TR", "TS", "UR", "R")

    def __init__(self, d_input: int, size: int, mechanism: str = "N",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mechanism not in self.MECHANISMS:
            raise NotImplementedError(f"gate mechanism {mechanism!r}")
        self.size = size
        self.mechanism = mechanism
        if mechanism == "N":
            return
        self.W_g = nn.Linear(d_input, size)
        if mechanism in ("UR", "R"):
            self.W_r = nn.Linear(d_input, size)
        if mechanism == "UR":
            u = torch.rand(2, size, generator=generator)
            self.uniform_b = nn.Parameter(torch.log(u[0].clamp_min(1e-6)
                                                    / (1 - u[1]).clamp_min(1e-6)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mechanism
        if m == "N":
            return torch.ones(*x.shape[:-1], self.size, dtype=x.dtype, device=x.device)
        g_pre = self.W_g(x)
        if m in ("G", "FS"):
            return torch.sigmoid(g_pre)
        if m == "BE":
            return torch.exp(g_pre)
        if m == "BR":
            return F.relu(g_pre)
        if m == "TE":
            e = torch.exp(g_pre)
            return e / (1.0 + e / 2.0)
        if m == "TR":
            r = F.relu(g_pre)
            return r / (1.0 + r / 2.0)
        if m == "TS":
            return 2.0 * torch.sigmoid(g_pre)
        g = torch.sigmoid(g_pre + self.uniform_b if m == "UR" else g_pre)
        r = torch.sigmoid(self.W_r(x))
        return (1 - 2 * r) * g ** 2 + 2 * r * g


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`): zero with probability p and
    scale the rest by 1/(1-p), only in training. The mask comes from
    `generator` (on x's device), so one seed gives one mask; the identity
    when not training or p == 0, as `deterministic=True` is in JAX. The mask
    is drawn contiguous, so it depends on x's shape and not its strides
    (`dropout_slice` draws the same mask for a slice of x)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p,
                                                                        generator=generator)
    return x * keep / (1.0 - p)


def dropout_slice(x: torch.Tensor, p: float, training: bool,
                  generator: Optional[torch.Generator], *cuts) -> torch.Tensor:
    """`dropout` of x, a slice of a larger tensor: each cut (dim, whole,
    start) says that x holds [start, start + x.shape[dim]) of a dimension
    `whole` long there. The mask is drawn for the whole tensor and sliced,
    so a rank of a model or seq axis drops what the run without one drops
    at those positions when the ranks' generators agree, and the ranks'
    generators move in step."""
    cuts = [c for c in cuts if x.shape[c[0]] != c[1]]
    if not training or p == 0.0 or p >= 1.0 or not cuts:
        return dropout(x, p, training, generator)
    shape = list(x.shape)
    for dim, whole, _ in cuts:
        shape[dim] = whole
    keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p,
                                                                         generator=generator)
    for dim, _, start in cuts:
        keep = keep.narrow(dim, start, x.shape[dim])
    return x * keep / (1.0 - p)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype`: the input, the float32 weight and the
    bias are cast to it first (flax `Dense(dtype)` promotes all three), so
    in bfloat16 it is one cuBLAS bf16 product with float32 accumulation and
    its gradients reach the float32 parameters through the casts."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, mesh) -> torch.Tensor:
    """`linear(x, layer, dtype)` of a row-parallel layer: under a model axis
    (`mesh`, else None) the rank's partial product over its columns of the
    weight, summed over the ranks (`reduce_from_model`), then the bias once."""
    if mesh is None:
        return linear(x, layer, dtype)
    part = reduce_from_model(F.linear(x.to(dtype), layer.weight.to(dtype)), mesh)
    return part if layer.bias is None else part + layer.bias.to(dtype)
