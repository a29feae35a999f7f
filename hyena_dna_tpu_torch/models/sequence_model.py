"""Generic isotropic sequence backbone (mirrors
`hyena_dna_tpu/models/sequence_model.py`): `SequenceModel` (registered
`model`), `SequenceResidualBlock`, and the layers, residual functions and
pools they use.

  * layers, built by `make_layer` from `utils/registry.py::LAYER_REGISTRY`
    by `_name_`: `id` (`SequenceIdentity`), `ff` (`FF`), `mha`
    (`models/attention.py`), `hyena` (`models/hyena.py`) and `long-conv`
    (`models/long_conv.py`);
  * residual functions R/H/D/A/F (`RESIDUAL_REGISTRY`): alpha x + beta y,
    a gated highway, a depth-decayed mix, a learned scale, none;
  * pools (`POOL_REGISTRY`): stride sampling, average, and a linear fold
    of `stride` steps into the channels; `UpAvgPool` repeats up.

A block is norm (before the layer with `prenorm`) -> layer -> dropout ->
residual -> norm (after, without `prenorm`) -> pool. The model stacks
n_layers * n_repeat blocks (a list of layer configs cycles), pools after
every `n_repeat`-th, and applies a final norm with `prenorm`. Layout
(B, L, d); every `forward` returns (y, state), the sequence-layer protocol
of the JAX modules. With `track_norms` the model keeps the mean square of
its input and of each block's output, detached, in `output_norms` (the
JAX module sows them into the "metrics" collection).

Dense layers start from flax's default init (normal of std 1/sqrt(fan_in),
zero bias), drawn from `generator`.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from hyena_dna_tpu_torch.models.nn import Normalization, activation_fn, dropout, linear


def _dense(d_in: int, d_out: int, generator=None, bias: bool = True) -> nn.Linear:
    """flax `Dense` default init: N(0, 1/fan_in) kernel, zero bias."""
    layer = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        layer.weight.normal_(0.0, 1.0 / math.sqrt(d_in), generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class SequenceIdentity(nn.Module):
    """The identity layer (`id`)."""

    def __init__(self, d_model: int = 0, dropout: float = 0.0):
        super().__init__()
        self.d_output = d_model

    def forward(self, x, state=None, **kwargs):
        return x, state

    def step(self, x, state=None, **kwargs):
        return x, state


class FF(nn.Module):
    """Transformer FFN as a layer (`ff`): linear1 (d -> expand d) ->
    activation -> dropout -> linear2 (-> d_output, default d), in `dtype`."""

    def __init__(self, d_input: int, expand: int = 2, d_output: Optional[int] = None,
                 activation: str = "gelu", dropout: float = 0.0, transposed: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.d_output = d_output or d_input
        self.dtype = dtype
        self.dropout = dropout
        self.act = activation_fn(activation)
        self.linear1 = _dense(d_input, expand * d_input, generator)
        self.linear2 = _dense(expand * d_input, self.d_output, generator)

    def forward(self, x, state=None, generator=None, **kwargs):
        h = self.act(linear(x, self.linear1, self.dtype))
        h = dropout(h, self.dropout, self.training, generator)
        return linear(h, self.linear2, self.dtype), None


# residual functions (the reference's residual.py registry)

class Residual(nn.Module):
    """alpha x + beta y (y alone when alpha is 0)."""

    def __init__(self, i_layer: int, d_input: int, d_model: int, alpha: float = 1.0,
                 beta: float = 1.0, generator=None):
        super().__init__()
        self.i_layer, self.d_input, self.d_output = i_layer, d_input, d_model
        self.alpha, self.beta = alpha, beta

    def forward(self, x, y):
        y = self.beta * y if self.beta != 1.0 else y
        return self.alpha * x + y if self.alpha else y


class Affine(Residual):
    """alpha x + a y with a learned `affine` (a scalar, or one per channel),
    started at beta * i_layer^-gamma."""

    def __init__(self, i_layer: int, d_input: int, d_model: int, alpha: float = 1.0,
                 beta: float = 1.0, scalar: bool = True, gamma: float = 0.0, generator=None):
        super().__init__(i_layer, d_input, d_model, alpha, beta)
        c0 = beta * i_layer ** (-gamma)
        self.affine = nn.Parameter(c0 * torch.ones(1 if scalar else d_input))

    def forward(self, x, y):
        return self.alpha * x + self.affine * y


class Feedforward(nn.Module):
    """No residual: y."""

    def __init__(self, i_layer: int, d_input: int, d_model: int, generator=None):
        super().__init__()
        self.d_output = d_model

    def forward(self, x, y):
        return y


class Highway(nn.Module):
    """Gated highway: r = sigmoid(Wx x + Wy y), corr (1 - r) x + r y."""

    def __init__(self, i_layer: int, d_input: int, d_model: int,
                 scaling_correction: bool = False, elemwise: bool = False, generator=None):
        super().__init__()
        self.d_output = d_model
        self.corr = 1.732 if scaling_correction else 1.0
        self.elemwise = elemwise
        self.Wx = _dense(d_input, d_input, generator)
        if elemwise:
            self.Wy = nn.Parameter(torch.randn(d_input, generator=generator))
        else:
            self.Wy = _dense(d_model, d_input, generator)

    def forward(self, x, y):
        yy = self.Wy * y if self.elemwise else self.Wy(y)
        r = torch.sigmoid(self.Wx(x) + yy)
        return self.corr * (1.0 - r) * x + r * y


class DecayResidual(nn.Module):
    """beta = i_layer^-power, alpha = sqrt(1 - beta^2) (or 1 - beta): alpha x + beta y."""

    def __init__(self, i_layer: int, d_input: int, d_model: int, power: float = 0.5,
                 l2: bool = True, generator=None):
        super().__init__()
        self.d_output = d_model
        self.beta = i_layer ** (-power)
        self.alpha = (1.0 - self.beta ** 2) ** 0.5 if l2 else 1.0 - self.beta

    def forward(self, x, y):
        return self.alpha * x + self.beta * y


RESIDUAL_REGISTRY = {
    "F": Feedforward, "N": Feedforward, "R": Residual, "H": Highway, "D": DecayResidual,
    "A": Affine, "none": Feedforward, "ff": Feedforward, "feedforward": Feedforward,
    "residual": Residual, "highway": Highway, "decay": DecayResidual, "affine": Affine,
}


# pools (the reference's pool.py registry)

class DownSample(nn.Module):
    """Every `stride`-th step; channels repeated `expand` times."""

    def __init__(self, d_input: int, stride: int = 1, expand: int = 1, generator=None):
        super().__init__()
        self.stride, self.expand = stride, expand
        self.d_output = d_input * expand

    def forward(self, x):
        if self.stride > 1:
            x = x[..., ::self.stride, :]
        if self.expand > 1:
            x = x.repeat_interleave(self.expand, dim=-1)
        return x, None


class DownAvgPool(DownSample):
    """The mean over windows of `stride` steps (a ragged end dropped)."""

    def forward(self, x):
        if self.stride > 1:
            length = (x.shape[-2] // self.stride) * self.stride
            x = x[..., :length, :].reshape(*x.shape[:-2], length // self.stride, self.stride,
                                           x.shape[-1]).mean(-2)
        if self.expand > 1:
            x = x.repeat_interleave(self.expand, dim=-1)
        return x, None


class DownLinearPool(nn.Module):
    """`stride` steps folded into the channels, then a Linear (`linear`)."""

    def __init__(self, d_input: int, stride: int = 1, expand: int = 1, generator=None):
        super().__init__()
        self.stride = stride
        self.d_output = d_input * expand
        self.linear = _dense(stride * d_input, d_input * expand, generator)

    def forward(self, x):
        s = self.stride
        length = (x.shape[-2] // s) * s
        x = x[..., :length, :].reshape(*x.shape[:-2], length // s, s * x.shape[-1])
        return self.linear(x), None


class UpAvgPool(nn.Module):
    """Repeat each step `stride` times (shifted one step with `causal`),
    after a Linear to d_input / expand channels when `expand` > 1."""

    def __init__(self, d_input: int, stride: int = 1, expand: int = 1, causal: bool = False,
                 generator=None):
        super().__init__()
        self.stride, self.expand, self.causal = stride, expand, causal
        self.d_output = d_input // expand
        if expand > 1:
            self.linear = _dense(d_input, d_input // expand, generator)

    def forward(self, x):
        if self.expand > 1:
            x = self.linear(x)
        if self.stride > 1:
            if self.causal:
                x = torch.nn.functional.pad(x[..., :-1, :], (0, 0, 1, 0))
            x = x.repeat_interleave(self.stride, dim=-2)
        return x, None


POOL_REGISTRY = {"sample": DownSample, "pool": DownAvgPool, "avg": DownAvgPool,
                 "linear": DownLinearPool}
UP_POOL_REGISTRY = {"pool": UpAvgPool, "avg": UpAvgPool}


def make_layer(d_input: int, layer_cfg: Optional[dict], dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """A registered layer (`_name_`, default `id`) at width d_input (JAX
    `_make_layer`)."""
    from hyena_dna_tpu_torch.models.blocks import make_mixer
    from hyena_dna_tpu_torch.utils.registry import LAYER_REGISTRY

    cfg = dict(layer_cfg or {"_name_": "id"})
    name = cfg.pop("_name_", "id")
    cfg.pop("transposed", None)
    if name == "id":
        cfg.pop("dropout", None)
        return LAYER_REGISTRY[name](d_model=d_input)
    if name == "hyena":
        layer = make_mixer(d_input, {"_name_": "hyena", **cfg}, dtype)
        layer.init_weights(generator)
        return layer
    if name == "ff":
        return LAYER_REGISTRY[name](d_input=d_input, dtype=dtype, generator=generator, **cfg)
    if name in ("mha", "long-conv"):
        return LAYER_REGISTRY[name](d_model=d_input, dtype=dtype, generator=generator, **cfg)
    return LAYER_REGISTRY[name](d_input, **cfg)


class SequenceResidualBlock(nn.Module):
    def __init__(self, d_input: int, i_layer: int = 1, prenorm: bool = True,
                 dropout: float = 0.0, layer: Optional[dict] = None,
                 residual: Optional[str] = None, norm: Optional[str] = None,
                 pool: Optional[dict] = None, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prenorm = prenorm
        self.dropout = dropout
        self.layer = make_layer(d_input, layer, dtype, generator)
        self.d_residual = getattr(self.layer, "d_output", d_input) or d_input
        self.residual = None
        if residual is not None:
            self.residual = RESIDUAL_REGISTRY[residual](
                i_layer=i_layer, d_input=d_input, d_model=self.d_residual, generator=generator)
        self.norm = None
        if norm is not None:
            self.norm = Normalization(d_input if prenorm else self.d_residual, norm)
        self.pool = None
        if pool is not None:
            pool_cfg = dict(pool)
            pname = pool_cfg.pop("_name_", "avg")
            self.pool = POOL_REGISTRY[pname](d_input=self.d_residual, generator=generator,
                                             **pool_cfg)

    @property
    def d_output(self) -> int:
        return self.pool.d_output if self.pool is not None else self.d_residual

    def forward(self, x, state=None, generator: Optional[torch.Generator] = None, **kwargs):
        y = x
        if self.norm is not None and self.prenorm:
            y = self.norm(y)
        if isinstance(self.layer, SequenceIdentity):
            out = self.layer(y, state=state)
        else:
            out = self.layer(y, generator=generator)
        y, state = (out[0], out[1] if len(out) > 1 else None) if isinstance(out, tuple) \
            else (out, None)
        if self.residual is not None:
            y = self.residual(x, dropout(y, self.dropout, self.training, generator))
        if self.norm is not None and not self.prenorm:
            y = self.norm(y)
        if self.pool is not None:
            y, _ = self.pool(y)
        return y, state

    def step(self, x, state=None):
        """One token through the block (layers with a `step`)."""
        y = x
        if self.norm is not None and self.prenorm:
            y = self.norm(y)
        y, state = self.layer.step(y, state)
        if self.residual is not None:
            y = self.residual(x, y)
        if self.norm is not None and not self.prenorm:
            y = self.norm(y)
        return y, state


class SequenceModel(nn.Module):
    """The isotropic backbone, registered `model`: (B, L, d) -> ((B, L, d), states)."""

    def __init__(self, d_model: int, n_layers: int = 1, dropout: float = 0.0,
                 prenorm: bool = True, n_repeat: int = 1, layer: Optional[Any] = None,
                 residual: Optional[str] = None, norm: Optional[str] = None,
                 pool: Optional[dict] = None, track_norms: bool = True, dropinp: float = 0.0,
                 transposed: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.prenorm = prenorm
        self.track_norms = track_norms
        self.dropinp = dropinp
        layer_cfgs = layer if isinstance(layer, (list, tuple)) else [layer]
        layer_cfgs = [dict(c or {"_name_": "id"}) for c in layer_cfgs]
        for c in layer_cfgs:
            c.setdefault("dropout", dropout)
        cfgs = list(layer_cfgs) * n_layers * n_repeat
        self.layers = nn.ModuleList(
            SequenceResidualBlock(d_model, i_layer=i + 1, prenorm=prenorm, dropout=dropout,
                                  layer=cfg, residual=residual, norm=norm,
                                  pool=pool if (i + 1) % n_repeat == 0 else None, dtype=dtype,
                                  generator=generator)
            for i, cfg in enumerate(cfgs))
        self.norm_f = (Normalization(d_model, norm)
                       if prenorm and norm is not None else None)
        self.output_norms = None

    @property
    def d_output(self) -> int:
        return self.d_model

    def forward(self, x, state=None, generator: Optional[torch.Generator] = None, **kwargs):
        x = dropout(x, self.dropinp, self.training, generator)
        norms = [x.detach().float().square().mean()] if self.track_norms else None
        states = [None] * len(self.layers) if state is None else state
        next_states = []
        for block, st in zip(self.layers, states):
            x, st = block(x, state=st, generator=generator)
            next_states.append(st)
            if self.track_norms:
                norms.append(x.detach().float().square().mean())
        if self.norm_f is not None:
            x = self.norm_f(x)
        if self.track_norms:
            self.output_norms = torch.stack(norms)
        return x, next_states

    def step(self, x, state=None):
        states = [None] * len(self.layers) if state is None else state
        next_states = []
        for block, st in zip(self.layers, states):
            x, st = block.step(x, state=st)
            next_states.append(st)
        if self.norm_f is not None:
            x = self.norm_f(x)
        return x, next_states
