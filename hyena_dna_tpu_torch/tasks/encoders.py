"""Input encoders: raw batch inputs into model space (a copy of
`hyena_dna_tpu/tasks/encoders.py`; upstream `src/tasks/encoders.py:16-331`).

The registry's encoders (embedding, linear, position, position_id, class,
onehot, conv1d, layer, time, pack, patch2d, timestamp_embedding) and the
auto-wiring tables: the constructor arguments each encoder takes from the
dataset (`DATASET_ATTRS`, e.g. `n_tokens`) and from the model
(`MODEL_ATTRS`, `d_model`).

No config of the repository uses an encoder: the LM and `dna_embedding`
pipelines embed inside the backbone. These serve the generic
`SequenceModel` pipelines (`models/sequence_model.py`). Layouts follow the
JAX modules: sequences are (B, L, d) and images NHWC. Parameters are
float32 and drawn at construction from `generator` with the flax
initialisers' scales (Dense and Conv: normal of std 1/sqrt(fan_in), zero
bias; the default Embed: normal of std 1/sqrt(features)); with `dtype` the
output is computed in it, as flax's `dtype` does.
`utils/convert.py::flax_encoder_to_torch_state_dict` carries an encoder's
flax parameters onto these names.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.nn import Normalization, dropout, linear
from hyena_dna_tpu_torch.models.sequence_model import make_layer


def _normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _dense(d_in: int, d_out: int, generator) -> nn.Linear:
    """flax Dense: lecun-normal kernel, zero bias."""
    layer = nn.Linear(d_in, d_out)
    _normal_(layer.weight, 1.0 / math.sqrt(d_in), generator)
    nn.init.zeros_(layer.bias)
    return layer


def _embed(n: int, d: int, generator, std: Optional[float] = None) -> nn.Embedding:
    """flax Embed: normal of `std`, by default 1/sqrt(features)."""
    emb = nn.Embedding(n, d)
    _normal_(emb.weight, 1.0 / math.sqrt(d) if std is None else std, generator)
    return emb


class EmbeddingEncoder(nn.Module):
    """Token embedding (`encoders.py:295` 'embedding')."""

    def __init__(self, n_tokens: int, d_model: int, init_std: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _embed(n_tokens, d_model, generator, init_std)

    def forward(self, x, **kwargs):
        return self.embedding.weight.to(self.dtype)[x]


class LinearEncoder(nn.Module):
    def __init__(self, d_input: int, d_model: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.linear = _dense(d_input, d_model, generator)

    def forward(self, x, **kwargs):
        return linear(x, self.linear, self.dtype)


class PositionalIDEncoder(nn.Module):
    """x and its position ids (transformer-xl style models)."""

    def forward(self, x, **kwargs):
        pos = torch.arange(x.shape[-1], device=x.device)
        return x, pos.expand(x.shape)


class PositionalEncoder(nn.Module):
    """Sinusoidal (or, with `pe_init`, learned) positions added to the
    input, then dropout (`encoders.py:42-91`)."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 16384,
                 pe_init: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.max_len = max_len
        self.pe = None
        if pe_init is not None:
            self.pe = nn.Parameter(torch.empty(max_len, 1, d_model))
            _normal_(self.pe, pe_init, generator)

    def table(self, length: int, device) -> torch.Tensor:
        """The first `length` rows of the (max_len, d_model) sinusoid table."""
        position = torch.arange(length, device=device, dtype=torch.float32)[:, None]
        div = torch.exp(-math.log(10000.0)
                        * torch.arange(0, self.d_model, 2, device=device) / self.d_model)
        pe = torch.zeros(length, self.d_model, device=device)
        pe[:, 0::2] = torch.sin(position * div)
        pe[:, 1::2] = torch.cos(position * div)
        return pe

    def forward(self, x, generator: Optional[torch.Generator] = None, **kwargs):
        length = x.shape[-2]
        pe = self.pe[:length, 0] if self.pe is not None else self.table(length, x.device)
        return dropout(x + pe, self.dropout, self.training, generator)


class ClassEmbedding(nn.Module):
    """A class embedding added at every position (`encoders.py:94-102`)."""

    def __init__(self, n_classes: int, d_model: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = _embed(n_classes, d_model, generator)

    def forward(self, x, y=None, **kwargs):
        return x + self.embedding(y)[..., None, :]


class OneHotEncoder(nn.Module):
    """Integer tokens to one-hot float32 vectors of d_model (`encoders.py:242-249`)."""

    def __init__(self, n_tokens: int, d_model: int):
        super().__init__()
        if n_tokens > d_model:
            raise ValueError(f"n_tokens {n_tokens} > d_model {d_model}")
        self.d_model = d_model

    def forward(self, x, **kwargs):
        x = x.squeeze(-1) if x.dim() > 2 else x
        return F.one_hot(x.long(), self.d_model).float()


def _same_pad(length: int, kernel: int, stride: int):
    """(left, right) padding of flax's "SAME" along one axis."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class Conv1DEncoder(nn.Module):
    """A 1-D conv over the length of (B, L, d_input), "SAME" padding
    (`encoders.py:105-119`)."""

    def __init__(self, d_input: int, d_model: int, kernel_size: int = 25, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(d_input, d_model, kernel_size, stride=stride)
        _normal_(self.conv.weight, 1.0 / math.sqrt(kernel_size * d_input), generator)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x, **kwargs):
        k = self.conv.kernel_size[0]
        u = F.pad(x.transpose(1, 2), _same_pad(x.shape[1], k, self.stride))
        return self.conv(u).transpose(1, 2)


def _make_layer(d_model: int, layer_cfg: Optional[dict], generator) -> Optional[nn.Module]:
    """The block's inner layer: None for 'id', else the layer of
    `utils/registry.py::LAYER_REGISTRY` built and initialised by
    `models/sequence_model.py::make_layer` ('hyena' is the port's
    `HyenaOperator` with its own init; a name no registry has raises
    KeyError, as in the JAX package)."""
    cfg = dict(layer_cfg or {"_name_": "id"})
    if cfg.get("_name_", "id") == "id":
        return None
    cfg.pop("dropout", None)
    return make_layer(d_model, cfg, generator=generator)


class ResidualBlock(nn.Module):
    """The JAX `SequenceResidualBlock` as the 'layer' encoder builds it:
    norm (before the layer with `prenorm`, else after the add), the layer,
    and the residual x + y ('R'); no dropout, no pooling."""

    def __init__(self, d_model: int, prenorm: bool, norm: Optional[str],
                 layer: Optional[dict], generator=None):
        super().__init__()
        self.prenorm = prenorm
        self.layer = _make_layer(d_model, layer, generator)
        self.norm = Normalization(d_model, norm) if norm is not None else None

    def forward(self, x):
        y = x
        if self.norm is not None and self.prenorm:
            y = self.norm(y)
        if self.layer is not None:
            y = self.layer(y)
            y = y[0] if isinstance(y, tuple) else y
        y = x + y
        if self.norm is not None and not self.prenorm:
            y = self.norm(y)
        return y


class LayerEncoder(nn.Module):
    """A registered layer as an encoder (`encoders.py:121-141`)."""

    def __init__(self, d_model: int, prenorm: bool = False, norm: str = "layer",
                 layer: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer = ResidualBlock(d_model, prenorm, norm, layer, generator)

    def forward(self, x, **kwargs):
        return self.layer(x)


class TimeEncoder(nn.Module):
    """Time features for forecasting (`encoders.py:206-230`): timeenc 0
    sums one embedding per integer feature (month, day, weekday, hour, ...),
    else one Linear of the float marks; then a 2-way embedding of the mask
    (observed or to predict) is added."""

    def __init__(self, n_tokens_time: Sequence[int], d_model: int, timeenc: int = 0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.timeenc = timeenc
        self.n_features = len(n_tokens_time)
        if timeenc == 0:
            for i, v in enumerate(n_tokens_time):
                setattr(self, f"encoder_{i}", _embed(int(v), d_model, generator))
        else:
            self.encoders = _dense(len(n_tokens_time), d_model, generator)
        self.mask_embed = _embed(2, d_model, generator)

    def forward(self, x, mark=None, mask=None, **kwargs):
        if mark is None or mask is None:
            raise ValueError("TimeEncoder needs the `mark` and `mask` extras of the batch")
        if self.timeenc == 0:
            if mark.shape[-1] != self.n_features:
                raise ValueError(f"mark has {mark.shape[-1]} features, want {self.n_features}")
            time_encode = sum(getattr(self, f"encoder_{i}").weight.to(self.dtype)[mark[..., i]]
                              for i in range(self.n_features))
        else:
            time_encode = linear(mark.to(self.dtype), self.encoders, self.dtype)
        mask_tok = mask[..., 0] if mask.dim() == x.dim() else mask
        mask_encode = self.mask_embed.weight.to(self.dtype)[mask_tok.long()]
        return x + time_encode + mask_encode


class PackedEncoder(nn.Module):
    """Variable-length rows (`encoders.py:233-239`): positions at or past a
    row's length are zeroed (the dense form of a packed sequence)."""

    def forward(self, x, lengths=None, len_batch=None, **kwargs):
        lens = lengths if lengths is not None else len_batch
        if lens is None:
            raise ValueError("PackedEncoder needs `lengths` in the batch")
        pos = torch.arange(x.shape[1], device=x.device)
        keep = pos[None, :] < torch.as_tensor(lens, device=x.device).reshape(-1, 1)
        return x * keep[..., None].to(x.dtype)


class Conv2DPatchEncoder(nn.Module):
    """Image to patch sequence (`encoders.py:252-287`): a conv with stride
    equal to its kernel over NHWC input, flattened to (B, h * w, d_model);
    `flat` takes flattened square images."""

    def __init__(self, d_input: int, d_model: int, filter_sizes: Sequence[int],
                 flat: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(filter_sizes) != 2:
            raise ValueError(f"filter_sizes needs two sizes, got {filter_sizes}")
        fh, fw = filter_sizes
        self.d_input, self.d_model, self.flat, self.dtype = d_input, d_model, flat, dtype
        self.encoder = nn.Conv2d(d_input, d_model, (fh, fw), stride=(fh, fw))
        _normal_(self.encoder.weight, 1.0 / math.sqrt(fh * fw * d_input), generator)
        nn.init.zeros_(self.encoder.bias)

    def forward(self, x, **kwargs):
        if self.flat:
            side = math.isqrt(x.shape[1])
            x = x.reshape(x.shape[0], side, side, self.d_input)
        w, b = self.encoder.weight.to(self.dtype), self.encoder.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b, stride=self.encoder.stride)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.d_model)


class TimestampEmbeddingEncoder(nn.Module):
    """Monash-style timestamps (`encoders.py:144-204`): for each attribute
    of the `timestamps` extra, add an embedding lookup (`table`; -1, a
    missing stamp, adds nothing) or a Linear of the value scaled to
    [-1, 1]."""

    # (min, max) of each attribute
    CARDINALITIES = {
        "day": (1, 31), "hour": (0, 23), "minute": (0, 59),
        "second": (0, 59), "month": (1, 12), "year": (1950, 2010),
        "dayofweek": (0, 6), "dayofyear": (1, 366), "quarter": (1, 4),
        "week": (1, 53), "is_month_start": (0, 1), "is_month_end": (0, 1),
        "is_quarter_start": (0, 1), "is_quarter_end": (0, 1),
        "is_year_start": (0, 1), "is_year_end": (0, 1),
        "is_leap_year": (0, 1),
    }

    def __init__(self, d_model: int, table: bool = False,
                 features: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table, self.dtype = table, dtype
        self.cards = {k: v for k, v in self.CARDINALITIES.items()
                      if features is None or k in features}
        for attr, (lo, hi) in self.cards.items():
            if table:
                setattr(self, f"embedding_{attr}", _embed(hi - lo + 2, d_model, generator))
            else:
                setattr(self, f"linear_{attr}", _dense(1, d_model, generator))

    def forward(self, x, timestamps=None, **kwargs):
        if timestamps is None:
            raise ValueError("TimestampEmbeddingEncoder needs the `timestamps` extra")
        for attr, t in timestamps.items():
            lo, hi = self.cards[attr]
            t = torch.as_tensor(t, device=x.device)
            null = t == -1
            idx = torch.where(null, torch.zeros_like(t), t - lo)
            if self.table:
                table = getattr(self, f"embedding_{attr}").weight.to(self.dtype)
                emb = table[idx.long()] * (~null)[..., None].to(self.dtype)
            else:
                val = (2.0 * idx.float() / (hi - lo + 2) - 1.0)[..., None]
                emb = linear(val, getattr(self, f"linear_{attr}"), self.dtype)
            x = x + emb
        return x


ENCODER_REGISTRY = {
    "embedding": EmbeddingEncoder,
    "linear": LinearEncoder,
    "position": PositionalEncoder,
    "position_id": PositionalIDEncoder,
    "class": ClassEmbedding,
    "onehot": OneHotEncoder,
    "conv1d": Conv1DEncoder,
    "layer": LayerEncoder,
    "time": TimeEncoder,
    "pack": PackedEncoder,
    "patch2d": Conv2DPatchEncoder,
    "timestamp_embedding": TimestampEmbeddingEncoder,
    "id": None,
}

# constructor arguments each encoder takes from the dataset and from the
# model (`encoders.py:311-331`)
DATASET_ATTRS = {
    "embedding": [("n_tokens", "n_tokens")],
    "linear": [("d_input", "d_input")],
    "class": [("n_classes", "n_classes")],
    "time": [("n_tokens_time", "n_tokens_time")],
    "onehot": [("n_tokens", "n_tokens")],
    "conv1d": [("d_input", "d_input")],
    "patch2d": [("d_input", "d_input")],
}
MODEL_ATTRS = {
    "embedding": ["d_model"],
    "linear": ["d_model"],
    "position": ["d_model"],
    "class": ["d_model"],
    "time": ["d_model"],
    "onehot": ["d_model"],
    "conv1d": ["d_model"],
    "patch2d": ["d_model"],
    "timestamp_embedding": ["d_model"],
    "layer": ["d_model"],
}
