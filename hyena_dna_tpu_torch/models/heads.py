"""Decoders mapping backbone outputs to task outputs (mirrors
`hyena_dna_tpu/models/heads.py`).

`SequenceDecoder` pools over the length and projects: (B, L, d) ->
(B, l_output, d_output), in the modes of the JAX module:

  last:   the final l_output positions
  first:  the first l_output positions
  pool:   the running mean over the prefix, its final l_output positions;
          with a `mask` (B, L), the mean at each sequence's true last
          position (the count of mask entries minus one)
  sum:    the running sum, its final l_output positions
  ragged: the feature at each sequence's last real position (`lengths`)

`l_output=None` keeps every position; `l_output=0` takes one and squeezes
the length axis. The running sums and means accumulate in float32 and round
once to the hidden states' dtype. For float32 hidden states that is the JAX
module's value exactly. For bf16 ones the port departs from the JAX module
on purpose: JAX sums in bf16. A bf16 `cumsum` on the card accumulates
serially in bf16 and drifts over a 1024-long window, which moved the
fine-tune's first loss by 1% against the CPU; in float32 the card and the
CPU agree, and the reference trained under autocast, which also runs
`cumsum` in float32. The port's bf16 result stays within 1e-2 of max|x|
of the JAX module's bf16 one, closer to the float32 sums than that is
(`tests/test_torch_port_finetune.py`). `TokenDecoder` is a per-token Linear, `NDDecoder`
a mean over the length (mode "pool") or nothing ("full") then a Linear,
`RetrievalDecoder` a length-squeezing `SequenceDecoder` (no projection)
then `RetrievalHead` (NLI features [a, b, a - b, a * b] of the two halves
of the batch, or their concatenation, through an MLP), `PackedDecoder` the
identity and `StateDecoder` a Linear over the model's final state.

Every projection is a `nn.Linear` named as the flax `Dense` it mirrors
(`output_transform`, `fc1`, `fc2`, `fc3`, under `retrieval` in
`RetrievalDecoder`), so `utils/convert.py::flax_to_torch_state_dict` maps a
JAX head's parameters onto it. A projection runs in `dtype` (float32 by
default, as the JAX trainer builds its heads) through `models/nn.py::linear`.
`init_weights(generator)` draws the JAX initialisers: N(0, init_std) for
`output_transform` of the sequence, token and N-D decoders, flax's
`lecun_normal` (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in) for the retrieval and state heads; biases zero.

Sequence parallelism (`mesh` with a seq axis S above 1; the JAX package
runs its heads on the global view under GSPMD): each rank holds its
contiguous L / S columns of x, and every mode keeps its global meaning,
written with the collectives of `ops/distributed.py`, whose backwards are
their exact adjoints:
  * `last` and `first`: each rank places its part of the l_output global
    positions in a zero window, and `seq_sum` joins the windows;
  * `pool` and `sum`: the local float32 cumsum plus the exclusive prefix of
    the earlier ranks' sums (`seq_exclusive_prefix`), divided (pool) by the
    global position, then windowed as `last`;
  * masked `pool` and `ragged`: the global end index (the mask's count,
    summed over the ranks, or `lengths`) picks the owning rank's value,
    and `seq_sum` gives it to every rank;
  * `l_output=None` keeps every position: the rank's own columns of the
    global running values, a per-token output.
`NDDecoder`'s mean over L is the `seq_sum` of the ranks' sums over the
global length; `RetrievalDecoder`'s feature is a `SequenceDecoder`;
`TokenDecoder` and `PackedDecoder` are per token and `StateDecoder` reads
no length, so they need nothing. Every seq rank ends with the same
per-sequence output; the train step weights each rank's copy of its loss
by 1 / S (`train/step.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.nn import linear
from hyena_dna_tpu_torch.ops.distributed import seq_exclusive_prefix, seq_sum


def _normal_(layer: nn.Linear, std: float, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()


def _lecun_normal_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax `lecun_normal`: truncated at +-2 sigma, variance 1 / fan_in."""
    std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        layer.bias.zero_()


def _seq_axis(mesh):
    """`mesh` when it has a seq axis above 1, else None."""
    return mesh if mesh is not None and mesh.seq > 1 else None


class SequenceDecoder(nn.Module):
    def __init__(self, d_model: int, d_output: Optional[int] = None,
                 l_output: Optional[int] = None, mode: str = "last",
                 use_lengths: bool = False, init_std: float = 0.02,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        if mode not in ("last", "first", "pool", "sum", "ragged"):
            raise NotImplementedError(f"mode {mode}")
        self.seq = _seq_axis(mesh)
        self.l_output = l_output
        self.mode = mode
        self.init_std = init_std
        self.dtype = dtype
        self.output_transform = None if d_output is None else nn.Linear(d_model, d_output)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        if self.output_transform is not None:
            _normal_(self.output_transform, self.init_std, generator)

    def forward(self, x: torch.Tensor, state=None, lengths=None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = self.l_output == 0
        x = self._pool(x, lengths, mask)
        if squeeze:
            x = x.squeeze(-2)
        if self.output_transform is not None:
            x = linear(x, self.output_transform, self.dtype)
        return x

    def _pool(self, x, lengths, mask) -> torch.Tensor:
        """The mode's (B, l_output, d) of the global sequence, from this
        rank's columns x (B, L / S, d) (all of them without a seq axis): the
        same on every seq rank, or with `l_output=None` the rank's columns of
        the per-token result."""
        mesh, local, dtype = self.seq, x.shape[-2], x.dtype
        offset, length = ((mesh.seq_index * local, mesh.seq * local) if mesh is not None
                          else (0, local))
        if self.mode in ("pool", "sum"):  # the global running sums in float32
            xf = x.float()
            x = (torch.cumsum(xf, dim=-2)
                 + seq_exclusive_prefix(xf.sum(dim=-2, keepdim=True), mesh))
            if self.mode == "pool":
                x = x / torch.arange(offset + 1, offset + local + 1, dtype=torch.float32,
                                     device=x.device)[:, None]
            x = x.to(dtype)
        if self.mode == "ragged" or (self.mode == "pool" and mask is not None):
            if self.mode == "ragged":
                if lengths is None:
                    raise ValueError("lengths required for ragged mode")
                ends = torch.as_tensor(lengths, device=x.device).reshape(-1).long() - 1
            else:  # the mask's global count
                ends = seq_sum(mask.reshape(x.shape[0], -1).sum(dim=-1).float(), mesh)
                ends = ends.long() - 1
            # an end of -1 (an empty sequence) indexes from the back, as in JAX
            return self._pick(x, torch.remainder(ends, length) - offset)[:, None, :]
        if self.l_output is None:
            return x
        n = max(self.l_output, 1)
        start = length - n if self.mode != "first" else 0
        # this rank's part of the global positions [start, start + n), in place;
        # an empty part is still a slice of x, so every rank's backward
        # reaches the collective
        lo, hi = max(start, offset), min(start + n, offset + local)
        part, left = ((x[..., lo - offset:hi - offset, :], lo - start) if hi > lo
                      else (x[..., :0, :], 0))
        return seq_sum(F.pad(part, (0, 0, left, n - left - part.shape[-2])), mesh)

    def _pick(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """x[b, idx[b]] (B, d) for the rank that holds column idx[b] of
        its columns x (B, L / S, d), given on every seq rank."""
        mine = (idx >= 0) & (idx < x.shape[-2])
        rows = torch.arange(x.shape[0], device=x.device)
        picked = x[rows, idx.clamp(0, x.shape[-2] - 1)] * mine[:, None].to(x.dtype)
        return seq_sum(picked, self.seq)


class TokenDecoder(nn.Module):
    """Per-token classification head."""

    def __init__(self, d_model: int, d_output: int, init_std: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_std = init_std
        self.dtype = dtype
        self.output_transform = nn.Linear(d_model, d_output)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        _normal_(self.output_transform, self.init_std, generator)

    def forward(self, x: torch.Tensor, state=None, **kwargs) -> torch.Tensor:
        return linear(x, self.output_transform, self.dtype)


class NDDecoder(nn.Module):
    """Mean over the length ("pool") or not ("full"), then a Linear."""

    def __init__(self, d_model: int, d_output: Optional[int] = None, mode: str = "pool",
                 init_std: float = 0.02, dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        if mode not in ("pool", "full"):
            raise ValueError(f"mode {mode!r} is not pool or full")
        self.seq = _seq_axis(mesh)
        self.mode = mode
        self.init_std = init_std
        self.dtype = dtype
        self.output_transform = None if d_output is None else nn.Linear(d_model, d_output)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        if self.output_transform is not None:
            _normal_(self.output_transform, self.init_std, generator)

    def forward(self, x: torch.Tensor, state=None, **kwargs) -> torch.Tensor:
        if self.mode == "pool":  # the global mean, summed in float32
            total = seq_sum(x.float().sum(dim=-2), self.seq)
            s = 1 if self.seq is None else self.seq.seq
            x = (total / (x.shape[-2] * s)).to(x.dtype)
        if self.output_transform is not None:
            x = linear(x, self.output_transform, self.dtype)
        return x


_ACTIVATIONS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


class RetrievalHead(nn.Module):
    """Dual-sequence classifier over (2B, d): the first B rows against the last B."""

    def __init__(self, d_input: int, d_model: int, n_classes: int, nli: bool = True,
                 activation: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nli = nli
        self.act = _ACTIVATIONS[activation]
        self.dtype = dtype
        if nli:
            self.fc1 = nn.Linear(4 * d_input, d_model)
            self.fc2 = nn.Linear(d_model, n_classes)
        else:
            self.fc1 = nn.Linear(2 * d_input, d_model)
            self.fc2 = nn.Linear(d_model, d_model // 2)
            self.fc3 = nn.Linear(d_model // 2, n_classes)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.children():
            _lecun_normal_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.chunk(x, 2, dim=0)
        if self.nli:
            h = self.act(linear(torch.cat([a, b, a - b, a * b], dim=-1), self.fc1, self.dtype))
            return linear(h, self.fc2, self.dtype)
        h = self.act(linear(torch.cat([a, b], dim=-1), self.fc1, self.dtype))
        h = self.act(linear(h, self.fc2, self.dtype))
        return linear(h, self.fc3, self.dtype)


class RetrievalDecoder(nn.Module):
    """A length-squeezing `SequenceDecoder` (no projection), then `RetrievalHead`."""

    def __init__(self, d_input: int, n_classes: int, d_model: Optional[int] = None,
                 nli: bool = True, activation: str = "relu", mode: str = "pool",
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.feature = SequenceDecoder(d_input, None, l_output=0, mode=mode, dtype=dtype,
                                       mesh=mesh)
        self.retrieval = RetrievalHead(d_input, d_model or d_input, n_classes, nli,
                                       activation, dtype)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        self.retrieval.init_weights(generator)

    def forward(self, x: torch.Tensor, state=None, **kwargs) -> torch.Tensor:
        return self.retrieval(self.feature(x, **kwargs))


class PackedDecoder(nn.Module):
    """The identity: the batch never leaves its dense (B, L, d) layout."""

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        pass

    def forward(self, x: torch.Tensor, state=None, **kwargs) -> torch.Tensor:
        return x


class StateDecoder(nn.Module):
    """A Linear over the model's final state, `state_to_tensor(state)` (B, d_model)."""

    def __init__(self, d_model: int, d_output: int,
                 state_to_tensor: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.state_to_tensor = state_to_tensor
        self.dtype = dtype
        self.output_transform = nn.Linear(d_model, d_output)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.output_transform, generator)

    def forward(self, x, state=None, **kwargs) -> torch.Tensor:
        s = self.state_to_tensor(state) if self.state_to_tensor else state
        return linear(s, self.output_transform, self.dtype)
