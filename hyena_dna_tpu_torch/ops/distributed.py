"""Sequence-sharded convolutions: the channel-pencil FFT conv and the halo
short conv (mirrors `hyena_dna_tpu/ops/distributed.py`); and the
conjugate collectives of tensor parallelism over a mesh's model axis.

Under a mesh with a seq axis of size S, each rank holds a (B, C, L / S)
block of columns (`parallel/sharding.py`, its contiguous columns).

  * `seq_fftconv`: a length-L FFT cannot run on L / S columns, but a
    depthwise conv splits over channels. An all-to-all over the seq group
    turns (B, C, L / S) into the rank's channel pencil (B, C / S, L); the
    rank runs the port's conv on it (`ops/fftconv.py::fftconv_tagged`:
    kernel B forward, kernel C backward on the card) with its filter rows
    k[c0:c1] and D[c0:c1]; a second all-to-all brings (B, C, L / S) back.
    Each pencil is the same single-device conv, so the result is the same
    as one conv of the whole tensor. The backward of an all-to-all is the
    reverse all-to-all; dk and dD come back full size and zero outside the
    rank's rows, for the gradient all-reduce (`train/step.py`) to sum.
    The all-to-alls move u in its own dtype (the model dtype, as the JAX
    route does) and the pencil is cast to the filter's dtype for the
    kernel (bfloat16 from L = 2^15, the single-device route's conv I/O).
    Under a checkpoint cell that saves the conv output the recompute
    replays the pencil conv but runs both all-to-alls again: every rank
    issues them in one order, since every rank runs the same graph.
  * `seq_short_conv`: the causal depthwise k-tap conv needs the k - 1
    columns left of the rank's first: an all-gather of every rank's last
    k - 1 columns, of which each rank keeps its left neighbour's (rank 0
    takes zeros, the causal pad); the backward all-gathers the halo's
    gradient and each rank keeps its right neighbour's. An all-gather and
    not send / recv, which gloo takes only for CPU tensors.

With a seq axis of 1 (or no mesh) both are the single-device ops, as in
the JAX package.

Tensor parallelism (`parallel/sharding.py`: a model axis of M ranks, each
holding a slice of a layer's columns or rows; the JAX package lets GSPMD
insert these, the reference writes them by hand in flash-attn's parallel
layers). Each is an `autograd.Function` over the mesh's model group:

  * `copy_to_model`: the identity forward, an all-reduce of the gradient
    backward (a replicated input entering column-parallel layers: each
    rank's input gradient is its share of the sum);
  * `reduce_from_model`: an all-reduce forward, the identity backward (the
    rank's partial output of a row-parallel layer);
  * `gather_from_model`: an all-gather along the last dimension forward,
    the rank's slice of the gradient backward (the vocab-parallel logits).

The all-reduces sum in float32 and round once to the tensor's dtype.

The mesh-rest collectives, each an `autograd.Function` whose backward is
the exact adjoint of its forward, so that every rank may backpropagate its
own share of the loss and the train step's gradient sum over the ranks
(`train/step.py`) is the gradient of the global loss:

  * `gather_along(x, group, dim)`: every rank's x joined along `dim` in
    group order; backward, the reduce-scatter of the gathered gradient
    (each rank gets the sum of every rank's gradient of its own slice).
    Gloo has no reduce-scatter, so it is an `all_to_all_single` of the
    slices and a float32 sum in group order. `seq_gather` is it over the
    seq group (attention's keys and values, the position metrics' NLL),
    and the tensor-parallel general Hyena path uses it over the model
    group (v before the post-order FFN, x_i before outer mixing);
  * `seq_sum`: the sum over the seq group forward and backward (a value
    every rank reads whole, built from disjoint parts of the ranks: the
    decoder heads' picked and windowed positions);
  * `seq_exclusive_prefix`: the sum of the earlier seq ranks' x (zeros on
    the first); backward, the sum of the later ranks' gradients (the
    running sums and means of the pooled heads).

Each collective is counted in `parallel.launch.COLLECTIVES`; a failed one
raises, which ends the run.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from hyena_dna_tpu_torch.ops.fftconv import fftconv_tagged
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d, short_conv_1d_with_halo
from hyena_dna_tpu_torch.parallel.launch import timed


def all_to_all(x: torch.Tensor, group, to_pencil: bool) -> torch.Tensor:
    """(B, C, L / S) -> (B, C / S, L) with `to_pencil`, else the reverse,
    over the S ranks of `group` (rank j of the group holds columns
    j L / S .. (j + 1) L / S and channel block j)."""
    s = dist.get_world_size(group)
    b = x.shape[0]
    if to_pencil:
        c, ls = x.shape[1], x.shape[2]
        send = x.reshape(b, s, c // s, ls).permute(1, 0, 2, 3).contiguous()
    else:
        cs, ls = x.shape[1], x.shape[2] // s
        send = x.reshape(b, cs, s, ls).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    timed("all_to_all_single", send, lambda: dist.all_to_all_single(recv, send, group=group))
    if to_pencil:  # recv[j]: rank j's columns of this rank's channels
        return recv.permute(1, 2, 0, 3).reshape(b, send.shape[2], s * ls)
    return recv.permute(1, 0, 2, 3).reshape(b, s * cs, ls)  # recv[j]: channel block j


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, to_pencil):
        ctx.group, ctx.to_pencil = group, to_pencil
        return all_to_all(x, group, to_pencil)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.group, not ctx.to_pencil), None, None


def _gather_neighbour(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """The x of the group rank `offset` away from this one, zeros past the ends."""
    s, i = dist.get_world_size(group), dist.get_rank(group)
    parts = [torch.empty_like(x) for _ in range(s)]
    x = x.contiguous()
    timed("all_gather", x, lambda: dist.all_gather(parts, x, group=group))
    j = i + offset
    return parts[j] if 0 <= j < s else torch.zeros_like(x)


class _Halo(torch.autograd.Function):
    """The left neighbour's tail forward, the right neighbour's halo
    gradient backward."""

    @staticmethod
    def forward(ctx, tail, group):
        ctx.group = group
        return _gather_neighbour(tail, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return _gather_neighbour(grad, ctx.group, 1), None


def seq_fftconv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor, mesh=None) -> torch.Tensor:
    """Causal FFT conv with skip of this rank's columns u (B, C, L / S) of
    a (B, C, L) signal; k (C, Lk) the whole filter bank in the conv dtype
    (float32 or bfloat16), D (C,) float32. C must divide by S. Returns
    (B, C, L / S) in u's dtype."""
    if mesh is None or mesh.seq == 1:
        return fftconv_tagged(u.to(k.dtype), k, D).to(u.dtype)
    s, c = mesh.seq, u.shape[1]
    if u.dim() != 3 or c % s:
        raise ValueError(f"seq_fftconv takes (B, C, L / S) with C divisible by S={s}; "
                         f"got {tuple(u.shape)}")
    rows = slice(mesh.seq_index * (c // s), (mesh.seq_index + 1) * (c // s))
    pencil = _AllToAll.apply(u, mesh.seq_group, True)
    y = fftconv_tagged(pencil.to(k.dtype), k[rows], D[rows]).to(u.dtype)
    return _AllToAll.apply(y, mesh.seq_group, False)


def seq_short_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   mesh=None) -> torch.Tensor:
    """Depthwise causal conv of this rank's columns x (B, C, L / S), the
    halo from the left neighbour (rank 0: zeros, the causal pad)."""
    if mesh is None or mesh.seq == 1 or w.shape[-1] == 1:
        return short_conv_1d(x, w, b)
    halo = _Halo.apply(x[..., x.shape[-1] - (w.shape[-1] - 1):], mesh.seq_group)
    return short_conv_1d_with_halo(x, w, b, halo)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, taken in float32, rounded once to x's dtype."""
    total = x.float().contiguous()
    if total is x:
        total = total.clone()
    timed("tp_all_reduce", total, lambda: dist.all_reduce(total, group=group))
    return total.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        timed("tp_all_gather", x, lambda: dist.all_gather(parts, x, group=group))
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad[..., ctx.index * w:(ctx.index + 1) * w].contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as it is; its gradient all-reduced over the model group."""
    return x if mesh is None or mesh.model == 1 else _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every model rank's x (float32, rounded once); its
    gradient passes as it is."""
    return x if mesh is None or mesh.model == 1 else _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's x joined along the last dimension in rank order;
    the gradient's slice of this rank backward."""
    if mesh is None or mesh.model == 1:
        return x
    return _GatherFromModel.apply(x, mesh.model_group, mesh.model_index)


# ---- the mesh-rest collectives ----------------------------------------------


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over `group` of x, this rank's 1/S slice along `dim` (S the
    group's size), summed in float32 in group order and rounded once: an
    all-to-all of the S slices (gloo has no reduce-scatter)."""
    s = dist.get_world_size(group)
    send = torch.stack(x.chunk(s, dim)).contiguous()
    recv = torch.empty_like(send)
    timed("reduce_scatter", send, lambda: dist.all_to_all_single(recv, send, group=group))
    return recv.float().sum(0).to(x.dtype)


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        timed("all_gather", x, lambda: dist.all_gather(parts, x, group=group))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad.contiguous(), ctx.group, ctx.dim), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


def _rank_sum(x: torch.Tensor, group, ranks) -> torch.Tensor:
    """The float32 sum of the x of the group ranks in `ranks` (zeros if
    none), from an all-gather, in x's dtype."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    timed("all_gather", x, lambda: dist.all_gather(parts, x, group=group))
    total = torch.zeros_like(x, dtype=torch.float32)
    for j in ranks:
        total += parts[j].float()
    return total.to(x.dtype)


class _ExclusivePrefix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rank_sum(x, group, range(dist.get_rank(group)))

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return _rank_sum(grad, g, range(dist.get_rank(g) + 1, dist.get_world_size(g))), None


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x of `group` joined along `dim` in group order; its
    gradient reduce-scattered back."""
    return _GatherAlong.apply(x, group, dim)


def seq_gather(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole sequence from every seq rank's columns along `dim` (x
    itself without a seq axis); the gradient reduce-scattered back."""
    if mesh is None or mesh.seq == 1:
        return x
    return _GatherAlong.apply(x, mesh.seq_group, dim)


def seq_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every seq rank's x (float32, rounded once), and the same
    sum of the gradients backward."""
    if mesh is None or mesh.seq == 1:
        return x
    return _SumOver.apply(x, mesh.seq_group)


def seq_exclusive_prefix(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the x of the seq ranks before this one (zeros on the
    first); backward, the sum of the gradients of the ranks after it."""
    if mesh is None or mesh.seq == 1:
        return torch.zeros_like(x)
    return _ExclusivePrefix.apply(x, mesh.seq_group)
