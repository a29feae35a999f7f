"""The mesh of ranks: data, sequence and tensor parallelism (the port's
counterpart of `hyena_dna_tpu/parallel/sharding.py`).

The JAX package lays its devices out as a ("data", "seq", "model") mesh and
lets GSPMD insert the collectives. Here each rank is a process
(`parallel/launch.py`), and the mesh is a small object that says where the
rank sits and which process groups it talks over:

  * "data": the batch's rows split over the data axis (each data rank reads
    its strided share of the epoch's order, `data/loader.py`);
  * "seq": each row's length split into contiguous L / S columns
    (`Mesh.local_batch`, `Mesh.seq_columns`); the conv
    chain runs through `ops/distributed.py` (the channel-pencil FFT conv and
    the halo short conv) over the seq group, attention gathers its keys and
    values, and the decoder heads and position metrics reduce over it;
  * "model": tensor parallelism, written the Megatron way: column- and
    row-parallel layers joined by the conjugate collectives of
    `ops/distributed.py` over the model group (the JAX `PARAM_RULES`
    placements, which GSPMD turns into collectives).

Ranks are numbered with model innermost, then seq, rank = (data_index *
seq + seq_index) * model + model_index, as the JAX `make_mesh` puts the
later axis innermost. Every rank of a model group reads the same batch.

Parameters under a model axis of M. A module that splits (`HyenaOperator`,
`MHA`, `Mlp`, `GPT2Embeddings`; each decides from its own widths) names
its sharded parameters in `tp_rules`, {parameter: (dim, chunks)}: the
dimension `dim` holds `chunks` equal chunks, and the rank keeps its M-th
of each chunk (its channels of each of in_proj's [x0 | x1 | v], its heads
of each of Wqkv's [q | k | v], its rows of the vocabulary). A parameter
whose dimension does not divide by M stays whole, as the JAX
`shard_params` leaves it; so does a module whose width does not divide
(it runs whole on each rank). `tp_partial` names the whole submodules or
parameters of a split module whose gradient on a rank is that rank's share
of a sum (the filter MLP of a split Hyena operator: each rank builds the
whole bank and takes its rows; its `ord_proj_w`). `tp_layout(model)` collects both.

Gradients (`train/step.py`): a sharded parameter's over `grad_group`, the
data x seq ranks of this rank's model index; every whole parameter's over
every rank (a partial one summed over the model axis, a
replicated one counted once). With `model == 1`, `grad_group` is every rank.

Checkpoints hold whole tensors: `gather_state_dict` joins the ranks'
slices over the model group (a collective: every rank calls it) and
`shard_state_dict` gives a rank its slices of whole tensors, so a
checkpoint written under one mesh resumes under any other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from hyena_dna_tpu_torch.parallel import launch


@dataclass(frozen=True)
class Mesh:
    data: int
    seq: int
    data_index: int = 0
    seq_index: int = 0
    data_group: Optional[Any] = None   # the ranks of this rank's seq and model index
    seq_group: Optional[Any] = None    # the ranks of this rank's data and model index
    grad_group: Optional[Any] = None   # the data x seq ranks of this rank's model index
    model: int = 1
    model_index: int = 0
    model_group: Optional[Any] = None  # the ranks of this rank's data and seq index

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seq": self.seq, "model": self.model}

    @property
    def size(self) -> int:
        """The ranks of the mesh."""
        return self.data * self.seq * self.model

    @property
    def replicas(self) -> int:
        """The ranks that hold one model slice: data x seq."""
        return self.data * self.seq

    def whole(self) -> "Mesh":
        """This mesh without its model axis: what a module that runs whole
        on each rank sees."""
        return dataclasses.replace(self, model=1, model_index=0, model_group=None)

    def seq_columns(self, length: int) -> slice:
        """This rank's contiguous L / S columns of a length-L row."""
        if length % self.seq:
            raise ValueError(f"length {length} does not split over seq={self.seq}")
        c = length // self.seq
        return slice(self.seq_index * c, (self.seq_index + 1) * c)

    def local_batch(self, batch):
        """This rank's columns of every 2-D array of a numpy batch (a tuple
        of arrays, a trailing dict of arrays) that is as wide as its first
        array, the sequence (the inputs, per-token targets, masks); other
        arrays (per-sequence labels such as a (B, 919) chromatin profile)
        stay whole. Its rows are already its own: each data rank's loader
        serves its strided share of the epoch's order (`data/loader.py`)."""
        if self.seq == 1:
            return batch
        width = batch[0].shape[1]

        def cut(a):
            if a.ndim == 2 and a.shape[1] == width:
                return a[:, self.seq_columns(width)]
            return a

        return tuple({k: cut(v) for k, v in b.items()} if isinstance(b, dict) else cut(b)
                     for b in batch)


def model_axis(mesh: Optional[Mesh], *widths: int) -> Optional[Mesh]:
    """`mesh` when it has a model axis above 1 that divides every width (the
    module then splits), else None (the module runs whole on each rank)."""
    if mesh is None or mesh.model == 1 or any(w % mesh.model for w in widths):
        return None
    return mesh


def make_mesh(data: int = -1, seq: int = 1, model: int = 1) -> Mesh:
    """The mesh over the running ranks (JAX `make_mesh`): `data=-1` takes
    the world size left over by the other axes. Every rank must call it,
    in the same order, as it creates the axis groups."""
    world, rank = launch.world_size(), launch.rank()
    if data == -1:
        data = max(world // (seq * model), 1)
    if data < 1 or seq < 1 or model < 1 or data * seq * model != world:
        raise ValueError(f"mesh data={data} x seq={seq} x model={model} needs "
                         f"{data * seq * model} ranks, the run has {world}: launch one process "
                         "per rank with torchrun (python -m torch.distributed.run "
                         "--nproc_per_node N ...)")
    if world == 1:
        return Mesh(1, 1)
    r = lambda d, s, m: (d * seq + s) * model + m
    d_idx, rest = divmod(rank, seq * model)
    s_idx, m_idx = divmod(rest, model)
    groups = {}

    def axis_group(name, size, members):
        """One group per fixed index of the other axes (`members`, lists of
        ranks), created by every rank in one order; this rank's is kept."""
        if size == 1:
            return
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g

    D, S, M = range(data), range(seq), range(model)
    axis_group("data", data, [[r(d, s, m) for d in D] for s in S for m in M])
    axis_group("seq", seq, [[r(d, s, m) for s in S] for d in D for m in M])
    axis_group("model", model, [[r(d, s, m) for m in M] for d in D for s in S])
    if model == 1:
        grad_group = dist.group.WORLD
    else:
        axis_group("grad", data * seq, [[r(d, s, m) for d in D for s in S] for m in M])
        grad_group = groups.get("grad")
    return Mesh(data, seq, d_idx, s_idx, groups.get("data"), groups.get("seq"), grad_group,
                model, m_idx, groups.get("model"))


# ---- parameter layout under a model axis ------------------------------------

SHARDED, PARTIAL = "sharded", "partial"


def tp_layout(model: nn.Module) -> Dict[str, tuple]:
    """{parameter or buffer name: (SHARDED, dim, chunks) | (PARTIAL,)} over
    the modules of `model` that split (their `tp_rules` and `tp_partial`);
    a name it leaves out is whole and replicated."""
    layout = {}
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        for name, (dim, chunks) in getattr(mod, "tp_rules", {}).items():
            layout[pre + name] = (SHARDED, dim, chunks)
        for sub in getattr(mod, "tp_partial", ()):  # submodules or parameters
            part = getattr(mod, sub)
            names = ([""] if isinstance(part, nn.Parameter)
                     else ["." + name for name, _ in part.named_parameters()])
            for name in names:
                layout[f"{pre}{sub}{name}"] = (PARTIAL,)
    return layout


def shard_tensor(whole: torch.Tensor, dim: int, chunks: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor: its M-th of each of the `chunks`
    equal chunks of dimension `dim`, in chunk order."""
    m, M = mesh.model_index, mesh.model
    n = whole.shape[dim]
    if n % (chunks * M):
        raise ValueError(f"dimension {dim} of {tuple(whole.shape)} does not split into "
                         f"{chunks} chunks over model={M}")
    parts = whole.unflatten(dim, (chunks, M, n // (chunks * M)))
    return parts.select(dim + 1, m).flatten(dim, dim + 1).contiguous()


def gather_tensor(local: torch.Tensor, dim: int, chunks: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's slice (`shard_tensor`'s
    inverse); a collective over the model group."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.model)]
    launch.timed("tp_all_gather", local,
                 lambda: dist.all_gather(parts, local, group=mesh.model_group))
    n = local.shape[dim] // chunks
    joined = torch.stack([p.unflatten(dim, (chunks, n)) for p in parts], dim=dim + 1)
    return joined.flatten(dim, dim + 2)


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                     layout: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """This rank's state dict from a whole one (JAX `shard_params` for a
    torch state dict): every SHARDED entry of `layout` sliced, the rest as
    it is."""
    if mesh is None or mesh.model == 1:
        return dict(full)
    return {k: (shard_tensor(v, *layout[k][1:], mesh) if layout.get(k, ("",))[0] == SHARDED
                else v) for k, v in full.items()}


def gather_state_dict(local: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                      layout: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's (`shard_state_dict`'s
    inverse); a collective over the model group: every rank calls it with
    the same keys in the same order."""
    if mesh is None or mesh.model == 1:
        return dict(local)
    return {k: (gather_tensor(v, *layout[k][1:], mesh) if layout.get(k, ("",))[0] == SHARDED
                else v) for k, v in local.items()}


def build_sharded(build, mesh: Optional[Mesh], generator=None) -> nn.Module:
    """`build(mesh, generator)`, a module whose weights are drawn from
    `generator`. Under a model axis the whole module is built first
    (`build(mesh.whole(), generator)`), then the rank's module without
    weights (on the meta device, drawing nothing), which takes its slices
    of the whole weights: a tensor-parallel run starts from the weights of
    the run without a model axis, and `generator` is left where that run
    leaves it."""
    if mesh is None or mesh.model == 1:
        return build(mesh, generator)
    whole = build(mesh.whole(), generator)
    with torch.device("meta"):
        module = build(mesh, None)
    module.load_state_dict(shard_state_dict(whole.state_dict(), mesh, tp_layout(module)),
                           assign=True)
    return module
