"""The mesh of ranks: data and sequence parallelism (the data and seq parts
of `hyena_dna_tpu/parallel/sharding.py`).

The JAX package lays its devices out as a ("data", "seq", "model") mesh and
lets GSPMD insert the collectives. Here each rank is a process
(`parallel/launch.py`), and the mesh is a small object that says where the
rank sits and which process groups it talks over:

  * "data": the batch's rows split over the data axis (each data rank reads
    its strided share of the epoch's order, `data/loader.py`);
  * "seq": each row's length split into contiguous L / S columns
    (`Mesh.local_batch`, `Mesh.seq_columns`); the conv
    chain runs through `ops/distributed.py` (the channel-pencil FFT conv and
    the halo short conv) over the seq group;
  * "model": tensor parallelism, not ported (ROADMAP.md item 21): a mesh
    with `model > 1` raises.

Ranks are numbered with seq innermost, rank = data_index * seq + seq_index,
as the JAX mesh puts the later axis innermost. Every rank holds the whole
model; the gradient is all-reduced over every rank (the data x seq group,
`grad_group`), so a checkpoint written under one mesh resumes under any
other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from hyena_dna_tpu_torch.parallel import launch

TP_ITEM = "ROADMAP.md Queue 1 item 21"


@dataclass(frozen=True)
class Mesh:
    data: int
    seq: int
    data_index: int = 0
    seq_index: int = 0
    data_group: Optional[Any] = None  # the ranks of this rank's seq index, one per data index
    seq_group: Optional[Any] = None   # the ranks of this rank's data index, one per seq index
    grad_group: Optional[Any] = None  # every rank: the gradient and metric reductions

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seq": self.seq, "model": 1}

    @property
    def size(self) -> int:
        return self.data * self.seq

    def seq_columns(self, length: int) -> slice:
        """This rank's contiguous L / S columns of a length-L row."""
        if length % self.seq:
            raise ValueError(f"length {length} does not split over seq={self.seq}")
        c = length // self.seq
        return slice(self.seq_index * c, (self.seq_index + 1) * c)

    def local_batch(self, batch):
        """This rank's columns of every 2-D array of a numpy batch (a tuple
        of arrays, a trailing dict of arrays). Its rows are already its
        own: each data rank's loader serves its strided share of the
        epoch's order (`data/loader.py`)."""
        if self.seq == 1:
            return batch

        def cut(a):
            return a[:, self.seq_columns(a.shape[1])] if a.ndim == 2 else a

        return tuple({k: cut(v) for k, v in b.items()} if isinstance(b, dict) else cut(b)
                     for b in batch)


def make_mesh(data: int = -1, seq: int = 1, model: int = 1) -> Mesh:
    """The mesh over the running ranks (JAX `make_mesh`): `data=-1` takes
    the world size left over by the other axes. Every rank must call it,
    in the same order, as it creates the axis groups."""
    if model != 1:
        raise NotImplementedError(
            f"mesh.model={model}: tensor parallelism is not ported; it waits for {TP_ITEM}")
    world, rank = launch.world_size(), launch.rank()
    if data == -1:
        data = max(world // seq, 1)
    if data < 1 or seq < 1 or data * seq != world:
        raise ValueError(f"mesh data={data} x seq={seq} needs {data * seq} ranks, the run has "
                         f"{world}: launch one process per rank with torchrun "
                         "(python -m torch.distributed.run --nproc_per_node N ...)")
    if world == 1:
        return Mesh(1, 1)
    d_idx, s_idx = divmod(rank, seq)
    data_group = seq_group = None
    if data > 1:  # one group per seq index, created by every rank in one order
        for s in range(seq):
            g = dist.new_group([d * seq + s for d in range(data)])
            data_group = g if s == s_idx else data_group
    if seq > 1:
        for d in range(data):
            g = dist.new_group([d * seq + s for s in range(seq)])
            seq_group = g if d == d_idx else seq_group
    return Mesh(data, seq, d_idx, s_idx, data_group, seq_group, dist.group.WORLD)
