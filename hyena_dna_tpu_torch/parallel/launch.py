"""Process launch for data, sequence and tensor parallelism (the
counterpart of `hyena_dna_tpu/parallel/launch.py`).

One process per rank, started by torchrun:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m hyena_dna_tpu_torch.train experiment=hg38/hg38_medium_450k ...

Collectives run on `torch.distributed` process groups (the mesh's groups
are in `parallel/sharding.py`). `initialize_distributed(device)` reads
torchrun's `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and
`MASTER_PORT`; without them it does nothing and the run is one process.

Each rank's device is `cuda:{LOCAL_RANK % torch.cuda.device_count()}`, or
the CPU when the caller asks for it (the tests). The backend is one rule:
NCCL when every rank of the node has a card of its own
(`LOCAL_WORLD_SIZE <= device_count`), gloo when ranks share a card (NCCL
does not support two ranks on one device) or run on the CPU. Gloo takes
the card's tensors in every collective the port issues
(`all_to_all_single`, `all_gather`, `all_reduce`), so the port stages
nothing through host memory. Rank 0 prints the backend and the
rank-to-device map on a line of its own.

`COLLECTIVES` counts each collective the port issues on a training path
(`ops/distributed.py`'s all-to-alls, halo all-gathers and tensor-parallel
all-reduces and all-gathers, the train step's and optimizer's all-reduces,
`parallel/sharding.py`'s gathers of whole tensors): calls, bytes this rank sends and host seconds inside the
call. Under gloo a call on the card's tensors first waits for the kernels
queued before it, so those seconds hold that wait too; under NCCL the call
returns once it is enqueued. A measurement that wants the collectives
alone sets `COLLECTIVES.synchronize`: each collective then synchronises
the card first and counts that wait apart (`wait_seconds`). What is left
inside the call still holds the wait for the slowest rank of the group.

`spawn(fn, world, ...)` starts `world` local ranks on a free TCP port with
torchrun's variables set, for the tests (pytest-xdist runs several spawned
worlds at once, so no port is fixed); each rank joins the group through
`initialize_distributed`.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class CollectiveStats:
    """Per collective name: calls, bytes sent by this rank, host seconds in
    the call and, with `synchronize` set, host seconds waiting for the card
    before it."""

    def __init__(self):
        self.synchronize = False
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds, self.wait_seconds = {}, {}, {}, {}

    def record(self, name: str, nbytes: int, seconds: float, wait: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + nbytes
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.wait_seconds[name] = self.wait_seconds.get(name, 0.0) + wait

    def summary(self) -> dict:
        return {n: {"calls": self.calls[n], "bytes": self.bytes[n], "seconds": self.seconds[n],
                    "wait_seconds": self.wait_seconds[n]} for n in self.calls}


COLLECTIVES = CollectiveStats()


def timed(name: str, sent: torch.Tensor, call: Callable[[], Any]) -> None:
    """Run the collective `call` and count it in COLLECTIVES under `name`
    with the bytes of `sent`, this rank's buffer."""
    t0 = time.perf_counter()
    if COLLECTIVES.synchronize and sent.is_cuda:
        torch.cuda.synchronize(sent.device)
    t1 = time.perf_counter()
    call()
    COLLECTIVES.record(name, sent.numel() * sent.element_size(), time.perf_counter() - t1,
                       t1 - t0)


def launched() -> bool:
    """Whether torchrun's variables describe a process group to join."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device: torch.device) -> torch.device:
    """The rank's device: a CUDA device without an index becomes
    `cuda:{LOCAL_RANK % device_count}`; raises without a card."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launch asked for the card; pass "
                           "device='cpu' to run the kernels' plain versions")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """NCCL when every rank of the node has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device: torch.device) -> torch.device:
    """Join torchrun's process group (once) and return the rank's device;
    a process without torchrun's variables is a single rank."""
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not launched() or dist.is_initialized():
        return device
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun's {', '.join(missing)} not set")
    backend = backend_for(device)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(device))
    if dist.get_rank() == 0:
        print(json.dumps({"distributed": {"backend": backend, "world": len(devices),
                                          "rank_device": devices}}), flush=True)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    """Every rank waits for the others (nothing for a single process)."""
    if world_size() > 1:
        dist.barrier()


def free_port() -> int:
    """A TCP port on localhost that was free when asked (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, fn: Callable, world: int, port: int, args: Sequence) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), timeout: float = 600.0) -> None:
    """Run `fn(*args)` on `world` local ranks: spawned processes with
    torchrun's variables set, on a free port; `fn` joins the group through
    `initialize_distributed`. Raises if a rank fails or the ranks outlast
    `timeout` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_spawned, args=(fn, world, free_port(), tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} spawned ranks outlasted {timeout} s")
