"""Data, sequence and tensor parallelism: the mesh of ranks and their launch."""

from hyena_dna_tpu_torch.parallel.launch import (barrier, initialize_distributed,
                                                 is_main_process, spawn)
from hyena_dna_tpu_torch.parallel.sharding import Mesh, make_mesh

__all__ = ["Mesh", "barrier", "initialize_distributed", "is_main_process", "make_mesh", "spawn"]
