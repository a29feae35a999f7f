"""Kernel names to the port's kernel groups.

Copied from `hyena_dna_tpu_torch/utils/profile_forward.py::GROUPS` (each
entry: a group and the substrings of the CUDA kernel names that belong to
it; the first match wins). A kernel in no group is glue: the torch
operations between the port's kernels (casts, LN, GeLU, the loss, the
optimizer's elementwise work, copies)."""

from __future__ import annotations

GROUPS = (("kernel_d_bwd", ("add_ln_bwd_kernel", "add_ln_sum_kernel")),
          ("kernel_d", ("add_ln_fwd_kernel",)),
          ("kernel_a_bwd", ("front_bwd::",)),
          ("kernel_a", ("front_fwd::",)),
          ("kernel_a4_bwd", ("front4_bwd::",)),
          ("kernel_a4", ("front4_fwd::",)),
          ("kernel_b", ("conv_fwd::",)),
          ("kernel_c", ("conv_bwd::",)),
          ("kernel_e", ("conv_gfwd::",)),
          ("kernel_e_bwd", ("conv_gbwd::",)),
          ("attention", ("flash", "fmha", "attention")),
          ("matmul", ("gemm", "sm90_", "cutlass", "ampere_", "cublas", "nvjet")))

GLUE = "other"


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return GLUE
