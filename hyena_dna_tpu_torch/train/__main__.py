"""`python -m hyena_dna_tpu_torch.train experiment=hg38/hg38_hyena k=v ...`

The port's training entry (mirrors `hyena_dna_tpu/train/__main__.py`): the
shared `configs/config.yaml` is the base, `experiment=` composes an
experiment file onto it, the other arguments are dot-overrides, then
`${...}` interpolations resolve and keys starting with "__" are dropped.
The trainer runs on the card; `--device cpu` (or `main(argv,
device="cpu")`) runs it on the CPU with the kernels' plain versions. A mesh
config runs one process per rank under torchrun:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m hyena_dna_tpu_torch.train experiment=hg38/hg38_medium_450k ...
    python -m torch.distributed.run --nproc_per_node 4 \
        -m hyena_dna_tpu_torch.train experiment=hg38/hg38_large_1m_singlechip mesh.model=4 ...
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch.distributed as dist

from hyena_dna_tpu_torch.train.trainer import Trainer
from hyena_dna_tpu_torch.utils.config import (apply_overrides, deep_merge, load_config,
                                              resolve_interpolations)

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def process_config(cfg):
    """Drop interpolation-only keys (a leading "__")."""
    if isinstance(cfg, dict):
        return {k: process_config(v) for k, v in cfg.items()
                if not (isinstance(k, str) and k.startswith("__"))}
    if isinstance(cfg, list):
        return [process_config(v) for v in cfg]
    return cfg


def build_config(argv):
    overrides, experiment = [], None
    for arg in argv:
        if arg.startswith("experiment="):
            experiment = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = load_config(CONFIG_DIR / "config.yaml", CONFIG_DIR)
    if experiment:
        cfg = deep_merge(cfg, load_config(CONFIG_DIR / "experiment" / f"{experiment}.yaml",
                                          CONFIG_DIR))
    cfg = apply_overrides(cfg, overrides)
    return process_config(resolve_interpolations(cfg))


def main(argv=None, device=None):
    """Train on `argv`'s config; its `--device NAME` sets `device` (default
    the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    trainer = Trainer(build_config(argv), device=device)
    try:
        return trainer.fit()
    finally:
        trainer.close()


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
