"""Checkpoint and resume on `torch.save`, and the fine-tuning hook
(mirrors `hyena_dna_tpu/train/checkpoint.py`).

A checkpoint directory (the trainer writes `<run_dir>/checkpoints/last` and
`<run_dir>/checkpoints/best`, as the JAX layout names them) holds, per
saved step, `state_<step>.pt` ({"model": the model's state dict, reference
torch names; "optimizer": the optimizer's step count and moments; "step"})
and `host_state_<step>.json` ({"loader_state", "metadata", "step"}); the
newest `keep` steps are kept. Each file is written to a temporary name and
renamed into place, so a crash leaves the previous checkpoint whole.

Under a mesh every rank calls `save_checkpoint` and rank 0 writes. The
tensors are whole: under a model axis (tensor parallelism) the model's and
the optimizer's sharded tensors are gathered over the model group first
(`parallel/sharding.py::gather_state_dict`, `Optimizer.state_dict`), and
`restore_checkpoint` gives every rank its slices of them, so a checkpoint
written under one mesh resumes under any other.

Which files the port reads. Its own checkpoints, and the reference's
`.pt` / `.ckpt` state dicts (a file, or a directory holding
`weights.ckpt`), through `utils/convert.py::load_reference_state_dict`. It
does not read the JAX package's Orbax directories: reading them needs JAX
and Orbax, which the port does not import. Only the tests convert a JAX
checkpoint, with `utils/convert.py::flax_to_torch_state_dict`. The port
raises a clear error when it is pointed at an Orbax directory.

`load_backbone_hook` copies every `backbone.` tensor of a pretrained state
dict into the model's, keeping the scratch head, with the JAX hook's
canonicalisation: repeated leading `backbone.` prefixes collapse to one,
so the fine-tune model's `backbone.backbone.` (the embedding model inside
the decoder wrapper) matches an LM's `backbone.`. It raises when a shape
differs or when no tensor matched.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from hyena_dna_tpu_torch.parallel import launch
from hyena_dna_tpu_torch.parallel.sharding import gather_state_dict, shard_state_dict, tp_layout
from hyena_dna_tpu_torch.utils.convert import load_reference_state_dict

_STATE = re.compile(r"^state_(\d+)\.pt$")


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _steps(ckpt_dir: Path):
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir() if (m := _STATE.match(p.name)))


def _is_orbax(path: Path) -> bool:
    """An Orbax CheckpointManager directory: numbered step directories, or
    the metadata file Orbax writes in each."""
    return path.is_dir() and any(
        (p.is_dir() and p.name.isdigit()) or p.name == "_CHECKPOINT_METADATA"
        for p in path.iterdir())


def _refuse_orbax(path: Path) -> None:
    if _is_orbax(path):
        raise ValueError(
            f"{path} is an Orbax checkpoint of the JAX package; the port reads its own "
            "checkpoints and reference .pt/.ckpt state dicts. Convert the JAX parameters "
            "with hyena_dna_tpu_torch.utils.convert.flax_to_torch_state_dict and torch.save "
            "the result.")


def save_checkpoint(ckpt_dir, state, step: int, loader_state: Optional[dict] = None,
                    metadata: Optional[dict] = None, keep: int = 2) -> None:
    """Write the model, the optimizer and the step, plus the loader state and
    metadata, as step `step`; drop all but the newest `keep` steps. Every
    rank of a mesh calls it (the tensors are gathered whole); rank 0 writes."""
    model = gather_state_dict(state.model.state_dict(), state.optimizer.mesh,
                              tp_layout(state.model))
    payload = {"model": model, "optimizer": state.optimizer.state_dict(), "step": int(step)}
    if not launch.is_main_process():
        return
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _atomic_write(ckpt_dir / f"state_{step}.pt", lambda p: torch.save(payload, p))
    host = {"loader_state": loader_state or {}, "metadata": metadata or {}, "step": int(step)}
    _atomic_write(ckpt_dir / f"host_state_{step}.json",
                  lambda p: p.write_text(json.dumps(host)))
    for old in _steps(ckpt_dir)[:-keep]:
        (ckpt_dir / f"state_{old}.pt").unlink()
        (ckpt_dir / f"host_state_{old}.json").unlink(missing_ok=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir).resolve()
    if not ckpt_dir.is_dir():
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, state, step: Optional[int] = None):
    """Load step `step` (default the newest) into `state`'s model and
    optimizer, in place (under a model axis, each rank's slices). Returns
    (state, loader_state, metadata)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    if ckpt_dir.is_dir():
        _refuse_orbax(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    device = next(state.model.parameters()).device
    payload = torch.load(ckpt_dir / f"state_{step}.pt", map_location=device,
                         weights_only=True)
    state.model.load_state_dict(shard_state_dict(payload["model"], state.optimizer.mesh,
                                                 tp_layout(state.model)))
    state.optimizer.load_state_dict(payload["optimizer"])
    loader_state, metadata = {}, {}
    host_file = ckpt_dir / f"host_state_{step}.json"
    if host_file.exists():
        host = json.loads(host_file.read_text())
        loader_state, metadata = host.get("loader_state", {}), host.get("metadata", {})
    return state, loader_state, metadata


def restore_params_only(ckpt_dir, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint directory: the directory itself,
    or its `best` or `last` (a run's `checkpoints/`)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    for cand in (ckpt_dir, ckpt_dir / "best", ckpt_dir / "last"):
        if not cand.is_dir():
            continue
        _refuse_orbax(cand)
        s = step if step is not None else latest_step(cand)
        if s is not None:
            return torch.load(cand / f"state_{s}.pt", map_location="cpu",
                              weights_only=True)["model"]
    raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")


def load_pretrained(path) -> Dict[str, torch.Tensor]:
    """A pretrained state dict from a reference `.pt` / `.ckpt` file, a
    directory holding `weights.ckpt`, or a checkpoint of the port."""
    path = Path(path)
    if path.suffix in (".ckpt", ".pt"):
        return load_reference_state_dict(str(path))
    if (path / "weights.ckpt").exists():
        return load_reference_state_dict(str(path / "weights.ckpt"))
    return restore_params_only(path)


def _canonical(name: str) -> str:
    """Collapse repeated leading `backbone.` prefixes to one."""
    while name.startswith("backbone.backbone."):
        name = name[len("backbone."):]
    return name


def load_backbone_hook(model: torch.nn.Module, pretrained: Dict[str, torch.Tensor],
                       freeze_backbone: bool = False, shard=None):
    """Copy every `backbone.` tensor of `pretrained` into `model` (in place),
    keeping the scratch head; `shard(name, tensor)`, where given, takes the
    rank's slice of a whole tensor for the model's entry `name` (tensor
    parallelism). Returns (model, info): info["loaded"] counts
    the parameters loaded, info["scratch"] names the state entries left as
    they were, info["frozen"] is {parameter name: "frozen" | None} under
    `freeze_backbone` (every backbone parameter frozen), else None."""
    pre = {_canonical(k): v for k, v in pretrained.items()}
    params = dict(model.named_parameters())
    own = model.state_dict()
    loaded, skipped, new = 0, [], {}
    for name, dst in own.items():
        src = pre.get(_canonical(name)) if name.startswith("backbone.") else None
        if src is None:
            skipped.append(name)
            continue
        if shard is not None:
            src = shard(name, src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(src.shape)} vs "
                             f"{tuple(dst.shape)}")
        new[name] = src
        loaded += name in params
    if not loaded:
        raise ValueError("load_backbone matched no tensors: checkpoint and model differ")
    model.load_state_dict(new, strict=False)
    frozen = ({name: ("frozen" if name.startswith("backbone.") else None) for name in params}
              if freeze_backbone else None)
    return model, {"loaded": loaded, "scratch": skipped, "frozen": frozen}
