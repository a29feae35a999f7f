"""Eval presets: `configs/evals/*.yaml` -> eval CLI settings (mirrors
`hyena_dna_tpu/evals/presets.py`), on the port's `utils/config.py`.

  * `hyena_dna_512ksl.yaml` (the 512k-seqlen checkpoint's shape) ->
    `hg38_inference --preset ...` builds the model from its `model:` block;
  * `soft_prompting_genomics.yaml` / `instruction_tuned_genomics.yaml` ->
    `icl_cli --preset ...` takes the mode, tuning hyperparameters and
    dataset settings as defaults (flags given on the command line win).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.utils.config import load_config


def load_eval_preset(path: str) -> Dict[str, Any]:
    """A preset file, or a bare name under `configs/evals/`."""
    p = Path(path)
    if not p.exists():
        repo = Path(__file__).resolve().parents[2]
        p = repo / "configs" / "evals" / (path.removesuffix(".yaml") + ".yaml")
    return load_config(str(p))


def build_model_from_preset(model_cfg: Dict[str, Any],
                            generator: Optional[torch.Generator] = None,
                            dtype: torch.dtype = torch.float32) -> ConvLMHeadModel:
    """`ConvLMHeadModel` from a preset's `model:` block (the LM family
    only), with the defaults of the JAX `build_model_from_preset`."""
    cfg = dict(model_cfg)
    name = cfg.pop("_name_", "lm")
    if name != "lm":
        raise ValueError(f"eval presets build the LM family, got {name!r}")
    layer = dict(cfg.pop("layer"))
    layer.setdefault("_name_", "hyena")
    return ConvLMHeadModel(
        d_model=cfg["d_model"],
        n_layer=cfg["n_layer"],
        d_inner=cfg.get("d_inner", 4 * cfg["d_model"]),
        vocab_size=cfg.get("vocab_size", 12),
        pad_vocab_size_multiple=cfg.get("pad_vocab_size_multiple", 8),
        residual_in_fp32=cfg.get("residual_in_fp32", True),
        embed_dropout=cfg.get("embed_dropout", 0.1),
        resid_dropout=cfg.get("resid_dropout", 0.0),
        checkpoint_mixer=cfg.get("checkpoint_mixer", False),
        checkpoint_mlp=cfg.get("checkpoint_mlp", False),
        layer=layer,
        generator=generator,
        dtype=dtype,
    )


def apply_icl_preset(args, preset: Dict[str, Any], explicit: set):
    """Fill argparse `args` from an ICL eval preset; flags the user passed
    (names in `explicit`) keep their command-line values."""
    ev = preset.get("eval", {})
    ds = preset.get("dataset", {})
    mapping = {
        "mode": ev.get("_name_"),
        "lr": ev.get("lr"),
        "steps": ev.get("steps"),
        "n_soft": ev.get("n_tunable_tokens"),
        "dataset_name": ds.get("dataset_name"),
        "shots": ds.get("shots"),
        "max_length": ds.get("max_length"),
        "batch_size": ds.get("batch_size"),
    }
    for name, value in mapping.items():
        if value is not None and name not in explicit:
            setattr(args, name, value)
    return args
