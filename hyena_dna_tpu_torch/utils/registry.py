"""The `_name_` registries of models and sequence layers (mirrors
`hyena_dna_tpu/utils/registry.py`).

Entries resolve lazily, so importing this module imports no model.
Datamodules register themselves in `data/datamodules.py` (every one of the
JAX package's), tasks in `tasks/tasks.py`, encoders in
`tasks/encoders.py`, decoders in `train/trainer.py`, callbacks in
`train/callbacks.py`; the LM's mixers are built by `models/blocks.py`.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def _lazy(path: str, attr: str) -> Callable:
    def build(*args, **kwargs):
        return getattr(importlib.import_module(path), attr)(*args, **kwargs)

    return build


MODEL_REGISTRY: Dict[str, Callable] = {
    "lm": _lazy("hyena_dna_tpu_torch.models", "ConvLMHeadModel"),
    "lm_simple": _lazy("hyena_dna_tpu_torch.models", "ConvLMHeadModel"),
    "dna_embedding": _lazy("hyena_dna_tpu_torch.models", "DNAEmbeddingModel"),
    "model": _lazy("hyena_dna_tpu_torch.models.sequence_model", "SequenceModel"),
    "adaptive_lm": _lazy("hyena_dna_tpu_torch.models.adaptive_softmax", "AdaptiveLMModel"),
}

LAYER_REGISTRY: Dict[str, Callable] = {
    "id": _lazy("hyena_dna_tpu_torch.models.sequence_model", "SequenceIdentity"),
    "ff": _lazy("hyena_dna_tpu_torch.models.sequence_model", "FF"),
    "mha": _lazy("hyena_dna_tpu_torch.models.attention", "MHA"),
    "hyena": _lazy("hyena_dna_tpu_torch.models.hyena", "HyenaOperator"),
    "hyena-filter": _lazy("hyena_dna_tpu_torch.models.filters", "HyenaFilter"),
    "long-conv": _lazy("hyena_dna_tpu_torch.models.long_conv", "LongConv"),
}
