"""The `_name_` registry of models (mirrors `hyena_dna_tpu/utils/registry.py`)
and the entry that stands for a module not ported yet.

Entries resolve lazily, so importing this module imports no model.
Datamodules register themselves in `data/datamodules.py` (every one of the
JAX package's), tasks in `tasks/tasks.py`, encoders in
`tasks/encoders.py`, decoders in `train/trainer.py`, callbacks in
`train/callbacks.py`; the Hyena mixer is built by `models/blocks.py`. The
two models still missing, `model` (`SequenceModel`) and `adaptive_lm`,
raise and cite ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def _lazy(path: str, attr: str) -> Callable:
    def build(*args, **kwargs):
        return getattr(importlib.import_module(path), attr)(*args, **kwargs)

    return build


def unported(what: str, item: str) -> Callable:
    """A registry entry that raises, citing the ROADMAP.md item that ports it."""
    def build(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 {item})")

    return build


MODEL_REGISTRY: Dict[str, Callable] = {
    "lm": _lazy("hyena_dna_tpu_torch.models", "ConvLMHeadModel"),
    "lm_simple": _lazy("hyena_dna_tpu_torch.models", "ConvLMHeadModel"),
    "dna_embedding": _lazy("hyena_dna_tpu_torch.models", "DNAEmbeddingModel"),
    "model": unported("model 'model'", "item 12 (models/sequence_model.py)"),
    "adaptive_lm": unported("model 'adaptive_lm'", "item 12 (models/adaptive_softmax.py)"),
}
