"""Activation registry (mirrors `hyena_dna_tpu/models/nn.py::activation_fn`).

Only the identity, the Hyena operator's activation on the ported path, is
here; the rest of the JAX registry comes with ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in (None, "id", "identity", "linear", "none"):
        return lambda x: x
    raise NotImplementedError(
        f"activation {name!r} is not ported yet (ROADMAP.md Queue 1 item 12)")
