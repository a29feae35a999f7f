"""The card's numeric policy, set once by every entry point of the port.

The JAX package accumulates every float32 and bf16 product in float32 and
runs float32 products in full float32. PyTorch's defaults differ on the
card: cuDNN may run float32 convolutions in TF32, and cuBLAS may reduce
bf16 products in bf16 (`allow_bf16_reduced_precision_reduction`).
`set_card_numerics` turns all three off. `bench.py`,
`utils/profile_forward.py`, `evals/hg38_inference.py`, `chip_smoke.py` and
the CUDA tests call it; a library caller of `ConvLMHeadModel` calls it
before running the model on the card.
"""

from __future__ import annotations

import torch


def set_card_numerics() -> None:
    """No TF32 in cuBLAS or cuDNN, and float32 reductions in bf16 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
