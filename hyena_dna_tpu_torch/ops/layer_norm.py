"""LayerNorm with f32 statistics (mirrors `hyena_dna_tpu/ops/layer_norm.py`).

Statistics, the affine map and the output are float32, the block dtype of
the ported path. Called with a residual, the module is the residual-add + LN
unit of the prenorm block and returns `(y, res_out)` with
`res_out = (x + res)` summed in f32 and rounded once to the residual's
dtype. The JAX package's Pallas add+LN is off by default and never taken
with an f32 residual, so the port has no kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LayerNormF32(nn.Module):
    """Parameters `weight`/`bias` (the reference torch names)."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None):
        if res is None:
            return self._norm(x)
        res_out = (x.float() + res.float()).to(res.dtype)
        return self._norm(res_out), res_out
