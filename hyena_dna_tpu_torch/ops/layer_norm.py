"""LayerNorm with f32 statistics (mirrors `hyena_dna_tpu/ops/layer_norm.py`).

Statistics and the affine map run in float32 with float32 parameters; the
output is `out_dtype`, the block dtype. Called with a residual, the module
is the residual-add + LN unit of the prenorm block and returns
`(y, res_out)` through `ops/add_ln.py::add_ln`, with
`res_out = (x + res)` summed in f32 and rounded once to the residual's
dtype: a bfloat16 residual with bfloat16 output runs kernels D and D' on the
card, anything else the plain unit, as the JAX dispatcher routes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.ops.add_ln import add_ln


class LayerNormF32(nn.Module):
    """Parameters `weight`/`bias` (the reference torch names)."""

    def __init__(self, d: int, eps: float = 1e-5, out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None):
        if res is None:
            return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                                self.bias.float(), self.eps).to(self.out_dtype)
        return add_ln(x, res, self.weight, self.bias, self.eps, self.out_dtype, res.dtype)
