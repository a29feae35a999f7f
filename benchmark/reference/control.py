"""The controls: the reference computed one precision below what the
configuration states, put in the program's place to show that the
comparison fails it.

* `tf32`: a float32 configuration (TF32 off). Each product operand keeps
  10 mantissa bits, rounded to nearest even, as the tensor cores' TF32
  mode reads it.
* `fp8`: a bfloat16 configuration. Each product operand and the long
  conv's I/O go through float8 e4m3 with one scale per tensor (amax to
  448), as an fp8 training recipe would run them; the backward takes the
  rounded operands' products and passes the rounding straight through.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32).view(x.shape) - x.detach())


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())  # the rounded value, the gradient passed straight through


CONTROLS = {"tf32": tf32_round, "fp8": fp8_round}
