"""Short depthwise causal convolution (mirrors `hyena_dna_tpu/ops/short_conv.py`).

The Hyena operator applies a k=3 depthwise Conv1d over the projected
channels, padded by k-1 on the left and cut to the input length: output[t]
depends on input[t-k+1..t]. Written as k shifted multiply-adds, as in the
JAX package. On the card this op runs inside kernel A (`ops/fused_front.py`);
this is its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def short_conv_1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along the last axis.

    x: (..., C, L); w: (C, K) taps, w[:, -1] multiplies x[t] (torch Conv1d
    layout with padding K-1); b: optional (C,).
    Returns (..., C, L): y[..., c, t] = sum_j w[c, j] x[..., c, t-(K-1)+j] + b[c].
    """
    k = w.shape[-1]
    length = x.shape[-1]
    acc = None
    for j in range(k):
        shift = (k - 1) - j
        shifted = F.pad(x, (shift, 0))[..., :length] if shift else x
        term = shifted * w[:, j, None]
        acc = term if acc is None else acc + term
    if b is not None:
        acc = acc + b[:, None]
    return acc
