"""Short depthwise causal convolution (mirrors `hyena_dna_tpu/ops/short_conv.py`).

The Hyena operator applies a k=3 depthwise Conv1d over the projected
channels, padded by k-1 on the left and cut to the input length: output[t]
depends on input[t-k+1..t]. Written as k shifted multiply-adds, as in the
JAX package. On the card this op runs inside kernel A (`ops/fused_front.py`);
this is its plain version, the halo form below with a zero halo (the
causal pad). `short_conv_1d_with_halo` is the form of the
sequence-sharded route (`ops/distributed.py::seq_short_conv`), which runs
no fused front end, as in the JAX package: the K-1 columns before the
rank's first one come from its left neighbour in place of the zero pad.
"""

from __future__ import annotations

from typing import Optional

import torch


def short_conv_1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along the last axis.

    x: (..., C, L); w: (C, K) taps, w[:, -1] multiplies x[t] (torch Conv1d
    layout with padding K-1); b: optional (C,).
    Returns (..., C, L): y[..., c, t] = sum_j w[c, j] x[..., c, t-(K-1)+j] + b[c].
    """
    k = w.shape[-1]
    return short_conv_1d_with_halo(x, w, b, x.new_zeros(*x.shape[:-1], k - 1))


def short_conv_1d_with_halo(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                            halo: torch.Tensor) -> torch.Tensor:
    """`short_conv_1d` of the columns x (..., C, L_local) whose K-1
    predecessors are `halo` (..., C, K-1) (JAX `short_conv_1d_with_halo`)."""
    k = w.shape[-1]
    length = x.shape[-1]
    ext = torch.cat([halo, x], dim=-1)
    acc = None
    for j in range(k):  # tap j multiplies ext[..., t + j] for output t
        term = ext[..., j:j + length] * w[:, j, None]
        acc = term if acc is None else acc + term
    if b is not None:
        acc = acc + b[:, None]
    return acc
