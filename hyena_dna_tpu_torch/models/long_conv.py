"""Directly parameterised long convolution, registered `long-conv` (mirrors
`hyena_dna_tpu/models/long_conv.py`).

`LongConvKernel`: an explicit kernel parameter `kernel` (channels, H, L,
or 2L when not causal) with a random (N(0, 0.002)) or double-exponential
init, optional moving-average smoothing (over time, or over frequency with
`smooth_freq`), the L1-style squash relu(|k| - lam) sign(k), and kernel
dropout. `LongConv`: the FFT conv of the squashed kernel with the input,
zero-padded to next_fast_fft_size(Lk + L), plus the per-channel skip `D`,
then the activation, dropout and a GLU output transform
(`output_linear`); with `bidirectional` the two kernels of each channel
are laid out as a two-sided filter; with `block_fft_conv` the transforms
are the learnable `BlockFFT` (`models/block_fft.py`). The conv is plain
`torch.fft`, as it was plain `jnp.fft` in the JAX module (no Pallas kernel
stood behind it); it runs in float32 and the result is cast to `dtype`.
Layout (B, L, H); `forward` returns (y, None), the sequence-layer protocol.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyena_dna_tpu_torch.models.block_fft import BlockFFT
from hyena_dna_tpu_torch.models.nn import activation_fn, dropout, linear
from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size


class LongConvKernel(nn.Module):
    def __init__(self, H: int, L: int, channels: int = 1, learning_rate: Optional[float] = None,
                 lam: float = 0.1, causal: bool = True, kernel_dropout: float = 0.0,
                 weight_init: str = "random", use_ma_smoothing: bool = False,
                 ma_window_len: int = 7, smooth_freq: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.H = H
        self.lam = lam
        self.kernel_dropout = kernel_dropout
        self.use_ma_smoothing = use_ma_smoothing
        self.ma_window_len = ma_window_len
        self.smooth_freq = smooth_freq
        self.learning_rate = learning_rate  # the reference's per-tensor lr; labels only
        length = L if causal else 2 * L
        k = torch.randn(channels, H, length, generator=generator)
        if weight_init == "random":
            k = k * 0.002
        elif weight_init == "double_exp":
            i = torch.arange(H, dtype=torch.float32)[:, None]
            j = torch.arange(length, dtype=torch.float32)[None, :]
            k = k * 0.02 * torch.exp(-(j / length) * float(H // 2) ** (i / H))[None]
        else:
            raise NotImplementedError(f"weight_init {weight_init!r}")
        self.kernel = nn.Parameter(k)

    @property
    def d_output(self) -> int:
        return self.H

    def forward(self, L: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """The squashed (and smoothed, dropped) kernel, and None."""
        k = self.kernel
        if self.use_ma_smoothing:
            w = self.ma_window_len
            pad = w // 2
            if self.smooth_freq:
                weight = torch.exp(-0.5 * (torch.arange(w, device=k.device) - pad).abs() ** 2)
                k_f = torch.fft.rfft(k, dim=-1)
                k_f_p = F.pad(k_f, (pad, pad))
                sm = sum(weight[j] * k_f_p[..., j:j + k_f.shape[-1]] for j in range(w))
                k = torch.fft.irfft(sm, dim=-1)
            else:
                if w % 2 == 0:
                    raise ValueError("window size must be odd")
                kp = F.pad(k, (pad, pad))
                k = sum(kp[..., j:j + k.shape[-1]] for j in range(w)) / w
        k = F.relu(k.abs() - self.lam) * torch.sign(k)
        return dropout(k, self.kernel_dropout, self.training, generator), None


class LongConv(nn.Module):
    def __init__(self, d_model: int, l_max: int = 1024, channels: int = 1,
                 bidirectional: bool = False, activation: str = "gelu",
                 postact: Optional[str] = "glu", dropout: float = 0.0,
                 transposed: bool = False, kernel_cfg: Optional[dict] = None,
                 block_fft_conv: bool = False, block_fft_conv_args: Optional[dict] = None,
                 learn_ifft: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.l_max = l_max
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.dtype = dtype
        self.block_fft_conv = block_fft_conv
        self.learn_ifft = learn_ifft
        self.D = nn.Parameter(torch.randn(channels, d_model, generator=generator))
        self.kernel = LongConvKernel(H=d_model, L=l_max,
                                     channels=channels * (2 if bidirectional else 1),
                                     generator=generator, **(kernel_cfg or {}))
        if block_fft_conv:
            # made at the FFT length of an l_max input, the length the
            # JAX module's parameters are made at by a full-length init
            args = dict(block_fft_conv_args or {})
            args["N"] = next_fast_fft_size(2 * l_max)
            self.block_fft_u = BlockFFT(generator=generator, **args)
            self.block_fft_k = BlockFFT(generator=generator, **args)
        self.act = activation_fn(activation)
        self.postact = postact
        if postact is not None:
            d_in = channels * d_model
            self.output_linear = nn.Linear(d_in, d_model * (2 if postact == "glu" else 1))
            with torch.no_grad():
                self.output_linear.weight.normal_(0.0, 1.0 / math.sqrt(d_in),
                                                  generator=generator)
                self.output_linear.bias.zero_()
            self.postact_fn = activation_fn(postact)

    @property
    def d_output(self) -> int:
        return self.d_model

    def forward(self, u: torch.Tensor, state=None,
                generator: Optional[torch.Generator] = None):
        """u (B, L, H) -> ((B, L, H), None)."""
        u = u.transpose(-1, -2)
        length = u.shape[-1]
        l_kernel = min(length, self.l_max)
        k, _ = self.kernel(l_kernel, generator)
        k = k[..., :l_kernel]
        if self.bidirectional:
            k0, k1 = k.chunk(2, dim=0)
            k = F.pad(k0, (0, length)) + F.pad(k1.flip(-1), (length, 0))
        n = next_fast_fft_size(l_kernel + length)
        if self.block_fft_conv:
            k_f = self.block_fft_k(k.to(torch.complex64), N=n)
            u_f = self.block_fft_u(u.to(torch.complex64), N=n)
            y_f = torch.einsum("bhf,chf->bchf", u_f, k_f)
            if self.learn_ifft:
                y = self.block_fft_u(y_f, N=n, forward=False).real[..., :length]
            else:
                y = torch.fft.ifft(y_f, n=n, dim=-1).real[..., :length]
        else:
            k_f = torch.fft.rfft(k.float(), n=n)
            u_f = torch.fft.rfft(u.float(), n=n)
            y = torch.fft.irfft(torch.einsum("bhf,chf->bchf", u_f, k_f), n=n)[..., :length]
        y = y + torch.einsum("bhl,ch->bchl", u.float(), self.D)
        y = y.reshape(y.shape[0], -1, length).transpose(-1, -2)
        y = self.act(y.to(self.dtype))
        y = dropout(y, self.dropout, self.training, generator)
        if self.postact is not None:
            y = self.postact_fn(linear(y, self.output_linear, self.dtype))
        return y, None
