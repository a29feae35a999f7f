"""Long FFT convolution: dispatch layer (mirrors `hyena_dna_tpu/ops/fftconv.py`).

y = irfft(rfft(u, n) * rfft(k, n), n)[..., :L] + u * D with the
power-of-two size n = next_fast_fft_size(2L). FFTs run in float32 whatever
the input dtype; the result is cast back to u's dtype. `fftconv_aliased`
is the JAX package's conv for a filter longer than the signal
(`num_blocks > 1`): circular at exactly 2L, so taps in [L, 2L) alias, in
plain `torch.fft` as the JAX package computes it with plain autodiff.

`fftconv` is the `torch.autograd.Function` `FFTConv`, with the
frequency-domain backward of the JAX `_fftconv_bwd`: du in dy's dtype, dk
(the batch reduced on the spectrum first) in k's, dD in float32. On a CUDA
tensor every conv, at every size from 16 to 2^21, goes to kernel B forward
and kernel C backward (`ops/fused_fftconv.py`); on the TPU sizes below 2^16
ran XLA's FFT, but on the card no library FFT sits on the path. Where the
JAX package saved u's spectrum for the backward (`saves_spectrum`), kernel B
saves it and kernel C reads it; elsewhere kernel C transforms u again. On a
CPU tensor the same calls run the kernels' plain versions.

`fftconv_gated` is the conv with the Hyena post-gate: the composite route
by default, or kernels E and E' (`ops/gated_fftconv.py`) when a gated mode
is asked for and `gated_plan` covers the shape. On the composite route the
ungated conv output is tagged `CONV_OUT_TAG` for activation checkpointing
(`ops/remat.py`), as in the JAX package; the gated output is not.

`fftconv_outer_4d` (JAX `fftconv_outer_4d`, the `HYENA_FRONT4` route) is
the `autograd.Function` over the 4-D conv entries of
`ops/fused_fftconv.py`: kernel B forward, kernel C's retransform route
backward, on (B, C, h1 * r, m) operands.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyena_dna_tpu_torch.ops import remat


def next_fast_fft_size(n: int) -> int:
    """Round up to a power of two, at least 16 (JAX `next_fast_fft_size`)."""
    return max(16, 1 << (n - 1).bit_length())


def fftconv_ref(u: torch.Tensor, k: torch.Tensor,
                D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain causal FFT conv on `torch.fft`: u (..., C, L), k (C, Lk <= L),
    D (C,) or None. Returns u's shape and dtype."""
    seqlen = u.shape[-1]
    n = next_fast_fft_size(2 * seqlen)
    k_f = torch.fft.rfft(k.float(), n=n)
    u_f = torch.fft.rfft(u.float(), n=n)
    y = torch.fft.irfft(u_f * k_f, n=n)[..., :seqlen]
    if D is not None:
        y = y + u.float() * D.float()[..., None]
    return y.to(u.dtype)


def fftconv_h3(k: torch.Tensor, ssm_kernel: torch.Tensor, D: torch.Tensor, q: torch.Tensor,
               v: torch.Tensor, head_dim: int = 1,
               ssm_kernel_rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The H3 gated FFT conv (JAX `ops/fftconv.py::fftconv_h3`, the
    reference's `src/ops/fftconv.py`): kv = k (x) v, the outer product of
    each head's channels, convolved causally with `ssm_kernel` (plus its
    reverse's conjugate spectrum, where given) plus the D skip, then
    contracted with q. k, q, v (B, H, L) with H = heads * head_dim;
    ssm_kernel (H, L); D (H,); a head_dim above 1 takes one head (H ==
    head_dim), as the JAX function does. Plain `torch.fft` in float32 (no
    kernel of its own, as in the JAX package); returns v's dtype."""
    seqlen = k.shape[-1]
    n = next_fast_fft_size(2 * seqlen)
    f32 = torch.float32
    kernel_f = torch.fft.rfft(ssm_kernel.to(f32), n=n)
    if ssm_kernel_rev is not None:
        kernel_f = kernel_f + torch.fft.rfft(ssm_kernel_rev.to(f32), n=n).conj()
    b, h = k.shape[0], ssm_kernel.shape[0]
    kv = torch.einsum("bfhl,bghl->bfghl", k.reshape(b, -1, head_dim, seqlen).to(f32),
                      v.reshape(b, -1, head_dim, seqlen).to(f32))
    kv_f = torch.fft.rfft(kv, n=n) / n
    kernel_f = kernel_f.reshape(h // head_dim, head_dim, 1, n // 2 + 1)
    y = (torch.fft.irfft(kv_f * kernel_f, n=n) * n)[..., :seqlen]
    out = y + kv * D.to(f32).reshape(h // head_dim, head_dim, 1, 1)
    out = torch.einsum("bfghl,bfhl->bghl", out, q.reshape(b, -1, head_dim, seqlen).to(f32))
    return out.reshape(b, -1, seqlen).to(v.dtype)


def fftconv_aliased(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The conv of a (C, Lk) filter that may be longer than the (..., C, L)
    signal, circular at exactly n = 2L (JAX `fftconv_aliased`): the filter
    is cut to 2L, its taps in [L, 2L) alias into the output. Plain
    `torch.fft`, differentiated by autograd; u's dtype."""
    seqlen = u.shape[-1]
    n = 2 * seqlen
    k_f = torch.fft.rfft(k.float()[..., :n], n=n)
    y = torch.fft.irfft(torch.fft.rfft(u.float(), n=n) * k_f, n=n)[..., :seqlen]
    return (y + u.float() * D.float()[..., None]).to(u.dtype)


def fftconv_bwd_ref(u: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                    D: torch.Tensor, dk_dtype: Optional[torch.dtype] = None):
    """Plain backward (JAX `ops/fftconv.py::_fftconv_bwd`) on `torch.fft`:
    u, dy (B, C, L); k (C, Lk); D (C,). Returns du in dy's dtype, dk in k's
    (or `dk_dtype`), dD float32; the batch is reduced on the spectrum before
    dk's inverse."""
    return fftconv_bwd_from_rfft(
        torch.fft.rfft(u.float(), n=next_fast_fft_size(2 * u.shape[-1])), dy, k, D,
        dD=(dy.float() * u.float()).sum((0, 2)), dk_dtype=dk_dtype)


def fftconv_bwd_from_rfft(u_f: torch.Tensor, dy: torch.Tensor, k: torch.Tensor,
                          D: torch.Tensor, dD: Optional[torch.Tensor] = None,
                          dk_dtype: Optional[torch.dtype] = None):
    """`fftconv_bwd_ref` given u's rfft (B, C, n//2+1) in place of u; without
    `dD`, dD is read off dk's lag 0 (Parseval), as the spectrum route does."""
    length = dy.shape[-1]
    n = next_fast_fft_size(2 * length)
    dy_f = torch.fft.rfft(dy.float(), n=n)
    k_f = torch.fft.rfft(k.float(), n=n)
    du = torch.fft.irfft(dy_f * k_f.conj(), n=n)[..., :length] + dy.float() * D.float()[:, None]
    dk_full = torch.fft.irfft((dy_f * u_f.conj()).sum(0), n=n)
    if dD is None:
        dD = dk_full[:, 0]  # lag 0: sum_{b,t} dy u
    return du.to(dy.dtype), dk_full[:, :k.shape[-1]].to(dk_dtype or k.dtype), dD.float()


class FFTConv(torch.autograd.Function):
    """Kernel B forward, kernel C backward. Saves u's spectrum (spectrum
    route) or u itself (retransform route), with k and D."""

    @staticmethod
    def forward(ctx, u, k, D, save_spectrum):
        from hyena_dna_tpu_torch.ops import fused_fftconv as FB

        ctx.spectrum = save_spectrum
        if save_spectrum:
            y, spec = FB.fftconv_fused(u, k, D, save_spectrum=True)
            ctx.save_for_backward(spec, k, D)
        else:
            y = FB.fftconv_fused(u, k, D)
            ctx.save_for_backward(u, k, D)
        return y

    @staticmethod
    def backward(ctx, dy):
        from hyena_dna_tpu_torch.ops import fused_fftconv as FB

        saved, k, D = ctx.saved_tensors
        bwd = FB.fftconv_bwd_spectrum if ctx.spectrum else FB.fftconv_bwd_retransform
        du, dk, dD = bwd(saved, dy.contiguous(), k, D)
        return du, dk, dD, None


def _retransform_bwd(dy, u, k, D):
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB

    return FB.fftconv_bwd_retransform(u, dy.contiguous(), k, D)


def fftconv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Causal conv with skip: (B, C, L) in, (B, C, L) out in u's dtype.
    Under a checkpointed cell that saves the conv output, the backward takes
    the retransform route (`ops/remat.py`)."""
    from hyena_dna_tpu_torch.ops.fused_fftconv import saves_spectrum

    training = torch.is_grad_enabled() and (u.requires_grad or k.requires_grad
                                            or D.requires_grad)
    spectrum = training and saves_spectrum(*u.shape) and not remat.saving(remat.CONV_OUT_TAG)
    return FFTConv.apply(u, k, D, spectrum)


def fftconv_chunked(u: torch.Tensor, k: torch.Tensor,
                    D: torch.Tensor) -> torch.Tensor:
    """JAX `fftconv_chunked` scans channel blocks to bound XLA's FFT
    workspace; kernel B bounds its own, so on the port it is one call."""
    return fftconv(u, k, D)


def fftconv_tagged(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """`fftconv_chunked(u, k, D)` tagged `CONV_OUT_TAG` for activation
    checkpointing (`ops/remat.py`): a cell that saves the tag replays it,
    with kernel C's retransform route as its backward."""
    return remat.tagged(remat.CONV_OUT_TAG, lambda: fftconv_chunked(u, k, D),
                        lambda y: remat.replay(y, _retransform_bwd, u, k, D))


# The gate-fused route (kernels E and E', `ops/gated_fftconv.py`), off unless
# a mode is asked for, as in the JAX package (`HYENA_GATED_CONV`). It covers
# the shapes of the JAX `_gated_plan`: these FFT sizes (the packed kernels'
# 2^16-2^17; the tests lower them), even B, C % 8 == 0.
GATED_FFT_SIZES = (1 << 16, 1 << 17)
GATED_MODES = ("specv", "spec", "retransform")


def gated_plan(u: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the gate-fused route covers this conv (JAX `_gated_plan`)."""
    if u.dim() != 3 or k.dim() != 2 or k.shape[0] != u.shape[1]:
        return False
    b, c, length = u.shape
    return next_fast_fft_size(2 * length) in GATED_FFT_SIZES and b % 2 == 0 and c % 8 == 0


def gated_mode(mode: str, u: torch.Tensor) -> str:
    """`mode`, or "retransform" when what specv / spec would save for the
    backward passes `SAVE_SPECTRUM_MAX_BYTES` (JAX `ops/fftconv.py:895-902`),
    counted in the port's layout: u's float32 pair spectrum, plus v for
    specv."""
    from hyena_dna_tpu_torch.ops.fused_fftconv import SAVE_SPECTRUM_MAX_BYTES

    if mode == "retransform":
        return mode
    b, c, length = u.shape
    saved = b * ((c + 1) // 2) * next_fast_fft_size(2 * length) * 8
    if mode == "specv":
        saved += u.numel() * u.element_size()
    return mode if saved <= SAVE_SPECTRUM_MAX_BYTES else "retransform"


class GatedFFTConv(torch.autograd.Function):
    """Kernel E forward, kernel E' backward on the route `mode` names. Saves
    u's spectrum and v (specv), u's spectrum (spec) or u (retransform), with
    x0, k and D; with `mode` None (no gradient needed) nothing more than its
    inputs."""

    @staticmethod
    def forward(ctx, u, x0, k, D, mode):
        from hyena_dna_tpu_torch.ops import gated_fftconv as GE

        ctx.mode = mode
        if mode == "specv":
            y, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
            ctx.save_for_backward(spec, v, x0, k, D)
        elif mode == "spec":
            y, spec = GE.fftconv_gated_fused(u, x0, k, D, save_spectrum=True)
            ctx.save_for_backward(spec, x0, k, D)
        else:
            y = GE.fftconv_gated_fused(u, x0, k, D)
            if mode == "retransform":
                ctx.save_for_backward(u, x0, k, D)
        return y

    @staticmethod
    def backward(ctx, dy):
        from hyena_dna_tpu_torch.ops import gated_fftconv as GE

        if ctx.mode is None:
            raise RuntimeError("GatedFFTConv ran without a backward mode")
        bwd = {"specv": GE.fftconv_gated_bwd_specv, "spec": GE.fftconv_gated_bwd_spec,
               "retransform": GE.fftconv_gated_bwd_retransform}[ctx.mode]
        du, dx0, dk, dD = bwd(*ctx.saved_tensors[:-3], dy.contiguous(), *ctx.saved_tensors[-3:])
        return du, dx0, dk, dD, None


def fftconv_gated(u: torch.Tensor, x0: torch.Tensor, k: torch.Tensor,
                  D: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """(causal_conv(u, k) + u * D) * x0 on (B, C, L), in u's dtype.

    With `mode` None, or where `gated_plan` does not cover the shape, the
    composite route of JAX `fftconv_gated`: kernel B, then the gate as
    elementwise work. With `mode` one of `GATED_MODES` and a covered shape,
    the gate-fused kernels E and E', whose backward takes the route `mode`
    names. The math is the same either way."""
    if mode is not None and mode not in GATED_MODES:
        raise ValueError(f"gated conv mode {mode!r} is not one of {GATED_MODES}")
    if mode is None or not gated_plan(u, k):
        return (fftconv_tagged(u, k, D) * x0).to(u.dtype)
    training = torch.is_grad_enabled() and any(t.requires_grad for t in (u, x0, k, D))
    return GatedFFTConv.apply(u, x0, k, D, gated_mode(mode, u) if training else None)


class FFTConvOuter4D(torch.autograd.Function):
    """Kernel B forward, kernel C's retransform route backward, on the 4-D
    layout of the outer plan (n1, r, m); saves (u4, k4, D)."""

    @staticmethod
    def forward(ctx, u4, k4, D, n1, r, m):
        from hyena_dna_tpu_torch.ops import fused_fftconv as FB

        ctx.plan = (n1, r, m)
        ctx.save_for_backward(u4, k4, D)
        return FB.fftconv_outer_fwd4(u4, k4, D, n1, r, m)

    @staticmethod
    def backward(ctx, dy4):
        return (*_outer4_bwd(dy4, *ctx.saved_tensors, plan=ctx.plan), None, None, None)


def _outer4_bwd(dy4, u4, k4, D, plan):
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB

    return FB.fftconv_outer_bwd4(u4, dy4.contiguous(), k4, D, *plan)


def fftconv_outer_4d(u4: torch.Tensor, k4: torch.Tensor, D: torch.Tensor,
                     n1: int, r: int, m: int) -> torch.Tensor:
    """causal_conv(u, k) + u * D on the (B, C, h1 * r, m) operands of the
    outer plan (n1, r, m) (k4 (C, h1 * r, m)), differentiable in u4, k4 and
    D; in u4's dtype. Tagged `CONV_OUT_TAG` (JAX `hyena.py:466`)."""
    return remat.tagged(
        remat.CONV_OUT_TAG, lambda: FFTConvOuter4D.apply(u4, k4, D, n1, r, m),
        lambda y: remat.replay(y, lambda dy, *saved: _outer4_bwd(dy, *saved, plan=(n1, r, m)),
                               u4, k4, D))
