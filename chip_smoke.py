#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no final
line:

1. build    every hand-written kernel from `hyena_dna_tpu_torch/csrc` (one
            nvcc per source, eight sources, started together): kernels A and
            A' (the front end forward and backward), B and C (the FFT conv
            forward and backward), D and D' (the fused residual-add + LN
            forward and backward), E and E' (the gate-fused FFT conv forward
            and backward);
2. kernels  each kernel against its plain PyTorch version on the card, in the
            working dtype, at the shapes of the TPU routes it replaces, with
            the tolerances below; kernel, plain and library-call times.
            Kernels A and A' in float32 and in bfloat16, D and D' at the bf16
            model's 4 x 32768 x 256 rows; E at 4 x 32768 x 256 bf16 (fft
            2^16) with each of its outputs' sets (y; y, v and u's spectrum
            for specv; y and the spectrum for spec) and at 2 x 65536 (fft
            2^17); E' at 4 x 32768 on each route, and specv at 2 x 65536;
3. parity   the full-width model (d=256 x 8 layers, random weights from a
            seeded torch.Generator) on the CPU through the plain versions and
            on the card through the kernels: logits at (B=2, L=8192)
            (float32 conv I/O) and (B=1, L=32768) (bfloat16 conv I/O), then
            the loss and every parameter's gradient at the same two shapes;
            then the same four checks of the bf16 model (bfloat16
            activations and residual stream, as every hg38 config trains);
            then, with the gate-fused conv (kernels E and E'), the logits,
            loss and every gradient of the bf16 model on the specv route at
            (B=2, L=24576) (float32 conv I/O) and (B=2, L=32768) (bfloat16
            conv I/O), and of the float32 model at (B=2, L=24576) on the
            spec and the retransform routes;
4. serving  the port's `hg38_inference.main` on a synthetic FASTA and a
            reference-named `.pt`: 2 batches of 4 x 32768 tokens, then one
            1,000,448-token window. Kernel A must run n_layer times per
            batch, kernel B at least as often;
5. training the port's `bench.main` (forward, backward, clip, AdamW) at
            4 x 32768 and at 1 x 131072 in float32, then at 4 x 32768 in
            bf16 (`--precision bf16`): the loss must be finite and lower
            after the steps than at step 0; kernels A and A' must run
            n_layer times per step, kernels B and C at least as often, and
            in bf16 kernels D and D' 2 n_layer times per step (2 n_layer - 1
            block units plus ln_f; never in float32). Then the bf16 step at
            4 x 32768 with `--gated_conv` specv, spec and retransform: kernels
            E and E' n_layer times per step, B and C never, D and D' as
            before; each step's ms is printed beside the composite bf16
            step's of the same run.
Launch counts are zeroed just before each request of phases 4 and 5 and
read just after it.

It then prints the card's name and power limit, one JSON line
{"kernels": [...]} with each kernel's launches in phases 4 and 5, its error,
times and bound at the main paths' 4 x 32768 shape (kernels A and A' in
float32, with their bf16 numbers under "bf16"; kernels E and E' on the
specv route, the gated step's, with every route's numbers under "routes"),
and last
{"ok": true, "device": {...}}. Times come from CUDA events around repeated
launches after a warm-up. `bound_ms` is the larger of the bytes the function
must move (inputs read once, outputs written once) at 3.35 TB/s and its
operations at 67 TFLOP/s for float32 inputs or at the bf16 tensor cores'
989 TFLOP/s for bf16 inputs (H100 SXM data sheet), the least time the card
could take.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense tensor-core rate: the least time for bf16-input products
FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}
D_MODEL, N_LAYER = 256, 8
LN_EPS = 1e-5

# Kernel vs plain: |kernel - plain| <= ATOL_FRAC * max|plain| + RTOL * |plain|.
# float32: both sum in float32 in other orders (a 256-term dot product for
# kernel A, a 2^21-point transform for kernel B). bfloat16 I/O: both round
# a float32 result once, so an element may land one bf16 step (2^-8) apart.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 2 ** -7)}
# Card vs CPU logits of the whole model, 8 layers deep: float32, and bf16
# conv I/O (roundings that flip between the two sides compound per layer).
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# Card vs CPU gradients of the whole model, each parameter's |error| against
# its own max |g|: float32 sums over up to 2^15 rows per parameter in other
# orders; bf16 conv I/O adds per-layer roundings that may flip by one bf16
# step (2^-8) on either side, over 8 layers forward and back. Loss: relative.
GRAD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# The bf16 model (bfloat16 activations and residual), card vs CPU: logits at
# the JAX package's own bf16 model tolerance (tests/test_pallas_ln.py, 5e-2),
# taken against max(1, max|logit|). Gradients: every activation and
# cotangent rounds to bf16 on both sides (cuBLAS and the CPU sum bf16
# products in other orders), so an element may land a bf16 step (2^-8)
# apart at each of ~10 roundings per layer, over 8 layers forward and back:
# each parameter within 5e-2 of its max |g|. Loss: float32 from bf16
# logits, which may differ by a step.
MODEL_BF16 = {"logits": 5e-2, "grads": 5e-2, "loss": 5e-3}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, budget_ms: float = 400.0) -> float:
    """Mean time of one call, from CUDA events around repeated calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(out, ref, dtype: str):
    """(max abs err, max rel err); raise if outside TOL[dtype]."""
    atol_frac, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    scale = ref.abs().max().item()
    ok = bool((err <= atol_frac * scale + rtol * ref.abs()).all())
    max_abs = err.max().item()
    max_rel = max_abs / max(scale, 1e-30)
    if not ok or not math.isfinite(max_abs):
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{max_abs:.3e} (max |plain| {scale:.3e}, tol {TOL[dtype]})")
    return max_abs, max_rel


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def front_inputs(B, L, dtype, seed):
    """u in `dtype`, float32 parameters at the model's init scales."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = D_MODEL
    u = torch.randn(B, L, d, device="cuda", generator=g).to(getattr(torch, dtype))
    w = torch.randn(d, 3 * d, device="cuda", generator=g) * 0.02
    bp = torch.randn(3 * d, device="cuda", generator=g) * 0.02
    wc = (torch.rand(3, 3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    bc = (torch.rand(3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    return g, (u, w, bp, wc, bc)


def check_front(FF, B, L, seed, dtype="float32"):
    """Kernel A against `reference_fwd` (float32 arithmetic on u's values;
    bf16 u: vx and x0 rounded once, see ops/fused_front.py)."""
    import torch
    import torch.nn.functional as F

    d = D_MODEL
    _, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed)
    vx, x0 = FF.fused_proj_conv_gate(u, w, bp, wc, bc)
    torch.cuda.synchronize()
    vx_ref, x0_ref = FF.reference_fwd(u, w, bp, wc, bc)
    err = [compare(vx, vx_ref, dtype), compare(x0, x0_ref, dtype)]
    conv_w = wc.t().contiguous()[:, None, :].to(u.dtype)
    lw, lbp, lbc = w.to(u.dtype), bp.to(u.dtype), bc.to(u.dtype)

    def library():  # torch.matmul + cuDNN depthwise conv1d + gate, in u's dtype
        proj = torch.matmul(u, lw) + lbp
        conv = F.conv1d(proj.transpose(1, 2), conv_w, lbc, padding=2, groups=3 * d)[..., :L]
        return conv[:, 2 * d:] * conv[:, d:2 * d], conv[:, :d]

    size = u.element_size()
    nbytes = size * (B * L * d + 2 * B * d * L) + 4 * (d * 3 * d + 3 * 3 * d + 2 * 3 * d)
    flops = B * L * (2 * d * 3 * d + 3 * d * 7 + d)
    bound_ms, bound_by = bound(nbytes, flops, FLOPS[dtype])
    return {"name": "fused_front", "shape": f"B={B} L={L} d={d} {dtype}",
            "max_abs_err": max(e[0] for e in err), "max_rel_err": max(e[1] for e in err),
            "ms": time_ms(lambda: FF.fused_proj_conv_gate(u, w, bp, wc, bc)),
            "plain_ms": time_ms(lambda: FF.reference_fwd(u, w, bp, wc, bc)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_conv(FB, B, L, dtype, route, seed):
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, dt = D_MODEL, getattr(torch, dtype)
    n = next_fast_fft_size(2 * L)
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    D = torch.randn(C, device="cuda", generator=g)
    y = FB.fftconv_fused(u, k, D)
    torch.cuda.synchronize()
    max_abs, max_rel = compare(y, fftconv_ref(u, k, D), dtype)
    uf, kf = u.float(), k.float()

    def library():  # cuFFT through torch.fft
        return torch.fft.irfft(torch.fft.rfft(uf, n=n) * torch.fft.rfft(kf, n=n), n=n)

    size = u.element_size()
    nbytes = size * (2 * B * C * L + C * L) + 4 * C
    log_n = int(math.log2(n))
    flops = B * C * (5 * n * log_n + 3 * n + 2 * L) + C * 2.5 * n * log_n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": time_ms(lambda: FB.fftconv_fused(u, k, D)),
            "plain_ms": time_ms(lambda: fftconv_ref(u, k, D)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_front_bwd(FF, B, L, seed, dtype="float32"):
    """Kernel A' against `reference_bwd` (du in u's dtype, the parameter
    gradients float32)."""
    import torch
    import torch.nn.functional as F

    d = D_MODEL
    g, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed)
    dvx = torch.randn(B, d, L, device="cuda", generator=g).to(u.dtype)
    dx0 = torch.randn(B, d, L, device="cuda", generator=g).to(u.dtype)
    args = (u, w, bp, wc, bc, dvx, dx0)
    out = FF.front_bwd(*args)
    torch.cuda.synchronize()
    ref = FF.reference_bwd(*args)
    errs = {name: compare(o, r, dtype if name == "du" else "float32")
            for name, o, r in zip(("du", "dw", "dbp", "dwc", "dbc"), out, ref)}
    leaves = [t.detach().clone().to(u.dtype).requires_grad_() for t in (u, w, bp)]
    conv_w = wc.t().contiguous()[:, None, :].to(u.dtype).requires_grad_()
    conv_b = bc.detach().clone().to(u.dtype).requires_grad_()

    def library():  # autograd through torch.matmul + cuDNN depthwise conv1d + gate
        lu, lw, lbp = leaves
        with torch.enable_grad():
            proj = torch.matmul(lu, lw) + lbp
            conv = F.conv1d(proj.transpose(1, 2), conv_w, conv_b, padding=2,
                            groups=3 * d)[..., :L]
            outs = (conv[:, 2 * d:] * conv[:, d:2 * d], conv[:, :d])
            return torch.autograd.grad(outs, leaves + [conv_w, conv_b], (dvx, dx0))

    size = u.element_size()
    nbytes = size * (2 * B * L * d + 2 * B * d * L) + 4 * (2 * d * 3 * d + 11 * 3 * d)
    flops = 3 * 2 * B * L * d * 3 * d + B * L * 3 * d * 16
    bound_ms, bound_by = bound(nbytes, flops, FLOPS[dtype])
    return {"name": "fused_front_bwd", "shape": f"B={B} L={L} d={d} {dtype}",
            "route": "pallas_hyena.py:395", "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: FF.front_bwd(*args)),
            "plain_ms": time_ms(lambda: FF.reference_bwd(*args)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_add_ln(AL, B, L, seed):
    """Kernels D and D' against `add_ln_ref` and `add_ln_bwd_ref` on the bf16
    model's B*L rows of d: res_out must be the same bits (one rounding on
    both sides), y and d_total within one bf16 step, dscale and dbias float32
    sums over the rows in another order. Returns the two kernels' rows."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d, bf = B * L, D_MODEL, torch.bfloat16
    h = torch.randn(n, d, device="cuda", generator=g).to(bf)
    r = (torch.randn(n, d, device="cuda", generator=g) * 3).to(bf)
    w = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    b = 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(n, d, device="cuda", generator=g).to(bf)
    dup = torch.randn(n, d, device="cuda", generator=g).to(bf)
    y, ro = AL.add_ln_fwd(h, r, w, b, LN_EPS)
    torch.cuda.synchronize()
    y_ref, ro_ref = AL.add_ln_ref(h, r, w, b, LN_EPS)
    if not torch.equal(ro, ro_ref):
        raise AssertionError("kernel D's res_out differs from the plain rounding")
    fwd_err = [compare(y, y_ref, "bfloat16"), compare(ro, ro_ref, "bfloat16")]
    out = AL.add_ln_bwd(ro, dy, dup, w, LN_EPS)
    torch.cuda.synchronize()
    ref = AL.add_ln_bwd_ref(ro, dy, dup, w, LN_EPS)
    bwd_err = {name: compare(o, rf, "bfloat16" if name == "d_total" else "float32")
               for name, o, rf in zip(("d_total", "dscale", "dbias"), out, ref)}
    lw, lb = w.to(bf), b.to(bf)

    def library_fwd(hh=h, rr=r, ww=lw, bb=lb):  # the add, one rounding, then F.layer_norm
        ro_l = (hh.float() + rr.float()).to(bf)
        return F.layer_norm(ro_l, (d,), ww, bb, LN_EPS), ro_l

    leaves = [t.detach().clone().requires_grad_() for t in (h, r, lw, lb)]

    def library_bwd():  # torch.autograd.grad through library_fwd
        with torch.enable_grad():
            return torch.autograd.grad(library_fwd(*leaves), leaves, (dy, dup))

    shape = f"B={B} L={L} d={d} bfloat16 (N={n} rows)"
    # each direction reads two and writes two bf16 (N, d) tensors: 8 bytes per element
    fwd_bytes, bwd_bytes = 8 * n * d + 8 * d, 8 * n * d + 12 * d
    fb, fby = bound(fwd_bytes, 12 * n * d)
    bb_, bby = bound(bwd_bytes, 16 * n * d)
    return [
        {"name": "add_ln", "shape": shape, "route": "pallas_ln.py:102",
         "max_abs_err": max(e[0] for e in fwd_err), "max_rel_err": max(e[1] for e in fwd_err),
         "ms": time_ms(lambda: AL.add_ln_fwd(h, r, w, b, LN_EPS)),
         "plain_ms": time_ms(lambda: AL.add_ln_ref(h, r, w, b, LN_EPS)),
         "library_ms": time_ms(library_fwd), "bound_ms": fb, "bound_by": fby},
        {"name": "add_ln_bwd", "shape": shape, "route": "pallas_ln.py:130",
         "errors": {k: v[0] for k, v in bwd_err.items()},
         "max_abs_err": max(e[0] for e in bwd_err.values()),
         "max_rel_err": max(e[1] for e in bwd_err.values()),
         "ms": time_ms(lambda: AL.add_ln_bwd(ro, dy, dup, w, LN_EPS)),
         "plain_ms": time_ms(lambda: AL.add_ln_bwd_ref(ro, dy, dup, w, LN_EPS)),
         "library_ms": time_ms(library_bwd), "bound_ms": bb_, "bound_by": bby}]


def check_conv_bwd(FB, entry, B, L, dtype, route, seed):
    """Kernel C through one TPU row's entry point against `fftconv_bwd_ref`
    (du and dk in the I/O dtype, dD float32). A spectrum-route entry gets
    u's spectrum from kernel B's `save_spectrum`."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, dt = D_MODEL, getattr(torch, dtype)
    n = next_fast_fft_size(2 * L)
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    dy = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    D = torch.randn(C, device="cuda", generator=g)
    spectrum = getattr(entry, "spectrum", False)  # the TPU row read u's saved spectrum
    x = FB.fftconv_fused(u, k, D, save_spectrum=True)[1] if spectrum else u
    out = entry(x, dy, k, D)
    torch.cuda.synchronize()
    ref = FB.fftconv_bwd_ref(u, dy, k, D)
    errs = {name: compare(o, r, "float32" if name == "dD" else dtype)
            for name, o, r in zip(("du", "dk", "dD"), out, ref)}
    plain_bwd = FB.fftconv_bwd_spectrum_ref if spectrum else FB.fftconv_bwd_ref
    uf, dyf, kf = u.float(), dy.float(), k.float()

    def library():  # cuFFT through torch.fft
        dy_f = torch.fft.rfft(dyf, n=n)
        du = torch.fft.irfft(dy_f * torch.fft.rfft(kf, n=n).conj(), n=n)[..., :L] + dyf * D[:, None]
        dk = torch.fft.irfft((dy_f * torch.fft.rfft(uf, n=n).conj()).sum(0), n=n)[..., :L]
        return du, dk, (dyf * uf).sum((0, 2))

    size = u.element_size()
    x_bytes = x.numel() * x.element_size()
    nbytes = x_bytes + size * (2 * B * C * L + 2 * C * L) + 8 * C
    log_n = int(math.log2(n))
    transforms = (2 if spectrum else 3) * B * C + 2 * C
    flops = transforms * 2.5 * n * log_n + B * C * 4 * n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_bwd", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "entry": entry.__name__,
            "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: entry(x, dy, k, D)),
            "plain_ms": time_ms(lambda: plain_bwd(x, dy, k, D)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def gated_inputs(B, L, dtype, seed):
    """u, x0, dy in `dtype`, a decaying filter k, float32 D (C = d_model)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, dt = D_MODEL, getattr(torch, dtype)
    u, x0, dy = (torch.randn(B, C, L, device="cuda", generator=g).to(dt) for _ in range(3))
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    return u, x0, dy, k, torch.randn(C, device="cuda", generator=g)


def check_gated(GE, B, L, dtype, variant, seed):
    """Kernel E against `fftconv_gated_ref` with one set of outputs: y alone
    ("y"), y, v and u's spectrum ("specv"), or y and the spectrum ("spec")."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    u, x0, _, k, D = gated_inputs(B, L, dtype, seed)
    C, n = D_MODEL, next_fast_fft_size(2 * L)
    save = {"save_v": variant == "specv", "save_spectrum": variant != "y"}
    out = GE.fftconv_gated_fused(u, x0, k, D, **save)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = GE.fftconv_gated_ref(u, x0, k, D, **save)
    ref = ref if isinstance(ref, tuple) else (ref,)
    names = ["y"] + ["v"] * save["save_v"] + ["spectrum"] * save["save_spectrum"]
    errs = {nm: compare(o, r, "float32" if nm == "spectrum" else dtype)
            for nm, o, r in zip(names, out, ref)}
    uf, x0f, kf = u.float(), x0.float(), k.float()

    def library():  # cuFFT through torch.fft, the gate and skip term as elementwise work
        v = torch.fft.irfft(torch.fft.rfft(uf, n=n) * torch.fft.rfft(kf, n=n), n=n)[..., :L]
        v = v + uf * D[:, None]
        return ((v * x0f).to(u.dtype), v.to(u.dtype)) if save["save_v"] else (v * x0f).to(u.dtype)

    size, pairs = u.element_size(), (C + 1) // 2
    nbytes = (size * ((3 + save["save_v"]) * B * C * L + C * L) + 4 * C
              + save["save_spectrum"] * 8 * B * pairs * n)
    log_n = int(math.log2(n))
    flops = B * C * (5 * n * log_n + 3 * n + 3 * L) + C * 2.5 * n * log_n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_gated", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": variant, "errors": {k_: v[0] for k_, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: GE.fftconv_gated_fused(u, x0, k, D, **save)),
            "plain_ms": time_ms(lambda: GE.fftconv_gated_ref(u, x0, k, D, **save)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_gated_bwd(GE, route, B, L, dtype, seed):
    """Kernel E' on one route, through the torch entry point of that route's
    TPU kernel, against the route's plain version (du, dx0, dk in the I/O
    dtype, dD float32). The saved spectrum and v come from kernel E."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    u, x0, dy, k, D = gated_inputs(B, L, dtype, seed)
    C, n = D_MODEL, next_fast_fft_size(2 * L)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    saved = {"specv": (spec, v), "spec": (spec,), "retransform": (u,)}[route]
    entry = {"specv": GE.fftconv_fused_bwd_specv_packed_gated,
             "spec": GE.fftconv_fused_bwd_spec_packed_gated,
             "retransform": GE.fftconv_fused_bwd_packed_gated}[route]
    plain = getattr(GE, f"fftconv_gated_bwd_{route}_ref")
    args = saved + (dy, x0, k, D)
    out = entry(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    errs = {nm: compare(o, r, "float32" if nm == "dD" else dtype)
            for nm, o, r in zip(("du", "dx0", "dk", "dD"), out, ref)}
    uf, x0f, dyf, kf = u.float(), x0.float(), dy.float(), k.float()

    def library():  # cuFFT through torch.fft computing du, dx0, dk, dD from u, x0, dy, k, D
        u_f, k_f = torch.fft.rfft(uf, n=n), torch.fft.rfft(kf, n=n)
        vv = torch.fft.irfft(u_f * k_f, n=n)[..., :L] + uf * D[:, None]
        dv = dyf * x0f
        dv_f = torch.fft.rfft(dv, n=n)
        du = torch.fft.irfft(dv_f * k_f.conj(), n=n)[..., :L] + dv * D[:, None]
        dk = torch.fft.irfft((dv_f * u_f.conj()).sum(0), n=n)[..., :L]
        return du.to(u.dtype), (dyf * vv).to(u.dtype), dk.to(u.dtype), (dv * uf).sum((0, 2))

    size = u.element_size()
    saved_bytes = sum(t.numel() * t.element_size() for t in saved)
    nbytes = saved_bytes + size * (4 * B * C * L + 2 * C * L) + 8 * C
    log_n = int(math.log2(n))
    transforms = {"specv": 2, "spec": 3, "retransform": 4}[route] * B * C + 2 * C
    flops = transforms * 2.5 * n * log_n + B * C * 6 * n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_gated_bwd", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "entry": entry.__name__,
            "errors": {k_: v_[0] for k_, v_ in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: entry(*args)), "plain_ms": time_ms(lambda: plain(*args)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def model_kwargs(precision: str) -> dict:
    """`build_model` arguments of the float32 model (float32 residual) or the
    bf16 model (bfloat16 activations and residual stream)."""
    import torch

    if precision == "bf16":
        return {"dtype": torch.bfloat16, "residual_in_fp32": False}
    return {}


def expected_launches(precision: str, per_pass: int, gated: str | None = None) -> dict:
    """Launches of each kernel in `per_pass` forward+backward passes: A, A'
    once per layer; B, C once per layer, or with the gate-fused conv E, E'
    once per layer and B, C never; D, D' 2 n_layer times in the bf16 model
    (2 n_layer - 1 block units plus ln_f) and never with a float32
    residual."""
    fused = 2 * N_LAYER * per_pass if precision == "bf16" else 0
    conv, gconv = (0, N_LAYER * per_pass) if gated else (N_LAYER * per_pass, 0)
    return {"fused_front": N_LAYER * per_pass, "fused_front_bwd": N_LAYER * per_pass,
            "fftconv": conv, "fftconv_bwd": conv, "add_ln": fused, "add_ln_bwd": fused,
            "fftconv_gated": gconv, "fftconv_gated_bwd": gconv}


def grad_parity(build_model, cross_entropy, kernels, B, L, dtype, seed, precision="fp32",
                gated=None):
    """Logits, loss and every parameter gradient of the full-width model,
    card (kernels A, A', B, C or with `gated` E, E'; D, D' in bf16) against
    CPU (their plain versions)."""
    import torch

    t0 = time.perf_counter()
    model = build_model(D_MODEL, N_LAYER, 32768, generator=torch.Generator().manual_seed(seed),
                        gated_conv=gated, **model_kwargs(precision)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L + 1)).astype(np.int64))
    x, y = tokens[:, :-1], tokens[:, 1:]
    logits_cpu = model(x)
    loss_cpu = cross_entropy(logits_cpu, y)
    loss_cpu.backward()
    card_model = copy.deepcopy(model).to("cuda")
    card_model.zero_grad(set_to_none=True)
    before = {k.name: k.launches for k in kernels}
    logits_card = card_model(x.to("cuda"))
    loss_card = cross_entropy(logits_card, y.to("cuda"))
    loss_card.backward()
    torch.cuda.synchronize()
    logit_err = (logits_card.detach().float().cpu() - logits_cpu.detach().float()).abs().max().item()
    logit_scale = max(1.0, logits_cpu.detach().float().abs().max().item())
    launches = {k.name: k.launches - before[k.name] for k in kernels}
    worst, worst_name, missing = 0.0, None, []
    cpu_grads = dict(model.named_parameters())
    for name, p in card_model.named_parameters():
        if p.grad is None:
            missing.append(name)
            continue
        ref = cpu_grads[name].grad
        ratio = (p.grad.cpu() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_name = ratio, name
    loss_err = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    bf16 = precision == "bf16"
    grad_tol = MODEL_BF16["grads"] if bf16 else GRAD_TOL[dtype]
    loss_tol = MODEL_BF16["loss"] if bf16 else LOSS_RTOL[dtype]
    logit_tol = MODEL_BF16["logits"] if bf16 else LOGIT_TOL[dtype]
    ok = (not missing and math.isfinite(worst) and worst <= grad_tol and loss_err <= loss_tol
          and math.isfinite(logit_err) and logit_err <= logit_tol * logit_scale
          and launches == expected_launches(precision, 1, gated))
    log({"phase": "grad_parity", "precision": precision, "gated_conv": gated or "off",
         "B": B, "L": L, "conv_io": dtype, "logits_max_abs_err": logit_err,
         "max_abs_logit": logit_scale, "logit_tol": logit_tol,
         "loss_cpu": loss_cpu.item(), "loss_card": loss_card.item(), "loss_rel_err": loss_err,
         "worst_grad_err_over_max": worst, "worst_param": worst_name, "tol": grad_tol,
         "params": len(cpu_grads), "missing_grads": missing, "launches": launches,
         "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"card gradients disagree with the CPU at B={B} L={L}")


def train(bench, kernels, batch, length, seed, precision="fp32", gated=None):
    """A few timed train steps through the port's bench entry point."""
    import torch

    argv = ["--batch", str(batch), "--length", str(length), "--d_model", str(D_MODEL),
            "--n_layer", str(N_LAYER), "--warmup", "1", "--windows", "2", "--steps", "3",
            "--device", "cuda", "--seed", str(seed), "--precision", precision,
            "--gated_conv", gated or "off"]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    result = bench.main(argv)
    launches = {k.name: k.launches for k in kernels}
    steps = result["steps_run"]
    expect = expected_launches(precision, steps, gated)
    losses = result["losses"]
    exact = ["fused_front", "fused_front_bwd", "add_ln", "add_ln_bwd", "fftconv_gated",
             "fftconv_gated_bwd"] + (["fftconv", "fftconv_bwd"] if gated else [])
    ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and all(launches[n] == expect[n] for n in exact)
          and launches["fftconv"] >= expect["fftconv"]
          and launches["fftconv_bwd"] >= expect["fftconv_bwd"])
    log({"phase": "training", "precision": precision, "gated_conv": gated or "off",
         "residual": result["residual"],
         "batch": batch, "L": length, "steps": steps,
         "step_ms": result["step_ms"], "tokens_per_s": result["value"],
         "loss_first": losses[0], "loss_last": losses[-1],
         "launches_per_step": {n: c / steps for n, c in launches.items()},
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "ok": ok})
    if not ok:
        raise AssertionError(f"training at {batch} x {length} failed its checks")
    torch.cuda.empty_cache()
    return launches, result["step_ms"]


def slice_parity(build_model, B, L, dtype, seed, precision="fp32"):
    import torch

    model = build_model(D_MODEL, N_LAYER, 32768, generator=torch.Generator().manual_seed(seed),
                        **model_kwargs(precision)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L)).astype(np.int64))
    with torch.inference_mode():
        cpu = model(tokens)
        card_model = copy.deepcopy(model).to("cuda")
        card = card_model(tokens.to("cuda")).cpu()
    err = (card.float() - cpu.float()).abs().max().item()
    scale = cpu.float().abs().max().item()
    tol = MODEL_BF16["logits"] if precision == "bf16" else LOGIT_TOL[dtype]
    ok = math.isfinite(err) and err <= tol * max(1.0, scale) and card.dtype == cpu.dtype
    log({"phase": "parity", "precision": precision, "B": B, "L": L, "conv_io": dtype,
         "max_abs_err": err, "max_abs_logit": scale, "tol": tol, "ok": ok})
    if not ok or card.shape != (B, L, 16):
        raise AssertionError(f"card logits disagree with the CPU at B={B} L={L}")


def write_fasta(path: Path, n_bases: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n_bases)].copy()
    seq[rng.random(n_bases) < 0.001] = ord("N")
    width = 80
    lines = [seq[i:i + width].tobytes() for i in range(0, n_bases, width)]
    path.write_bytes(b">chrS synthetic\n" + b"\n".join(lines) + b"\n")


def serve(cli, kernels, tmp: Path, fasta: Path, max_length: int, batch_size: int,
          n_windows: int, seed: int):
    import torch

    ckpt = tmp / f"weights_{max_length}.pt"
    model = cli.build_model(D_MODEL, N_LAYER, max_length,
                            generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), ckpt)
    del model
    argv = ["--ckpt", str(ckpt), "--fasta", str(fasta), "--max_length", str(max_length),
            "--d_model", str(D_MODEL), "--n_layer", str(N_LAYER),
            "--batch_size", str(batch_size),
            "--chr_ranges", f"chrS:0-{n_windows * max_length}", "--device", "cuda"]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    result = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    batches = math.ceil(n_windows / batch_size)
    expect = N_LAYER * batches
    ok = (math.isfinite(result["loss"]) and result["tokens"] == n_windows * max_length
          and launches["fused_front"] == expect and launches["fftconv"] >= expect)
    log({"phase": "serving", "batch": batch_size, "L": max_length, "batches": batches,
         "loss": result["loss"], "tokens": result["tokens"],
         "tokens_per_s_eval": result["tokens"] / result["eval_seconds"],
         "tokens_per_s_request": result["tokens"] / wall,
         "eval_seconds": result["eval_seconds"], "request_seconds": wall,
         "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"serving request at L={max_length} failed its checks")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "hyena_dna_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from hyena_dna_tpu_torch import _cuda, bench
    from hyena_dna_tpu_torch.evals import hg38_inference as cli
    from hyena_dna_tpu_torch.ops import add_ln as AL
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE
    from hyena_dna_tpu_torch.tasks.metrics import cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels = [FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD, AL.KERNEL, AL.KERNEL_BWD,
               GE.KERNEL, GE.KERNEL_BWD]
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    _cuda.build_all(kernels)
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "libraries": [k.library_path.name for k in kernels]})

    rows = [check_front(FF, 4, 32768, 1), check_front(FF, 1, 1000448, 2),
            check_front_bwd(FF, 4, 32768, 8)]
    rows += check_add_ln(AL, 4, 32768, 9)
    bf16_rows = [check_front(FF, 4, 32768, 10, "bfloat16"),
                 check_front_bwd(FF, 4, 32768, 18, "bfloat16")]
    rows += [check_conv(FB, 2, 8192, "float32", "XLA FFT on the TPU", 3),
             check_conv(FB, 4, 32768, "bfloat16", "pallas_fftconv.py:1119 packed", 4),
             check_conv(FB, 1, 32768, "bfloat16", "pallas_fftconv.py:296 unpacked", 5),
             check_conv(FB, 1, 131072, "bfloat16", "pallas_fftconv_n3.py:413 outer", 6),
             check_conv(FB, 1, 1000448, "bfloat16", "pallas_fftconv_n3.py:413 outer", 7)]
    for entry, B, L, dtype, route, seed in (
            (None, 2, 8192, "float32", "XLA FFT on the TPU", 20),
            (FB.fftconv_fused_bwd_spec_packed, 4, 32768, "bfloat16", "pallas_fftconv.py:1344", 21),
            (FB.fftconv_fused_bwd_packed, 4, 32768, "bfloat16", "pallas_fftconv.py:1222", 22),
            (FB.fftconv_fused_bwd_spec, 1, 32768, "bfloat16", "pallas_fftconv.py:519", 23),
            (FB.fftconv_fused_bwd, 1, 32768, "bfloat16", "pallas_fftconv.py:398", 24),
            (FB.fftconv_fused_bwd_split, 2, 131072, "bfloat16",
             "pallas_fftconv.py:687 + :775", 25),
            (FB.fftconv_outer_bwd, 1, 131072, "bfloat16", "pallas_fftconv_n3.py:629", 26),
            (FB.fftconv_outer_bwd, 1, 1000448, "bfloat16", "pallas_fftconv_n3.py:629", 27)):
        rows.append(check_conv_bwd(FB, entry or FB.fftconv_bwd_retransform, B, L, dtype,
                                   route, seed))
    rows += [check_gated(GE, 4, 32768, "bfloat16", variant, 40 + i)
             for i, variant in enumerate(("specv", "spec", "y"))]
    rows.append(check_gated(GE, 2, 65536, "bfloat16", "specv", 43))
    rows += [check_gated_bwd(GE, route, 4, 32768, "bfloat16", 44 + i)
             for i, route in enumerate(("specv", "spec", "retransform"))]
    rows.append(check_gated_bwd(GE, "specv", 2, 65536, "bfloat16", 47))
    for row in rows + bf16_rows:
        log({"phase": "kernel", **row})

    slice_parity(cli.build_model, 2, 8192, "float32", 11)
    slice_parity(cli.build_model, 1, 32768, "bfloat16", 12)
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 8192, "float32", 15)
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 32768, "bfloat16", 16)
    slice_parity(cli.build_model, 2, 8192, "float32", 30, "bf16")
    slice_parity(cli.build_model, 1, 32768, "bfloat16", 31, "bf16")
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 8192, "float32", 32, "bf16")
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 32768, "bfloat16", 33, "bf16")
    # the gate-fused conv (kernels E, E'): the gated route takes even B at fft 2^16
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 24576, "float32", 34, "bf16", "specv")
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 32768, "bfloat16", 35, "bf16", "specv")
    for seed, gated in ((36, "spec"), (37, "retransform")):
        grad_parity(cli.build_model, cross_entropy, kernels, 2, 24576, "float32", seed,
                    gated=gated)

    total = {k.name: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta = tmp / "synthetic.fa"
        write_fasta(fasta, 1_100_000, seed=13)
        for max_length, batch_size, n_windows in ((32768, 4, 8), (1000448, 1, 1)):
            for name, n in serve(cli, kernels, tmp, fasta, max_length, batch_size,
                                 n_windows, seed=14).items():
                total[name] += n
    step_ms = {}
    for batch, length, precision, gated in ((4, 32768, "fp32", None), (1, 131072, "fp32", None),
                                            (4, 32768, "bf16", None), (4, 32768, "bf16", "specv"),
                                            (4, 32768, "bf16", "spec"),
                                            (4, 32768, "bf16", "retransform")):
        launches, ms = train(bench, kernels, batch, length, 17, precision, gated)
        for name, n in launches.items():
            total[name] += n
        step_ms[f"{precision} {batch}x{length} gated_conv={gated or 'off'}"] = ms
    composite = step_ms["bf16 4x32768 gated_conv=off"]
    log({"phase": "gated_step", "step_ms": step_ms,
         "vs_composite_bf16": {k: v / composite for k, v in step_ms.items()
                               if k.startswith("bf16 4x32768")}})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    csrc = "hyena_dna_tpu_torch/csrc/"
    sources = {"fused_front": csrc + "fused_front.cu", "fused_front_bwd": csrc + "fused_front_bwd.cu",
               "fftconv": csrc + "fftconv.cu", "fftconv_bwd": csrc + "fftconv_bwd.cu",
               "add_ln": csrc + "add_ln.cu", "add_ln_bwd": csrc + "add_ln_bwd.cu",
               "fftconv_gated": csrc + "fftconv_gated.cu",
               "fftconv_gated_bwd": csrc + "fftconv_gated_bwd.cu"}
    replaces = {"add_ln": "hyena_dna_tpu/ops/pallas_ln.py:102",
                "add_ln_bwd": "hyena_dna_tpu/ops/pallas_ln.py:130",
                "fused_front": "hyena_dna_tpu/ops/pallas_hyena.py:85",
                "fused_front_bwd": "hyena_dna_tpu/ops/pallas_hyena.py:395",
                "fftconv": "hyena_dna_tpu/ops/pallas_fftconv.py:1119; "
                           "hyena_dna_tpu/ops/pallas_fftconv.py:296; "
                           "hyena_dna_tpu/ops/pallas_fftconv_n3.py:413",
                "fftconv_bwd": "hyena_dna_tpu/ops/pallas_fftconv.py:1344; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:1222; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:519; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:398; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:687; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:775; "
                               "hyena_dna_tpu/ops/pallas_fftconv_n3.py:629",
                "fftconv_gated": "hyena_dna_tpu/ops/pallas_fftconv.py:1534",
                "fftconv_gated_bwd": "hyena_dna_tpu/ops/pallas_fftconv.py:1796; "
                                     "hyena_dna_tpu/ops/pallas_fftconv.py:1662; "
                                     "hyena_dna_tpu/ops/pallas_fftconv.py:1932"}
    # each kernel's row at the main paths' 4 x 32768 shape (the conv's
    # backward on the spectrum route the training step takes there; kernels
    # A and A' in float32, their bf16 rows under "bf16"; E and E' on the
    # gated step's specv route, every route's row under "routes")
    gated = ("fftconv_gated", "fftconv_gated_bwd")
    headline = {name: next(r for r in rows if r["name"] == name and r["shape"].startswith("B=4 ")
                           and (name not in gated or r["route"] == "specv"))
                for name in sources}
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bf16 = {r["name"]: {"max_abs_err": r["max_abs_err"], **{k: r[k] for k in timing}}
            for r in bf16_rows}
    # errors: the worst over every shape checked in phase 2 (bf16 dk sums
    # B * L products, so one bf16 step of it is large in absolute terms)
    log({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         "launches": total[name],
         "max_abs_err": max(r["max_abs_err"] for r in rows if r["name"] == name),
         "max_rel_err": max(r["max_rel_err"] for r in rows if r["name"] == name),
         **{k: row[k] for k in timing}, **({"bf16": bf16[name]} if name in bf16 else {}),
         **({"routes": {f"{r['route']} {r['shape']}": {"max_abs_err": r["max_abs_err"],
                                                       **{k: r[k] for k in timing}}
                        for r in rows if r["name"] == name}}
            if name in gated else {})}
        for name, row in headline.items()]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
