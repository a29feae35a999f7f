#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no final
line:

1. build    every hand-written kernel from `hyena_dna_tpu_torch/csrc` (one
            nvcc per source, started together): kernels A and A' (the front
            end forward and backward), B and C (the FFT conv forward and
            backward);
2. kernels  each kernel against its plain PyTorch version on the card, in the
            working dtype, at the shapes of the TPU routes it replaces, with
            the tolerances below; kernel, plain and library-call times;
3. parity   the full-width model (d=256 x 8 layers, random weights from a
            seeded torch.Generator) on the CPU through the plain versions and
            on the card through the kernels: logits at (B=2, L=8192)
            (float32 conv I/O) and (B=1, L=32768) (bfloat16 conv I/O), then
            the loss and every parameter's gradient at the same two shapes;
4. serving  the port's `hg38_inference.main` on a synthetic FASTA and a
            reference-named `.pt`: 2 batches of 4 x 32768 tokens, then one
            1,000,448-token window. Kernel A must run n_layer times per
            batch, kernel B at least as often;
5. training the port's `bench.main` (forward, backward, clip, AdamW) at
            4 x 32768 and at 1 x 131072: the loss must be finite and lower
            after the steps than at step 0; kernels A and A' must run
            n_layer times per step, kernels B and C at least as often.
Launch counts are zeroed just before each request of phases 4 and 5 and
read just after it.

It then prints the card's name and power limit, one JSON line
{"kernels": [...]} with each kernel's launches in phases 4 and 5, its error,
times and bound at the main paths' 4 x 32768 shape, and last
{"ok": true, "device": {...}}. Times come from CUDA events around repeated
launches after a warm-up. `bound_ms` is the larger of the bytes the function
must move (inputs read once, outputs written once) at 3.35 TB/s and its
float32 operations at 67 TFLOP/s (H100 SXM data sheet), the least time the
card could take.
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
D_MODEL, N_LAYER = 256, 8

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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_front(FF, B, L, seed):
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = D_MODEL
    u = torch.randn(B, L, d, device="cuda", generator=g)
    w = torch.randn(d, 3 * d, device="cuda", generator=g) * 0.02
    bp = torch.randn(3 * d, device="cuda", generator=g) * 0.02
    wc = (torch.rand(3, 3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    bc = (torch.rand(3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    vx, x0 = FF.fused_proj_conv_gate(u, w, bp, wc, bc)
    torch.cuda.synchronize()
    vx_ref, x0_ref = FF.reference_fwd(u, w, bp, wc, bc)
    err = [compare(vx, vx_ref, "float32"), compare(x0, x0_ref, "float32")]
    conv_w = wc.t().contiguous()[:, None, :]

    def library():  # torch.matmul + cuDNN depthwise conv1d + gate
        proj = torch.matmul(u, w) + bp
        conv = F.conv1d(proj.transpose(1, 2), conv_w, bc, padding=2, groups=3 * d)[..., :L]
        return conv[:, 2 * d:] * conv[:, d:2 * d], conv[:, :d]

    nbytes = 4 * (B * L * d + d * 3 * d + 3 * 3 * d + 2 * 3 * d + 2 * B * d * L)
    flops = B * L * (2 * d * 3 * d + 3 * d * 7 + d)
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fused_front", "shape": f"B={B} L={L} d={d} float32",
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


def check_front_bwd(FF, B, L, seed):
    """Kernel A' against `reference_bwd` (float32)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = D_MODEL
    u = torch.randn(B, L, d, device="cuda", generator=g)
    w = torch.randn(d, 3 * d, device="cuda", generator=g) * 0.02
    bp = torch.randn(3 * d, device="cuda", generator=g) * 0.02
    wc = (torch.rand(3, 3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    bc = (torch.rand(3 * d, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    dvx = torch.randn(B, d, L, device="cuda", generator=g)
    dx0 = torch.randn(B, d, L, device="cuda", generator=g)
    args = (u, w, bp, wc, bc, dvx, dx0)
    out = FF.front_bwd(*args)
    torch.cuda.synchronize()
    ref = FF.reference_bwd(*args)
    errs = {name: compare(o, r, "float32")
            for name, o, r in zip(("du", "dw", "dbp", "dwc", "dbc"), out, ref)}
    leaves = [t.detach().clone().requires_grad_() for t in (u, w, bp)]
    conv_w = wc.t().contiguous()[:, None, :].requires_grad_()
    conv_b = bc.clone().requires_grad_()

    def library():  # autograd through torch.matmul + cuDNN depthwise conv1d + gate
        lu, lw, lbp = leaves
        with torch.enable_grad():
            proj = torch.matmul(lu, lw) + lbp
            conv = F.conv1d(proj.transpose(1, 2), conv_w, conv_b, padding=2,
                            groups=3 * d)[..., :L]
            outs = (conv[:, 2 * d:] * conv[:, d:2 * d], conv[:, :d])
            return torch.autograd.grad(outs, leaves + [conv_w, conv_b], (dvx, dx0))

    nbytes = 4 * (2 * B * L * d + 2 * d * 3 * d + 11 * 3 * d + 2 * B * d * L)
    flops = 3 * 2 * B * L * d * 3 * d + B * L * 3 * d * 16
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fused_front_bwd", "shape": f"B={B} L={L} d={d} float32",
            "route": "pallas_hyena.py:395", "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: FF.front_bwd(*args)),
            "plain_ms": time_ms(lambda: FF.reference_bwd(*args)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


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


def grad_parity(build_model, cross_entropy, kernels, B, L, dtype, seed):
    """Loss and every parameter gradient of the full-width model, card
    (kernels A, A', B, C) against CPU (their plain versions)."""
    import torch

    model = build_model(D_MODEL, N_LAYER, 32768,
                        generator=torch.Generator().manual_seed(seed)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L + 1)).astype(np.int64))
    x, y = tokens[:, :-1], tokens[:, 1:]
    loss_cpu = cross_entropy(model(x), y)
    loss_cpu.backward()
    card_model = copy.deepcopy(model).to("cuda")
    card_model.zero_grad(set_to_none=True)
    before = {k.name: k.launches for k in kernels}
    loss_card = cross_entropy(card_model(x.to("cuda")), y.to("cuda"))
    loss_card.backward()
    torch.cuda.synchronize()
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
    ok = (not missing and math.isfinite(worst) and worst <= GRAD_TOL[dtype]
          and loss_err <= LOSS_RTOL[dtype] and all(n == N_LAYER for n in launches.values()))
    log({"phase": "grad_parity", "B": B, "L": L, "conv_io": dtype, "loss_cpu": loss_cpu.item(),
         "loss_card": loss_card.item(), "loss_rel_err": loss_err,
         "worst_grad_err_over_max": worst, "worst_param": worst_name, "tol": GRAD_TOL[dtype],
         "params": len(cpu_grads), "missing_grads": missing, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"card gradients disagree with the CPU at B={B} L={L}")


def train(bench, kernels, batch, length, seed):
    """A few timed train steps through the port's bench entry point."""
    import torch

    argv = ["--batch", str(batch), "--length", str(length), "--d_model", str(D_MODEL),
            "--n_layer", str(N_LAYER), "--warmup", "1", "--windows", "2", "--steps", "3",
            "--device", "cuda", "--seed", str(seed)]
    for k in kernels:
        k.launches = 0
    result = bench.main(argv)
    launches = {k.name: k.launches for k in kernels}
    steps = result["steps_run"]
    expect = N_LAYER * steps
    losses = result["losses"]
    ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and launches["fused_front"] == launches["fused_front_bwd"] == expect
          and launches["fftconv"] >= expect and launches["fftconv_bwd"] >= expect)
    log({"phase": "training", "batch": batch, "L": length, "steps": steps,
         "step_ms": result["step_ms"], "tokens_per_s": result["value"],
         "loss_first": losses[0], "loss_last": losses[-1],
         "launches_per_step": {n: c / steps for n, c in launches.items()},
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "ok": ok})
    if not ok:
        raise AssertionError(f"training at {batch} x {length} failed its checks")
    torch.cuda.empty_cache()
    return launches


def slice_parity(build_model, B, L, dtype, seed):
    import torch

    model = build_model(D_MODEL, N_LAYER, 32768,
                        generator=torch.Generator().manual_seed(seed)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L)).astype(np.int64))
    with torch.inference_mode():
        cpu = model(tokens)
        card_model = copy.deepcopy(model).to("cuda")
        card = card_model(tokens.to("cuda")).cpu()
    err = (card - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    ok = math.isfinite(err) and err <= LOGIT_TOL[dtype] * max(1.0, scale)
    log({"phase": "parity", "B": B, "L": L, "conv_io": dtype, "max_abs_err": err,
         "max_abs_logit": scale, "tol": LOGIT_TOL[dtype], "ok": ok})
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
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF
    from hyena_dna_tpu_torch.tasks.metrics import cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD]
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    _cuda.build_all(kernels)
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "libraries": [k.library_path.name for k in kernels]})

    rows = [check_front(FF, 4, 32768, 1), check_front(FF, 1, 1000448, 2),
            check_front_bwd(FF, 4, 32768, 8)]
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
    for row in rows:
        log({"phase": "kernel", **row})

    slice_parity(cli.build_model, 2, 8192, "float32", 11)
    slice_parity(cli.build_model, 1, 32768, "bfloat16", 12)
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 8192, "float32", 15)
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 32768, "bfloat16", 16)

    total = {k.name: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta = tmp / "synthetic.fa"
        write_fasta(fasta, 1_100_000, seed=13)
        for max_length, batch_size, n_windows in ((32768, 4, 8), (1000448, 1, 1)):
            for name, n in serve(cli, kernels, tmp, fasta, max_length, batch_size,
                                 n_windows, seed=14).items():
                total[name] += n
    for batch, length in ((4, 32768), (1, 131072)):
        for name, n in train(bench, kernels, batch, length, seed=17).items():
            total[name] += n

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    csrc = "hyena_dna_tpu_torch/csrc/"
    sources = {"fused_front": csrc + "fused_front.cu", "fused_front_bwd": csrc + "fused_front_bwd.cu",
               "fftconv": csrc + "fftconv.cu", "fftconv_bwd": csrc + "fftconv_bwd.cu"}
    replaces = {"fused_front": "hyena_dna_tpu/ops/pallas_hyena.py:85",
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
                               "hyena_dna_tpu/ops/pallas_fftconv_n3.py:629"}
    # each kernel's row at the main paths' 4 x 32768 shape (the conv's
    # backward on the spectrum route the training step takes there)
    headline = {name: next(r for r in rows if r["name"] == name and r["shape"].startswith("B=4 "))
                for name in sources}
    # errors: the worst over every shape checked in phase 2 (bf16 dk sums
    # B * L products, so one bf16 step of it is large in absolute terms)
    log({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         "launches": total[name],
         "max_abs_err": max(r["max_abs_err"] for r in rows if r["name"] == name),
         "max_rel_err": max(r["max_rel_err"] for r in rows if r["name"] == name),
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in headline.items()]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
