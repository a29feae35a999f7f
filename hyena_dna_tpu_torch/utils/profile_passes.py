"""Device time of each launch inside one call of kernel B or C, on the card.

    python -m hyena_dna_tpu_torch.utils.profile_passes \
        C:4x32768:bf16:spectrum C:1x1000448:bf16:retransform B:1x450048:bf16

Each argument is KERNEL:BxL:DTYPE[:ROUTE] (kernel B, or kernel C on its
spectrum or retransform route; C = 256 channels, k as long as u, random
inputs from a fixed seed). For each, the script warms up, profiles REPS
calls with `torch.profiler` (one session a call), and prints one JSON line listing the call's
launches in order: the kernel's name, its mean device time, the bytes its
role in the four-step transform must move through device memory (each
buffer it reads or writes counted once per read or write, from the shapes,
see `pass_bytes`), and that traffic's share of 3.35 TB/s (H100 SXM data
sheet) over the launch's time. Prints the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import torch

from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

HBM_BYTES_PER_S = 3.35e12
CHANNELS = 256
REPS = 5
SEED = 0


def pass_bytes(kernel: str, name: str, ordinal: int, B: int, C: int, L: int, n: int, size: int):
    """(role, bytes read + written) of a launch named `name` in one call,
    `ordinal` counting the earlier launches of its kind (forward column,
    inverse column, other). `slab` is one complex64 scratch of n per channel
    pair; the forward column passes of k, dy and u come in that order, the
    inverse ones du then dk (C) or y (B)."""
    slab = (C + 1) // 2 * n * 8
    sig = B * C * L * size
    filt = C * L * size  # k as long as u
    if "cols_fwd_kernel" in name or "cols_in_kernel" in name:
        signal = "dy columns" if kernel == "C" else "u columns"
        return [("k columns", filt + slab), (signal, sig + B * slab),
                ("u columns", sig + B * slab)][ordinal]
    if "rows_fwd_kernel" in name:
        return "k rows (in place)", 2 * slab
    if "rows_conv_kernel" in name:  # u's rows, K per batch row, the inverse rows in place
        return "rows", 3 * B * slab
    if "rows_bwd_kernel" in name or "rows_grad" in name:
        return "rows", 4 * B * slab + slab  # dy, u, K per batch row; du and dk rows out
    if "cols_inv_kernel" in name:
        if kernel == "B":  # the rows, the skip term's input u, y
            return "y columns", B * slab + 2 * sig
        if ordinal == 0:  # the rows, du (the skip term is in du's spectrum)
            return "du columns", B * slab + sig
        return "dk columns", slab + C * L * size
    return "?", 0


def _inputs(B, L, dtype):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    C, dt = CHANNELS, getattr(torch, dtype)
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    dy = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    return u, dy, k, torch.randn(C, device="cuda", generator=g)


def profile(spec: str) -> dict:
    kernel, shape, dtype, *route = spec.split(":")
    B, L = map(int, shape.split("x"))
    dtype = {"bf16": "bfloat16", "f32": "float32"}.get(dtype, dtype)
    route = route[0] if route else ("retransform" if kernel == "C" else "forward")
    u, dy, k, D = _inputs(B, L, dtype)
    if kernel == "B":
        call = lambda: FB.fftconv_fused(u, k, D)
    elif route == "spectrum":
        spec_u = FB.fftconv_fused(u, k, D, save_spectrum=True)[1]
        call = lambda: FB.fftconv_bwd_spectrum(spec_u, dy, k, D)
    else:
        call = lambda: FB.fftconv_bwd_retransform(u, dy, k, D)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lib = "conv_fwd::" if kernel == "B" else "conv_bwd::"
    times = defaultdict(float)
    for _ in range(REPS):  # one profiled call at a time: each holds the call's launches alone
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA and lib in e.name),
                          key=lambda e: e.time_range.start)
        if not launches or (times and len(launches) != len(times)):
            raise RuntimeError(f"{spec}: {len(launches)} kernel launches in one call")
        for i, e in enumerate(launches):
            times[i] += e.time_range.elapsed_us() / 1e3 / REPS
    per_call = len(launches)
    n = next_fast_fft_size(2 * L)
    size = u.element_size()
    seen = defaultdict(int)
    rows = []
    for i in range(per_call):
        name = launches[i].name
        kind = ("fwd" if "cols_fwd" in name or "cols_in_" in name else
                "inv" if "cols_inv" in name else name)
        role, nbytes = pass_bytes(kernel, name, seen[kind], B, CHANNELS, L, n, size)
        seen[kind] += 1
        ms = times[i]
        rows.append({"launch": i, "kernel": name[:90], "role": role, "ms": ms, "bytes": nbytes,
                     "hbm_share": nbytes / HBM_BYTES_PER_S / (ms / 1e3) if ms else None})
    return {"kernel": kernel, "route": route, "shape": f"B={B} C={CHANNELS} L={L} {dtype}",
            "fft": n, "call_ms": sum(times.values()), "launches": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="+",
                    help="KERNEL:BxL:DTYPE[:ROUTE], e.g. C:4x32768:bf16:spectrum")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_passes measures the card; no CUDA device is available")
    set_card_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    for spec in args.specs:
        print(json.dumps({"card": smi, **profile(spec)}), flush=True)


if __name__ == "__main__":
    main()
