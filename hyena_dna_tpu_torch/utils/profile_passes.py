"""Device time of each launch inside one call of kernel B, C, E or E', on the card.

    python -m hyena_dna_tpu_torch.utils.profile_passes \
        C:4x32768:bf16:spectrum C:1x1000448:bf16:retransform B:1x450048:bf16 \
        E:4x32768:bf16:specv "E':4x32768:bf16:specv"

Each argument is KERNEL:BxL:DTYPE[:ROUTE]: kernel B; kernel C on its
retransform (the default) or spectrum route; kernel E writing y alone (y,
the default), y and u's spectrum (spec) or y, v and the spectrum (specv);
kernel E' on its specv (the default), spec or retransform route. C = 256
channels, k as long as u, random inputs from a fixed seed. For each, the
script warms up, profiles REPS calls with `torch.profiler` (one session a
call; a session that recorded no device activity is run again), and
prints one JSON line listing the call's launches in order: the kernel's
name, its mean device time, its role in the four-step transform (or on
kernels B and C's short path, FFT sizes up to 2^kShortMaxLogN: `python -m
hyena_dna_tpu_torch.utils.profile_passes C:32x1024:float32` names its three
launches) and the bytes that role must move through device memory (each
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
from hyena_dna_tpu_torch.ops import gated_fftconv as GE
from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

HBM_BYTES_PER_S = 3.35e12
CHANNELS = 256
REPS = 5
SEED = 0
ROUTES = {"B": ("forward",), "C": ("retransform", "spectrum"), "E": ("y", "spec", "specv"),
          "E'": ("specv", "spec", "retransform")}
# the launch kinds, told apart by the kernel's name
FWD, ROWS, INV = "forward columns", "rows", "inverse columns"
SHORT = "short path (rows whole in shared memory)"


def launch_kind(name: str) -> str:
    """The kind of a launch from its kernel's name (every library names its
    forward column passes cols_fwd* or cols_in_*, its inverse ones
    cols_inv*, its row passes rows_*, the short path's kernels short_*)."""
    if "short_" in name:
        return SHORT
    if "cols_inv" in name:
        return INV
    if "cols_fwd" in name or "cols_in_" in name:
        return FWD
    if "rows_" in name:
        return ROWS
    raise ValueError(f"not a four-step launch: {name}")


def pass_bytes(kernel: str, route: str, B: int, C: int, L: int, n: int, size: int,
               slices: int | None = None):
    """[(role, kind, bytes read + written)] of one call's launches, in the
    order the call makes them. `slab` is one complex64 scratch of n per
    channel pair, `sig` one (B, C, L) signal and `filt` the (C, L) filter
    in the I/O type (`size` bytes an element). A row pass reads K once per
    batch row, and kernel C's and E''s row pass (`rows_grad_body`) reads dy
    (dv) and u and writes du per batch row, and dk's rows once. On the short
    path (kernel B, and kernel C's retransform route, at n <= 2^kShortMaxLogN)
    K + D is written once and read once (the blocks' later reads of it
    counted as L2's), and kernel C's grad launch writes `slices` dk partials
    a pair, which its last launch reads (`slices` is the library's
    `short_slices`, a card property)."""
    slab = (C + 1) // 2 * n * 8
    sig = B * C * L * size
    filt = C * L * size  # k as long as u
    if n <= 1 << FB.short_max_log_n() and (kernel, route) in (("B", "forward"),
                                                              ("C", "retransform")):
        kspec = [("K + D spectrum", SHORT, filt + slab)]
        if kernel == "B":
            return kspec + [("u rows: U (K + D), y", SHORT, 2 * sig + slab)]
        if slices is None:
            raise ValueError("kernel C's short path needs its number of dk partials (slices)")
        return kspec + [("dy, u rows: du, dk partials", SHORT, 3 * sig + slab + slices * slab),
                        ("dk: partials summed, inverse", SHORT, slices * slab + filt)]
    k_chain = [("k columns", FWD, filt + slab), ("k rows (in place)", ROWS, 2 * slab)]
    grad = [("rows", ROWS, 4 * B * slab + slab), ("du columns", INV, B * slab + sig),
            ("dk columns", INV, slab + filt)]
    if kernel == "B":  # the rows: u's, K per batch row, the inverse out; y reads u (skip term)
        return k_chain + [("u columns", FWD, sig + B * slab), ("rows", ROWS, 3 * B * slab),
                          ("y columns", INV, B * slab + 2 * sig)]
    if kernel == "C":
        u_cols = [("u columns", FWD, sig + B * slab)] if route == "retransform" else []
        return k_chain + [("dy columns", FWD, sig + B * slab)] + u_cols + grad
    if kernel == "E":  # k + D: the last pass reads x0, writes y (and v)
        spec, save_v = route != "y", route == "specv"
        return k_chain + [("u columns", FWD, sig + B * slab),
                          ("rows" + " (+ u's spectrum)" * spec, ROWS, (3 + spec) * B * slab),
                          ("y columns", INV, B * slab + (2 + save_v) * sig)]
    if kernel == "E'":  # k + D; dv = dy x0 (specv: dx0 = dy v in the same pass)
        if route == "specv":
            return k_chain + [("dv columns (+ dx0)", FWD, 4 * sig + B * slab)] + grad
        u_cols = [("u columns", FWD, sig + B * slab)] if route == "retransform" else []
        v_rows = (4 if route == "retransform" else 3) * B * slab  # + u's spectrum stored
        return k_chain + u_cols + [("v rows", ROWS, v_rows),
                                   ("dx0 columns", INV, B * slab + 2 * sig),
                                   ("dv columns", FWD, 2 * sig + B * slab)] + grad
    raise ValueError(f"unknown kernel {kernel!r}: one of {sorted(ROUTES)}")


def parse(spec: str):
    """(kernel, B, L, dtype, route) of a KERNEL:BxL:DTYPE[:ROUTE] argument."""
    kernel, shape, dtype, *route = spec.split(":")
    if kernel not in ROUTES or len(route) > 1 or (route and route[0] not in ROUTES[kernel]):
        raise ValueError(f"{spec}: KERNEL:BxL:DTYPE[:ROUTE] with routes {ROUTES}")
    B, L = map(int, shape.split("x"))
    dtype = {"bf16": "bfloat16", "f32": "float32"}.get(dtype, dtype)
    return kernel, B, L, dtype, route[0] if route else ROUTES[kernel][0]


def _inputs(B, L, dtype):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    C, dt = CHANNELS, getattr(torch, dtype)
    u, x0, dy = (torch.randn(B, C, L, device="cuda", generator=g).to(dt) for _ in range(3))
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    return u, x0, dy, k, torch.randn(C, device="cuda", generator=g)


def _call(kernel, route, B, L, dtype):
    u, x0, dy, k, D = _inputs(B, L, dtype)
    if kernel == "B":
        return lambda: FB.fftconv_fused(u, k, D), "conv_fwd::"
    if kernel == "C":
        if route == "spectrum":
            spec_u = FB.fftconv_fused(u, k, D, save_spectrum=True)[1]
            return lambda: FB.fftconv_bwd_spectrum(spec_u, dy, k, D), "conv_bwd::"
        return lambda: FB.fftconv_bwd_retransform(u, dy, k, D), "conv_bwd::"
    if kernel == "E":
        save = {"save_v": route == "specv", "save_spectrum": route != "y"}
        return lambda: GE.fftconv_gated_fused(u, x0, k, D, **save), "conv_gfwd::"
    _, v, spec_u = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    fn = getattr(GE, f"fftconv_gated_bwd_{route}")
    saved = {"specv": (spec_u, v), "spec": (spec_u,), "retransform": (u,)}[route]
    return lambda: fn(*saved, dy, x0, k, D), "conv_gbwd::"


def profile(spec: str) -> dict:
    kernel, B, L, dtype, route = parse(spec)
    call, lib = _call(kernel, route, B, L, dtype)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = next_fast_fft_size(2 * L)
    dt = getattr(torch, dtype)
    short_c = (kernel, route) == ("C", "retransform")
    slices = FB.short_slices(B, CHANNELS, n, dt) if short_c else None
    roles = pass_bytes(kernel, route, B, CHANNELS, L, n, dt.itemsize, slices)
    times = defaultdict(float)
    done = 0
    for _ in range(3 * REPS):  # one profiled call at a time: each holds the call's launches alone
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA and lib in e.name),
                          key=lambda e: e.time_range.start)
        if not launches:  # a session that recorded no device activity: profile again
            continue
        kinds = [launch_kind(e.name) for e in launches]
        if kinds != [kind for _, kind, _ in roles]:
            raise RuntimeError(f"{spec}: launches {[e.name[:60] for e in launches]} are not "
                               f"the call's roles {[r for r, _, _ in roles]}")
        for i, e in enumerate(launches):
            times[i] += e.time_range.elapsed_us() / 1e3 / REPS
        done += 1
        if done == REPS:
            break
    if done < REPS:
        raise RuntimeError(f"{spec}: {done} of {REPS} profiled calls recorded their launches")
    rows = []
    for i, (role, _, nbytes) in enumerate(roles):
        ms = times[i]
        rows.append({"launch": i, "kernel": launches[i].name[:90], "role": role, "ms": ms,
                     "bytes": nbytes,
                     "hbm_share": nbytes / HBM_BYTES_PER_S / (ms / 1e3) if ms else None})
    return {"kernel": kernel, "route": route, "shape": f"B={B} C={CHANNELS} L={L} {dtype}",
            "fft": n, "slices": slices or None, "call_ms": sum(times.values()), "launches": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="+",
                    help="KERNEL:BxL:DTYPE[:ROUTE], e.g. C:4x32768:bf16:spectrum")
    args = ap.parse_args(argv)
    for spec in args.specs:
        parse(spec)
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
