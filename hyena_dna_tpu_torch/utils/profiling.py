"""Profiling helpers for the card (the port's counterpart of
`hyena_dna_tpu/utils/profiling.py`):

  * `benchmark(fn, *args)`: the latency of a call, in ms, from CUDA events
    around each call after a warm-up, with a synchronise (on the card; a
    host clock with `device="cpu"`);
  * `benchmark_fwd_bwd`: the forward and the forward + backward of a
    scalar loss;
  * `device_memory_stats`: bytes in use, their peak and the card's total,
    from `torch.cuda.memory_stats`;
  * `trace(path)`: a `torch.profiler` trace of the card and the host,
    written as a Chrome trace;
  * `flops_estimate`: the analytic operations of a Hyena LM step per token.

The card ones raise without a card: they measure the card and never fall
back to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Callable, Dict

import torch


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measures the card; pass device='cpu' to time "
                           "on the host")
    return device


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2, device="cuda",
              **kwargs) -> Dict[str, float]:
    """Run fn `warmup` times, then time `iters` calls: mean, median, min and
    max ms, and the warm-up's ms. On the card each call sits between two
    CUDA events and the card is synchronised after it."""
    device = _card(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    sync()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(iters):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fn(*args, **kwargs)
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fn(*args, **kwargs)
            times.append((time.perf_counter() - t) * 1e3)
    times.sort()
    return {"mean_ms": sum(times) / len(times), "p50_ms": times[len(times) // 2],
            "min_ms": times[0], "max_ms": times[-1], "warmup_ms": warmup_ms}


def benchmark_fwd_bwd(loss_fn: Callable, params, *args, iters: int = 20,
                      device="cuda") -> Dict[str, Dict[str, float]]:
    """The latency of `loss_fn(params, *args)` (a scalar) and of its
    forward + backward into `params` (tensors that require grad)."""
    def fwd():
        with torch.no_grad():
            return loss_fn(params, *args)

    def fwd_bwd():
        return torch.autograd.grad(loss_fn(params, *args), params)

    return {"fwd": benchmark(fwd, iters=iters, device=device),
            "fwd_bwd": benchmark(fwd_bwd, iters=iters, device=device)}


def device_memory_stats(device=None) -> Dict[str, int]:
    """bytes_in_use, peak_bytes_in_use and bytes_limit of a card."""
    device = _card(device if device is not None else "cuda")
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """A `torch.profiler` trace of the host and the card around the block,
    written to `log_dir/trace.json` (Perfetto or chrome://tracing)."""
    device = _card(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def flops_estimate(d_model: int, n_layer: int, d_inner: int, seq_len: int,
                   vocab_size: int = 16, order: int = 2, train: bool = True) -> float:
    """Analytic operations per token of the Hyena LM (forward; x3 to train):
    the projections, the MLP, the short conv, the gates, the LM head and
    the FFT convs at 5 N log2 N real operations per length-N transform (3
    transforms per conv, order - 1 convs a layer)."""
    proj = 2 * d_model * (order + 1) * d_model + 2 * d_model * d_model
    mlp = 2 * 2 * d_model * d_inner
    short = 2 * 3 * (order + 1) * d_model
    n_fft = 1 << (2 * seq_len - 1).bit_length()
    fft = (order - 1) * 3 * 5 * n_fft * math.log2(n_fft) / seq_len
    gate = 4 * order * d_model
    total = n_layer * (proj + mlp + short + fft + gate) + 2 * d_model * vocab_size
    return total * (3.0 if train else 1.0)
