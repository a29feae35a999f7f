"""Arithmetic the per-layer metric readers share. A reader that finds
nothing to read (no trace, no device time, no launch of the kernel)
returns None and the metric is left out of the line."""

from __future__ import annotations

from benchmark.counts import flops as F
from benchmark.counts import roofline as R
from benchmark.counts.groups import GLUE

PEAK = R.PEAK_FLOPS


def _conv_size(ctx) -> int:
    """Bytes of an element of the long conv's I/O (bf16 from the
    configuration's length on)."""
    return 2 if ctx["length"] >= ctx["cell"].config["conv_io_bf16_from"] else 4


def bound_s(ctx, group: str) -> float:
    """The least time of one call of the kernel `group` at the cell's shape."""
    d = ctx["cell"].model_cfg["d_model"]
    B, L = ctx["rows"], ctx["length"]
    size = _conv_size(ctx)
    counts = {"kernel_a": lambda: R.front_fwd(B, L, d, d, ctx["u_size"]),
              "kernel_a_bwd": lambda: R.front_bwd(B, L, d, d, ctx["u_size"]),
              "kernel_b": lambda: R.conv_fwd(B, d, L, size),
              "kernel_c": lambda: R.conv_bwd(B, d, L, size, size)}
    return R.bound_s(*counts[group]())


def roofline_pct(ctx, groups) -> float | None:
    """100 x the sum of the calls' bounds over the device time of `groups`
    in the traced window."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    by_group = tr.device_s_by_group()
    device_s = sum(by_group.get(g, 0.0) for g in groups)
    calls = {g: ctx["calls"].get(g, 0) for g in groups}
    if device_s <= 0 or not all(calls.values()):
        return None
    return 100.0 * sum(n * bound_s(ctx, g) for g, n in calls.items()) / device_s


def glue_pct(ctx) -> float | None:
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    by_group = tr.device_s_by_group()
    glue = sum(v for g, v in by_group.items() if g == GLUE)
    return 100.0 * glue / tr.busy_s


def idle_pct(ctx) -> float | None:
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def train_mfu(ctx) -> float | None:
    if ctx.get("rate") is None or ctx.get("trace") is None or not ctx["trace"].kernels:
        return None
    cfg = ctx["cell"].model_cfg
    rows, L = ctx["rows_per_step"], ctx["length"]
    per_token = F.train_step_flops(cfg, rows, L) / (rows * L)
    return 100.0 * ctx["rate"] * per_token / (ctx["cell"].chips * PEAK)


def score_mfu(ctx) -> float | None:
    if ctx.get("rate") is None or ctx.get("trace") is None or not ctx["trace"].kernels:
        return None
    cfg = ctx["cell"].model_cfg
    per_token = F.forward_flops(cfg, ctx["rows"], ctx["length"]) / (ctx["rows"] * ctx["length"])
    return 100.0 * ctx["rate"] * per_token / (ctx["cell"].chips * PEAK)


def remat_repeat_x(ctx) -> float | None:
    """Kernel A's runs per micro-step and layer over the timed window."""
    runs, micro = ctx.get("window_launches", {}).get("kernel_a", 0), ctx.get("window_micro_steps")
    if not runs or not micro:
        return None
    return runs / micro / ctx["cell"].model_cfg["n_layer"]


def peak_gib(ctx) -> float | None:
    return ctx["peak_bytes"] / 2 ** 30 if ctx.get("peak_bytes") else None
