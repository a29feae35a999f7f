"""The traced run's device trace: `torch.profiler` over a few steps or
windows, reduced to kernel intervals, busy time, idle gaps and the top
device operations.

The benchmark marks its own calls into the program with `record_function`
ranges named `bench.*` (the step call, the batch's feed, the loader's
hand-off, the forward, the metric update); an idle gap on the device is
named by the innermost such range that covered its start on the host.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.counts.groups import group_of

Interval = Tuple[str, float, float]  # name, start, end (microseconds)
WINDOW_RANGE = "bench.traced_window"


@dataclass
class Trace:
    kernels: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels if e > lo and s < hi)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def device_s_by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            out[group_of(name)] += (e - s) / 1e6
        return dict(out)

    def device_s_by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            out[name] += (e - s) / 1e6
        return dict(out)

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap inside the window, (host range, seconds)."""
        lo, hi = self.window
        edges, t = [], lo
        for s, e in self.merged():
            if s > t:
                edges.append((t, s))
            t = max(t, e)
        if hi > t:
            edges.append((t, hi))
        return [(self.host_range_at(s), (e - s) / 1e6) for s, e in edges]

    def host_range_at(self, t: float) -> str:
        inner = [(s, name) for name, s, e in self.host
                 if s <= t < e and name != WINDOW_RANGE]
        return max(inner)[1] if inner else "outside bench ranges"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (`group: kernel`) and
        the longest idle gaps, each at most `top` entries."""
        ops = sorted(self.device_s_by_kernel().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[f"{group_of(k)}: {k[:160]}", v] for k, v in ops],
                "idle_gaps": [[name, v] for name, v in gaps]}


def profile(run: Callable[[], None]) -> Trace:
    """Run `run()` under the profiler, inside a `bench.traced_window` range
    that ends after a device sync."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    trace = Trace()
    for evt in prof.events():
        name = evt.name
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False) or name.startswith("bench."):
                continue
            trace.kernels.append((name, start, end))
        elif name.startswith("bench."):
            trace.host.append((name, start, end))
            if name == WINDOW_RANGE:
                trace.window = (start, end)
    return trace


class Span:
    """A `record_function` range opened and closed by hand (a forward
    pre-hook opens it, the forward hook closes it)."""

    def __init__(self, name: str):
        self.name = name
        self.ctx = None

    def open(self, *_):
        self.ctx = torch.profiler.record_function(self.name)
        self.ctx.__enter__()

    def close(self, *_):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.ctx = None
