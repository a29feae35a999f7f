"""Traffic driver `score_windows`: one client scoring windows one at a time
through the port's hg38 eval entry, `evals/hg38_inference.py::run_eval`.

Set-up builds the kernels, the eval preset's model in float32 with the
benchmark's weights, and a pool of windows drawn from the seed, then runs
one window through `run_eval` to warm its shape. The window then feeds
`run_eval` from a loader that hands over the pool's windows in turn
(numpy arrays, as the eval's loader yields them) until `--seconds` have
passed. Each window is timed from the loader's hand-off to the loader
being asked for the next one: the copy to the card, the forward, the NLL
and `Perplexity.update`'s sync. `score_tokens_per_s` is the bases scored
(the perplexity's count) over the wall time from the first hand-off to
`run_eval`'s return; `score_window_p90_ms` the 90th percentile of every
window's time.

A forward hook keeps the logits of a few windows drawn from the seed, and
the benchmark takes their NLL sums. Once the window has closed and the
program is freed, the plain reference scores each pool window that was
served; those windows' NLL sums and the run's perplexity are compared.
"""

from __future__ import annotations

import gc
import math
import random
import sys
from time import perf_counter as now

import torch

from benchmark.harness import feed, port
from benchmark.harness.compare import score_numbers
from benchmark.harness.trace import Span, profile
from benchmark.reference import hyena_lm as ref


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def percentile(values, pct: float) -> float:
    """Nearest-rank percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100 * len(ordered)) - 1)]


def reference_scores(cell, seed: int, pool, used, device, q=ref.identity):
    """{pool index: NLL sum} of the reference over the pool windows in `used`."""
    cfg = cell.model_cfg
    params = {**ref.make_params(cfg, seed, device), **ref.buffers(cfg, device)}
    nll = {}
    with torch.no_grad():
        for i in sorted(used):
            x, y = (torch.as_tensor(a, device=device) for a in pool[i])
            nll[i] = float(ref.nll(ref.forward(params, x, cfg, q=q), y).double().sum())
    return nll


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    t = cell.traffic
    on_card = device.type == "cuda"
    if on_card:
        port.set_numerics()
        port.build_kernels()
        log(f"kernels ready at {now() - t_start:.2f} s")
    cfg = cell.model_cfg
    params = ref.make_params(cfg, seed, device)
    model = port.eval_model(cell.recipe, params, ref.buffers(cfg, device), device)
    log(f"model ready at {now() - t_start:.2f} s")
    pool = feed.score_pool(seed, int(t["pool"]), int(t["window"]), t["gc_range"])
    log(f"pool ready at {now() - t_start:.2f} s")
    port.run_eval(model, pool[:1], device)  # warm the window's shape
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    sampled = set(random.Random(feed.mix(seed, "sample")).sample(
        range(int(t["sample_within"])), int(t["sampled_windows"])))
    setup_s = now() - t_start
    log(f"set-up {setup_s:.2f} s")

    served, times, kept = [], [], {}
    state = {"n": 0, "record": True}

    def keep(_module, _inputs, out):
        if state["record"] and state["n"] in sampled:
            kept[state["n"]] = out.detach().clone()

    # host ranges in sequence around run_eval's work on a window: the copy to
    # the card (hand-off to forward), the forward, the NLL and metric update
    # (forward's end to the next request to the loader)
    copy, forward, update = Span("bench.copy_in"), Span("bench.forward"), Span("bench.nll_update")

    def before(*_):  # a hook that returns None leaves the call's inputs and output alone
        copy.close()
        forward.open()

    def after(*_):
        forward.close()
        update.open()

    hooks = [model.register_forward_pre_hook(before), model.register_forward_hook(keep),
             model.register_forward_hook(after)]

    def loader(limit_s: float, limit_n: int, record: bool):
        start = now()
        while True:
            i = state["n"] % len(pool)
            with torch.profiler.record_function("bench.loader_handoff"):
                handed = now()
            copy.open()
            yield pool[i]
            update.close()
            if record:
                times.append(now() - handed)
                served.append(i)
            state["n"] += 1
            if now() - start >= limit_s or state["n"] >= limit_n:
                return

    t0 = now()
    ppl = port.run_eval(model, loader(seconds, 1 << 62, True), device)
    if on_card:
        torch.cuda.synchronize(device)
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    result = {"metrics": {"setup_s": setup_s, "score_tokens_per_s": ppl.count / window_s,
                          "score_window_p90_ms": 1e3 * percentile(times, 90)},
              "attempted": len(served), "failed": 0, "peak_bytes": peak}
    prog_ppl = ppl.compute()
    log(f"window {window_s:.2f} s, {len(served)} windows, peak {peak / 2**30:.2f} GiB")
    used = set(served)
    state["record"] = False
    if trace:
        n_traced = int(t.get("trace_windows", 8))
        before = port.launches()
        mark = state["n"]
        t1 = now()
        tr = profile(lambda: port.run_eval(model, loader(float("inf"), mark + n_traced, False),
                                           device))
        log(f"traced {n_traced} windows in {now() - t1:.2f} s")
        result["trace"] = tr
        result["context"] = {
            "cell": cell, "trace": tr, "rate": ppl.count / window_s, "peak_bytes": peak,
            "calls": {k: v - before[k] for k, v in port.launches().items()},
            "rows": 1, "length": int(t["window"]), "u_size": 4}
    for h in hooks:
        h.remove()

    # the comparison, with the program freed
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = now()
    ref_nll = reference_scores(cell, seed, pool, used, device)
    log(f"reference {now() - t1:.2f} s over {len(used)} windows")
    count = sum(pool[i][1].size for i in served)
    ref_ppl = math.exp(sum(ref_nll[i] for i in served) / count)
    prog_logits = {served[n]: v for n, v in kept.items()}
    prog_nll = {i: float(ref.nll(v, torch.as_tensor(pool[i][1], device=device)).double().sum())
                for i, v in prog_logits.items()}
    result["numbers"] = score_numbers(prog_nll, {i: ref_nll[i] for i in prog_nll},
                                      prog_ppl, ref_ppl)
    return result
