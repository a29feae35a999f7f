"""Traffic driver `train_step`: a closed loop of optimizer steps of the
port's pretraining step, on token rows drawn from the seed.

Set-up builds the kernels (the first run in a checkout compiles them), the
benchmark's weights on the card, the model through the registry, the
optimizer and `make_train_step` as the trainer makes them, then drives
that one object through the mix's `steps_followed` first steps on the
window's own feed; their losses and target counts, Adam's first moment
after step 1 and the parameters after the last of them are kept for the
comparison. The window
then runs whole steps, each ended by a device sync, until `--seconds` have
passed: `train_tokens_per_s` is every target token of those steps over
the wall time from the first step's start to the sync after the last.
With `--trace 1` a few more steps run under the profiler. Last, with the
program freed, the plain reference follows the same first steps from the
same weights, batches and dropout masks.
"""

from __future__ import annotations

import gc
import sys
from time import perf_counter as now

import torch

from benchmark.harness import feed, port
from benchmark.harness.compare import train_numbers
from benchmark.harness.trace import profile
from benchmark.reference import hyena_lm as ref


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def shapes(cell):
    """(accumulate, rows a micro-batch, tokens a row) of the mix, checked
    against its recipe."""
    t = cell.traffic
    recipe = cell.recipe
    accum = int(recipe["trainer"]["accumulate_grad_batches"])
    micro = recipe["batch_size"]  # one card holds every data rank's rows of a micro-batch
    if (t["accumulate"], t["micro_rows"], t["max_length"]) != (accum, micro, recipe["max_length"]):
        raise ValueError(f"the mix {t} does not run its recipe's step "
                         f"({accum} x {micro} rows of {recipe['max_length']})")
    return accum, micro, recipe["max_length"]


def follow(cell, seed: int, device, q=ref.identity, conv_round=ref.bf16_round, micro_keep=None):
    """The reference through the mix's first steps from the seed's weights:
    (losses, target tokens a step, the first gradient by leaf, each leaf's
    change). `q`,
    `conv_round` and `micro_keep` put a control or a fault in its place."""
    accum, micro, length = shapes(cell)
    cfg = cell.model_cfg
    params = ref.make_params(cfg, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    bufs = ref.buffers(cfg, device)
    dtype = port.DTYPES[str(cell.recipe["trainer"]["precision"])]
    masks = feed.dropout_masks(seed, (micro, length - 1, cfg["d_model"]), dtype,
                               cfg["embed_dropout"], device)
    k = int(cell.traffic["steps_followed"])
    batches = (feed.train_batch(seed, s, accum * micro, length, cell.traffic["gc_range"], device)
               for s in range(k))
    run = dict(cell.recipe, layer_optim=cfg["layer"])
    losses, counts, grads, _ = ref.train_steps(
        params, bufs, batches, cfg, run, masks, q, conv_round,
        int(cell.traffic.get("reference_row_block", 0)), micro_keep=micro_keep)
    change = {n: params[n] - start[n] for n in grads}
    return losses, counts, grads, change


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    accum, micro, length = shapes(cell)
    rows = accum * micro
    gc_range = cell.traffic["gc_range"]
    on_card = device.type == "cuda"
    if on_card:
        port.set_numerics()
        port.build_kernels()
        log(f"kernels ready at {now() - t_start:.2f} s")
    cfg = cell.model_cfg
    params = ref.make_params(cfg, seed, device)
    model = port.train_model(cell.recipe, params, ref.buffers(cfg, device), device)
    state, step = port.train_state(cell.recipe, model)
    log(f"model and optimizer ready at {now() - t_start:.2f} s")
    gen = torch.Generator(device=device).manual_seed(feed.dropout_seed(seed))
    b1 = port.betas(state)[0]

    # set-up: the first steps, which the reference follows
    losses, counts, grads = [], [], {}
    for s in range(int(cell.traffic["steps_followed"])):
        out = step(state, feed.train_batch(seed, s, rows, length, gc_range, device), gen)
        losses.append(float(out["loss"]))
        counts.append(float(out["token_count"]))
        log(f"followed step {s} done at {now() - t_start:.2f} s")
        if s == 0:
            grads = {n: m / (1 - b1) for n, m in port.first_moments(state).items()}
    moved = {n: p.detach().clone() for n, p in model.named_parameters()}
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = now() - t_start
    log(f"set-up {setup_s:.2f} s, losses of the followed steps {losses}")

    # the window
    s = len(losses)
    before = port.launches()
    attempted = failed = 0
    t0 = now()
    while True:
        attempted += 1
        try:
            with torch.profiler.record_function("bench.feed"):
                batch = feed.train_batch(seed, s, rows, length, gc_range, device)
            with torch.profiler.record_function("bench.step"):
                step(state, batch, gen)
            if on_card:
                torch.cuda.synchronize(device)
        except RuntimeError as err:  # a step that fails (out of memory) ends the window
            log(f"step {s} failed: {err}")
            failed += 1
            break
        s += 1
        if now() - t0 >= seconds:
            break
    window_s = now() - t0
    done = attempted - failed
    window_launches = {k: v - before[k] for k, v in port.launches().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rate = done * rows * (length - 1) / window_s
    log(f"window {window_s:.2f} s, {done} steps, peak {peak / 2**30:.2f} GiB")

    result = {"metrics": {"setup_s": setup_s, "train_tokens_per_s": rate},
              "attempted": attempted, "failed": failed, "peak_bytes": peak}
    if trace:
        n_traced = int(cell.traffic.get("trace_steps", 1))
        before = port.launches()

        def steps():
            nonlocal s
            for _ in range(n_traced):
                with torch.profiler.record_function("bench.feed"):
                    batch = feed.train_batch(seed, s, rows, length, gc_range, device)
                with torch.profiler.record_function("bench.step"):
                    step(state, batch, gen)
                s += 1

        t1 = now()
        tr = profile(steps)
        log(f"traced {n_traced} steps in {now() - t1:.2f} s")
        result["trace"] = tr
        result["context"] = {
            "cell": cell, "trace": tr, "rate": rate, "peak_bytes": peak,
            "calls": {k: v - before[k] for k, v in port.launches().items()},
            "window_launches": window_launches, "window_micro_steps": done * accum,
            "rows": micro, "length": length - 1, "rows_per_step": rows,
            "u_size": torch.finfo(port.DTYPES[str(cell.recipe["trainer"]["precision"])]).bits // 8}

    # the comparison, with the program freed
    prog_change = {n: moved[n] - params[n] for n in moved}
    del state, step, model, moved, gen
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = now()
    ref_losses, ref_counts, ref_grads, ref_change = follow(cell, seed, device)
    log(f"reference {now() - t1:.2f} s, losses {ref_losses}")
    result["numbers"] = train_numbers((losses, counts, grads, prog_change),
                                      (ref_losses, ref_counts, ref_grads, ref_change))
    return result
