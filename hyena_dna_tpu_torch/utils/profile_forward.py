"""Where one forward pass, or one train step, spends its time on the card.

    python -m hyena_dna_tpu_torch.utils.profile_forward --batch 4 --length 32768
    python -m hyena_dna_tpu_torch.utils.profile_forward --train --batch 4 --length 32768

Builds the hg38 model of `evals/hg38_inference.py` (d_model 256, 8 layers by
default, random weights from `--seed`), warms up, then:

* times `--reps` forwards (or, with `--train`, train steps of
  `train/step.py` with `bench.py`'s optimizer and synthetic batch) with CUDA
  events: `forward_ms` or `step_ms`. With `--train` it also splits one step
  by CUDA events into forward (with the loss), backward and optimizer (clip
  and AdamW): `phase_ms`;
* profiles one forward (or step) with `torch.profiler` and sums the device
  time of its kernels into groups: kernels A (`fused_front_kernel`), A'
  (`front_bwd_*`), B (`conv_fwd::*`, its four passes), C (`conv_bwd::*`),
  matrix products (cuBLAS), and the rest (elementwise, LN, embedding,
  filter MLP, optimizer); `device_idle_share` is 1 - busy / wall over the
  profiled forward or step.

Prints one JSON line with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import numpy as np
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model

GROUPS = (("kernel_a_bwd", ("front_bwd_",)),
          ("kernel_a", ("fused_front_kernel",)),
          ("kernel_b", ("conv_fwd::",)),
          ("kernel_c", ("conv_bwd::",)),
          ("matmul", ("gemm", "sm90_", "cutlass", "ampere_", "cublas")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _forward_runner(model, args):
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        7, 12, size=(args.batch, args.length))).to("cuda")
    model.eval()

    def run():
        with torch.inference_mode():
            model(tokens)

    return run


def _train_runner(model, args):
    from hyena_dna_tpu_torch.bench import synthetic_batch
    from hyena_dna_tpu_torch.tasks import LMTask
    from hyena_dna_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    optimizer, _ = build_optimizer(model, lr=6e-4, weight_decay=0.1)
    state = create_train_state(model, optimizer)
    task, batch = LMTask(), synthetic_batch(args.batch, args.length, "cuda")
    step = make_train_step(task)
    generator = torch.Generator(device="cuda").manual_seed(args.seed)

    def phases():
        """One step as `make_train_step` runs it, with an event between phases."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        for p in model.parameters():
            p.grad = None
        events[0].record()
        loss = task.compute_loss(model(batch[0], generator=generator), batch[1])
        events[1].record()
        loss.backward()
        events[2].record()
        state.apply_gradients()
        events[3].record()
        torch.cuda.synchronize()
        return {name: events[i].elapsed_time(events[i + 1])
                for i, name in enumerate(("forward", "backward", "optimizer"))}

    return (lambda: step(state, batch, generator)), phases


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--length", type=int, default=32768)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layer", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile a train step (forward, backward, clip, AdamW)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward measures the card; no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(args.d_model, args.n_layer, args.length,
                        generator=torch.Generator().manual_seed(args.seed)).to("cuda")
    phase_ms = None
    if args.train:
        run, phases = _train_runner(model, args)
    else:
        run = _forward_runner(model, args)
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        run()
    end.record()
    torch.cuda.synchronize()
    mean_ms = start.elapsed_time(end) / args.reps
    if args.train:
        phase_ms = phases()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end)

    device_ms = defaultdict(float)
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t and evt.device_type == torch.autograd.DeviceType.CUDA:
            device_ms[_group(evt.key)] += t / 1e3
            kernels[evt.key] += t / 1e3
    busy = sum(device_ms.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    what = "step" if args.train else "forward"
    print(json.dumps({
        "card": smi, "mode": what, "batch": args.batch, "length": args.length,
        "d_model": args.d_model, "n_layer": args.n_layer, f"{what}_ms": mean_ms,
        "tokens_per_s": args.batch * args.length / mean_ms * 1e3,
        "phase_ms": phase_ms, f"profiled_{what}_ms": profiled_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / profiled_ms if profiled_ms else None,
        "device_ms_by_group": dict(device_ms),
        "top_kernels_ms": [[name[:80], ms] for name, ms in top]}))


if __name__ == "__main__":
    main()
