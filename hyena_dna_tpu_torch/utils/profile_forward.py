"""Where one forward pass, or one train step, spends its time on the card.

    python -m hyena_dna_tpu_torch.utils.profile_forward --batch 4 --length 32768
    python -m hyena_dna_tpu_torch.utils.profile_forward --train --batch 4 --length 32768
    python -m hyena_dna_tpu_torch.utils.profile_forward --train --precision bf16
    python -m hyena_dna_tpu_torch.utils.profile_forward --train --precision bf16 --gated_conv specv
    python -m hyena_dna_tpu_torch.utils.profile_forward --train --precision bf16 --residual fp32 \
        --batch 1 --length 1000448 --remat residual --remat_group_size 2 [--front4] --reps 1

Builds the hg38 model of `evals/hg38_inference.py` (d_model 256, 8 layers by
default, random weights from `--seed`; float32, or with `--precision bf16`
bfloat16 activations and residual as `bench.py --precision bf16` trains
it; with `--gated_conv` the gate-fused conv of `bench.py --gated_conv`;
`--residual`, `--front4` and the activation checkpointing flags `--remat`,
`--remat_group_size`, `--save_filter`, `--no_save_conv` as `bench.py` has
them), warms up, then:

* times `--reps` forwards (or, with `--train`, train steps of
  `train/step.py` with `bench.py`'s optimizer and synthetic batch) with CUDA
  events: `forward_ms` or `step_ms`, their mean, and each one in `rep_ms`
  (recorded back to back, no synchronisation between). With `--train` it also splits one step
  by CUDA events into forward (with the loss), backward and optimizer (clip
  and AdamW): `phase_ms`;
* profiles one forward (or step) with `torch.profiler` and sums the device
  time of its kernels into groups: kernels A (`front_fwd::*`), A'
  (`front_bwd::*`), A4 (`front4_fwd::*`), A4' (`front4_bwd::*`), B
  (`conv_fwd::*`, its four passes), C (`conv_bwd::*`),
  D (`add_ln_fwd_kernel`), D' (`add_ln_bwd_kernel`, `add_ln_sum_kernel`),
  E (`conv_gfwd::*`), E' (`conv_gbwd::*`),
  SDPA's attention kernels (`flash*`, `fmha*`: the attention configs,
  which this tool does not build; `chip_smoke.py` phase 9 profiles their
  step with `profile_device`), matrix products (cuBLAS, `nvjet` for bf16
  on Hopper), and the rest
  (elementwise, float32 LN, embedding, filter MLP, optimizer);
  `device_idle_share` is 1 - busy / wall over the profiled forward or step.

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
from hyena_dna_tpu_torch.ops.fftconv import GATED_MODES
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

GROUPS = (("kernel_d_bwd", ("add_ln_bwd_kernel", "add_ln_sum_kernel")),
          ("kernel_d", ("add_ln_fwd_kernel",)),
          ("kernel_a_bwd", ("front_bwd::",)),
          ("kernel_a", ("front_fwd::",)),
          ("kernel_a4_bwd", ("front4_bwd::",)),
          ("kernel_a4", ("front4_fwd::",)),
          ("kernel_b", ("conv_fwd::",)),
          ("kernel_c", ("conv_bwd::",)),
          ("kernel_e", ("conv_gfwd::",)),
          ("kernel_e_bwd", ("conv_gbwd::",)),
          # SDPA's kernels (flash, memory-efficient) on the attention configs
          ("attention", ("flash", "fmha", "attention")),
          ("matmul", ("gemm", "sm90_", "cutlass", "ampere_", "cublas", "nvjet")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def profile_device(run):
    """Run `run()` once under `torch.profiler`: (its wall ms on CUDA events,
    device ms by group of `GROUPS`, device ms by kernel name)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    device_ms = defaultdict(float)
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        # a record_function range (the optimizer's) also shows on the device as
        # a user annotation spanning its kernels: not device time of its own
        if (t and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            device_ms[_group(evt.key)] += t / 1e3
            kernels[evt.key] += t / 1e3
    return start.elapsed_time(end), dict(device_ms), dict(kernels)


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
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                    help="activation dtype; bf16 also keeps a bf16 residual stream")
    ap.add_argument("--gated_conv", default="off", choices=("off",) + GATED_MODES,
                    help="the gate-fused conv (kernels E, E') and its backward route")
    ap.add_argument("--residual", default=None, choices=("bf16", "fp32"),
                    help="residual stream dtype (default: as --precision)")
    ap.add_argument("--front4", action="store_true", help="the 4-D conv-layout route")
    ap.add_argument("--remat", default="off", choices=("off", "block", "residual"))
    ap.add_argument("--remat_group_size", type=int, default=1)
    ap.add_argument("--save_filter", action="store_true")
    ap.add_argument("--no_save_conv", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward measures the card; no CUDA device is available")
    set_card_numerics()
    bf16 = args.precision == "bf16"
    model = build_model(args.d_model, args.n_layer, args.length,
                        generator=torch.Generator().manual_seed(args.seed),
                        dtype=torch.bfloat16 if bf16 else torch.float32,
                        residual_in_fp32=(args.residual or args.precision) == "fp32",
                        gated_conv=None if args.gated_conv == "off" else args.gated_conv,
                        front4=args.front4, checkpoint_mixer=args.remat != "off",
                        remat_residual_only=args.remat == "residual",
                        remat_group_size=args.remat_group_size,
                        remat_save_conv=not args.no_save_conv,
                        remat_save_filter=args.save_filter).to("cuda")
    phase_ms = None
    if args.train:
        run, phases = _train_runner(model, args)
    else:
        run = _forward_runner(model, args)
    run()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(args.reps + 1)]
    events[0].record()
    for e in events[1:]:
        run()
        e.record()
    torch.cuda.synchronize()
    rep_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    mean_ms = sum(rep_ms) / args.reps
    if args.train:
        phase_ms = phases()

    profiled_ms, device_ms, kernels = profile_device(run)
    busy = sum(device_ms.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    what = "step" if args.train else "forward"
    print(json.dumps({
        "card": smi, "mode": what, "precision": args.precision, "gated_conv": args.gated_conv,
        "residual": args.residual or args.precision, "front4": args.front4, "remat": args.remat,
        "remat_group_size": args.remat_group_size, "remat_save_filter": args.save_filter,
        "remat_save_conv": not args.no_save_conv,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "batch": args.batch, "length": args.length,
        "d_model": args.d_model, "n_layer": args.n_layer, f"{what}_ms": mean_ms, "rep_ms": rep_ms,
        "tokens_per_s": args.batch * args.length / mean_ms * 1e3,
        "phase_ms": phase_ms, f"profiled_{what}_ms": profiled_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / profiled_ms if profiled_ms else None,
        "device_ms_by_group": dict(device_ms),
        "top_kernels_ms": [[name[:80], ms] for name, ms in top]}))


if __name__ == "__main__":
    main()
