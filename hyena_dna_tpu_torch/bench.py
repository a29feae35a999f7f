"""Train-step throughput of the hg38 LM on the card (the port of `bench.py`).

    python -m hyena_dna_tpu_torch.bench [--batch 4 --length 32768 --d_model 256 --n_layer 8]
                                        [--precision fp32|bf16] [--residual bf16|fp32]
                                        [--gated_conv off|specv|spec|retransform]
                                        [--remat off|block|residual] [--remat_group_size N]
                                        [--save_filter] [--no_save_conv] [--front4]

One train step of `ConvLMHeadModel` (forward, backward, global-norm clip,
AdamW) as the JAX `bench.py` runs it: d_model 256, 8 layers, d_inner 4 d,
order-2 Hyena (emb_dim 5, filter_order 64, w 10, l_max L + 2), vocabulary 12
padded to 16, embedding dropout 0.1 with masks from a seeded
`torch.Generator`, `build_optimizer(lr=6e-4, weight_decay=0.1)` on float32
master parameters and the tiled synthetic batch x = (t % 4) + 7, y = x
rolled by one. Weights are random, from `--seed`. The conv I/O is bfloat16
from L = 2^15 at either precision, as in the model.

`--precision fp32` (the default): float32 activations and residual.
`--precision bf16`: the JAX `bench.py` headline step, bfloat16 activations
(the model `dtype` every hg38 config sets with `precision: bf16`) and a
bfloat16 residual stream (the JAX bench's default, `BENCH_RESIDUAL_F32`
unset), where the residual add + LN runs kernels D and D'. The loss is
float32 either way. `--gated_conv` (default `off`) folds the Hyena post-gate
into the conv, kernels E and E' on that mode's backward route, as
`HYENA_GATED_CONV=1 HYENA_GATED_MODE=...` does for the JAX `bench.py`.
`--residual` sets the residual stream's dtype apart from `--precision`
(the JAX `BENCH_RESIDUAL_F32`; by default it follows `--precision`).
`--front4` takes the 4-D conv-layout route (kernels A4 and A4') where it
engages, as `HYENA_FRONT4=1` does. `--remat` checkpoints activations, as
the JAX `scripts/bench_long_context.py` modes do: `block` cells (its 450k
mode, with `--save_filter` for `remat_save_filter`) or `residual` cells
(its 1m mode, and `hg38_large_1m_singlechip.yaml` with
`--remat_group_size 2`); `--no_save_conv` drops `remat_save_conv`. Matrix
products run without TF32 and bf16 products accumulate in float32
(`utils/numerics.py::set_card_numerics`), as the TPU's matrix unit does.

The long-context steps on one card:
  python -m hyena_dna_tpu_torch.bench --precision bf16 --residual fp32 --batch 1 \
      --length 1000448 --remat residual --remat_group_size 2 [--front4]
  python -m hyena_dna_tpu_torch.bench --precision bf16 --batch 1 --length 450048 \
      --remat block --save_filter

It runs `--warmup` steps, then `--windows` windows of `--steps` steps, each
window between `torch.cuda.synchronize()` calls, and keeps the best window
(every window's time per step is in `window_step_ms`). It prints one JSON
line,
  {"metric": "hg38_trainstep_tokens_per_sec_L{L}_d{d}x{n}_{precision}[_res{residual}]"
             "[_gated_{mode}][_remat_{mode}[_g{N}][_savefilter][_noconvsave]][_front4]",
   "value": ..., "unit": "tokens/s", "precision": "fp32" or "bf16", "residual": ...,
   "gated_conv": "off" or the mode, "remat": ..., "front4": ..., "peak_memory_gib": ...}
(`_res...` where the residual differs from the precision, `_g{N}` for
residual cells), and returns it as a dict with every step's loss.
`peak_memory_gib` is the card's peak allocation over the steps, read after
`torch.cuda.reset_peak_memory_stats` (None on the CPU). It runs on the card
unless `--device cpu` is given (the kernels' plain versions, at the shape
given). A failure raises; there is no fallback shape.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model, resolve_device
from hyena_dna_tpu_torch.ops.fftconv import GATED_MODES
from hyena_dna_tpu_torch.tasks import LMTask
from hyena_dna_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics


def synthetic_batch(batch: int, length: int, device) -> tuple:
    x = torch.from_numpy(np.tile((np.arange(length) % 4 + 7).astype(np.int64), (batch, 1)))
    return x.to(device), torch.roll(x, -1, dims=1).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--length", type=int, default=32768)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layer", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10, help="steps per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                    help="activation dtype (the model's `dtype`)")
    ap.add_argument("--gated_conv", default="off", choices=("off",) + GATED_MODES,
                    help="the gate-fused conv (kernels E, E') and its backward route")
    ap.add_argument("--residual", default=None, choices=("bf16", "fp32"),
                    help="residual stream dtype (default: as --precision)")
    ap.add_argument("--remat", default="off", choices=("off", "block", "residual"),
                    help="activation checkpointing cells")
    ap.add_argument("--remat_group_size", type=int, default=1,
                    help="residual cells per outer cell")
    ap.add_argument("--save_filter", action="store_true",
                    help="save the filter banks across cells (remat_save_filter)")
    ap.add_argument("--no_save_conv", action="store_true",
                    help="recompute the conv outputs (remat_save_conv off)")
    ap.add_argument("--front4", action="store_true",
                    help="the 4-D conv-layout route (kernels A4, A4') where it engages")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_card_numerics()

    bf16 = args.precision == "bf16"
    residual = args.residual or args.precision
    model = build_model(args.d_model, args.n_layer, args.length,
                        generator=torch.Generator().manual_seed(args.seed),
                        dtype=torch.bfloat16 if bf16 else torch.float32,
                        residual_in_fp32=residual == "fp32",
                        gated_conv=None if args.gated_conv == "off" else args.gated_conv,
                        front4=args.front4, checkpoint_mixer=args.remat != "off",
                        remat_residual_only=args.remat == "residual",
                        remat_group_size=args.remat_group_size,
                        remat_save_conv=not args.no_save_conv,
                        remat_save_filter=args.save_filter).to(device)
    optimizer, _ = build_optimizer(model, lr=6e-4, weight_decay=0.1)
    state = create_train_state(model, optimizer)
    step = make_train_step(LMTask())
    batch = synthetic_batch(args.batch, args.length, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    losses = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def run(n: int) -> None:
        for _ in range(n):
            losses.append(step(state, batch, generator)["loss"])

    run(args.warmup)
    windows = []
    for _ in range(args.windows):
        _sync(device)
        t0 = time.perf_counter()
        run(args.steps)
        _sync(device)
        windows.append(time.perf_counter() - t0)
    best = min(windows)
    tokens = args.batch * args.length
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    suffix = "" if residual == args.precision else f"_res{dict(fp32='f32', bf16='bf16')[residual]}"
    suffix += "" if args.gated_conv == "off" else f"_gated_{args.gated_conv}"
    if args.remat != "off":
        suffix += f"_remat_{args.remat}"
        suffix += f"_g{args.remat_group_size}" if args.remat == "residual" else ""
        suffix += "_savefilter" * args.save_filter + "_noconvsave" * args.no_save_conv
    suffix += "_front4" * args.front4
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda"
            else None)
    result = {
        "metric": (f"hg38_trainstep_tokens_per_sec_L{args.length}_d{args.d_model}"
                   f"x{args.n_layer}_{args.precision}{suffix}"),
        "value": tokens * args.steps / best, "unit": "tokens/s", "precision": args.precision,
        "residual": residual, "gated_conv": args.gated_conv, "remat": args.remat,
        "remat_group_size": args.remat_group_size, "remat_save_conv": not args.no_save_conv,
        "remat_save_filter": args.save_filter, "front4": args.front4,
        "peak_memory_gib": peak,
        "device": name, "batch": args.batch, "length": args.length,
        "step_ms": best / args.steps * 1e3, "steps_per_window": args.steps,
        "windows": args.windows, "window_step_ms": [t / args.steps * 1e3 for t in windows],
        "steps_run": len(losses),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
    }
    print(json.dumps(result), flush=True)
    result["losses"] = [float(v) for v in losses]
    return result


if __name__ == "__main__":
    main()
