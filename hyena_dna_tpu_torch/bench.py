"""Train-step throughput of the hg38 LM on the card (the port of `bench.py`).

    python -m hyena_dna_tpu_torch.bench [--batch 4 --length 32768 --d_model 256 --n_layer 8]

One train step of `ConvLMHeadModel` (forward, backward, global-norm clip,
AdamW) as the JAX `bench.py` runs it: d_model 256, 8 layers, d_inner 4 d,
order-2 Hyena (emb_dim 5, filter_order 64, w 10, l_max L + 2), vocabulary 12
padded to 16, float32 residual, embedding dropout 0.1 with masks from a
seeded `torch.Generator`, `build_optimizer(lr=6e-4, weight_decay=0.1)` and
the tiled synthetic batch x = (t % 4) + 7, y = x rolled by one. Weights are
random, from `--seed`. Activations are float32 (the JAX trainer's default
precision); the conv I/O is bfloat16 from L = 2^15, as in the model.

It runs `--warmup` steps, then `--windows` windows of `--steps` steps, each
window between `torch.cuda.synchronize()` calls, and keeps the best window.
It prints one JSON line,
  {"metric": "hg38_trainstep_tokens_per_sec_L{L}_d{d}x{n}_fp32", "value": ...,
   "unit": "tokens/s", "precision": "fp32", ...}
and returns it as a dict with every step's loss. It runs on the card unless
`--device cpu` is given (the kernels' plain versions, at the shape given).
A failure raises; there is no fallback shape.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model, resolve_device
from hyena_dna_tpu_torch.tasks import LMTask
from hyena_dna_tpu_torch.train import build_optimizer, create_train_state, make_train_step


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
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    args = ap.parse_args(argv)
    if args.precision != "fp32":
        raise NotImplementedError(
            "bf16 activations need a model dtype and kernels A/A' on bf16 u "
            "(ROADMAP.md, the port's next slice, item 1: bf16 activations)")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = build_model(args.d_model, args.n_layer, args.length,
                        generator=torch.Generator().manual_seed(args.seed)).to(device)
    optimizer, _ = build_optimizer(model, lr=6e-4, weight_decay=0.1)
    state = create_train_state(model, optimizer)
    step = make_train_step(LMTask())
    batch = synthetic_batch(args.batch, args.length, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    losses = []

    def run(n: int) -> None:
        for _ in range(n):
            losses.append(step(state, batch, generator)["loss"])

    run(args.warmup)
    best = float("inf")
    for _ in range(args.windows):
        _sync(device)
        t0 = time.perf_counter()
        run(args.steps)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    tokens = args.batch * args.length
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {
        "metric": f"hg38_trainstep_tokens_per_sec_L{args.length}_d{args.d_model}x{args.n_layer}_fp32",
        "value": tokens * args.steps / best, "unit": "tokens/s", "precision": "fp32",
        "device": name, "batch": args.batch, "length": args.length,
        "step_ms": best / args.steps * 1e3, "steps_per_window": args.steps,
        "windows": args.windows, "steps_run": len(losses),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
    }
    print(json.dumps(result), flush=True)
    result["losses"] = [float(v) for v in losses]
    return result


if __name__ == "__main__":
    main()
