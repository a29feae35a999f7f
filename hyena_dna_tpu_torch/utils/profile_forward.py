"""Where one forward pass spends its time on the card.

    python -m hyena_dna_tpu_torch.utils.profile_forward --batch 4 --length 32768

Builds the hg38 model of `evals/hg38_inference.py` (d_model 256, 8 layers by
default, random weights from `--seed`), runs one forward to warm up, then:

* times `--reps` forwards with CUDA events (`forward_ms`);
* profiles one forward with `torch.profiler` and sums the device time of
  its kernels into groups: kernel A (`fused_front_kernel`), kernel B (its
  four passes), matrix products (cuBLAS), and the rest (elementwise, LN,
  embedding, filter MLP glue); `device_idle_share` is 1 - busy / wall over
  the profiled forward.

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

GROUPS = (("kernel_a", ("fused_front_kernel",)),
          ("kernel_b", ("cols_fwd_kernel", "rows_fwd_kernel", "rows_conv_kernel",
                        "cols_inv_kernel")),
          ("matmul", ("gemm", "sm90_", "cutlass", "ampere_", "cublas")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--length", type=int, default=32768)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layer", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward measures the card; no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(args.d_model, args.n_layer, args.length,
                        generator=torch.Generator().manual_seed(args.seed))
    model = model.to("cuda").eval()
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        7, 12, size=(args.batch, args.length))).to("cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        model(tokens)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            model(tokens)
        end.record()
        torch.cuda.synchronize()
        forward_ms = start.elapsed_time(end) / args.reps

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            model(tokens)
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
    print(json.dumps({
        "card": smi, "batch": args.batch, "length": args.length, "d_model": args.d_model,
        "n_layer": args.n_layer, "forward_ms": forward_ms,
        "tokens_per_s": args.batch * args.length / forward_ms * 1e3,
        "profiled_forward_ms": profiled_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / profiled_ms if profiled_ms else None,
        "device_ms_by_group": dict(device_ms),
        "top_kernels_ms": [[name[:80], ms] for name, ms in top]}))


if __name__ == "__main__":
    main()
