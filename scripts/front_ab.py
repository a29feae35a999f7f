#!/usr/bin/env python3
"""Kernels A, A', A4 and A4' of the checkout at ROOT at the main paths'
shapes, timed by that checkout's own `chip_smoke.py` (CUDA events around
repeated launches): A and A' at B 4, L 32768, d 256, A4 and A4' at the 1M
step's 1 x 1,000,448 (plan (16, 512, 256)), each in float32 and bf16.

    python3 scripts/front_ab.py ROOT build    # build the four libraries only
    python3 scripts/front_ab.py ROOT time     # one JSON line of ms
    python3 scripts/front_ab.py ROOT passes   # device ms of each kernel of one A' call

`passes` profiles one call of A' at 4 x 32768 x 256 in each dtype with
`torch.profiler` and prints the device ms of each kernel it launched (the
split-W pass, A'1, A'2, the sums). To compare a parent with a change on one
card, unpack the parent into a git-ignored directory (`git archive`), build
both, then time parent, change, change, parent in one call.
"""

import json
import sys
from collections import defaultdict
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))

import chip_smoke as C  # noqa: E402
from hyena_dna_tpu_torch import _cuda  # noqa: E402
from hyena_dna_tpu_torch.ops import fused_front as FF  # noqa: E402
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics  # noqa: E402

PLAN_1M = (16, 512, 256)

set_card_numerics()
_cuda.build_all([FF.KERNEL, FF.KERNEL_BWD, FF.KERNEL4, FF.KERNEL4_BWD])
out = {"tree": sys.argv[1]}
if sys.argv[2] == "time":
    for dt in ("float32", "bfloat16"):
        out[f"A {dt}"] = C.check_front(FF, 4, 32768, 1, dt)["ms"]
        out[f"A' {dt}"] = C.check_front_bwd(FF, 4, 32768, 8, dt)["ms"]
        out[f"A4 {dt}"] = C.check_front4(FF, 1, 1000448, PLAN_1M, dt, 50)["ms"]
        out[f"A4' {dt}"] = C.check_front4_bwd(FF, 1, 1000448, PLAN_1M, dt, 51)["ms"]
elif sys.argv[2] == "passes":
    import torch
    from torch.profiler import ProfilerActivity, profile

    for dt in ("float32", "bfloat16"):
        g, (u, w, bp, wc, bc) = C.front_inputs(4, 32768, dt, 8)
        cot = [torch.randn(4, 256, 32768, device="cuda", generator=g).to(u.dtype)
               for _ in range(2)]
        FF.front_bwd(u, w, bp, wc, bc, *cot)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                FF.front_bwd(u, w, bp, wc, bc, *cot)
            torch.cuda.synchronize()
        ms = defaultdict(float)
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t and e.device_type == torch.autograd.DeviceType.CUDA:
                ms[e.key.split("(")[0][:80]] += t / 5e3
        out[dt] = dict(sorted(ms.items(), key=lambda kv: -kv[1]))
print(json.dumps(out), flush=True)
