"""Readings of a cell's control and faults, for setting the limits that
decide `correct` (not run by the benchmark's own runs).

    python3 benchmark/controls.py --workload <cell> --seeds 11 12 13 [--faults]

For each seed, the reference put in the program's place at the cell's own
size is compared with the reference by the cell's numbers:
* `control`: the reference one precision below what the configuration
  states (TF32 for a float32 configuration, fp8 for a bfloat16 one);
* with `--faults`, a training cell's `half_batch` (half of each step's
  micro-batches, the mean taken over the rest).
A state left unchanged reads 1 on `change_gap` by the measure and needs no
run. One JSON line per reading; the cell's limits beside them.
"""

import argparse
import json
import math
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, faults: bool):
    import torch

    from benchmark.harness import feed
    from benchmark.harness.compare import score_numbers, train_numbers
    from benchmark.harness.manifest import load_driver
    from benchmark.reference import control, hyena_lm as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = load_driver(cell)
    t = cell.traffic
    if t["driver"] == "train_step":
        base = driver.follow(cell, seed, device)
        runs = {"control": dict(q=control.fp8_round, conv_round=control.fp8_round)}
        if faults:
            runs["half_batch"] = dict(micro_keep=lambda i: i < t["accumulate"] // 2)
        for name, kw in runs.items():
            yield name, train_numbers(driver.follow(cell, seed, device, **kw), base)
    else:
        pool = feed.score_pool(seed, int(t["pool"]), int(t["window"]), t["gc_range"])
        sampled = random.Random(feed.mix(seed, "sample")).sample(
            range(int(t["sample_within"])), int(t["sampled_windows"]))
        keep = {n % len(pool) for n in sampled}
        used = set(range(len(pool)))
        nll = driver.reference_scores(cell, seed, pool, used, device)
        cnll = driver.reference_scores(cell, seed, pool, used, device, q=control.tf32_round)
        count = sum(pool[i][1].size for i in used)
        ppl = lambda d: math.exp(sum(d.values()) / count)
        yield "control", score_numbers({i: cnll[i] for i in keep}, {i: nll[i] for i in keep},
                                       ppl(cnll), ppl(nll))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.manifest import find_cell

    cell = find_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        for name, numbers in readings(cell, seed, device, args.faults):
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "numbers": {k: v[0] for k, v in numbers.items()},
                              "at": {k: v[1] for k, v in numbers.items()},
                              "limits": cell.settings["limits"],
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
