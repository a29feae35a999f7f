"""One run of one cell: check the cards, drive the cell's traffic, decide
`correct`, read the metrics and print the result line.

The result is the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside its
limit. Those numbers are also the last lines of standard error. No result
is printed, and the exit code is not 0, when the cell asks for more cards
than the machine has, or when a JAX module is loaded once the window has
closed.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness.manifest import ROOT, find_cell, load_driver, load_readers

BANNED = ("jax", "jaxlib", "flax", "hyena_dna_tpu")


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def power_limit():
    """`nvidia-smi`'s name and power limit of each card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             root: Path = ROOT, device: str = "cuda"):
    """(exit code, result dict or None). `device="cpu"` skips the look for
    cards and runs the program's plain versions (the harness's tests)."""
    import torch

    cell = find_cell(name, root)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"cell {name} needs {cell.chips} CUDA card(s), this machine has {have}",
                  file=sys.stderr)
            return 2, None
    out = load_driver(cell).run(cell, seed, seconds, trace, torch.device(device), t_start)
    loaded = banned_modules()
    if loaded:
        print(f"JAX modules are loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3, None

    from benchmark.harness.compare import judge, print_checks

    correct, checks = judge(out["numbers"], cell.settings["limits"])
    correct = correct and out["failed"] == 0
    if trace:
        readers = load_readers(cell)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(out["context"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}
    if on_card:
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    print_checks(out["numbers"], cell.settings["limits"])
    return 0, result


def main(args, t_start: float) -> int:
    code, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code
