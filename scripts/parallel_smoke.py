#!/usr/bin/env python3
"""Phases 10-12 of `chip_smoke.py` alone: build the port's kernels,
write phase 6's synthetic genome, then the data- and sequence-parallel
phase (10a-10d), the tensor-parallel phase (11a-11d) and the mesh's
remaining combinations (12a-12e), each on 4 ranks.

    python3 scripts/parallel_smoke.py [--phases 10,11,12]

On one card the ranks share it over gloo; on a host with 4 cards each
rank takes its own and the backend rule (`parallel/launch.py`) gives NCCL.
Prints the phases' lines and the cards' names and power limits; exits
non-zero if a check fails or there is no card.
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description="phases 10-12 of chip_smoke.py")
    parser.add_argument("--phases", default="10,11,12", help="comma-separated: 10, 11, 12")
    phases = set(parser.parse_args().phases.split(","))

    if not torch.cuda.is_available():
        print("parallel_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hyena_dna_tpu_torch import _cuda
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    kernels = C.port_kernels()
    C.log({"torch": torch.__version__, "cuda": torch.version.cuda,
           "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]})
    t0 = time.perf_counter()
    _cuda.build_all(kernels)
    C.log({"phase": "build", "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(ROOT / "scripts" / "make_synthetic_genome.py"),
                        str(tmp / "genome"), "--bases", "4000000", "--chroms", "2",
                        "--seed", "18"], check=True, timeout=600, capture_output=True)
        if "10" in phases:
            C.parallel_phase(FB, kernels, tmp, seed=22)
        if "11" in phases:
            C.tp_phase(FF, FB, kernels, tmp, seed=23)
        if "12" in phases:
            C.mesh_rest_phase(FF, kernels, tmp, seed=24)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
