"""The benchmark of the PyTorch / CUDA port of HyenaDNA.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; the cells are listed in `BENCHMARK.json`. See
`benchmark/README.md`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    sys.path.insert(0, str(ROOT))
    # caches of any library that builds kernels stay in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness.core import main

    sys.exit(main(args, T_START))
