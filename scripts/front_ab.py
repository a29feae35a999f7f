#!/usr/bin/env python3
"""Kernels A and A' of the checkout at ROOT at the main path's shapes (B 4,
L 32768, d 256, float32 and bf16), timed by that checkout's own
`chip_smoke.py` (CUDA events around repeated launches):

    python3 scripts/front_ab.py ROOT build   # build the two libraries only
    python3 scripts/front_ab.py ROOT time    # one JSON line of ms

To compare a parent with a change on one card, unpack the parent into a
git-ignored directory (`git archive`), build both, then time parent,
change, change, parent in one call.
"""

import json
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))

import chip_smoke as C  # noqa: E402
from hyena_dna_tpu_torch import _cuda  # noqa: E402
from hyena_dna_tpu_torch.ops import fused_front as FF  # noqa: E402
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics  # noqa: E402

set_card_numerics()
_cuda.build_all([FF.KERNEL, FF.KERNEL_BWD])
if sys.argv[2] == "time":
    out = {"tree": sys.argv[1]}
    for dt in ("float32", "bfloat16"):
        out[f"A {dt}"] = C.check_front(FF, 4, 32768, 1, dt)["ms"]
        out[f"A' {dt}"] = C.check_front_bwd(FF, 4, 32768, 8, dt)["ms"]
    print(json.dumps(out), flush=True)
