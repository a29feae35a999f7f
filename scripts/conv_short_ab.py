#!/usr/bin/env python3
"""Kernels B, C, E and E' of the checkout at ROOT, timed by that checkout's
own `chip_smoke.py` check functions (CUDA events around repeated launches;
each row with its plain version's and the library call's time and its bound):

    python3 scripts/conv_short_ab.py ROOT build   # build the four libraries
    python3 scripts/conv_short_ab.py ROOT check   # kernels B and C's short path sweep
    python3 scripts/conv_short_ab.py ROOT time    # one JSON line of every row
    python3 scripts/conv_short_ab.py ROOT time short   # the short path's rows only

`time` runs the short path's shapes (the trainer's 32 x 128 x 1024, the
species curriculum's 128 x 128 x 1024, 64 x 128 x 2048 and 32 x 128 x 4096,
all float32, fft 2^11-2^13) and the four-step rows that must not move (B and
C at 4 x 32768, 1 x 1,000,448, 1 x 450,048 and 2 x 8192; E and E' at 4 x
32768 and 2 x 65536), with chip_smoke.py's inputs and seeds. `check` needs
a checkout that has the short path.

To compare a parent with a change on one card, unpack each tree into a
git-ignored directory (`git archive`), build them all, then time parent,
change, change, parent in one call. A tree whose `kShortMaxLogN`
(csrc/fft_short.cuh) is lowered times the four-step passes at the sizes
above its cut.
"""

import json
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))

import chip_smoke as C  # noqa: E402
from hyena_dna_tpu_torch import _cuda  # noqa: E402
from hyena_dna_tpu_torch.ops import fused_fftconv as FB  # noqa: E402
from hyena_dna_tpu_torch.ops import gated_fftconv as GE  # noqa: E402
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics  # noqa: E402

TIMING = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")


def rows(short_only: bool = False):
    """(label, row) of every timed row, in chip_smoke.py's arguments."""
    d, p16 = C.TRAINER_D, (256, 256, 8)
    for B, L in ((32, 1024), (128, 1024), (64, 2048), (32, 4096)):
        yield f"B {B}x{d}x{L} f32", C.check_conv(FB, B, L, "float32", "short", 102, C=d)
        yield f"C {B}x{d}x{L} f32", C.check_conv_bwd(FB, FB.fftconv_bwd_retransform, B, L,
                                                     "float32", "short", 103, C=d)
    if short_only:
        return
    yield "B 2x8192 f32", C.check_conv(FB, 2, 8192, "float32", "generic", 3)
    yield "C 2x8192 f32", C.check_conv_bwd(FB, FB.fftconv_bwd_retransform, 2, 8192, "float32",
                                           "generic", 20)
    yield "B 4x32768 bf16", C.check_conv(FB, 4, 32768, "bfloat16", "packed", 4,
                                         FB.fftconv_fused_fwd_packed, p16)
    yield "C 4x32768 bf16 spectrum", C.check_conv_bwd(FB, FB.fftconv_fused_bwd_spec_packed, 4,
                                                      32768, "bfloat16", "spec", 21, p16)
    yield "C 4x32768 bf16 retransform", C.check_conv_bwd(FB, FB.fftconv_fused_bwd_packed, 4,
                                                         32768, "bfloat16", "packed", 22, p16)
    for L, seeds in ((1000448, (7, 28)), (450048, (19, 29))):
        yield f"B 1x{L} bf16", C.check_conv(FB, 1, L, "bfloat16", "flat", seeds[0])
        yield f"C 1x{L} bf16", C.check_conv_bwd(FB, FB.fftconv_bwd_retransform, 1, L,
                                                "bfloat16", "flat", seeds[1])
    for i, variant in enumerate(("specv", "spec", "y")):
        yield f"E 4x32768 {variant}", C.check_gated(GE, 4, 32768, "bfloat16", variant, 40 + i)
    yield "E 2x65536 specv", C.check_gated(GE, 2, 65536, "bfloat16", "specv", 43)
    for i, route in enumerate(("specv", "spec", "retransform")):
        yield f"E' 4x32768 {route}", C.check_gated_bwd(GE, route, 4, 32768, "bfloat16", 44 + i)
    yield "E' 2x65536 specv", C.check_gated_bwd(GE, "specv", 2, 65536, "bfloat16", 47)


set_card_numerics()
kernels = [FB.KERNEL, FB.KERNEL_BWD, GE.KERNEL, GE.KERNEL_BWD]
_cuda.build_all(kernels)
mode = sys.argv[2]
if mode == "build":
    print(json.dumps({"tree": sys.argv[1], "ptxas": C.kernel_ptxas(kernels)}), flush=True)
elif mode == "check":
    print(json.dumps({"tree": sys.argv[1], **C.check_short_path(FB, 118)}), flush=True)
elif mode == "time":
    out = {"tree": sys.argv[1]}
    for label, row in rows(sys.argv[3:] == ["short"]):
        out[label] = {k: row[k] for k in TIMING}
        print(json.dumps({"tree": sys.argv[1], "row": label, **out[label]}), flush=True)
    print(json.dumps(out), flush=True)
else:
    raise SystemExit(f"mode {mode!r}: build, check or time")
