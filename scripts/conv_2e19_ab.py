#!/usr/bin/env python3
"""Kernels B, C, E and E' at fft 2^19 in the checkout at ROOT, timed by that
checkout's own `chip_smoke.py` check functions (CUDA events around repeated
launches; each row with its error against its plain version, the plain
version's and the library call's time and its bound):

    python3 scripts/conv_2e19_ab.py ROOT build        # B, C, E, E': seconds, ptxas
    python3 scripts/conv_2e19_ab.py ROOT build all    # every kernel of the port
    python3 scripts/conv_2e19_ab.py ROOT time main    # B and C on the outer route
    python3 scripts/conv_2e19_ab.py ROOT time 2e19    # every fft 2^19 row
    python3 scripts/conv_2e19_ab.py ROOT variant NAME DEST

The fft 2^19 rows (all bf16, C = 256 but the pencil's 32): B and C through
the outer entries at the JAX plan (16, 128, 256) on 1 x 262,144, the shape
of stage 3 of `hg38_large_1m`'s curriculum; the narrow pair and the 3-factor
pair at fft 2^19 (1 x 262,144); the seq route's channel pencil of that stage
(1 x 32 x 262,144, 32 channels a rank on seq 8); E and E' (specv, spec) on
1 x 262,144 through their generic wrappers. `build` prints each library's
build seconds (all started together) and ptxas's registers, stack and spill
bytes of every instantiation of the four-step passes and the short path's
kernels.

`variant NAME DEST` writes a copy of ROOT to DEST with fft 2^19 at one of
the designs weighed for it, by rewriting `csrc/fft_common.cuh`'s
`kPlanLogN1`, `kSchedLogN1` and `kSchedLogN2` lines (and for b the
compile-time schedule's rule, `sched_lr`):
  a  512 x 1024, the rows at 16 8 8 (the short path's schedule of 2^10);
  b  512 x 1024, the rows at 4 16 16 (a radix-4 pass, then two of 16; the
     short path's 2^10 too);
  c  128 x 4096, the rows in the radix-16 class (kernel C's 2-CTA cluster
     at N2 = 4096) and the 128-point columns at 16 8: the tree as shipped.

To compare trees on one card, unpack each into a git-ignored directory
(`git archive`, or `variant`), build them all, then time them in turns
(parent, change, change, parent) in one call.
"""

import json
import re
import shutil
import sys
import time
from pathlib import Path

# name: (log2 N1 at fft 2^19, kSchedLogN1, kSchedLogN2, first pass of 1024 points radix 4)
VARIANTS = {"a": (9, (2,), (2, 10), False), "b": (9, (2,), (2, 10), True),
            "c": (7, (2, 7), (2,), False)}
SCHED_RULE = "__host__ __device__ constexpr int sched_lr(int log_m, int p) {\n"
FOUR_STEP = ("cols_fwd_kernel", "cols_in_kernel", "cols_in_delta_kernel", "cols_inv_kernel",
             "rows_fwd_kernel", "rows_conv_kernel", "rows_grad_kernel", "rows_grad_cluster_kernel",
             "cols_inv_gate_kernel", "cols_in_dv_kernel", "cols_inv_dx0_kernel",
             "short_kspec_kernel", "short_conv_kernel", "short_grad_kernel", "short_dk_kernel")


def variant(root: Path, name: str, dest: Path) -> None:
    log_n1, cols, rows_, radix4 = VARIANTS[name]
    shutil.copytree(root, dest, ignore=shutil.ignore_patterns(
        ".git", "_archive", "_build", "__pycache__", "*.log"))
    header = dest / "hyena_dna_tpu_torch" / "csrc" / "fft_common.cuh"
    text = header.read_text()
    for array, sizes in (("kSchedLogN1", cols), ("kSchedLogN2", rows_)):
        text, count = re.subn(rf"constexpr int {array}\[\] = \{{[^}}]*\}};",
                              "constexpr int %s[] = {%s};" % (array, ", ".join(map(str, sizes))),
                              text)
        if count != 1:
            raise SystemExit(f"{header}: {array} not found")
    if radix4:
        if text.count(SCHED_RULE) != 1:
            raise SystemExit(f"{header}: sched_lr not found")
        text = text.replace(SCHED_RULE, SCHED_RULE + "  if (log_m == 10) return p == 0 ? 2 : 4;\n")
    table = re.search(r"kPlanLogN1\[kMaxLogN \+ 1\] = \{([^}]*)\}", text)
    values = [int(v) for v in table.group(1).split(",")]
    values[19] = log_n1
    text = text[:table.start(1)] + ", ".join(map(str, values)) + text[table.end(1):]
    header.write_text(text)
    print(json.dumps({"variant": name, "dest": str(dest), "log_n1_at_2e19": log_n1,
                      "kSchedLogN1": cols, "kSchedLogN2": rows_, "radix4_first": radix4}),
          flush=True)


def rows(C, FB, GE, which: str):
    """(label, row) of each timed row, in chip_smoke.py's arguments."""
    L, plan = 1 << 18, (16, 128, 256)
    yield "B outer 1x256x262144", C.check_conv(FB, 1, L, "bfloat16", "pallas_fftconv_n3.py:413 outer",
                                               140, FB.fftconv_outer_fwd, plan)
    yield "C outer 1x256x262144", C.check_conv_bwd(FB, FB.fftconv_outer_bwd, 1, L, "bfloat16",
                                                   "pallas_fftconv_n3.py:629 outer", 141, plan)
    if which == "main":
        return
    narrow = FB.plan(1 << 19, C.D_MODEL, L, FB.nat_chain(1 << 19))
    yield "B narrow", C.check_conv(FB, 1, L, "bfloat16", "pallas_fftconv.py:890 narrow", 70,
                                   FB.fftconv_fused_fwd_narrow, narrow)
    yield "C narrow", C.check_conv_bwd(FB, FB.fftconv_fused_bwd_narrow, 1, L, "bfloat16",
                                       "pallas_fftconv.py:987 narrow", 71, narrow)
    factors, cb = FB.PLAN3_BY_N[1 << 19]
    yield "B 3-factor", C.check_conv(FB, 1, L, "bfloat16", "pallas_fftconv3.py:293", 72,
                                     FB.fftconv3_fwd, (*factors, cb))
    yield "C 3-factor", C.check_conv_bwd(FB, FB.fftconv3_bwd, 1, L, "bfloat16",
                                         "pallas_fftconv3.py:390", 73, (*factors, cb))
    yield "B pencil 1x32x262144", C.check_conv(FB, 1, L, "bfloat16", "seq pencil", 142, C=32)
    yield "C pencil 1x32x262144", C.check_conv_bwd(FB, FB.fftconv_bwd_retransform, 1, L,
                                                   "bfloat16", "seq pencil", 143, C=32)
    yield "E specv 1x262144", C.check_gated(GE, 1, L, "bfloat16", "specv", 144)
    for i, route in enumerate(("specv", "spec")):
        yield f"E' {route} 1x262144", C.check_gated_bwd(GE, route, 1, L, "bfloat16", 145 + i,
                                                        generic=True)


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    mode, rest = sys.argv[2], sys.argv[3:]
    if mode == "variant":
        variant(root, rest[0], Path(rest[1]).resolve())
        return
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from hyena_dna_tpu_torch import _cuda
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    conv = [FB.KERNEL, FB.KERNEL_BWD, GE.KERNEL, GE.KERNEL_BWD]
    if mode == "build":
        kernels = C.port_kernels() if rest == ["all"] else conv
        t0 = time.perf_counter()
        _cuda.build_all(kernels)
        seconds = time.perf_counter() - t0
        ptxas = {}
        for k in conv:
            for fn in FOUR_STEP:
                for mangled, reading in C.ptxas_readings(k.build_log, fn).items():
                    inst = re.search(fn + r"I(?:13__nv_bfloat16|f)?((?:Li\d+E|Lb[01]E)+)", mangled)
                    args = ",".join(re.findall(r"L[ib](\d+)E", inst.group(1))) if inst else ""
                    dtype = "bf16," if fn + "I13__nv_bfloat16" in mangled else (
                        "f32," if fn + "If" in mangled else "")
                    ptxas.setdefault(k.name, {})[f"{fn}<{dtype}{args}>"] = reading
        print(json.dumps({"tree": str(root), "build_seconds": seconds,
                          "libraries": [k.library_path.name for k in kernels], "ptxas": ptxas}),
              flush=True)
    elif mode == "time":
        _cuda.build_all(conv)
        out = {"tree": str(root)}
        for label, row in rows(C, FB, GE, rest[0]):
            out[label] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "max_abs_err")}
            print(json.dumps({"tree": str(root), "row": label, **out[label]}), flush=True)
        print(json.dumps(out), flush=True)
    else:
        raise SystemExit(f"mode {mode!r}: build, time or variant")


if __name__ == "__main__":
    main()
