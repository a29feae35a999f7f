"""The comparisons that decide `correct`: each number the program's timed
path produced against the plain reference's, as one reading per number,
held to the cell's limit (`workloads/<cell>.json`, "limits").

Training (`train_numbers`): each set-up step's loss, relative; its target
count, exact (a step that ran part of its batch and took the mean over the
rest moves neither the loss nor the norms of a long-context step much, but
counts fewer targets); the first
gradient as the optimizer received it (Adam's first moment after step 1
over 1 - beta1) and each parameter's change over the followed steps, both
by the worst leaf: the gap between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose first reference gradient is under a thousandth of the
median leaf's (nought to rounding) are left out of the change.

Scoring (`score_numbers`): the answers run_eval produces, relative: the NLL
sum of each sampled window (from the logits the program produced) and the
run's perplexity. The logits themselves are not compared: their widest gap
and their gap of norms are set by bfloat16 roundings of the long conv's I/O
that land on the other side, in the program and in the TF32 control alike,
and read less than 3x apart (PERF.md).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Sequence, Tuple

import torch

Reading = Tuple[str, float, float]  # name, value, limit


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Sequence[str]) -> Tuple[float, str]:
    """(worst gap of norms, its leaf) over `names`."""
    norms = {n: float(ref[n].double().norm()) for n in names}
    floor = statistics.median(norms.values())
    worst, leaf = 0.0, ""
    for n in names:
        p = float(prog[n].double().norm()) if n in prog else 0.0
        gap = abs(p - norms[n]) / max(norms[n], floor, 1e-30)
        if not gap <= worst:  # a NaN is the worst
            worst, leaf = gap, n
    return worst, leaf


def moved_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= floor]


def train_numbers(prog, ref) -> Dict[str, Tuple[float, str]]:
    """`prog` and `ref`: (each step's loss, each step's target count, the
    first gradient by leaf, each leaf's change)."""
    (p_loss, p_count, p_grads, p_change), (r_loss, r_count, r_grads, r_change) = prog, ref
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    return {"loss_gap": (rel(p_loss, r_loss), f"{len(r_loss)} steps"),
            "tokens_gap": (rel(p_count, r_count), f"{len(r_count)} steps"),
            "grad_gap": leaf_gap(p_grads, r_grads, sorted(r_grads)),
            "change_gap": leaf_gap(p_change, r_change, moved_leaves(r_grads))}


def score_numbers(prog_nll: Dict[int, float], ref_nll: Dict[int, float],
                  prog_ppl: float, ref_ppl: float) -> Dict[str, Tuple[float, str]]:
    nll = max((abs(prog_nll[i] - ref_nll[i]) / abs(ref_nll[i]) for i in ref_nll), default=0.0)
    return {"window_nll_gap": (nll, f"{len(ref_nll)} windows"),
            "ppl_gap": (abs(prog_ppl - ref_ppl) / ref_ppl, "run")}


def judge(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}) over the numbers the cell has a
    limit for (one without is not compared: no reading separates it from
    the control and the faults in that cell); a NaN fails."""
    out, ok = {}, True
    for name, (value, _) in numbers.items():
        if name in limits:
            ok = ok and value <= limits[name]
            out[name] = {"value": value, "limit": limits[name]}
    return ok, out


def print_checks(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> None:
    for name, (value, at) in numbers.items():
        if name not in limits:
            print(f"not compared {name} = {value!r} ({at})", file=sys.stderr)
    for name, (value, at) in numbers.items():
        if name in limits:
            print(f"check {name} = {value!r} limit {limits[name]!r} ({at})", file=sys.stderr)
