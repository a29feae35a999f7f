"""Activation checkpointing with the JAX package's save policy (the port of
`hyena_dna_tpu/ops/fftconv.py`'s remat tags and `models/lm.py`'s policy).

A cell is `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`
around a function of the model (`checkpoint_cell`): its forward keeps none
of its activations, and the backward runs it again to rebuild them. The
JAX policy `save_only_these_names(CONV_OUT_TAG[, FILTER_K_TAG])` keeps the
values tagged with those names instead, so the replay skips the op that
made them. The port's kernels launch through ctypes inside
`autograd.Function`s, out of sight of the dispatcher, so a selective-
checkpoint policy keyed on ATen ops could never match them. The port
therefore has a small mechanism of its own, a tape per cell:

* `tagged(name, compute, replay)` marks a value. Outside a cell that saves
  `name` it is `compute()`. In a cell's first forward it is `compute()`,
  and the tape of that cell (and of every cell around it) records the
  value. In the cell's recompute it is `replay(recorded)`: an
  `autograd.Function` that returns the recorded value without running the
  op, and saves for the backward exactly what the op's own Function saved,
  so the checkpoint matches the recomputed saved tensors to the first
  forward's, in order, and the first forward's node runs the op's backward
  kernel on them. A recorded value is released when its replay takes it.
* The conv (`CONV_OUT_TAG`, the ungated output of kernel B on the composite
  route and of the 4-D conv, as in the JAX package; kernel E's gated
  output is not tagged): a conv under a tape that saves it takes kernel
  C's retransform route (it saves u, k and D, which the replay has), so the
  spectrum route of fft 2^16-2^18 is not taken there. The JAX replay
  re-ran the conv forward to rebuild its spectrum residual instead.
* The filter bank (`FILTER_K_TAG`): with the filter saved, the bank is an
  `autograd.Function` (`filter_bank`) that saves no activation, so the
  replay returns the recorded bank; its backward runs the filter once more
  to differentiate it.

Generators: the port draws dropout masks from the `generator` handed to
`forward`, which `preserve_rng_state` does not stash. A cell snapshots the
generator's state at entry; its first forward draws from the caller's
generator, which so advances exactly as without checkpointing, and its
recompute draws from a private generator restored to the snapshot, so it
draws the same masks. One seed gives the same loss with and without
checkpointing.

Nested cells (the LM's residual groups) nest checkpoints: the outer
checkpoint's inputs of its inner cells are its saved tensors, so its
recompute runs the inner cells again up to the entry of the last one
(torch's early stop), and each inner cell is recomputed once more for its
own backward. The per-step run counts this implies are in
`models/lm.py`.

Outside autograd (`torch.no_grad`, inference) a cell is a plain call.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, List

import torch
from torch.utils.checkpoint import checkpoint

CONV_OUT_TAG = "hyena_conv_out"
FILTER_K_TAG = "hyena_filter_k"


class _Tape:
    """The tagged values of one cell invocation, per name in call order."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self.values = {n: [] for n in self.names}
        self.cursor = dict.fromkeys(self.names, 0)
        self.replaying = False


_LOCAL = threading.local()  # per thread: the backward may run on a device thread


def _stack() -> List[_Tape]:
    """The tapes of the cells running on this thread, outermost first."""
    if not hasattr(_LOCAL, "tapes"):
        _LOCAL.tapes = []
    return _LOCAL.tapes


def saving(name: str) -> bool:
    """Whether a running cell saves values tagged `name`."""
    return any(name in t.names for t in _stack())


def tagged(name: str, compute: Callable[[], torch.Tensor],
           replay: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """`compute()`, recorded by the running cells that save `name`, or in
    such a cell's recompute `replay(recorded value)` (module docstring)."""
    tapes = [t for t in _stack() if name in t.names]
    if not tapes:
        return compute()
    src = next((i for i in range(len(tapes) - 1, -1, -1) if tapes[i].replaying), None)
    if src is None:
        value = compute()
    else:
        tape = tapes[src]
        i = tape.cursor[name]
        tape.cursor[name] += 1
        recorded = tape.values[name][i]
        if recorded is None:
            raise RuntimeError(f"the value tagged {name!r} was already replayed: a "
                               "checkpointed cell does not take a second backward")
        tape.values[name][i] = None
        value = replay(recorded)
    kept = value.detach()
    for tape in tapes[0 if src is None else src + 1:]:
        tape.values[name].append(kept)
    return value


def restored(generator: torch.Generator, state: torch.Tensor) -> torch.Generator:
    """A private generator on `generator`'s device in `state`."""
    gen = torch.Generator(device=generator.device)
    gen.set_state(state)
    return gen


def checkpoint_cell(fn: Callable, *args, generator: torch.Generator | None = None,
                    names: Iterable[str] = ()):
    """`fn(*args, generator=...)` as one checkpointed cell that saves the
    values tagged with `names` (module docstring)."""
    if not torch.is_grad_enabled():
        return fn(*args, generator=generator)
    tape = _Tape(names)
    state = None if generator is None else generator.get_state()
    runs = [0]

    def run(*a):
        gen = generator
        if runs[0]:  # a recompute: the snapshot's masks, the recorded values
            if generator is not None:
                gen = restored(generator, state)
            tape.replaying = True
            tape.cursor = dict.fromkeys(tape.names, 0)
        runs[0] += 1
        stack = _stack()
        stack.append(tape)
        try:
            return fn(*a, generator=gen)
        finally:
            stack.pop()

    return checkpoint(run, *args, use_reentrant=False)


class _Replay(torch.autograd.Function):
    """Returns a recorded value (in a list, out of autograd's sight) under a
    node that saves `saved` and whose backward is `backward_fn`."""

    @staticmethod
    def forward(ctx, backward_fn, box, *saved):
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(*saved)
        return box[0].detach()

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *ctx.backward_fn(grad, *ctx.saved_tensors))


def replay(value: torch.Tensor, backward_fn: Callable, *saved: torch.Tensor) -> torch.Tensor:
    """`value` under a node that saves `saved` (in that order) and computes
    their gradients as `backward_fn(grad, *saved)`."""
    return _Replay.apply(backward_fn, [value], *saved)


class _FilterBank(torch.autograd.Function):
    """The filter bank `build()` of `params`, saving no activation: the
    backward builds it again to differentiate it."""

    @staticmethod
    def forward(ctx, build, box, *params):
        ctx.build = build
        ctx.params = params
        if box:
            return box[0].detach()
        with torch.no_grad():
            return build()

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            k = ctx.build()
            grads = torch.autograd.grad(k, ctx.params, grad, allow_unused=True)
        return (None, None, *grads)


def filter_bank(build: Callable[[], torch.Tensor], params) -> torch.Tensor:
    """The filter bank `build()` (a function of `params` alone), tagged
    `FILTER_K_TAG`: in a cell that saves it the bank is recorded and
    replayed, built under `_FilterBank`; elsewhere `build()` as it is."""
    if not saving(FILTER_K_TAG):
        return build()
    params = tuple(params)
    return tagged(FILTER_K_TAG, lambda: _FilterBank.apply(build, [], *params),
                  lambda k: _FilterBank.apply(build, [k], *params))
