"""The comparison that decides `correct` fails a broken timed path: a whole
run of a tiny cell on the CPU (no look for a card) with the program broken
underneath, under the real cells' limits; and the controls at the tiny size."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.core import run_cell

SEED = 2 ** 31 + 4242


def run(root, cell):
    code, result = run_cell(cell, SEED, 0.3, False, time.perf_counter(), root=root, device="cpu")
    assert code == 0
    return result


def test_a_number_without_a_limit_is_not_compared():
    from benchmark.harness.compare import judge

    numbers = {"loss_gap": (0.5, "2 steps"), "tokens_gap": (0.0, "2 steps")}
    assert judge(numbers, {"tokens_gap": 0.0}) == (True, {"tokens_gap": {"value": 0.0,
                                                                          "limit": 0.0}})
    assert not judge(numbers, {"loss_gap": 1e-3, "tokens_gap": 0.0})[0]


def test_sound_runs_are_correct(tiny_presets):
    assert run(tiny_presets, "tiny.pretrain")["correct"]
    assert run(tiny_presets, "tiny.score")["correct"]


def test_a_step_that_leaves_the_state_unchanged(tiny_root, monkeypatch):
    from hyena_dna_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: torch.zeros(()))
    result = run(tiny_root, "tiny.pretrain")
    assert not result["correct"] and result["checks"]["change_gap"]["value"] == 1.0


def test_half_of_each_batch_left_out(tiny_root, monkeypatch):
    """Half of each step's micro-batches run, the mean taken over the rest."""
    import hyena_dna_tpu_torch.train.step as S

    real = S.make_train_step

    def half(task, accum, mesh=None):
        inner = real(task, accum // 2)

        def step(state, batch, generator=None):
            n = batch[0].shape[0] // 2
            return inner(state, (batch[0][:n], batch[1][:n]), generator)
        return step

    monkeypatch.setattr(S, "make_train_step", half)
    result = run(tiny_root, "tiny.pretrain")
    assert not result["correct"] and result["checks"]["tokens_gap"]["value"] == 0.5


def test_an_answer_altered_where_it_is_produced(tiny_presets, monkeypatch):
    """Each window's scores altered as the model produces them: one token's
    logit raised by 1 at every position."""
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel

    real = ConvLMHeadModel.forward

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        out[..., 7] += 1.0
        return out

    monkeypatch.setattr(ConvLMHeadModel, "forward", altered)
    assert not run(tiny_presets, "tiny.score")["correct"]


@pytest.mark.parametrize("cell", ["tiny.pretrain", "tiny.score"])
def test_the_control_fails(tiny_presets, cell):
    """The reference one precision below the configuration's (fp8 for the
    bf16 training cell, TF32 for the float32 scoring cell) in the program's
    place fails one of the cell's numbers. The scoring control runs at the
    published widths (d_model 256, 8 layers) on 4096-token windows: TF32's
    error in a perplexity grows with depth and width."""
    from conftest import widen

    from benchmark.controls import readings
    from benchmark.harness.compare import judge
    from benchmark.harness.manifest import find_cell

    if cell == "tiny.score":
        widen(tiny_presets, 256, 8, 4096)
    c = find_cell(cell, tiny_presets)
    (name, numbers), = [r for r in readings(c, SEED, torch.device("cpu"), False)]
    assert name == "control"
    assert not judge(numbers, c.settings["limits"])[0], numbers
