"""The plain reference against the port at a tiny size: on the CPU the
port's kernels run their plain versions; the `cuda` case runs the kernels."""

from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark.harness.core import run_cell
from benchmark.reference import hyena_lm as ref

SEED = 2 ** 31 + 99


def test_scoring_forward_matches_the_port(tiny_presets):
    from benchmark.harness import feed, port
    from benchmark.harness.manifest import find_cell

    cell = find_cell("tiny.score", tiny_presets)
    cfg = cell.model_cfg
    params, bufs = ref.make_params(cfg, SEED, "cpu"), ref.buffers(cfg, "cpu")
    model = port.eval_model(cell.recipe, params, bufs, torch.device("cpu"))
    for x, _ in feed.score_pool(SEED, 2, 128, [0.35, 0.6]):
        x = torch.as_tensor(x)
        with torch.no_grad():
            got, want = model(x), ref.forward({**params, **bufs}, x, cfg)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()  # bf16 conv I/O: a flip


def test_train_steps_match_the_port(tiny_root):
    """The bf16 train step with residual cells, dropout and AdamW against the
    float32 reference through two steps, within the real cell's limits."""
    code, result = run_cell("tiny.pretrain", SEED, 0.3, False, time.perf_counter(),
                            root=tiny_root, device="cpu")
    assert code == 0 and result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["loss_gap"]["value"] < 1e-4
    assert checks["grad_gap"]["value"] < 2e-2 and checks["change_gap"]["value"] < 2e-2
    assert set(result["metrics"]) == {"setup_s", "train_tokens_per_s"}


def test_scoring_run_matches_the_port(tiny_presets):
    code, result = run_cell("tiny.score", SEED, 0.3, False, time.perf_counter(),
                            root=tiny_presets, device="cpu")
    assert code == 0 and result["correct"], result["checks"]
    assert result["checks"]["window_nll_gap"]["value"] <= 1e-5
    assert set(result["metrics"]) == {"setup_s", "score_tokens_per_s", "score_window_p90_ms"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_dropout_masks_are_the_ports(tiny_root):
    """The benchmark's mask stream is what the port's dropout draws from the
    generator the benchmark hands it."""
    from hyena_dna_tpu_torch.models.nn import dropout

    from benchmark.harness import feed

    gen = torch.Generator().manual_seed(feed.dropout_seed(SEED))
    masks = feed.dropout_masks(SEED, (2, 16, 8), torch.bfloat16, 0.1, "cpu")
    x = torch.ones(2, 16, 8, dtype=torch.bfloat16)
    for _ in range(3):
        assert torch.equal(dropout(x, 0.1, True, gen) != 0, next(masks) != 0)


def test_reference_adamw_is_torchs():
    torch.manual_seed(0)
    run = {"optimizer": {"lr": 1e-2, "weight_decay": 0.1}, "trainer": {"gradient_clip_val": None},
           "scheduler": {"_name_": "constant"}, "layer_optim": {"lr": 1e-2, "wd": 0.0,
                                                                "lr_pos_emb": 0.0}}
    p = {"backbone.layers.0.mlp.fc1.weight": torch.randn(4, 3)}
    mine = ref.AdamW(p, run)
    theirs_p = p["backbone.layers.0.mlp.fc1.weight"].clone().requires_grad_()
    theirs = torch.optim.AdamW([theirs_p], lr=1e-2, weight_decay=0.1)
    for _ in range(3):
        g = torch.randn(4, 3)
        mine.step(p, {"backbone.layers.0.mlp.fc1.weight": g})
        theirs_p.grad = g.clone()
        theirs.step()
    assert torch.allclose(p["backbone.layers.0.mlp.fc1.weight"], theirs_p.detach(), atol=1e-7)


def test_positional_features_and_schedule():
    z = ref.positional_features(5, 64)
    w = 2 * math.pi * torch.arange(64, dtype=torch.float64) / 64
    f = torch.linspace(1e-4, 1, 2, dtype=torch.float64)
    e = torch.exp(-1j * f[None] * w[:, None])
    assert torch.allclose(z[0, :, 1:3].double(), e.real, atol=1e-6)
    assert torch.allclose(z[0, :, 3:].double(), e.imag, atol=1e-6)
    sched = {"_name_": "cosine_warmup_timm", "t_initial": 100, "warmup_t": 10,
             "warmup_lr_init": 1e-6, "lr_min": 1e-5}
    assert ref.schedule_lr(1e-3, 0, sched) == 1e-6
    assert ref.schedule_lr(1e-3, 10, sched) == pytest.approx(1e-3)
    assert ref.schedule_lr(1e-3, 100, sched) == pytest.approx(1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.pretrain", "tiny.score"])
def test_tiny_cells_on_the_card(card, tiny_presets, cell):
    """A whole run of each tiny cell at d_model 256 on the card, kernels and
    trace included."""
    from conftest import widen

    widen(tiny_presets)
    code, result = run_cell(cell, SEED, 1.0, True, time.perf_counter(), root=tiny_presets,
                            device="cuda")
    assert code == 0 and result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["metrics"]
