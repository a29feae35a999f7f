"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as files, and the card check for the tests marked `cuda`."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LENGTH = 129  # a row's tokens: 128 inputs
TINY_BF16_FROM = 64  # the conv I/O rule, moved down to the tiny length


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card runs are made on the chip")
    return torch.device("cuda")


def tiny_model(l_max: int, remat: dict, emb_dim: int = 5, modulate: bool = True) -> dict:
    layer = {"_name_": "hyena", "emb_dim": emb_dim, "filter_order": 16, "short_filter_order": 3,
             "l_max": l_max, "modulate": modulate, "w": 10}
    return {"_name_": "lm", "d_model": 32, "n_layer": 2, "d_inner": 128, "vocab_size": 12,
            "resid_dropout": 0.0, "embed_dropout": 0.1, "residual_in_fp32": True,
            "pad_vocab_size_multiple": 8, **remat, "layer": layer}


def tiny_files(real: dict) -> dict:
    """{path: json} of a tiny configuration, two traffic mixes and two
    cells that take the real cells' limits (the training cell's change
    limit widened)."""
    train_model = tiny_model(TINY_LENGTH + 1, {"checkpoint_mixer": True, "checkpoint_mlp": True,
                                               "remat_residual_only": True,
                                               "remat_group_size": 2})
    train_model["layer"].update({"lr": 2e-4, "wd": 0.0, "lr_pos_emb": 0.0})
    eval_model = tiny_model(TINY_LENGTH + 2, {"checkpoint_mixer": True, "checkpoint_mlp": True},
                            emb_dim=33, modulate=False)
    eval_model.update({"embed_dropout": 0.0})
    del eval_model["resid_dropout"]
    eval_model["layer"].update({"linear_mixer": False, "w": 14})
    del eval_model["layer"]["short_filter_order"]
    config = {"name": "tiny", "source": "https://huggingface.co/LongSafari/hyenadna-tiny-1k-seqlen",
              "conv_io_bf16_from": TINY_BF16_FROM, "layer_norm_epsilon": 1e-5,
              "recipes": {
                  "train": {"model": train_model, "task": {"_name_": "hg38", "loss": "cross_entropy"},
                            "trainer": {"precision": "bf16", "gradient_clip_val": 1.0,
                                        "accumulate_grad_batches": 4},
                            "optimizer": {"lr": 2e-4, "weight_decay": 0.1},
                            "scheduler": {"_name_": "cosine_warmup_timm", "t_initial": 100000,
                                          "warmup_t": 1000, "lr_min": 2e-5,
                                          "warmup_lr_init": 1e-6},
                            "mesh": {"data": 1, "seq": 1, "model": 1},
                            "batch_size": 2, "max_length": TINY_LENGTH},
                  "eval": {"model": eval_model, "preset": "tiny", "precision": "float32"}}}
    train_mix = {"driver": "train_step", "recipe": "train", "micro_rows": 2, "accumulate": 4,
                 "max_length": TINY_LENGTH, "gc_range": [0.35, 0.6], "steps_followed": 2,
                 "reference_row_block": 1, "trace_steps": 1}
    score_mix = {"driver": "score_windows", "recipe": "eval", "window": TINY_LENGTH - 1,
                 "pool": 4, "gc_range": [0.35, 0.6], "sampled_windows": 2, "sample_within": 4,
                 "trace_windows": 2}
    limits = {w: json.loads((ROOT / "benchmark" / "workloads" / f"{w}.json").read_text())
              for w in ("large-1m.pretrain", "512ksl.score")}
    # 128-token rows on 32 channels: sound bf16 runs move a small leaf's change
    # by up to 1e-2 (the 1M cell's rows, by at most 2.1e-3), so the tiny
    # training cell's change limit is wider; its other limits are the 1M cell's
    limits["large-1m.pretrain"]["limits"]["change_gap"] = 0.03
    return {"benchmark/configs/tiny.json": config,
            "benchmark/traffic/tiny-train.json": train_mix,
            "benchmark/traffic/tiny-score.json": score_mix,
            "benchmark/workloads/tiny.pretrain.json": limits["large-1m.pretrain"],
            "benchmark/workloads/tiny.score.json": limits["512ksl.score"]}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout's benchmark with the tiny cells `tiny.pretrain` and
    `tiny.score` added as files and manifest entries, and the port's
    conv I/O rule moved to the tiny length."""
    from hyena_dna_tpu_torch.models import hyena

    monkeypatch.setattr(hyena, "CONV_IO_BF16_MIN_L", TINY_BF16_FROM)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path, obj in tiny_files(manifest).items():
        (tmp_path / path).write_text(json.dumps(obj))
    manifest["configs"].append({"name": "tiny", "source": "https://huggingface.co/LongSafari",
                                "file": "benchmark/configs/tiny.json", "reduced": [],
                                "why": "tiny"})
    manifest["workloads"] += [
        {"name": "tiny.pretrain", "config": "tiny", "traffic": "tiny-train", "chips": 1,
         "why": "tiny"},
        {"name": "tiny.score", "config": "tiny", "traffic": "tiny-score", "chips": 1, "why": "tiny"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            if any(w.startswith("large-1m") for w in m["workloads"]):
                m["workloads"].append("tiny.pretrain")
            if "512ksl.score" in m["workloads"]:
                m["workloads"].append("tiny.score")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


@pytest.fixture
def tiny_presets(monkeypatch, tiny_root):
    """The eval entry's preset loader answers `tiny` with the tiny eval model."""
    from hyena_dna_tpu_torch.evals import presets

    path = tiny_root / "benchmark" / "configs" / "tiny.json"
    real = presets.load_eval_preset
    monkeypatch.setattr(presets, "load_eval_preset",
                        lambda name: {"model": json.loads(path.read_text())["recipes"]["eval"][
                            "model"]} if name == "tiny" else real(name))
    return tiny_root


def widen(root: Path, d_model: int = 256, n_layer: int = 2, window: int = 0) -> None:
    """The tiny configuration at the published width (the card's kernels
    take d_model 256), with `n_layer` layers and, given a `window`, the
    scoring mix's windows that long."""
    path = root / "benchmark" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    for recipe in cfg["recipes"].values():
        recipe["model"].update({"d_model": d_model, "d_inner": 4 * d_model, "n_layer": n_layer})
    if window:
        cfg["recipes"]["eval"]["model"]["layer"]["l_max"] = window + 2
        mix = root / "benchmark" / "traffic" / "tiny-score.json"
        mix.write_text(json.dumps({**json.loads(mix.read_text()), "window": window}))
    path.write_text(json.dumps(cfg))
