"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell that was added as files only."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    entry_keys = {"configs": {"name", "source", "file", "reduced", "why"},
                  "workloads": {"name", "config", "traffic", "chips", "why"},
                  "end_to_end": {"name", "unit", "better", "bound", "source"},
                  "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, keys in entry_keys.items():
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names)), section
        for e in MANIFEST[section]:
            extra = set(e) - keys
            assert set(e) >= keys and extra <= ({"workloads"} if section in
                                                ("end_to_end", "per_layer") else set()), e
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer") + (("source",) if section == "configs" else ()):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert {w["config"] for w in MANIFEST["workloads"]} == configs
    reported = {c: {m["name"] for m in MANIFEST["end_to_end"]
                    if "workloads" not in m or c in m["workloads"]} for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"] + MANIFEST["end_to_end"]:
        for c in m.get("workloads", []):
            assert c in cells
    for m in MANIFEST["per_layer"]:
        for c in m.get("workloads", cells):
            if m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}:
                assert m["moves"] in reported[c], (m["name"], c)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    roof = [m for m in MANIFEST["per_layer"] if "roofline" in m["name"] or "mfu" in m["name"]]
    assert roof and all(m["unit"] == "%" for m in roof)


def test_every_piece_is_a_file_found_by_name():
    from benchmark.harness.manifest import find_cell, load_driver, load_readers

    for w in MANIFEST["workloads"]:
        cell = find_cell(w["name"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
        assert hasattr(load_driver(cell), "run")
        readers = load_readers(cell)
        assert set(readers) == {m["name"] for m in cell.per_layer}
        assert all(callable(r.read) for r in readers.values())
        numbers = ({"loss_gap", "tokens_gap", "grad_gap", "change_gap"}
                   if cell.traffic["driver"] == "train_step" else {"window_nll_gap", "ppl_gap"})
        assert cell.settings["limits"] and set(cell.settings["limits"]) <= numbers


def test_a_cell_added_as_files_is_found(tiny_root):
    """tiny.pretrain and tiny.score exist only as new files and manifest
    entries in a copy of the benchmark; the harness's code is unchanged."""
    from benchmark.harness.manifest import find_cell, load_driver, load_readers

    for name, driver in (("tiny.pretrain", "train_step"), ("tiny.score", "score_windows")):
        cell = find_cell(name, tiny_root)
        assert cell.traffic["driver"] == driver and cell.root == tiny_root
        assert load_driver(cell).__file__.startswith(str(tiny_root))
        assert load_readers(cell)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    with pytest.raises(KeyError):
        find_cell("no-such-cell", tiny_root)


@pytest.mark.parametrize("config", ["hyenadna-large-1m", "hyenadna-512ksl"])
def test_config_recipes_are_the_repo_yamls(config):
    """Each recipe's model block and training settings are its yaml's as the
    port's config loader resolves them (a change to a shipped yaml shows)."""
    from hyena_dna_tpu_torch.utils.config import load_config, resolve_interpolations

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    for recipe in cfg["recipes"].values():
        y = resolve_interpolations(load_config(ROOT / recipe["yaml"]))
        assert y["model"] == recipe["model"]
        for key in ("task", "optimizer", "scheduler", "mesh"):
            if key in recipe:
                assert y[key] == recipe[key], key
        if "trainer" in recipe:
            assert {k: y["trainer"][k] for k in recipe["trainer"]} == recipe["trainer"]
        if "stage" in recipe:
            stage = y["callbacks"]["seqlen_warmup_reload"]["stage_params"][recipe["stage"]]
            assert (stage["seq_len"], stage["batch_size"]) == (recipe["max_length"],
                                                               recipe["batch_size"])
        elif "max_length" in recipe:
            assert (y["dataset"]["max_length"], y["dataset"]["batch_size"]) == (
                recipe["max_length"], recipe["batch_size"])
        for key in ("d_model", "n_layer", "d_inner", "vocab_size", "pad_vocab_size_multiple"):
            assert cfg[key] == recipe["model"][key]


def test_token_ids_are_the_tokenizers():
    from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer

    from benchmark.harness import feed

    tok = CharacterTokenizer(model_max_length=16)
    vocab = tok.get_vocab()
    assert [vocab[c] for c in "ACGT"] == [feed.A, feed.C, feed.G, feed.T]
    assert tok.sep_token_id == feed.SEP


def test_feed_is_seeded_and_rows_differ():
    import torch

    from benchmark.harness import feed

    seed = 2 ** 31 + 12345
    x1, y1 = feed.train_batch(seed, 3, 4, 257, [0.35, 0.6], "cpu")
    x2, _ = feed.train_batch(seed, 3, 4, 257, [0.35, 0.6], "cpu")
    assert torch.equal(x1, x2) and x1.shape == (4, 256)
    assert torch.equal(x1[:, 1:], y1[:, :-1])
    assert len({tuple(r.tolist()) for r in x1}) == 4
    assert set(x1.unique().tolist()) <= {7, 8, 9, 10}
    assert not torch.equal(x1, feed.train_batch(seed + 1, 3, 4, 257, [0.35, 0.6], "cpu")[0])
    pool = feed.score_pool(seed, 3, 64, [0.35, 0.6])
    assert all(x.shape == (1, 64) and y[0, -1] == feed.SEP for x, y in pool)
    masks = feed.dropout_masks(seed, (2, 8), torch.bfloat16, 0.1, "cpu")
    assert not torch.equal(next(masks), next(masks))
