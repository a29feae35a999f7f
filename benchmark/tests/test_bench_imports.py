"""No JAX in the benchmark: after the harness and the reference are
imported, and a cell's driver and readers loaded, no module's top-level
name is jax, jaxlib, flax or the JAX package's; the reference imports
nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "hyena_dna_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    top = loaded_after(
        "import benchmark.harness.core, benchmark.harness.port, benchmark.controls\n"
        "from benchmark.harness import manifest\n"
        "for w in manifest.load_manifest()['workloads']:\n"
        "    c = manifest.find_cell(w['name']); manifest.load_driver(c); manifest.load_readers(c)\n"
        "import hyena_dna_tpu_torch.train.step, hyena_dna_tpu_torch.evals.hg38_inference\n"
        "import hyena_dna_tpu_torch.utils.registry, hyena_dna_tpu_torch.models")
    assert not top & BANNED, top & BANNED
    assert "hyena_dna_tpu_torch" in top  # compared whole: the port's name is allowed


def test_reference_imports_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.hyena_lm, benchmark.reference.control\n"
                       "import benchmark.counts.flops, benchmark.counts.roofline")
    assert not top & (BANNED | {"hyena_dna_tpu_torch"})


def test_harness_refuses_with_jax_loaded(monkeypatch):
    from benchmark.harness import core

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.banned_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "hyena_dna_tpu_torch_extra", object())
    assert "hyena_dna_tpu" not in core.banned_modules()
