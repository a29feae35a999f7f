"""The port's hg38 inference entry point against the JAX CLI, and the
guards that keep the port free of JAX and of hidden fallbacks."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hyena_dna_tpu_torch
from hyena_dna_tpu_torch.evals import hg38_inference as port_cli
from hyena_dna_tpu_torch.ops.fused_fftconv import fftconv_fused
from hyena_dna_tpu_torch.ops.fused_front import fused_proj_conv_gate

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(hyena_dna_tpu_torch.__file__).parent


def _write_fasta(path, lengths, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for name, n in lengths.items():
            seq = "".join(rng.choice(list("ACGTacgN"), size=n))
            f.write(f">{name} synthetic\n")
            f.writelines(seq[i:i + 60] + "\n" for i in range(0, n, 60))


def test_cli_loss_matches_jax_cli(tmp_path):
    from hyena_dna_tpu.evals import hg38_inference as jax_cli

    fasta = tmp_path / "tiny.fa"
    _write_fasta(fasta, {"chrA": 1400, "chrB": 500})
    ckpt = tmp_path / "weights.pt"
    model = port_cli.build_model(32, 2, 256, generator=torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), ckpt)
    argv = ["--ckpt", str(ckpt), "--fasta", str(fasta), "--max_length", "256",
            "--d_model", "32", "--n_layer", "2", "--batch_size", "2",
            "--chr_ranges", "chrA:0-1300", "chrB:100-400"]
    ref = jax_cli.main(argv)
    ours = port_cli.main(argv + ["--device", "cpu"])
    assert ours["tokens"] == ref["tokens"] == 8 * 256
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
    assert np.isfinite(ours["loss"]) and ours["eval_seconds"] > 0


def test_fixed_dataset_matches_jax(tmp_path):
    from hyena_dna_tpu.data.hg38 import HG38FixedDataset as JaxDataset

    from hyena_dna_tpu_torch.data.hg38 import HG38FixedDataset

    fasta = tmp_path / "d.fa"
    _write_fasta(fasta, {"chrA": 700, "chrB": 300}, seed=3)
    ranges = {"chrA": (10, 650), "chrB": (0, 300)}
    ref = JaxDataset(fasta_file=str(fasta), chr_ranges=ranges, max_length=128, add_eos=True)
    ours = HG38FixedDataset(str(fasta), ranges, max_length=128, add_eos=True)
    assert len(ours) == len(ref) == 8
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    ours.close()
    ref.close()


def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    """--device defaults to cuda; with no card the entry point raises and
    does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta = tmp_path / "t.fa"
    _write_fasta(fasta, {"chrA": 100})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--ckpt", "unused.pt", "--fasta", str(fasta),
                       "--chr_ranges", "chrA:0-100"])


def test_wrappers_have_no_fallback_for_other_devices():
    """A wrapper runs its plain version only for a CPU tensor."""
    u = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_proj_conv_gate(u, u, u, u, u)
    with pytest.raises(ValueError, match="no kernel"):
        fftconv_fused(u, u[0], u[0, 0])


def _port_modules():
    names = []
    for p in sorted(PORT.rglob("*.py")):
        parts = ("hyena_dna_tpu_torch",) + p.relative_to(PORT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_port_imports_without_jax():
    names = _port_modules()
    code = ("import sys\n"
            "for blocked in ('jax', 'jaxlib', 'flax', 'hyena_dna_tpu'):\n"
            "    sys.modules[blocked] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "hyena_dna_tpu"), (path, mod)
    # nor a dynamic import of the JAX package by name
    assert not re.search(r"""["']hyena_dna_tpu(\.|["'])""", Path(path).read_text())


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
