"""The port's `Trainer` against the JAX `Trainer` on the downstream
experiments, `experiment=hg38/chromatin_profile` (919-way multilabel, here 3
labels) and `experiment=hg38/species_classification`, at the tiny overrides
of `tests/test_trainer.py`'s chromatin case (d_model 32, max_length 128,
float32), one device on both sides, `embed_dropout` 0 and a short warm-up
(`scheduler.warmup_t` 2, so the steps move the parameters).

As in tests/test_torch_port_finetune.py: the JAX initial parameters are
converted into the port before `fit`; every train loss and the val and test
losses agree within 2e-4 relative, accuracy is equal (the same decisions;
its float32 batch means may round one step apart, so within 1e-6),
`auroc_macro` and `auroc_median` within 1e-6, parameters within 1e-2 lr
per step.
"""

import numpy as np
import pytest

from hyena_dna_tpu.train.__main__ import build_config as jax_build_config
from hyena_dna_tpu.train.trainer import Trainer as JaxTrainer
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.train.trainer import Trainer
from test_torch_port_trainer import (assert_params_match, assert_rel, load_jax_params,
                                     one_torch_thread, records, train_losses)

__all__ = ["one_torch_thread"]  # the fixture shared with the trainer tests

TINY = ["model.d_model=32", "model.d_inner=128", "model.layer.filter_order=16",
        "model.embed_dropout=0.0", "trainer.precision=32", "trainer.log_every_n_steps=1",
        "scheduler.warmup_t=2", "dataset.batch_size=8", "dataset.num_workers=0"]


def _write_fasta(path, records_):
    with open(path, "w") as f:
        for name, seq in records_.items():
            f.write(f">{name}\n" + "".join(seq[i:i + 60] + "\n" for i in range(0, len(seq), 60)))


@pytest.fixture
def chromatin_data(tmp_path):
    """tests/test_trainer.py's chromatin fixture: label 0 is GC content
    above 0.5 (learnable), labels 1-2 noise."""
    rng = np.random.default_rng(0)
    genome = {"chr1": "".join(rng.choice(list("ACGT"), size=6000)),
              "chr2": "".join(rng.choice(list("ACGT"), size=6000))}
    fa = tmp_path / "genome.fa"
    _write_fasta(fa, genome)
    for split, n in (("train", 48), ("val", 16), ("test", 16)):
        with open(tmp_path / f"{split}_hg38_coords_targets.csv", "w") as f:
            f.write("Chr_No,Start,End,y_0,y_1,y_2\n")
            for i in range(n):
                chr_no = i % 2
                start = int(rng.integers(300, 4500))
                seq = genome[f"chr{chr_no + 1}"][start:start + 1000]
                gc = int((seq.count("G") + seq.count("C")) / len(seq) > 0.5)
                f.write(f"{chr_no},{start},{start + 1000},{gc},"
                        f"{int(rng.integers(0, 2))},{int(rng.integers(0, 2))}\n")
    return fa, tmp_path


@pytest.fixture
def species_dir(tmp_path):
    """Human and mouse, every chromosome of their splits; mouse GC-rich, so
    the species can be told apart."""
    rng = np.random.default_rng(1)
    root = tmp_path / "species"
    for spec, gc in (("human", 0.4), ("mouse", 0.6)):
        d = root / spec
        d.mkdir(parents=True)
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        for c in ("1", "3", "12", "13", "2", "4", "5", "7", "9", "10", "11", "6", "8", "14",
                  "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"):
            _write_fasta(d / f"chr{c}.fa", {f"chr{c}": "".join(rng.choice(list("ACGT"), size=600,
                                                                             p=p))})
    return root


def assert_accuracy(a, b, key):
    """Equal decisions: the float32 batch means within one rounding."""
    assert abs(a[key] - b[key]) <= 1e-6, (key, a[key], b[key])


def run_pair(tmp_path, argv):
    """The same overrides through each side's build_config and Trainer (one
    device), the JAX initial parameters in the port; both fitted."""
    cfg = lambda side: {**build_config(argv + [f"train.run_dir={tmp_path / side}"]),
                        "mesh": {"data": 1}}
    jcfg = jax_build_config(argv + [f"train.run_dir={tmp_path / 'jax'}"])
    jcfg["mesh"] = {"data": 1}
    jt = JaxTrainer(jcfg)
    pt = Trainer(cfg("port"), device="cpu")
    load_jax_params(pt, jt)
    final_jax, final_port = jt.fit(), pt.fit()
    pt.close()
    ours, ref = train_losses(tmp_path / "port"), train_losses(tmp_path / "jax")
    assert ours and [s for s, _ in ours] == [s for s, _ in ref]
    for (step, a), (_, b) in zip(ours, ref):
        assert_rel(a, b, what=f"train/loss at step {step}")
    assert_rel(final_port["test/loss"], final_jax["test/loss"], what="test/loss")
    val = lambda d: [r for r in records(d) if "val/loss" in r]
    pairs = list(zip(val(tmp_path / "port"), val(tmp_path / "jax")))
    assert pairs
    for a, b in pairs:
        assert_rel(a["val/loss"], b["val/loss"], what="val/loss")
    assert_params_match(pt, jt, steps=pt.global_step)
    return final_port, final_jax, pairs


def test_chromatin_profile_trainer_matches_jax(tmp_path, chromatin_data):
    fa, data = chromatin_data
    argv = ["experiment=hg38/chromatin_profile", f"dataset.ref_genome_path={fa}",
            f"dataset.data_path={data}", "dataset.d_output=3", "dataset.max_length=128",
            "model.layer.l_max=130", "trainer.max_epochs=2", *TINY]
    final_port, final_jax, pairs = run_pair(tmp_path, argv)
    for split, (a, b) in [("test", (final_port, final_jax))] + [("val", p) for p in pairs]:
        assert_accuracy(a, b, f"{split}/binary_accuracy")
        for name in ("auroc_macro", "auroc_median"):
            key = f"{split}/{name}"
            assert 0.0 <= a[key] <= 1.0
            assert abs(a[key] - b[key]) <= 1e-6, key
    assert np.isfinite(final_port["test/loss"])


def test_species_classification_trainer_matches_jax(tmp_path, species_dir):
    argv = ["experiment=hg38/species_classification", f"dataset.species_dir={species_dir}",
            "dataset.max_length=128", "dataset.total_size=64", "trainer.max_epochs=2", *TINY]
    final_port, final_jax, pairs = run_pair(tmp_path, argv)
    assert_accuracy(final_port, final_jax, "test/accuracy")
    for a, b in pairs:
        assert_accuracy(a, b, "val/accuracy")
