"""The port's `Trainer` held against the JAX `Trainer` on the CPU: the hg38
LM config with its callbacks, resume from `checkpoints/last`, the
step-bounded epoch's data order, config composition over every experiment
file, and the trainer's refusals (no card, a mesh over several ranks in one
process, tensor parallelism).

Both trainers run the same config (float32, `embed_dropout` 0, one device,
d_model 32, 2 layers, L 64, every step logged); the JAX trainer's initial
parameters, converted with `utils/convert.py`, are loaded into the port's
before `fit`, and the two loaders give the same batches from the seed.
Tolerances: every logged train loss, and the val / test loss and
perplexity, within 2e-4 relative; final parameters within the Adam rule of
PERF.md section 2, 1e-2 lr per step of each element.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyena_dna_tpu.train.__main__ import build_config as jax_build_config
from hyena_dna_tpu.train.trainer import Trainer as JaxTrainer
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.train.trainer import Trainer
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

RTOL = 2e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_genome(tmp_path):
    """The genome fixture of tests/test_trainer.py."""
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=4096))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\n")
    bed = tmp_path / "g.bed"
    with open(bed, "w") as f:
        for i in range(32):
            f.write(f"chr1\t{i * 128}\t{i * 128 + 64}\ttrain\n")
        for i in range(4):
            f.write(f"chr1\t{i * 64}\t{i * 64 + 64}\tvalid\n")
        for i in range(4):
            f.write(f"chr1\t{2048 + i * 64}\t{2048 + i * 64 + 64}\ttest\n")
    return fa, bed


def lm_config(run_dir, fa, bed, **extra_train):
    return {
        "train": {"seed": 1, "run_dir": str(run_dir), **extra_train},
        "mesh": {"data": 1},
        "trainer": {"max_epochs": 2, "precision": "32", "gradient_clip_val": 1.0,
                    "log_every_n_steps": 1},
        "dataset": {"_name_": "hg38", "bed_file": str(bed), "fasta_file": str(fa),
                    "batch_size": 4, "max_length": 64, "add_eos": True},
        "task": {"_name_": "hg38", "loss": "cross_entropy"},
        "model": {"_name_": "lm", "d_model": 32, "n_layer": 2, "d_inner": 128,
                  "vocab_size": 12, "pad_vocab_size_multiple": 8, "embed_dropout": 0.0,
                  "layer": {"_name_": "hyena", "emb_dim": 5, "filter_order": 16,
                            "l_max": 66, "w": 10, "lr": 6e-4, "wd": 0.0,
                            "lr_pos_emb": 0.0}},
        "optimizer": {"lr": 3e-3, "weight_decay": 0.1},
        "scheduler": {"_name_": "cosine_warmup_timm", "t_initial": 64,
                      "warmup_t": 4, "lr_min": 3e-4, "warmup_lr_init": 1e-6},
        "callbacks": {"timer": {}, "params": {}, "learning_rate_monitor": {},
                      "model_checkpoint": {"monitor": "val/loss", "mode": "min"}},
    }


def jax_params_as_torch(trainer):
    return flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, trainer.state.params))


def load_jax_params(port, jax_trainer):
    """The JAX trainer's parameters into the port's model (every entry)."""
    missing, unexpected = port.model.load_state_dict(jax_params_as_torch(jax_trainer),
                                                     strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith(("pos_emb.t", ".freq")) for k in missing), missing


def records(run_dir):
    return [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]


def train_losses(run_dir):
    return [(r["step"], r["train/loss"]) for r in records(run_dir) if "train/loss" in r]


def assert_rel(a, b, rtol=RTOL, what=""):
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), f"{what}: {a} vs {b}"


def assert_results_match(ours, ref, keys):
    for k in keys:
        assert_rel(ours[k], ref[k], what=k)


def lr_sum(trainer, steps):
    """The largest group lr summed over the steps run (the Adam rule's scale)."""
    return sum(float(trainer.lr_fn(s)) for s in range(steps))


def assert_params_match(port, jax_trainer, steps, lr_scale=1.0):
    ref = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          jax_trainer.state.params),
                                   buffers=False)
    ours = dict(port.model.named_parameters())
    tol = 1e-2 * lr_scale * lr_sum(port, steps) + 1e-6
    worst = {}
    for name, want in ref.items():
        if name not in ours:  # the shared Sin freq: one parameter, several names
            assert name.endswith(".freq")
            continue
        err = (ours[name].detach().cpu().float() - want.float()).abs().max().item()
        worst[name] = err
        assert err <= tol, f"{name}: {err} > {tol}"
    return worst


def run_pair(cfg_port, cfg_jax):
    jt = JaxTrainer(cfg_jax)
    pt = Trainer(cfg_port, device="cpu")
    load_jax_params(pt, jt)
    final_jax = jt.fit()
    final_port = pt.fit()
    pt.close()
    return pt, jt, final_port, final_jax


def test_lm_trainer_matches_jax(tmp_path, tiny_genome):
    """The hg38 LM config with callbacks: every train loss, val and test
    loss and perplexity, the callbacks' records and the final parameters."""
    fa, bed = tiny_genome
    pt, jt, final_port, final_jax = run_pair(lm_config(tmp_path / "port", fa, bed),
                                             lm_config(tmp_path / "jax", fa, bed))
    ours, ref = train_losses(tmp_path / "port"), train_losses(tmp_path / "jax")
    assert [s for s, _ in ours] == [s for s, _ in ref] == list(range(1, 17))
    for (step, a), (_, b) in zip(ours, ref):
        assert_rel(a, b, what=f"train/loss at step {step}")
    assert_results_match(final_port, final_jax, ("test/loss", "test/ppl"))
    val = lambda d: [r for r in records(d) if "val/loss" in r]
    for a, b in zip(val(tmp_path / "port"), val(tmp_path / "jax")):
        assert_results_match(a, b, ("val/loss", "val/ppl", "train/ppl"))
    # the callbacks logged what the JAX ones log
    params = lambda d: next(r for r in records(d) if "params/total" in r)
    assert {k: v for k, v in params(tmp_path / "port").items() if k.startswith("params/")} \
        == {k: v for k, v in params(tmp_path / "jax").items() if k.startswith("params/")}
    lrs = lambda d: [r["lr"] for r in records(d) if "lr" in r]
    np.testing.assert_allclose(lrs(tmp_path / "port"), lrs(tmp_path / "jax"), rtol=1e-6)
    for d in ("port", "jax"):
        assert (tmp_path / d / "checkpoints" / "last").is_dir()
        assert (tmp_path / d / "checkpoints" / "best").is_dir()
    assert_params_match(pt, jt, steps=16)


def _record_batches(trainer):
    seen = []
    step = trainer.train_step

    def recording(state, batch, generator=None):
        seen.append((trainer.epoch, batch[0].cpu().numpy().copy()))
        return step(state, batch, generator)

    trainer.train_step = recording
    return seen


def test_resume_matches_uninterrupted(tmp_path, tiny_genome):
    """One epoch, then a resume from checkpoints/last to the second: the
    same parameters (bit for bit on the CPU) and the same batches as two
    epochs at once, and the step count continues."""
    fa, bed = tiny_genome
    whole = Trainer(lm_config(tmp_path / "whole", fa, bed), device="cpu")
    seen_whole = _record_batches(whole)
    whole.fit()

    first = lm_config(tmp_path / "cut", fa, bed)
    first["trainer"]["max_epochs"] = 1
    t1 = Trainer(first, device="cpu")
    seen_cut = _record_batches(t1)
    t1.fit()
    assert t1.global_step == 8
    ckpt = str(tmp_path / "cut" / "checkpoints" / "last")
    t2 = Trainer(lm_config(tmp_path / "cut", fa, bed, ckpt=ckpt), device="cpu")
    seen_resumed = _record_batches(t2)
    t2.fit()
    seen_cut += seen_resumed
    assert t2.global_step == whole.global_step == 16 and t2.epoch == 2
    assert len(seen_cut) == len(seen_whole)
    for (ea, a), (eb, b) in zip(seen_cut, seen_whole):
        assert ea == eb and np.array_equal(a, b)
    ref = dict(whole.model.named_parameters())
    for name, p in t2.model.named_parameters():
        assert torch.equal(p, ref[name]), name
    assert t2.state.step == whole.state.step == 16


def test_limit_train_batches_advances_data_order(tmp_path, tiny_genome):
    """Step-bounded epochs still move to the next epoch's permutation."""
    fa, bed = tiny_genome
    cfg = lm_config(tmp_path / "run", fa, bed)
    cfg["trainer"].update(limit_train_batches=2, max_epochs=3)
    cfg["callbacks"] = {}
    t = Trainer(cfg, device="cpu")
    seen = _record_batches(t)
    t.fit()
    assert [e for e, _ in seen] == [0, 0, 1, 1, 2, 2]
    assert not np.array_equal(seen[0][1], seen[2][1])


@pytest.mark.parametrize("experiment", sorted(
    str(p.relative_to(Path(__file__).resolve().parents[1] / "configs" / "experiment")
        .with_suffix(""))
    for p in (Path(__file__).resolve().parents[1] / "configs" / "experiment").rglob("*.yaml")))
def test_config_composition_matches_jax(experiment):
    """The port's composed config equals the JAX one for every experiment file."""
    argv = [f"experiment={experiment}", "trainer.max_epochs=3", "optimizer.lr=1e-3"]
    assert build_config(argv) == jax_build_config(argv)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path, tiny_genome, monkeypatch):
    fa, bed = tiny_genome
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(lm_config(tmp_path / "run", fa, bed))


@pytest.mark.parametrize("mesh", [{"data": 2}, {"seq": 2}, {"model": 2}])
def test_trainer_refuses_a_mesh_over_cards(tmp_path, tiny_genome, mesh):
    """A data, seq or model axis over several ranks in one process (no
    torchrun) raises and says how to launch."""
    fa, bed = tiny_genome
    cfg = lm_config(tmp_path / "run", fa, bed)
    cfg["mesh"] = mesh
    with pytest.raises(ValueError, match="one process per rank with torchrun"):
        Trainer(cfg, device="cpu")


def test_trainer_calls_set_card_numerics(tmp_path, tiny_genome, monkeypatch):
    from hyena_dna_tpu_torch.train import trainer as T

    calls = []
    monkeypatch.setattr(T, "set_card_numerics", lambda: calls.append(1))
    fa, bed = tiny_genome
    T.Trainer(lm_config(tmp_path / "run", fa, bed), device="cpu").close()
    assert calls == [1]
