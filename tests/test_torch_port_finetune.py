"""The port's downstream path held against the JAX package on the CPU:
GenomicBenchmarks classification through `DNAEmbeddingModel` and a
`SequenceDecoder` head (pool mode), fine-tuning from the LM run's
checkpoint with `freeze_backbone`, each decoder and mode, the embedding
model, and the `load_backbone` hook and checkpoint reader.

Trainer parity as in tests/test_torch_port_trainer.py: the same config on
both sides (float32, `embed_dropout` 0, one device), the JAX trainer's
initial parameters (after its `load_backbone` hook) converted into the
port's before `fit`; every train loss and the val / test loss within 2e-4
relative, accuracy equal, final parameters within 1e-2 lr per step.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import heads as JH
from hyena_dna_tpu.models.lm import DNAEmbeddingModel as JaxDNAEmbeddingModel
from hyena_dna_tpu.train.trainer import Trainer as JaxTrainer
from hyena_dna_tpu_torch.models import heads as H
from hyena_dna_tpu_torch.models.lm import DNAEmbeddingModel
from hyena_dna_tpu_torch.train import checkpoint as C
from hyena_dna_tpu_torch.train.trainer import Trainer
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from test_torch_port_trainer import (assert_params_match, assert_rel, jax_params_as_torch,
                                     lm_config, load_jax_params, one_torch_thread, records,
                                     tiny_genome, train_losses)

__all__ = ["one_torch_thread", "tiny_genome"]  # fixtures shared with the trainer tests


@pytest.fixture
def tiny_benchmark(tmp_path):
    """The GenomicBenchmarks fixture of tests/test_trainer.py."""
    rng = np.random.default_rng(1)
    root = tmp_path / "bench" / "toy_task"
    for split in ("train", "test"):
        for label, motif in (("pos", "ACGTACGT"), ("neg", "TTTTCCCC")):
            d = root / split / label
            d.mkdir(parents=True)
            n = 32 if split == "train" else 8
            for i in range(n):
                pad = "".join(rng.choice(list("ACGT"), size=24))
                (d / f"{i}.txt").write_text(motif + pad)
    return tmp_path / "bench"


def cls_config(run_dir, bench, **train):
    return {
        "train": {"seed": 0, "run_dir": str(run_dir), **train},
        "mesh": {"data": 1},
        "trainer": {"max_epochs": 2, "precision": "32", "log_every_n_steps": 1},
        "dataset": {"_name_": "genomic_benchmark", "dataset_name": "toy_task",
                    "dest_path": str(bench), "d_output": 2, "batch_size": 8,
                    "max_length": 32, "use_padding": True},
        "task": {"_name_": "multiclass", "loss": "cross_entropy", "metrics": ["accuracy"],
                 "host_metrics": ["mcc", "f1_macro", "roc_auc_macro"]},
        "model": {"_name_": "dna_embedding", "d_model": 32, "n_layer": 2, "d_inner": 128,
                  "vocab_size": 12, "pad_vocab_size_multiple": 8, "embed_dropout": 0.0,
                  "layer": {"_name_": "hyena", "emb_dim": 5, "filter_order": 16,
                            "l_max": 66, "w": 10}},
        "decoder": {"_name_": "sequence", "mode": "pool", "l_output": 0},
        "optimizer": {"lr": 1e-3, "weight_decay": 0.0},
        "callbacks": {},
    }


def assert_cls_match(port_dir, jax_dir, final_port, final_jax):
    ours, ref = train_losses(port_dir), train_losses(jax_dir)
    assert ours and [s for s, _ in ours] == [s for s, _ in ref]
    for (step, a), (_, b) in zip(ours, ref):
        assert_rel(a, b, what=f"train/loss at step {step}")
    assert_rel(final_port["test/loss"], final_jax["test/loss"], what="test/loss")
    assert final_port["test/accuracy"] == final_jax["test/accuracy"]
    for name in ("mcc", "f1_macro", "roc_auc_macro"):
        assert abs(final_port[f"test/{name}"] - final_jax[f"test/{name}"]) <= 1e-6, name
    val = lambda d: [r for r in records(d) if "val/loss" in r]
    for a, b in zip(val(port_dir), val(jax_dir)):
        assert_rel(a["val/loss"], b["val/loss"], what="val/loss")
        assert a["val/accuracy"] == b["val/accuracy"]


def test_classification_trainer_matches_jax(tmp_path, tiny_benchmark):
    cfg = lambda d: cls_config(tmp_path / d, tiny_benchmark)
    jt = JaxTrainer(cfg("jax"))
    pt = Trainer(cfg("port"), device="cpu")
    load_jax_params(pt, jt)
    final_jax, final_port = jt.fit(), pt.fit()
    pt.close()
    assert_cls_match(tmp_path / "port", tmp_path / "jax", final_port, final_jax)
    assert final_port["test/accuracy"] > 0.5  # separable motifs, two epochs
    assert_params_match(pt, jt, steps=pt.global_step)


def test_frozen_finetune_matches_jax(tmp_path, tiny_genome, tiny_benchmark):
    """Pretrain the LM on each side, fine-tune from its checkpoint with
    freeze_backbone: the port's hook loads its own checkpoint (held to the
    JAX one at the LM run's tolerance), no backbone element moves, the head
    does, and the run matches the JAX one."""
    fa, bed = tiny_genome
    lm = {}
    for side, cls, kw in (("jax", JaxTrainer, {}), ("port", Trainer, {"device": "cpu"})):
        cfg = lm_config(tmp_path / f"lm_{side}", fa, bed)
        cfg["trainer"]["max_epochs"] = 1
        lm[side] = cls(cfg, **kw)
    load_jax_params(lm["port"], lm["jax"])
    lm["jax"].fit()
    lm["port"].fit()
    lm["port"].close()

    hook = {"_name_": "load_backbone", "freeze_backbone": True}
    ckpt = lambda side: str(tmp_path / f"lm_{side}" / "checkpoints" / "last")
    jt = JaxTrainer(cls_config(tmp_path / "jax", tiny_benchmark, pretrained_model_path=ckpt("jax"),
                               pretrained_model_state_hook=hook))
    pt = Trainer(cls_config(tmp_path / "port", tiny_benchmark,
                            pretrained_model_path=ckpt("port"),
                            pretrained_model_state_hook=hook), device="cpu")
    assert pt.frozen_labels and all(
        (v == "frozen") == k.startswith("backbone.") for k, v in pt.frozen_labels.items())
    # the port's hook loaded its own LM run's final parameters
    ref = jax_params_as_torch(jt)
    tol = 1e-2 * sum(float(lm["port"].lr_fn(s)) for s in range(8)) + 1e-6
    for name, p in pt.model.named_parameters():
        if name.startswith("backbone."):
            assert (p.detach() - ref[name]).abs().max().item() <= tol, name
    logged = next(r for r in records(tmp_path / "port") if "pretrained/loaded_tensors" in r)
    assert logged["pretrained/loaded_tensors"] == next(
        r for r in records(tmp_path / "jax")
        if "pretrained/loaded_tensors" in r)["pretrained/loaded_tensors"]

    load_jax_params(pt, jt)
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    final_jax, final_port = jt.fit(), pt.fit()
    pt.close()
    after = dict(pt.model.named_parameters())
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    assert moved and all(not n.startswith("backbone.") for n in moved), moved
    assert_cls_match(tmp_path / "port", tmp_path / "jax", final_port, final_jax)
    assert_params_match(pt, jt, steps=pt.global_step)


# ---- modules ---------------------------------------------------------------

D, L, B = 16, 12, 3


def _jax_head(module, x, **kw):
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw).get("params", {})
    out = module.apply({"params": params}, jnp.asarray(x), **kw)
    return params, np.asarray(out)


def _port_head(module, params, x, **kw):
    if params:
        module.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                               params)))
    kw = {k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}
    return module(torch.from_numpy(x), **kw).detach().numpy()


@pytest.mark.parametrize("mode,l_output,masked", [
    ("last", None, False), ("last", 3, False), ("last", 0, False), ("first", 2, False),
    ("first", 0, False), ("pool", None, False), ("pool", 4, False), ("pool", 0, False),
    ("pool", 0, True), ("sum", 2, False), ("sum", 0, False), ("ragged", 0, False),
    ("ragged", None, False)])
@pytest.mark.parametrize("d_output", [None, 5])
def test_sequence_decoder_matches_jax(mode, l_output, masked, d_output):
    x = np.random.default_rng(0).standard_normal((B, L, D)).astype(np.float32)
    kw = {}
    if masked:
        mask = np.zeros((B, L), np.int32)
        for i, n in enumerate((L, 5, 9)):
            mask[i, :n] = 1
        kw["mask"] = mask
    if mode == "ragged":
        kw["lengths"] = np.array([L, 4, 7])
    jm = JH.SequenceDecoder(d_model=D, d_output=d_output, l_output=l_output, mode=mode)
    params, ref = _jax_head(jm, x, **kw)
    pm = H.SequenceDecoder(D, d_output, l_output, mode)
    out = _port_head(pm, params, x, **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["pool", "sum"])
def test_sequence_decoder_bf16_sums_in_float32(mode):
    """bf16 hidden states: the running sums accumulate in float32 and round
    once (the float32 sums of the JAX module, rounded to bf16)."""
    x = (np.random.default_rng(5).standard_normal((4, 1024, D)) + 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jm = JH.SequenceDecoder(d_model=D, l_output=0, mode=mode)
    ref = np.asarray(jm.apply({}, jnp.asarray(xb.float().numpy())))
    out = H.SequenceDecoder(D, None, 0, mode)(xb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  torch.from_numpy(ref).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("mode", ["pool", "sum"])
def test_sequence_decoder_bf16_agrees_with_jax_bf16(mode):
    """The float32 running sums are a deliberate departure from the JAX
    module, which sums bf16 hidden states in bf16. The two bf16 results agree
    within 1e-2 of max|sum| (a bf16 sum over 1024 positions drifts by a few
    of its steps, 2^-8 relative each), and the port's stands nearer the exact
    float32 sums than the JAX module's does."""
    x = (np.random.default_rng(5).standard_normal((4, 1024, D)) + 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jm = JH.SequenceDecoder(d_model=D, l_output=0, mode=mode)
    exact = np.asarray(jm.apply({}, jnp.asarray(xb.float().numpy())))
    jax_bf16 = np.asarray(jm.apply({}, jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
                          np.float32)
    out = H.SequenceDecoder(D, None, 0, mode)(xb).float().numpy()
    scale = np.abs(exact).max()
    assert np.abs(out - jax_bf16).max() <= 1e-2 * scale
    assert np.abs(out - exact).max() < np.abs(jax_bf16 - exact).max()


@pytest.mark.parametrize("case", ["token", "nd_pool", "nd_full", "retrieval_nli",
                                  "retrieval_concat", "pack"])
def test_other_decoders_match_jax(case):
    x = np.random.default_rng(1).standard_normal((2 * B, L, D)).astype(np.float32)
    jm, pm = {
        "token": (JH.TokenDecoder(d_model=D, d_output=3), H.TokenDecoder(D, 3)),
        "nd_pool": (JH.NDDecoder(d_model=D, d_output=4), H.NDDecoder(D, 4)),
        "nd_full": (JH.NDDecoder(d_model=D, d_output=4, mode="full"),
                    H.NDDecoder(D, 4, mode="full")),
        "retrieval_nli": (JH.RetrievalDecoder(d_input=D, n_classes=3, d_model=8),
                          H.RetrievalDecoder(D, 3, d_model=8)),
        "retrieval_concat": (JH.RetrievalDecoder(d_input=D, n_classes=3, d_model=8, nli=False,
                                                 activation="gelu"),
                             H.RetrievalDecoder(D, 3, d_model=8, nli=False, activation="gelu")),
        "pack": (JH.PackedDecoder(), H.PackedDecoder()),
    }[case]
    if case == "pack":
        np.testing.assert_array_equal(pm(torch.from_numpy(x)).numpy(),
                                      np.asarray(jm(jnp.asarray(x))))
        return
    params, ref = _jax_head(jm, x)
    np.testing.assert_allclose(_port_head(pm, params, x), ref, rtol=2e-5, atol=2e-6)


def test_state_decoder_matches_jax():
    state = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    jm = JH.StateDecoder(d_model=D, d_output=3)
    x = np.zeros((B, L, D), np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), state=jnp.asarray(state))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), state=jnp.asarray(state)))
    pm = H.StateDecoder(D, 3)
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    out = pm(torch.from_numpy(x), state=torch.from_numpy(state)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("make", [
    lambda: H.SequenceDecoder(D, 4, init_std=0.05), lambda: H.TokenDecoder(D, 4, init_std=0.05),
    lambda: H.NDDecoder(D, 4, init_std=0.05), lambda: H.RetrievalDecoder(D, 3, d_model=8),
    lambda: H.StateDecoder(D, 3)])
def test_decoder_init_is_seeded_and_scaled(make):
    a, b = make(), make()
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
    w = next(p for n, p in a.named_parameters() if n.endswith("weight"))
    assert 0.3 < float(w.detach().std()) / (0.05 if hasattr(a, "init_std") else w.shape[1] ** -0.5) < 1.7


def test_dna_embedding_model_matches_jax():
    """Hidden states of the embedding model, as tests/test_lm.py:44 builds it."""
    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
               embed_dropout=0.0)
    layer = dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=66, w=10)
    ids = np.random.default_rng(4).integers(7, 12, size=(2, 64)).astype(np.int32)
    jm = JaxDNAEmbeddingModel(layer=layer, **cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    ref, state = jm.apply({"params": params}, jnp.asarray(ids))
    assert state is None
    pm = DNAEmbeddingModel(layer=layer, **cfg).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    out = pm(torch.from_numpy(ids).long()).detach().numpy()
    assert out.shape == (2, 64, 32) and pm.d_output == 32
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_load_backbone_hook_canonicalises_nested_prefixes():
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
    from hyena_dna_tpu_torch.train.trainer import BackboneWithDecoder

    cfg = dict(d_model=16, n_layer=1, d_inner=32, vocab_size=12, pad_vocab_size_multiple=8,
               layer=dict(_name_="hyena", emb_dim=5, filter_order=8, l_max=34, w=10))
    lm = ConvLMHeadModel(generator=torch.Generator().manual_seed(0), **cfg)
    model = BackboneWithDecoder(DNAEmbeddingModel(generator=torch.Generator().manual_seed(1),
                                                  **cfg), H.SequenceDecoder(16, 2, 0, "pool"))
    head = {n: p.detach().clone() for n, p in model.decoder.named_parameters()}
    _, info = C.load_backbone_hook(model, lm.state_dict(), freeze_backbone=True)
    ref = lm.state_dict()
    for name, p in model.state_dict().items():
        if name.startswith("backbone."):
            assert torch.equal(p, ref[name[len("backbone."):]]), name
    for name, p in model.decoder.named_parameters():
        assert torch.equal(p, head[name])
    assert info["loaded"] == len([n for n, _ in model.named_parameters()
                                  if n.startswith("backbone.")])
    assert set(info["frozen"]) == {n for n, _ in model.named_parameters()}
    with pytest.raises(ValueError, match="matched no tensors"):
        C.load_backbone_hook(model, {"decoder.output_transform.weight": torch.zeros(2, 16)})
    bad = dict(ref)
    bad["backbone.ln_f.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch"):
        C.load_backbone_hook(model, bad)


def test_checkpoint_reader_refuses_orbax(tmp_path):
    orbax = tmp_path / "last"
    (orbax / "8").mkdir(parents=True)
    (orbax / "8" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        C.load_pretrained(tmp_path)
    with pytest.raises(ValueError, match="Orbax"):
        C.restore_params_only(orbax)


def test_checkpoint_reads_reference_state_dicts(tmp_path):
    """A reference `.ckpt` (Lightning prefix, tied head) and a directory
    holding `weights.ckpt` load as state dicts."""
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel

    lm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=12,
                         layer=dict(_name_="hyena", emb_dim=5, filter_order=8, l_max=34, w=10))
    sd = {f"model.{k}": v for k, v in lm.state_dict().items()}
    sd["model.lm_head.weight"] = lm.backbone.embeddings.word_embeddings.weight
    torch.save({"state_dict": sd}, tmp_path / "weights.ckpt")
    for path in (tmp_path / "weights.ckpt", tmp_path):
        got = C.load_pretrained(path)
        assert set(got) == set(lm.state_dict())


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
    from hyena_dna_tpu_torch.train.optim import build_optimizer
    from hyena_dna_tpu_torch.train.state import create_train_state

    lm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=12,
                         layer=dict(_name_="hyena", emb_dim=5, filter_order=8, l_max=34, w=10))
    state = create_train_state(lm, build_optimizer(lm)[0])
    for step in (1, 2, 3):
        C.save_checkpoint(tmp_path, state, step, loader_state={"epoch": step}, keep=2)
    assert C.latest_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "host_state_2.json", "host_state_3.json", "state_2.pt", "state_3.pt"]
    _, loader_state, _ = C.restore_checkpoint(tmp_path, state, step=2)
    assert loader_state == {"epoch": 2}
