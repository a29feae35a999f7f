"""The port's tensor parallelism on the CPU: a mesh's model axis through
the layers, the Hyena operator and the LM, against the port's whole modules
and the JAX package.

One world of 4 gloo ranks (`parallel.spawn`;
`tests/torch_parallel_workers.py::tensor_parallel`) runs every rank-side
check: the collectives and the split layers (`Mlp`'s column- and
row-parallel products, the vocab-parallel embedding and tied head, `MHA`
with 8 heads over 4 ranks) against the same modules run whole, 1e-6; the
Hyena operator (d 32) and tests/test_seq_parallel.py's tensor-parallel LM
(d 32 x 2, d_inner 128, vocab 12 padded to 16, L 128, B 2) on a model
axis of 4 and on seq 2 x model 2, each from the JAX module's parameters
(`utils/convert.py`, then `shard_state_dict`), against the unsharded JAX
module and the JAX LM placed by `shard_params` on
`make_mesh(data=1, seq=1, model=4)` of the conftest's virtual devices:
the loss within 1e-5 and every gathered whole gradient within 5e-4 / 5e-3
(atol / rtol), that JAX test's tolerances; then the clip norm and a
clipped LAMB step on model 4 against one process, 1e-6 relative.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as W
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM, HyenaOperator as JaxOp
from hyena_dna_tpu.parallel import make_mesh as jax_make_mesh
from hyena_dna_tpu.parallel.sharding import shard_params
from hyena_dna_tpu_torch.parallel import spawn
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.utils.registry import MODEL_REGISTRY
from hyena_dna_tpu_torch.parallel.sharding import Mesh, shard_state_dict, shard_tensor
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

WORLD = 4
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _jax_lm_loss(model, targets):
    def f(p, x):
        logits, _ = model.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))
    return f


@pytest.fixture(scope="module")
def jax_side():
    """The JAX operator's and LM's parameters, the LM's loss and gradients
    whole and placed on the model axis of 4 devices, the operator's output
    and gradients."""
    a = W.tp_inputs()
    op, lm = JaxOp(**W.TP_OP_KW), JaxLM(**W.TP_LM_KW)
    u, tokens = jnp.asarray(a["op_u"]), jnp.asarray(a["tokens"])
    op_params = op.init(jax.random.PRNGKey(2), u)["params"]
    lm_params = lm.init(jax.random.PRNGKey(5), tokens)["params"]
    y, vjp = jax.vjp(lambda p, x: op.apply({"params": p}, x), op_params, u)
    d_params, du = vjp(jnp.asarray(a["op_dy"]))
    f = _jax_lm_loss(lm, jnp.roll(tokens, -1, axis=1))
    mesh = jax_make_mesh(data=1, seq=1, model=4, devices=jax.devices()[:4])
    p_tp = shard_params(lm_params, mesh)
    x_tp = jax.device_put(tokens, NamedSharding(mesh, P()))
    return {"params": {"op": to_np(op_params), "lm": to_np(lm_params)},
            "op": {"y": np.asarray(y), "du": np.asarray(du), "grads": to_np(d_params)},
            "lm": {"loss": float(f(lm_params, tokens)),
                   "grads": to_np(jax.grad(f)(lm_params, tokens))},
            "lm_sharded": {"loss": float(jax.jit(f)(p_tp, x_tp)),
                           "grads": to_np(jax.jit(jax.grad(f))(p_tp, x_tp))}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    out = tmp_path_factory.mktemp("tensor_parallel")
    torch.save({k: flax_to_torch_state_dict(v) for k, v in jax_side["params"].items()},
               out / "params.pt")
    spawn(W.tensor_parallel, WORLD, args=(str(out), str(out / "params.pt")))
    return [torch.load(out / f"tp_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(ours, ref, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(ours, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def test_mesh_coordinates(ranks):
    """Model innermost: rank = (d * S + s) * M + m on both meshes."""
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]


@pytest.mark.parametrize("layer", ["mlp", "embedding", "mha"])
def test_split_layers_match_whole(ranks, layer):
    """Each split layer's outputs, input gradients and gathered whole
    parameter gradients equal the whole layer's on every rank, 1e-6; its
    sharded parameters are the JAX rules' (fc1 and fc2; the vocabulary
    rows; Wqkv by heads and out_proj)."""
    sharded = {"mlp": ["fc1.bias", "fc1.weight", "fc2.weight"],
               "embedding": ["word_embeddings.weight"],
               "mha": ["Wqkv.bias", "Wqkv.weight", "out_proj.weight"]}[layer]
    for r in ranks:
        res = r["layers"][layer]
        ref, ours = res["ref"], res["tp"]
        assert ours["sharded"] == sharded
        for a, b in zip(ours["out"] + ours["dx"], ref["out"] + ref["dx"]):
            _close(a, b, 1e-6, 1e-6 * float(b.abs().max()), layer)
        assert set(ours["grads"]) == set(ref["grads"])
        for name, g in ref["grads"].items():
            _close(ours["grads"][name], g, 1e-6, 1e-6 * float(g.abs().max()), name)


def _assert_grads(ours: dict, aliases: dict, ref_tree, what: str):
    """Every parameter's gradient by name: the port's parameters, with
    each second name of a shared tensor (`aliases`: the Sin `freq`), are
    exactly the JAX module's, and each one's gradient matches."""
    ref = flax_to_torch_state_dict(ref_tree, buffers=False)
    assert not set(ours) & set(aliases)
    assert set(ours) | set(aliases) == set(ref), set(ours) ^ set(ref)
    for name, g in ours.items():
        _close(g, ref[name], 5e-3, 5e-4, f"{what}: {name}")
    for name, first in aliases.items():
        _close(ours[first], ref[name], 5e-3, 5e-4, f"{what}: {name}")


def test_hyena_operator_matches_jax(ranks, jax_side):
    """The operator on a model axis of 4 (each rank d / 4 = 8 channels of
    each chunk, the filter MLP whole): y and du on every rank, and every
    whole gradient, against the JAX operator."""
    ref = jax_side["op"]
    for r in ranks:
        _close(r["op"]["y"], ref["y"], 1e-5, 1e-5, "y")
        _close(r["op"]["du"], ref["du"], 5e-3, 5e-4, "du")
        _assert_grads(r["op"]["grads"], r["op"]["aliases"], ref["grads"], "operator")


@pytest.mark.parametrize("mesh", ["lm_model4", "lm_seq2_model2"])
def test_lm_matches_jax(ranks, jax_side, mesh):
    """The LM's loss and every gathered whole gradient on every rank against
    the unsharded JAX LM (loss 1e-5, gradients 5e-4 / 5e-3), and against
    the JAX LM placed on its model axis by `shard_params`."""
    for key in ("lm", "lm_sharded"):
        ref = jax_side[key]
        for r in ranks:
            _close(float(r[mesh]["loss"]), ref["loss"], 1e-5, 1e-5, f"{mesh} loss vs {key}")
            _assert_grads(r[mesh]["grads"], r[mesh]["aliases"], ref["grads"],
                          f"{mesh} vs {key}")
    layout = ranks[0][mesh]["layout"]
    assert "backbone.embeddings.word_embeddings.weight" in layout
    assert "backbone.layers.0.mixer.in_proj.weight" in layout
    assert "backbone.layers.0.mlp.fc1.weight" in layout
    assert "backbone.layers.0.mixer.filter_fn.implicit_filter.0.weight" in layout


def test_clip_norm_and_lamb_step_match_one_process(ranks):
    """A clipped LAMB step on the model-4 ranks (the global norm and the
    per-tensor trust ratios summed over the model group) equals the same
    step of one process on the whole parameters, 1e-6 relative."""
    for r in ranks:
        ours, ref = r["lamb"], r["lamb_ref"]
        _close(float(ours["norm"]), float(ref["norm"]), 1e-6, 0.0, "norm")
        assert float(ref["norm"]) > 0.05  # the clip engaged
        assert set(ours["params"]) == set(ref["params"])
        for name, p in ref["params"].items():
            _close(ours["params"][name], p, 1e-6, 1e-7, name)


@pytest.mark.parametrize("dim,chunks", [(0, 3), (1, 1), (0, 1)])
def test_shard_tensor_takes_each_chunks_slice(dim, chunks):
    """`shard_tensor` gives model rank m its m-th part of each chunk, in
    chunk order (the per-chunk layout of in_proj and Wqkv); the slices of
    every rank, joined as `gather_tensor` joins them, are the whole."""
    whole = torch.arange(24 * 6, dtype=torch.float32).reshape(24, 6)
    if dim == 1:
        whole = whole.t().contiguous()
    slices = [shard_tensor(whole, dim, chunks, Mesh(1, 1, model=2, model_index=m))
              for m in range(2)]
    n = whole.shape[dim] // chunks
    for m, s in enumerate(slices):
        parts = [whole.narrow(dim, c * n + m * n // 2, n // 2) for c in range(chunks)]
        assert torch.equal(s, torch.cat(parts, dim))
    joined = torch.stack([s.unflatten(dim, (chunks, n // 2)) for s in slices],
                         dim=dim + 1).flatten(dim, dim + 2)
    assert torch.equal(joined, whole)
    sd = shard_state_dict({"w": whole, "b": whole[:1]}, Mesh(1, 1, model=2, model_index=1),
                          {"w": ("sharded", dim, chunks)})
    assert torch.equal(sd["w"], slices[1]) and torch.equal(sd["b"], whole[:1])


def test_torchrun_trains_on_a_model_axis_on_the_cpu(tmp_path):
    """`python -m torch.distributed.run ... -m hyena_dna_tpu_torch.train
    ... mesh.model=2 --device cpu` trains: two gloo ranks, the model axis
    of 2, rank 0's finite logged losses and test loss."""
    fa, bed = W.write_genome(tmp_path)
    root = Path(__file__).resolve().parents[1]
    argv = ["experiment=hg38/hg38_hyena", f"dataset.bed_file={bed}",
            f"dataset.fasta_file={fa}", "dataset.max_length=65", "dataset.batch_size=8",
            "model.d_model=32", "model.n_layer=2", "model.d_inner=128",
            "trainer.precision=32", "trainer.max_epochs=1", "trainer.limit_train_batches=2",
            "trainer.log_every_n_steps=1", f"train.run_dir={tmp_path / 'run'}",
            "mesh.model=2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                      "LOCAL_", "MASTER_"))}
    env["OMP_NUM_THREADS"] = "1"
    done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", "-m", "hyena_dna_tpu_torch.train", *argv],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite([r["test/loss"] for r in records if "test/loss" in r]).all()
    # the whole model's parameters, as one process counts them
    cfg = build_config([a for a in argv if a.startswith(("experiment", "model", "dataset.max"))])
    model_cfg = dict(cfg["model"])
    whole = MODEL_REGISTRY[model_cfg.pop("_name_")](generator=torch.Generator(), **model_cfg)
    assert [r["params/total"] for r in records if "params/total" in r] == [
        sum(p.numel() for p in whole.parameters())]
    assert '"backend": "gloo", "world": 2' in done.stdout
