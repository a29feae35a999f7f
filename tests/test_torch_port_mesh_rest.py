"""The mesh combinations the port computes since the seq and model axes
took every module: attention, learned positions, the decoder heads and the
position and host metrics under a seq axis; the general Hyena path and the
4-D route (`front4`) under a model axis. Each is held to the JAX package on
the CPU.

One spawned world of 2 gloo ranks (`parallel.spawn`;
`tests/torch_parallel_workers.py::mesh_rest_world`) runs every rank-side
check, from the JAX modules' parameters (`utils/convert.py`; under a model
axis each rank takes its slices with `shard_state_dict`), at B 2, L 64,
d 32:
  * seq 2: `MHA` causal, with rotary embeddings and bidirectional, and an
    all-attention LM with learned positions (hg38_attention's layout), on
    each rank's 32 columns, against the JAX modules whole: outputs within
    1e-5 of their max, every gradient within 1e-4 of its max (the
    tolerances of tests/test_torch_port_attention.py); the LM's loss
    within 1e-5. Attention dropout on the rank's columns equals the whole
    module's from the same generator, 1e-6;
  * seq 2: every `SequenceDecoder` mode (last, first, pool, sum at l_output
    0, 3, 40 (spanning both ranks) and None; masked pool; ragged) and
    `NDDecoder`'s pool, each rank's per-sequence loss weighted 1 / S as
    the train step weights it: outputs, the input gradient of each rank's
    columns and the summed parameter gradients against the JAX decoders,
    1e-5 / 1e-4 of max;
  * model 2: the general Hyena path (heads, blocks, outer mixing, the
    post-order FFN, order 3; the head split where 2 divides the heads, the
    channel split with one head) against the JAX operator whole: y within
    1e-5 of its max, du and every gathered whole gradient within 5e-4 of
    its max (FFT convs summed in other orders); with dropout, the split
    operator equals the whole one from the same generator, 1e-6;
  * model 2: `HyenaOperator(front4=True)` on the plan of
    tests/test_torch_port_front4.py (d 8, L 1536, fft 4096 at (4, 8, 128),
    each rank's kernels A4 and A4' plain versions at W (8, 12)) against the
    JAX operator's flat route, whose math the 4-D route shares (that test
    holds the 4-D routes of both packages to each other), at its
    tolerances (2e-4 output, 5e-3 of max for the gradients);
  * trainers on seq 2, against the JAX Trainer on the same mesh of the
    conftest's virtual devices (every train loss, grad norm, val and test
    loss within 2e-4, the tolerance of tests/test_torch_port_trainer.py):
    `experiment=hg38/species_classification` (dna_embedding + pool) with a
    host metric (mcc, within 1e-6), and `hg38_attention` (learned positions,
    8 heads, attention dropout off) with `last_k_ppl`, `per_token_ppl` and
    per-token host metrics (mcc, accuracy, the confusion matrix exactly);
    and the adaptive LM (a model outside the seq-sharded set, run whole on
    each seq rank; the JAX Trainer runs it under GSPMD on the global view).
Kernels A4 and A4' at d_c < d_in (a rank's W (d_in, 3 d_c)) are held, in
this process, to the Pallas `fused_proj_conv_gate4` in interpret mode on
the whole W, whose rank channels they must reproduce.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.models import HyenaOperator as JaxOp
from hyena_dna_tpu.models.attention import MHA as JaxMHA
from hyena_dna_tpu.models.heads import NDDecoder as JaxND
from hyena_dna_tpu.models.heads import SequenceDecoder as JaxSeqDec
from hyena_dna_tpu.ops.pallas_hyena import fused_proj_conv_gate4 as jax_front4
from hyena_dna_tpu.train.trainer import Trainer as JaxTrainer
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.parallel import spawn
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

WORLD = 2
RTOL = 2e-4
SEQ2 = {"data": 1, "seq": 2}
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def perturbed(params, seed):
    """Every parameter moved a little (the JAX inits leave biases at zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), to_np(params))


def assert_close(ours, ref, tol, what=""):
    """Within `tol` of max |ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), f"{what}: {err} vs max {np.abs(ref).max()}"


def assert_grads(ours: dict, ref_tree, tol, what, aliases=None):
    """Every parameter's gradient by name; a second name of a shared tensor
    (`aliases`: the Sin `freq`) is checked through its first."""
    aliases = aliases or {}
    ref = flax_to_torch_state_dict(to_np(ref_tree), buffers=False)
    assert set(ours) | set(aliases) == set(ref), set(ours) ^ set(ref)
    for name, g in ref.items():
        assert_close(ours[aliases.get(name, name)], g, tol, f"{what}: {name}")


def write_species(root: Path) -> Path:
    """tests/test_torch_port_downstream_trainer.py's species: human and
    mouse, every chromosome of their splits, mouse GC-rich."""
    from test_torch_port_downstream_trainer import _write_fasta

    rng = np.random.default_rng(1)
    out = root / "species"
    for spec, gc in (("human", 0.4), ("mouse", 0.6)):
        d = out / spec
        d.mkdir(parents=True)
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        for c in [str(i) for i in range(1, 23)] + ["X", "Y"]:
            _write_fasta(d / f"chr{c}.fa", {f"chr{c}": "".join(rng.choice(list("ACGT"), size=600,
                                                                             p=p))})
    return out


def trainer_configs(root: Path) -> dict:
    """The seq-2 trainer runs at tiny overrides (float32, embed dropout 0,
    warm-up 2 steps so the steps move the parameters)."""
    fa, bed = W.write_genome(root)
    tiny = ["model.d_model=32", "model.d_inner=128", "model.layer.filter_order=16",
            "model.embed_dropout=0.0", "trainer.precision=32", "trainer.log_every_n_steps=1",
            "scheduler.warmup_t=2", "dataset.num_workers=0"]
    species = build_config(["experiment=hg38/species_classification",
                            f"dataset.species_dir={write_species(root)}",
                            "dataset.max_length=128", "dataset.total_size=32",
                            "dataset.batch_size=8", "trainer.max_epochs=1"] + tiny)
    species["task"]["host_metrics"] = ["mcc"]
    attention = build_config([
        "experiment=hg38/hg38_attention", f"dataset.bed_file={bed}", f"dataset.fasta_file={fa}",
        "dataset.max_length=65", "dataset.batch_size=8", "model.n_layer=2",
        "model.attn_cfg.dropout=0.0", "trainer.max_epochs=1", "trainer.limit_train_batches=3",
        "task.last_k_ppl=16", "task.per_token_ppl=[1,33,64]", "task.seq_len=64"] + tiny)
    attention["task"]["host_metrics"] = ["mcc", "accuracy_host"]  # per token
    adaptive = W.lm_config(root / "adaptive_seq2", fa, bed, SEQ2)
    adaptive["model"] = {"_name_": "adaptive_lm", "d_model": 16, "cutoffs": [4, 8],
                         "div_val": 2, "backbone": {"n_layers": 1, "layer": {"_name_": "ff"},
                                                    "residual": "R", "norm": "layer"}}
    adaptive["task"] = {"_name_": "adaptive_lm", "loss": "cross_entropy", "cutoffs": [4, 8]}
    adaptive["trainer"].update(limit_train_batches=3)
    adaptive["callbacks"] = {}
    cfgs = {"species_seq2": species, "attention_seq2": attention, "adaptive_seq2": adaptive}
    for name, cfg in cfgs.items():
        cfg["mesh"] = dict(SEQ2)
        cfg["train"]["run_dir"] = str(root / name)
    return cfgs


def jax_modules(a: dict) -> dict:
    """The JAX modules' parameters and their outputs and gradients."""
    x, dy = jnp.asarray(a["x"]), jnp.asarray(a["dy"])
    out = {"params": {"mha": {}, "hyena": {}}, "mha": {}, "decoders": {}, "hyena": {}}

    def vjp(apply, params, x, cot):
        """The output, and the parameter and input gradients of
        sum(output * cot), in one jitted call."""
        def loss(p, x):
            y = apply(p, x)
            return jnp.sum(y * cot), y

        (gp, gx), y = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(params, x)
        return {"y": np.asarray(y), "grads": to_np(gp), "dx": np.asarray(gx)}

    for i, (name, kw) in enumerate(W.MR_MHA.items()):
        m = JaxMHA(d_model=W.MR_D, **kw)
        p = perturbed(jax.jit(m.init)(jax.random.PRNGKey(i), x)["params"], i)
        out["params"]["mha"][name] = p
        out["mha"][name] = vjp(lambda p, x: m.apply({"params": p}, x), p, x, cot=dy)

    lm_kw = dict(W.MR_ATTN_LM, attn_layer_idx=tuple(W.MR_ATTN_LM["attn_layer_idx"]))
    lm = JaxLM(**lm_kw)
    tokens = jnp.asarray(a["tokens"])
    p = perturbed(jax.jit(lm.init)(jax.random.PRNGKey(11), tokens[:, :-1])["params"], 11)

    def lm_loss(p):
        logits, _ = lm.apply({"params": p}, tokens[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))

    out["params"]["attn_lm"] = p
    out["attn_lm"] = {"loss": float(jax.jit(lm_loss)(p)),
                      "grads": to_np(jax.jit(jax.grad(lm_loss))(p))}

    lengths, mask = jnp.asarray(W.MR_LENGTHS), jnp.asarray(a["mask"])
    dec_params = None
    for name, (mode, l_output, masked) in W.MR_DECODERS.items():
        dec = JaxSeqDec(d_model=W.MR_D, d_output=W.MR_D_OUT, l_output=l_output, mode=mode)
        kw = {"mask": mask} if masked else {}
        if mode == "ragged":
            kw["lengths"] = lengths
        if dec_params is None:
            dec_params = perturbed(jax.jit(dec.init)(jax.random.PRNGKey(3), x, **kw)["params"], 3)
        out["decoders"][name] = vjp(lambda p, x: dec.apply({"params": p}, x, **kw), dec_params,
                                    x, cot=W.decoder_cotangent(a, name))
    nd = JaxND(d_model=W.MR_D, d_output=W.MR_D_OUT)
    out["decoders"]["nd_pool"] = vjp(lambda p, x: nd.apply({"params": p}, x), dec_params, x,
                                     cot=a["dec_dy"][:, 0])
    out["params"]["decoder"] = dec_params

    for i, (name, kw) in enumerate(W.MR_HYENA.items()):
        op = JaxOp(**W.MR_HYENA_KW, **kw)
        p = perturbed(jax.jit(op.init)(jax.random.PRNGKey(20 + i), x)["params"], 20 + i)
        out["params"]["hyena"][name] = p
        out["hyena"][name] = vjp(lambda p, x: op.apply({"params": p}, x), p, x, cot=dy)

    # the 4-D route's reference: the JAX operator's flat route, the same math
    # (tests/test_torch_port_front4.py holds the port's 4-D route to the JAX
    # one and to its own flat route)
    op = JaxOp(W.MR_F4_D, W.MR_F4_L, filter_order=16, filter_cfg=dict(emb_dim=5))
    u = jnp.asarray(a["f4_u"])
    p = perturbed(jax.jit(op.init)(jax.random.PRNGKey(40), u)["params"], 40)
    out["params"]["front4"] = p
    out["front4"] = vjp(lambda p, x: op.apply({"params": p}, x), p, u, cot=a["f4_dy"])
    return out


SEQ_TRAINERS = ("species_seq2", "attention_seq2", "adaptive_seq2")


class JaxAdaptiveTrainer(JaxTrainer):
    """The JAX Trainer with the registry's `adaptive_lm` given the dataset's
    vocabulary as `n_token`: the JAX Trainer passes every model `vocab_size`,
    which the JAX `AdaptiveLMModel` does not take (the port's takes it for
    `n_token`). Under the seq mesh GSPMD runs the model on the global view."""

    def _build_model(self, model_cfg, decoder_cfg):
        from hyena_dna_tpu.utils.registry import MODEL_REGISTRY

        cfg = {k: v for k, v in model_cfg.items() if k != "_name_"}
        cfg.setdefault("n_token", self.datamodule.vocab_size)
        return MODEL_REGISTRY["adaptive_lm"](**cfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side in this process (modules, then the trainers on SEQ2 of
    the virtual devices, each run's initial parameters saved for the port),
    then the one world of ranks."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("mesh_rest")
    a = W.mesh_rest_inputs()
    ref = jax_modules(a)
    torch.save({k: ({n: flax_to_torch_state_dict(p) for n, p in v.items()}
                    if k in ("mha", "hyena") else flax_to_torch_state_dict(v))
                for k, v in ref["params"].items()}, root / "params.pt")
    cfgs = trainer_configs(root)
    jax_final, jobs = {}, []
    for name in SEQ_TRAINERS:
        jcfg = json.loads(json.dumps(cfgs[name]))
        jcfg["train"]["run_dir"] = str(root / f"jax_{name}")
        jt = (JaxAdaptiveTrainer if name == "adaptive_seq2" else JaxTrainer)(jcfg)
        torch.save(flax_to_torch_state_dict(to_np(jt.state.params)), root / f"{name}.pt")
        jax_final[name] = jt.fit()
        jobs.append((name, cfgs[name], str(root / f"{name}.pt")))
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        spawn(W.mesh_rest_world, WORLD, args=(str(root), str(root / "params.pt"), jobs))
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env
    ranks = [torch.load(root / f"mesh_rest_rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    trainer_ranks = [torch.load(root / f"trainers_rank{r}.pt", weights_only=False)
                     for r in range(WORLD)]
    return {"root": root, "a": a, "ref": ref, "ranks": ranks, "trainers": trainer_ranks,
            "jax_final": jax_final}


def test_world_coordinates(world):
    """Two ranks: seq index and model index both follow the rank."""
    assert [r["coords"] for r in world["ranks"]] == [(0, 0), (1, 1)]


@pytest.mark.parametrize("case", list(W.MR_MHA))
def test_mha_on_a_seq_axis_matches_jax(world, case):
    """Each rank's output and input gradient are the JAX module's at its
    columns; the summed parameter gradients are the JAX ones."""
    ref = world["ref"]["mha"][case]
    for r, res in enumerate(world["ranks"]):
        cols = slice(r * W.MR_L // 2, (r + 1) * W.MR_L // 2)
        ours = res["mha"][case]
        assert_close(ours["y"], ref["y"][:, cols], 1e-5, f"{case} y")
        assert_close(ours["dx"], ref["dx"][:, cols], 1e-4, f"{case} dx")
        assert_grads(ours["grads"], ref["grads"], 1e-4, case)


def test_mha_dropout_is_the_whole_mask_sliced(world):
    """With dropout 0.3 in training, a rank's output equals the whole
    module's at its columns from the same generator."""
    for res in world["ranks"]:
        assert res["mha_dropout"] <= 1e-6


def test_attention_lm_with_learned_positions_on_a_seq_axis_matches_jax(world):
    """The all-attention LM (learned positions from each rank's first
    global column): the global loss and every summed gradient."""
    ref = world["ref"]["attn_lm"]
    for res in world["ranks"]:
        ours = res["attn_lm"]
        assert abs(float(ours["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert_grads(ours["grads"], ref["grads"], 1e-4, "attention LM", ours["aliases"])


@pytest.mark.parametrize("case", list(W.MR_DECODERS) + ["nd_pool"])
def test_decoder_on_a_seq_axis_matches_jax(world, case):
    """Every rank holds the JAX head's per-sequence output (its columns of a
    per-token one); each rank's input gradient is the JAX one at its
    columns; the parameter gradients summed over the ranks are the JAX
    ones (each rank's per-sequence loss weighted 1 / S)."""
    ref = world["ref"]["decoders"][case]
    per_token = case != "nd_pool" and W.MR_DECODERS[case][1] is None
    for r, res in enumerate(world["ranks"]):
        cols = slice(r * W.MR_L // 2, (r + 1) * W.MR_L // 2)
        ours = res["decoders"][case]
        assert_close(ours["y"], ref["y"][:, cols] if per_token else ref["y"], 1e-5, f"{case} y")
        assert_close(ours["dx"], ref["dx"][:, cols], 1e-4, f"{case} dx")
        assert_grads(ours["grads"], ref["grads"], 1e-4, case)


@pytest.mark.parametrize("case", list(W.MR_HYENA))
def test_general_hyena_on_a_model_axis_matches_jax(world, case):
    """The general path split over model 2: y and du on every rank and every
    gathered whole gradient against the JAX operator; the split is by heads
    where 2 divides them, else by each head's channels."""
    ref = world["ref"]["hyena"][case]
    for res in world["ranks"]:
        ours = res["hyena"][case]
        assert ours["split"] == ("heads" if W.MR_HYENA[case].get("num_heads", 1) % 2 == 0
                                 else "channels")
        assert_close(ours["y"], ref["y"], 1e-5, f"{case} y")
        assert_close(ours["du"], ref["dx"], 5e-4, f"{case} du")
        assert_grads(ours["grads"], ref["grads"], 5e-4, case, ours["aliases"])
        assert ours["layout"]["filter_fn.bias"] == ("partial",)
        if W.MR_HYENA[case].get("post_order_ffn"):
            assert ours["layout"]["ord_proj_w"] == ("partial",)


@pytest.mark.parametrize("case", ["all_heads2", "all_one_head"])
def test_general_hyena_dropout_is_the_whole_mask_sliced(world, case):
    """With dropout 0.2 in training, the split operator equals the whole one
    from the same generator (each mask drawn whole, sliced on the rank's
    heads or channels)."""
    for res in world["ranks"]:
        assert res["hyena_dropout"][case] <= 1e-6


def test_front4_on_a_model_axis_matches_jax(world):
    """`front4` on model 2: the 4-D route engages on each rank (its kernels
    A4 and A4' at W (8, 12)), and y, du and every gathered gradient match
    the JAX operator (its flat route, the same math)."""
    ref = world["ref"]["front4"]
    for res in world["ranks"]:
        ours = res["front4"]
        assert ours["plan"] is not None and tuple(ours["plan"][:3]) == W.MR_F4_PLAN
        np.testing.assert_allclose(ours["y"].numpy(), ref["y"], atol=2e-4, rtol=1e-3)
        assert_close(ours["du"], ref["dx"], 5e-3, "du")
        assert_grads(ours["grads"], ref["grads"], 5e-3, "front4", ours["aliases"])


def _records(run_dir):
    return [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]


def _series(run_dir, key):
    return [(r["step"], r[key]) for r in _records(run_dir) if key in r]


def _assert_rel(a, b, what, rtol=RTOL):
    assert abs(a - b) <= rtol * abs(b), f"{what}: {a} vs {b}"


@pytest.mark.parametrize("name", SEQ_TRAINERS)
def test_seq_trainer_matches_jax(world, name):
    """Every logged train loss and grad norm, and the val and test losses,
    against the JAX Trainer on the same seq-2 mesh; every rank reports the
    same results. The adaptive LM is a model outside the seq-sharded set,
    which the port runs whole on each seq rank from the gathered columns."""
    root = world["root"]
    for key in ("train/loss", "train/grad_norm"):
        ours, ref = _series(root / name, key), _series(root / f"jax_{name}", key)
        assert ours and [s for s, _ in ours] == [s for s, _ in ref]
        for (step, a), (_, b) in zip(ours, ref):
            _assert_rel(a, b, f"{name} {key} at step {step}")
    finals = [r[name]["final"] for r in world["trainers"]]
    assert all(f == finals[0] for f in finals)
    assert world["trainers"][0][name]["mesh"] == {"data": 1, "seq": 2, "model": 1}
    _assert_rel(finals[0]["test/loss"], world["jax_final"][name]["test/loss"], "test/loss")
    val = lambda d: [r for r in _records(d) if "val/loss" in r]
    pairs = list(zip(val(root / name), val(root / f"jax_{name}")))
    assert pairs
    for a, b in pairs:
        _assert_rel(a["val/loss"], b["val/loss"], "val/loss")


def test_species_host_metric_on_a_seq_axis_matches_jax(world):
    """The species run's test accuracy and mcc (a host metric streamed from
    the per-sequence logits, whole on every seq rank) against the JAX run."""
    ours, ref = world["trainers"][0]["species_seq2"]["final"], world["jax_final"]["species_seq2"]
    for key in ("test/accuracy", "test/mcc"):
        assert abs(ours[key] - ref[key]) <= 1e-6, (key, ours[key], ref[key])


def test_per_token_host_metrics_on_a_seq_axis_match_jax(world):
    """The attention LM's host metrics stream per-token predictions, which
    the eval step gathers over the seq group: every token of every batch
    (the confusion matrix, exactly) and mcc and accuracy, in every val and
    test record, against the JAX run; both ranks report the same."""
    root = world["root"]
    recs = lambda d: [r for r in _records(d) if "val/loss" in r or "test/loss" in r]
    pairs = list(zip(recs(root / "attention_seq2"), recs(root / "jax_attention_seq2")))
    assert pairs
    for a, b in pairs:
        split = "val" if "val/loss" in b else "test"
        cm = np.asarray(a[f"{split}/confusion_matrix"])
        assert cm.sum() > 0 and np.array_equal(cm, b[f"{split}/confusion_matrix"])
        for key in ("mcc", "accuracy_host"):
            assert abs(a[f"{split}/{key}"] - b[f"{split}/{key}"]) <= 1e-6, (split, key)


def test_position_metrics_on_a_seq_axis_match_jax(world):
    """`last_k_ppl` and `per_token_ppl` (the per-position NLL gathered over
    the seq group) in every val and test record, against the JAX run."""
    root = world["root"]
    keys = ["last_k_ppl"] + [f"per_token_ppl_{i}" for i in range(3)]
    recs = lambda d: [r for r in _records(d) if "val/loss" in r or "test/loss" in r]
    pairs = list(zip(recs(root / "attention_seq2"), recs(root / "jax_attention_seq2")))
    assert pairs
    for a, b in pairs:
        split = "val" if "val/loss" in b else "test"
        for key in keys:
            _assert_rel(a[f"{split}/{key}"], b[f"{split}/{key}"], f"{split}/{key}")


def test_whole_model_on_a_seq_axis_takes_the_rank_columns(world):
    """The adaptive LM's train steps each take the rank's 32 of the 64
    columns (the model gathers them whole inside), for its 3 steps."""
    for res in world["trainers"]:
        assert res["adaptive_seq2"]["shapes"] == [[4, 32]] * 3


def _front_inputs(seed, d_in=8):
    rng = np.random.default_rng(seed)
    length = 1536
    return (rng.normal(size=(1, length, d_in)).astype(np.float32),
            rng.normal(size=(d_in, 3 * d_in)).astype(np.float32) * 0.1,
            rng.normal(size=(3 * d_in,)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3 * d_in)).astype(np.float32),
            rng.normal(size=(3 * d_in,)).astype(np.float32) * 0.1)


def _rank_slice(args, rank, ranks):
    """A model rank's W (d_in, 3 d_c) and its bias and tap columns: its
    d / M channels of each of the three chunks."""
    u, w, bp, wc, bc = args
    d = w.shape[1] // 3
    c = d // ranks
    cols = np.concatenate([np.arange(k * d + rank * c, k * d + (rank + 1) * c) for k in range(3)])
    return u, np.ascontiguousarray(w[:, cols]), bp[cols], np.ascontiguousarray(wc[:, cols]), bc[cols]


@pytest.mark.parametrize("ranks", [2, 4])
def test_front4_kernels_take_a_channel_slice(ranks):
    """Kernels A4 and A4' (plain versions) on each rank's W (d_in, 3 d_c),
    d_c = d_in / M: the rank's channels of the Pallas A4 on the whole W in
    interpret mode (1e-4); against the Pallas VJP of a loss over every
    channel, each rank's dW, bias and tap gradients are the whole ones'
    columns of its channels, and the ranks' partial du sum to the whole du
    (2e-3 / 1e-3, tests/test_torch_port_front4.py's tolerances)."""
    rows, m, tile = 16, 128, 512
    args = _front_inputs(5)
    d = args[0].shape[-1]
    c = d // ranks

    def loss4(*a):
        vx4, x04 = jax_front4(*a, rows, m, tile, True)
        return jnp.sum(vx4 ** 2) + jnp.sum(jnp.sin(x04)), (vx4, x04)

    g_ref, ref = jax.grad(loss4, argnums=(0, 1, 2, 3, 4), has_aux=True)(*map(jnp.asarray, args))
    du = 0.0
    for rank in range(ranks):
        sl = _rank_slice(args, rank, ranks)
        leaves = [torch.from_numpy(t).requires_grad_() for t in sl]
        got = FF.fused_proj_conv_gate4(*leaves, rows, m, tile)
        for g, r in zip(got, ref):
            assert g.shape == (1, c, rows, m)
            np.testing.assert_allclose(g.detach().numpy(),
                                       np.asarray(r)[:, rank * c:(rank + 1) * c],
                                       atol=1e-4, rtol=1e-4)
        grads = torch.autograd.grad((got[0] ** 2).sum() + torch.sin(got[1]).sum(), leaves)
        cols = np.concatenate([np.arange(k * d + rank * c, k * d + (rank + 1) * c)
                               for k in range(3)])  # the rank's columns of W
        want = [np.asarray(g_ref[1])[:, cols], np.asarray(g_ref[2])[cols],
                np.asarray(g_ref[3])[:, cols], np.asarray(g_ref[4])[cols]]
        for name, g, r in zip(("dw", "dbp", "dwc", "dbc"), grads[1:], want):
            np.testing.assert_allclose(g.numpy(), r, atol=2e-3, rtol=1e-3, err_msg=name)
        du = du + grads[0].numpy()
    np.testing.assert_allclose(du, np.asarray(g_ref[0]), atol=2e-3, rtol=1e-3, err_msg="du")


def test_front4_wrappers_check_both_widths():
    """The A4 wrappers' `_check` takes W (d_in, 3 d_c) at any d_c and
    refuses a W whose rows are not u's width or whose columns do not split
    into three chunks."""
    u = torch.zeros(1, 1536, 8)
    ok = [torch.zeros(8, 12), torch.zeros(12), torch.zeros(3, 12), torch.zeros(12)]
    assert FF._check(u=u, w=ok[0], bp=ok[1], wc=ok[2], bc=ok[3]) == ""
    with pytest.raises(ValueError, match="d_in, 3 d_c"):
        FF._check(u=u, w=torch.zeros(6, 12), bp=ok[1], wc=ok[2], bc=ok[3])
    with pytest.raises(ValueError, match="d_in, 3 d_c"):
        FF._check(u=u, w=torch.zeros(8, 13), bp=ok[1], wc=ok[2], bc=ok[3])


def test_species_gz_is_renamed_into_place(tmp_path, monkeypatch):
    """The ranks of a mesh read one species directory and may decompress a
    gzipped chromosome at once: each writes a file of its own and renames
    it into place, so no rank opens a half-written `.fna` (4 ranks on the
    card read one with no record and stopped)."""
    import gzip

    from hyena_dna_tpu_torch.data import species as S

    d = tmp_path / "human"
    d.mkdir()
    text = b">chr1\n" + b"ACGT" * 100 + b"\n"
    with gzip.open(d / "chr1.fna.gz", "wb") as f:
        f.write(text)
    seen, real = [], os.replace

    def replace(src, dst):
        seen.append((Path(src).name, Path(dst).name, Path(dst).exists(),
                     Path(src).read_bytes() == text))
        real(src, dst)

    monkeypatch.setattr(S.os, "replace", replace)
    out = S.SpeciesDataset._resolve_chromosome_file(d, "1")
    assert out.read_bytes() == text
    assert seen == [(f"chr1.fna.{os.getpid()}.part", "chr1.fna", False, True)]
    assert sorted(p.name for p in d.iterdir()) == ["chr1.fna", "chr1.fna.gz"]


def test_fasta_index_is_renamed_into_place(tmp_path, monkeypatch):
    """`FastaFile` caches its `.fai` the same way: written whole to a file
    of its own and renamed, so a rank that opens the FASTA while
    another builds its index reads no empty or partial index."""
    from hyena_dna_tpu_torch.data import fasta as FA

    fa = tmp_path / "g.fna"
    fa.write_text(">chr1\n" + "ACGT" * 30 + "\n>chr2\n" + "GGCC" * 10 + "\n")
    fai, seen, real = tmp_path / "g.fna.fai", [], os.replace

    def replace(src, dst):
        # at the rename the index is complete and nothing is at `.fai` yet
        seen.append((Path(src).name, Path(dst).name, Path(dst).exists(),
                     [ln.split("\t")[0] for ln in Path(src).read_text().splitlines()]))
        real(src, dst)

    monkeypatch.setattr(FA.os, "replace", replace)
    assert list(FA.FastaFile(fa).keys()) == ["chr1", "chr2"]
    assert len(seen) == 1 and seen[0][1:] == ("g.fna.fai", False, ["chr1", "chr2"])
    assert seen[0][0].startswith("g.fna.fai.") and seen[0][0].endswith(".part")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["g.fna", "g.fna.fai"]
    assert list(FA.FastaFile(fa).keys()) == ["chr1", "chr2"]  # read from the cache
    assert fai.read_text().count("\n") == 2


def test_fasta_index_readers_racing_a_build(tmp_path):
    """Threads that open one fresh FASTA at once (a mesh's ranks on one
    species directory) each see every record, whether they build the index
    or read the one another has just renamed into place."""
    from concurrent.futures import ThreadPoolExecutor

    from hyena_dna_tpu_torch.data import fasta as FA

    names = [f"chr{i}" for i in range(200)]
    for trial in range(4):
        fa = tmp_path / f"g{trial}.fna"
        fa.write_text("".join(f">{n}\n{'ACGT' * 4}\n" for n in names))
        with ThreadPoolExecutor(8) as pool:
            keys = list(pool.map(lambda _: list(FA.FastaFile(fa).keys()), range(8)))
        assert all(k == names for k in keys)
        assert not list(tmp_path.glob("*.part"))


def test_local_batch_keeps_per_sequence_labels_whole():
    """Under a seq axis a rank takes its columns of every 2-D array as wide
    as the sequence (inputs, per-token targets, masks); a per-sequence 2-D
    label (a chromatin profile's (B, 919)) and 1-D labels stay whole."""
    from hyena_dna_tpu_torch.parallel.sharding import Mesh

    x = np.arange(2 * 8).reshape(2, 8)
    profile, label = np.ones((2, 5)), np.array([0, 1])
    for s in range(2):
        xs, ys, ls, extra = Mesh(1, 2, 0, s).local_batch((x, profile, label, {"mask": x}))
        assert np.array_equal(xs, x[:, 4 * s:4 * (s + 1)]) and np.array_equal(extra["mask"], xs)
        assert ys is profile and ls is label
