"""The port's Trainer on a mesh of gloo ranks on the CPU, against the JAX
Trainer on the same mesh of virtual CPU devices, and against itself in one
process.

One spawned world of 4 ranks (`tests/torch_parallel_workers.py::trainers`)
runs, in turn: tests/test_trainer.py's sequence-parallel config
(`test_trainer_sequence_parallel`: d 32 x 2, L 64, batch 4, 4 steps an
epoch) on a data 2 x seq 2 mesh; `experiment=hg38/hg38_medium_450k` on its shipped seq-4 mesh
and `experiment=hg38/hg38_large_1m` on a 2 x 2 mesh (its 2 x 8 needs 16
ranks), both at d 32 x 2, float32, with their mixer and MLP checkpoint
cells and `accumulate_grad_batches` 2 and 1: the 450k config 4 steps at
L 64, the 1M one its seqlen curriculum cut to two stages of 4 steps (L 32,
batch 4, then L 64, batch 2); tests/test_torch_port_finetune.py's classification config on a data
axis of 4 (the host metrics gathered over the ranks); tensor
parallelism: `experiment=hg38/hg38_hyena` and `hg38_attention` (attention
dropout off) at d 32 x 2, L 64, batch 8, on a data 2 x model 2 mesh; then
checkpoints across meshes, the model axis's included (written under model
2, resumed by one process and on data 2 x seq 2; written by one process
and on data 2 x seq 2, resumed under model 2). Each run of the port starts
from the JAX trainer's initial parameters (`utils/convert.py`) with
dropout off, and every logged train loss and the val / test loss and
perplexity must agree within 2e-4 relative, the tolerance of the
single-process Trainer parity (tests/test_torch_port_trainer.py).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from hyena_dna_tpu.train.__main__ import build_config as jax_build_config
from hyena_dna_tpu.train.trainer import Trainer as JaxTrainer
from hyena_dna_tpu_torch.parallel import spawn
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

RTOL = 2e-4
WORLD = 4
TP_MESH = {"data": 2, "model": 2}
TP_EXTRA = ["dataset.batch_size=8"]  # 4 steps an epoch of the genome's 32 rows


# hg38_large_1m's seqlen curriculum at the test's size: two stages of one
# epoch, each length's L - 1 split over seq 2, each batch over data 2
CURRICULUM = [{"seq_len": 33, "epochs": 1, "batch_size": 4},
              {"seq_len": 65, "epochs": 1, "batch_size": 2}]


def experiment(name, run_dir, fa, bed, mesh, accum, epochs=1, extra=()):
    """A shipped mesh experiment at the test's size (the JAX and port
    compositions are equal: tests/test_torch_port_trainer.py), `extra`
    overrides after; a seqlen curriculum runs at CURRICULUM's stages."""
    argv = [f"experiment=hg38/{name}", f"dataset.bed_file={bed}", f"dataset.fasta_file={fa}",
            "dataset.max_length=65", "model.d_model=32", "model.n_layer=2",
            "model.d_inner=128", "model.embed_dropout=0.0", "trainer.precision=32",
            f"trainer.max_epochs={epochs}", "trainer.limit_train_batches=4",
            "trainer.log_every_n_steps=1", f"trainer.accumulate_grad_batches={accum}",
            f"train.run_dir={run_dir}"] + [f"mesh.{k}={v}" for k, v in mesh.items()] + list(extra)
    cfg = build_config(argv)
    assert cfg == jax_build_config(argv)
    if "seqlen_warmup_reload" in cfg["callbacks"]:
        cfg["callbacks"]["seqlen_warmup_reload"]["stage_params"] = CURRICULUM
    return cfg


def records(run_dir):
    return [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]


def train_losses(run_dir):
    return [(r["step"], r["train/loss"]) for r in records(run_dir) if "train/loss" in r]


def assert_losses_match(ours, ref, what):
    assert [s for s, _ in ours] == [s for s, _ in ref] and ours, what
    for (step, a), (_, b) in zip(ours, ref):
        assert abs(a - b) <= RTOL * abs(b), f"{what} train/loss at step {step}: {a} vs {b}"


def assert_final_match(ours, ref, keys=("test/loss", "test/ppl")):
    for k in keys:
        assert abs(ours[k] - ref[k]) <= RTOL * abs(ref[k]), f"{k}: {ours[k]} vs {ref[k]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs in this process, the port's single-process runs, and
    the port's ranks, with every run directory."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("parallel_trainer")
    fa, bed = W.write_genome(root)
    cfgs = {
        "lm_2x2": W.lm_config(root / "lm_2x2", fa, bed, {"data": 2, "seq": 2}),
        "medium_450k": experiment("hg38_medium_450k", root / "medium_450k", fa, bed, {}, 2),
        "large_1m": experiment("hg38_large_1m", root / "large_1m", fa, bed,
                               {"data": 2, "seq": 2}, 1, epochs=len(CURRICULUM)),
        "cls_data4": W.cls_config(root / "cls_data4", W.write_benchmark(root), {"data": 4}),
        "hyena_tp": experiment("hg38_hyena", root / "hyena_tp", fa, bed, TP_MESH, 1,
                               extra=TP_EXTRA),
        "attention_tp": experiment("hg38_attention", root / "attention_tp", fa, bed, TP_MESH, 1,
                                   extra=TP_EXTRA + ["model.attn_cfg.dropout=0.0"]),
    }
    jax_final, params = {}, {}
    for name, cfg in cfgs.items():
        jcfg = json.loads(json.dumps(cfg))
        jcfg["train"]["run_dir"] = str(root / f"jax_{name}")
        jt = JaxTrainer(jcfg)
        params[name] = root / f"{name}.pt"
        torch.save(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                   jt.state.params)),
                   params[name])
        jax_final[name] = jt.fit()
    # checkpoints across meshes: one process writes after one epoch, ranks resume
    single = W.lm_config(root / "single", fa, bed, {"data": 1})
    single_trainer, single_final = W.run_trainer(single, params["lm_2x2"])
    ckpt_single = str(root / "single" / "checkpoints" / "last")
    ckpt_2x2 = str(root / "lm_2x2" / "checkpoints" / "last")
    resume = lambda name, mesh, ckpt: W.lm_config(root / name, fa, bed, mesh, ckpt=ckpt)
    resume_cfg = {name: resume(name, mesh, ckpt) for name, mesh, ckpt in (
        ("resume_2x2_from_single", {"data": 2, "seq": 2}, ckpt_single),
        ("resume_2x2_from_2x2", {"data": 2, "seq": 2}, ckpt_2x2),
        ("resume_single_from_2x2", {"data": 1}, ckpt_2x2),
        ("resume_single_from_single", {"data": 1}, ckpt_single))}
    resume_cfg["resume_tp_from_2x2"] = resume("resume_tp_from_2x2", TP_MESH, ckpt_2x2)
    # the model axis: hg38_hyena written under data 2 x model 2 and by one process
    hyena = lambda name, mesh, ckpt: experiment(
        "hg38_hyena", root / name, fa, bed, mesh, 1,
        extra=TP_EXTRA + [f"train.ckpt={ckpt}", "trainer.max_epochs=2"])
    W.run_trainer(experiment("hg38_hyena", root / "hyena_single", fa, bed, {"data": 1}, 1,
                             extra=TP_EXTRA), params["hyena_tp"])
    ckpt_tp = str(root / "hyena_tp" / "checkpoints" / "last")
    ckpt_hyena = str(root / "hyena_single" / "checkpoints" / "last")
    resume_cfg.update({
        "resume_2x2_from_tp": hyena("resume_2x2_from_tp", {"data": 2, "seq": 2}, ckpt_tp),
        "resume_single_from_tp": hyena("resume_single_from_tp", {"data": 1}, ckpt_tp),
        "resume_tp_from_hyena_single": hyena("resume_tp_from_hyena_single", TP_MESH, ckpt_hyena),
        "resume_single_from_hyena_single": hyena("resume_single_from_hyena_single", {"data": 1},
                                                 ckpt_hyena)})
    for cfg in resume_cfg.values():
        cfg["trainer"]["max_epochs"] = 2
    jobs = [(name, cfg, str(params[name])) for name, cfg in cfgs.items()]
    jobs += [(name, resume_cfg[name], None) for name in (
        "resume_2x2_from_single", "resume_2x2_from_2x2", "resume_tp_from_2x2",
        "resume_2x2_from_tp", "resume_tp_from_hyena_single")]
    spawn(W.trainers, WORLD, args=(str(root), jobs))
    ranks = [torch.load(root / f"trainers_rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    port_single = {name: W.run_trainer(resume_cfg[name])[1]
                   for name in ("resume_single_from_2x2", "resume_single_from_single",
                                "resume_single_from_tp", "resume_single_from_hyena_single")}
    return {"root": root, "jax": jax_final, "ranks": ranks, "single": single_final,
            "port_single": port_single}


@pytest.mark.parametrize("name", ["lm_2x2", "medium_450k", "large_1m", "hyena_tp",
                                  "attention_tp"])
def test_mesh_trainer_matches_jax(runs, name):
    """Every logged train loss and the test loss and perplexity against the
    JAX Trainer on the same mesh; every rank reports the same results."""
    root = runs["root"]
    assert_losses_match(train_losses(root / name), train_losses(root / f"jax_{name}"), name)
    finals = [r[name]["final"] for r in runs["ranks"]]
    assert_final_match(finals[0], runs["jax"][name])
    assert all(f == finals[0] for f in finals)
    val = lambda d: [r for r in records(d) if "val/loss" in r]
    for a, b in zip(val(root / name), val(root / f"jax_{name}")):
        assert_final_match(a, b, ("val/loss", "val/ppl", "train/ppl"))


def test_data_axis_classification_matches_jax(runs):
    """GenomicBenchmarks classification on a data axis of 4: every train
    loss and the test loss against the JAX Trainer on 4 devices, accuracy
    and the host metrics (mcc, f1, ROC-AUC over the ranks' gathered
    predictions) within 1e-6, on every rank."""
    root = runs["root"]
    assert_losses_match(train_losses(root / "cls_data4"), train_losses(root / "jax_cls_data4"),
                        "cls_data4")
    ref = runs["jax"]["cls_data4"]
    for r in runs["ranks"]:
        ours = r["cls_data4"]["final"]
        assert_final_match(ours, ref, ("test/loss",))
        for name in ("accuracy", "mcc", "f1_macro", "roc_auc_macro"):
            assert abs(ours[f"test/{name}"] - ref[f"test/{name}"]) <= 1e-6, name
        assert r["cls_data4"]["mesh"] == {"data": 4, "seq": 1, "model": 1}


def test_mesh_layouts_of_the_shipped_configs(runs):
    """medium_450k runs on its shipped 1 x 4 mesh, the others on 2 x 2; ranks
    number with seq innermost; only rank 0 wrote metrics and checkpoints."""
    ranks = runs["ranks"]
    for r, res in enumerate(ranks):
        assert res["medium_450k"]["mesh"] == {"data": 1, "seq": 4, "model": 1}
        assert res["medium_450k"]["coords"] == (0, r)
        assert res["large_1m"]["mesh"] == res["lm_2x2"]["mesh"] == {"data": 2, "seq": 2,
                                                                    "model": 1}
        assert res["lm_2x2"]["coords"] == divmod(r, 2)
        assert res["medium_450k"]["step"] == 4 and res["large_1m"]["step"] == 8
    assert (runs["root"] / "lm_2x2" / "checkpoints" / "last").is_dir()


def test_curriculum_under_the_mesh(runs):
    """hg38_large_1m's curriculum on the 2 x 2 mesh: each stage rebuilt the
    split loaders at its length and batch (rows of 2 x 32 then 1 x 64 a
    data and seq rank), logged as the JAX Trainer logged it, and its losses
    match (test_mesh_trainer_matches_jax[large_1m])."""
    root = runs["root"]
    stages = lambda d: [{k: v for k, v in r.items() if k.startswith("curriculum/")}
                        for r in records(d) if "curriculum/stage" in r]
    assert stages(root / "large_1m") == stages(root / "jax_large_1m") == [
        {"curriculum/stage": i, "curriculum/seq_len": c["seq_len"],
         "curriculum/batch_size": c["batch_size"]} for i, c in enumerate(CURRICULUM)]
    for r in runs["ranks"]:
        assert r["large_1m"]["shapes"] == [[2, 16]] * 4 + [[1, 32]] * 4


def test_data_and_seq_ranks_match_one_process(runs):
    """The 2 x 2 ranks' run equals the port's single-process run of the
    same global batches from the same parameters."""
    root = runs["root"]
    assert_losses_match(train_losses(root / "lm_2x2"), train_losses(root / "single"),
                        "2x2 vs one process")
    assert_final_match(runs["ranks"][0]["lm_2x2"]["final"], runs["single"])


@pytest.mark.parametrize("source", ["single", "2x2"])
def test_checkpoint_resumes_under_another_mesh(runs, source):
    """A checkpoint written by one process resumes on the 2 x 2 ranks, and
    the reverse, with the same losses as a resume under the writer's own
    mesh (the next epoch's every step and the test metrics)."""
    root = runs["root"]
    other = "2x2" if source == "single" else "single"
    ours, ref = f"resume_{other}_from_{source}", f"resume_{source}_from_{source}"
    assert_losses_match(train_losses(root / ours), train_losses(root / ref), ours)
    assert train_losses(root / ours)[0][0] == 5  # the second epoch's first step
    final = lambda name: (runs["ranks"][0][name]["final"] if name.startswith("resume_2x2")
                          else runs["port_single"][name])
    assert_final_match(final(ours), final(ref))


@pytest.mark.parametrize("ours,ref", [
    ("resume_single_from_tp", "resume_2x2_from_tp"),
    ("resume_tp_from_hyena_single", "resume_single_from_hyena_single"),
    ("resume_tp_from_2x2", "resume_single_from_2x2")])
def test_checkpoint_resumes_across_the_model_axis(runs, ours, ref):
    """A checkpoint written under data 2 x model 2 (whole tensors, the
    optimizer's moments gathered) resumes in one process and on data 2 x
    seq 2 with the same losses; one written by one process or on data 2 x
    seq 2 resumes under data 2 x model 2 (each rank its slices) with the
    losses of one process's resume."""
    root = runs["root"]
    assert_losses_match(train_losses(root / ours), train_losses(root / ref), ours)
    assert train_losses(root / ours)[0][0] == 5  # the second epoch's first step
    final = lambda name: (runs["ranks"][0][name]["final"] if name in runs["ranks"][0]
                          else runs["port_single"][name])
    assert_final_match(final(ours), final(ref))


def test_model_axis_layout(runs):
    """The model-axis runs number their ranks with model innermost; each
    rank of a model group reports the same metrics."""
    for r, res in enumerate(runs["ranks"]):
        for name in ("hyena_tp", "attention_tp", "resume_tp_from_2x2"):
            assert res[name]["mesh"] == {"data": 2, "seq": 1, "model": 2}
            assert res[name]["coords"] == (r // 2, 0)
            assert res[name]["final"] == runs["ranks"][0][name]["final"]
