"""Rank functions of the port's data- and sequence-parallel tests, run in
ranks started by `hyena_dna_tpu_torch.parallel.spawn` (gloo on the CPU).

Spawned ranks import this module afresh, so it imports neither JAX nor the
suite's conftest: the test files make the JAX side in the pytest process
and hand inputs and parameters over as files; each rank writes what it
computed to `out/<name>_rank<r>.pt`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from hyena_dna_tpu_torch.models import ConvLMHeadModel, HyenaOperator
from hyena_dna_tpu_torch.ops.distributed import seq_fftconv, seq_short_conv
from hyena_dna_tpu_torch.parallel import launch
from hyena_dna_tpu_torch.parallel.launch import COLLECTIVES
from hyena_dna_tpu_torch.parallel.sharding import make_mesh

B, C, L = 2, 16, 128  # the shapes of tests/test_seq_parallel.py
D_OP = 16
LM_LAYER = dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=L, w=10)
LM_KW = dict(d_model=16, n_layer=2, d_inner=64, vocab_size=12, pad_vocab_size_multiple=8,
             layer=LM_LAYER, embed_dropout=0.0)
OP_KW = dict(d_model=D_OP, l_max=L, filter_order=16, filter_cfg=dict(emb_dim=5))


def ops_inputs() -> dict:
    """The seeded numpy inputs of the op and model checks."""
    rng = np.random.default_rng(0)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"u": f32(B, C, L), "k": f32(C, L), "D": f32(C), "x": f32(B, C, L),
            "w": f32(C, 3), "b": f32(C), "dy": f32(B, C, L),
            "op_u": f32(B, L, D_OP), "op_dy": f32(B, L, D_OP),
            "tokens": rng.integers(7, 11, size=(B, L)).astype(np.int64)}


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The mean next-token NLL of tests/test_seq_parallel.py."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def _t(a, grad=False):
    return torch.tensor(a).requires_grad_(grad)


def _grads(module) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for n, p in module.named_parameters()}


def _summed(grads: dict) -> dict:
    for g in grads.values():
        dist.all_reduce(g)
    return grads


def ops_and_models(out: str, params: str) -> None:
    """Join the group through torchrun's variables (`initialize_distributed`),
    build the 2 x 2 mesh and sum the ranks over each of its groups, then on
    the rank's rows (a contiguous block here) and columns: `seq_fftconv`
    forward and backward (a loss of sum(y * dy)), `seq_short_conv` forward
    and backward, the collectives they issued, a `HyenaOperator` and a
    `ConvLMHeadModel` with the mesh (parameters from the JAX modules)."""
    torch.set_num_threads(1)
    device = launch.initialize_distributed(torch.device("cpu"))
    mesh = make_mesh(data=2, seq=2)
    res = {"device": str(device), "backend": dist.get_backend(), "rank": launch.rank(),
           "world": launch.world_size(), "main": launch.is_main_process(),
           "coords": (mesh.data_index, mesh.seq_index)}
    for axis in ("data", "seq"):  # the sum of the ranks in each of this rank's groups
        t = torch.tensor(float(launch.rank()))
        dist.all_reduce(t, group=getattr(mesh, f"{axis}_group"))
        res[f"{axis}_group_sum"] = float(t)
    launch.barrier()
    a = ops_inputs()
    rows = slice(mesh.data_index * (B // mesh.data), (mesh.data_index + 1) * (B // mesh.data))
    cols = mesh.seq_columns(L)
    local = lambda name: np.ascontiguousarray(a[name][rows][..., cols])

    COLLECTIVES.reset()
    u, k, D = _t(local("u"), True), _t(a["k"], True), _t(a["D"], True)
    y = seq_fftconv(u, k, D, mesh)
    calls_fwd = dict(COLLECTIVES.calls)
    (y * _t(local("dy"))).sum().backward()
    res["fftconv"] = {"y": y.detach(), "du": u.grad, "dk": _summed({"k": k.grad})["k"],
                      "dD": _summed({"D": D.grad})["D"], "calls_fwd": calls_fwd,
                      "calls": dict(COLLECTIVES.calls), "bytes": dict(COLLECTIVES.bytes)}
    COLLECTIVES.reset()
    x, w, b = _t(local("x"), True), _t(a["w"], True), _t(a["b"], True)
    yc = seq_short_conv(x, w, b, mesh)
    (yc * _t(local("dy"))).sum().backward()
    res["short_conv"] = {"y": yc.detach(), "dx": x.grad, "dw": _summed({"w": w.grad})["w"],
                         "db": _summed({"b": b.grad})["b"], "calls": dict(COLLECTIVES.calls)}

    sd = torch.load(params, weights_only=True)
    op = HyenaOperator(**OP_KW, mesh=mesh)
    op.load_state_dict(sd["op"], strict=False)
    ou = _t(np.ascontiguousarray(a["op_u"][rows][:, cols]), True)
    oy = op(ou)
    (oy * _t(np.ascontiguousarray(a["op_dy"][rows][:, cols]))).sum().backward()
    res["op"] = {"y": oy.detach(), "du": ou.grad, "grads": _summed(_grads(op))}

    lm = ConvLMHeadModel(**LM_KW, mesh=mesh)
    lm.load_state_dict(sd["lm"], strict=False)
    tokens = torch.from_numpy(a["tokens"])
    targets = torch.roll(tokens, -1, dims=1)
    loss = lm_loss(lm(tokens[rows][:, cols]), targets[rows][:, cols]) / mesh.size
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total)
    res["lm"] = {"loss": total, "grads": _summed(_grads(lm))}
    torch.save(res, Path(out) / f"ops_rank{launch.rank()}.pt")


def write_genome(root: Path) -> tuple:
    """The genome fixture of tests/test_trainer.py: 4096 bases, 32 train,
    4 valid and 4 test intervals of 64."""
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=4096))
    fa, bed = root / "g.fa", root / "g.bed"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\n")
    with open(bed, "w") as f:
        for i in range(32):
            f.write(f"chr1\t{i * 128}\t{i * 128 + 64}\ttrain\n")
        for split, start in (("valid", 0), ("test", 2048)):
            for i in range(4):
                f.write(f"chr1\t{start + i * 64}\t{start + i * 64 + 64}\t{split}\n")
    return fa, bed


def lm_config(run_dir, fa, bed, mesh: dict, **extra_train) -> dict:
    """tests/test_trainer.py's sequence-parallel config (max_length 65, so
    L - 1 = 64 splits over seq; l_max 67; one epoch), cut to 4 steps an
    epoch, dropout off."""
    return {
        "train": {"seed": 1, "run_dir": str(run_dir), **extra_train},
        "mesh": dict(mesh),
        "trainer": {"max_epochs": 1, "precision": "32", "gradient_clip_val": 1.0,
                    "log_every_n_steps": 1, "limit_train_batches": 4},
        "dataset": {"_name_": "hg38", "bed_file": str(bed), "fasta_file": str(fa),
                    "batch_size": 4, "max_length": 65, "add_eos": True},
        "task": {"_name_": "hg38", "loss": "cross_entropy"},
        "model": {"_name_": "lm", "d_model": 32, "n_layer": 2, "d_inner": 128,
                  "vocab_size": 12, "pad_vocab_size_multiple": 8, "embed_dropout": 0.0,
                  "layer": {"_name_": "hyena", "emb_dim": 5, "filter_order": 16,
                            "l_max": 67, "w": 10, "lr": 6e-4, "wd": 0.0,
                            "lr_pos_emb": 0.0}},
        "optimizer": {"lr": 3e-3, "weight_decay": 0.1},
        "scheduler": {"_name_": "cosine_warmup_timm", "t_initial": 64,
                      "warmup_t": 4, "lr_min": 3e-4, "warmup_lr_init": 1e-6},
        "callbacks": {"timer": {}, "params": {},
                      "model_checkpoint": {"monitor": "val/loss", "mode": "min"}},
    }


def write_benchmark(root: Path) -> Path:
    """The GenomicBenchmarks fixture of tests/test_trainer.py: a toy task of
    two motifs, 32 + 32 train and 8 + 8 test sequences."""
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        for label, motif in (("pos", "ACGTACGT"), ("neg", "TTTTCCCC")):
            d = root / "bench" / "toy_task" / split / label
            d.mkdir(parents=True)
            for i in range(32 if split == "train" else 8):
                (d / f"{i}.txt").write_text(motif + "".join(rng.choice(list("ACGT"), size=24)))
    return root / "bench"


def cls_config(run_dir, bench, mesh: dict) -> dict:
    """tests/test_torch_port_finetune.py's classification config (pool
    head, accuracy, the host metrics), batch 8, two epochs, dropout off."""
    return {
        "train": {"seed": 0, "run_dir": str(run_dir)},
        "mesh": dict(mesh),
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


def run_trainer(config: dict, params=None):
    """Build the port's Trainer on the CPU, load `params` (a whole state
    dict file) if given, fit, close; returns (trainer, final metrics), the
    trainer's `step_shapes` the shape of each train step's token batch."""
    from hyena_dna_tpu_torch.train.trainer import Trainer

    trainer = Trainer(config, device="cpu")
    step, trainer.step_shapes = trainer.train_step, []

    def train_step(state, batch, generator=None):  # records its token batch's shape
        trainer.step_shapes.append(list(batch[0].shape))
        return step(state, batch, generator)

    trainer.train_step = train_step
    if params is not None:  # whole tensors: under a model axis the rank takes its slices
        from hyena_dna_tpu_torch.parallel.sharding import shard_state_dict, tp_layout

        missing, unexpected = trainer.model.load_state_dict(shard_state_dict(
            torch.load(params, weights_only=True), trainer.mesh, tp_layout(trainer.model)),
            strict=False)
        assert not unexpected and all(k.endswith(("pos_emb.t", ".freq")) for k in missing)
    try:
        return trainer, trainer.fit()
    finally:
        trainer.close()


def trainers(out: str, jobs: list) -> None:
    """Run each (name, config, params file or None) job's trainer in turn
    on the spawned ranks; each rank writes its mesh coordinates, final
    metrics and the shapes of the token batches its train steps took."""
    torch.set_num_threads(1)
    res = {}
    for name, config, params in jobs:
        trainer, final = run_trainer(config, params)
        res[name] = {"final": final, "coords": (trainer.mesh.data_index, trainer.mesh.seq_index),
                     "mesh": trainer.mesh.shape, "step": trainer.global_step,
                     "shapes": trainer.step_shapes}
    torch.save(res, Path(out) / f"trainers_rank{launch.rank()}.pt")


# ---- tensor parallelism (tests/test_torch_port_tensor_parallel.py) -----------

TP_LAYER = dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=L, w=10)
# tests/test_seq_parallel.py's tensor-parallel model
TP_LM_KW = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
                layer=TP_LAYER, embed_dropout=0.0)
TP_OP_KW = dict(d_model=32, l_max=L, filter_order=16, filter_cfg=dict(emb_dim=5))
TP_MHA_KW = dict(d_model=64, num_heads=8, rotary_emb_dim=4)


def tp_inputs() -> dict:
    """The seeded numpy inputs of the tensor-parallel checks."""
    rng = np.random.default_rng(1)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"op_u": f32(B, L, 32), "op_dy": f32(B, L, 32), "mlp_x": f32(B, L, 32),
            "mlp_dy": f32(B, L, 32), "attn_x": f32(B, L, 64), "attn_dy": f32(B, L, 64),
            "emb_ids": rng.integers(0, 16, size=(B, L)).astype(np.int64),
            "emb_dy": f32(B, L, 32), "head_h": f32(B, L, 32), "head_dy": f32(B, L, 16),
            "tokens": rng.integers(7, 11, size=(B, L)).astype(np.int64)}


def whole_grads(module, mesh) -> dict:
    """Every parameter's whole gradient from the ranks' own: a sharded one
    gathered, a partial one summed over the model group, a replicated one
    as it is."""
    from hyena_dna_tpu_torch.parallel.sharding import PARTIAL, SHARDED, gather_tensor, tp_layout

    layout, out = tp_layout(module), {}
    for name, g in _grads(module).items():
        kind = layout.get(name, ("",))
        if kind[0] == SHARDED:
            g = gather_tensor(g, *kind[1:], mesh)
        elif kind[0] == PARTIAL:
            dist.all_reduce(g, group=mesh.model_group)
        out[name] = g
    return out


def _aliases(module) -> dict:
    """{name: the name it shares its parameter with} for every parameter
    name that `named_parameters()` leaves out as a second name of one
    tensor (a filter's Sin `freq`, which the JAX module holds once)."""
    first = {}
    for name, p in module.named_parameters(remove_duplicate=False):
        first.setdefault(id(p), name)
    return {name: first[id(p)] for name, p in module.named_parameters(remove_duplicate=False)
            if first[id(p)] != name}


def _layer_run(module, inputs: list, cotangents: list, fn) -> dict:
    """fn(module, *inputs) -> outputs; the loss sum(out * cotangent)."""
    xs = [_t(x, x.dtype == np.float32) for x in inputs]
    outs = fn(module, *xs)
    sum((o * _t(c)).sum() for o, c in zip(outs, cotangents)).backward()
    return {"out": [o.detach() for o in outs], "dx": [x.grad for x in xs if x.requires_grad]}


def tensor_parallel(out: str, params: str) -> None:
    """The tensor-parallel checks on 4 ranks: the layers against the port's
    whole modules (Mlp, the vocab-parallel embedding and head, MHA with its
    heads split, all on a model axis of 4), the Hyena operator and the LM
    (parameters from the JAX modules) on model 4 and on seq 2 x model 2,
    then the clip norm and a LAMB step against one process."""
    from hyena_dna_tpu_torch.models.attention import MHA
    from hyena_dna_tpu_torch.models.blocks import Mlp
    from hyena_dna_tpu_torch.models.embeddings import GPT2Embeddings
    from hyena_dna_tpu_torch.parallel.sharding import (build_sharded, gather_state_dict,
                                                       shard_state_dict, tp_layout)
    from hyena_dna_tpu_torch.train.optim import build_optimizer
    from hyena_dna_tpu_torch.train.step import reduce_gradients

    torch.set_num_threads(1)
    launch.initialize_distributed(torch.device("cpu"))
    mesh = make_mesh(data=1, seq=1, model=4)
    mesh_sm = make_mesh(data=1, seq=2, model=2)
    a = tp_inputs()
    res = {"coords": (mesh.model_index, mesh_sm.seq_index, mesh_sm.model_index)}

    layers = {
        "mlp": (lambda m, g: _seeded(Mlp(32, 128, mesh=m), g), ["mlp_x"], ["mlp_dy"],
                lambda mod, x: [mod(x)]),
        "embedding": (lambda m, g: _seeded(GPT2Embeddings(32, 16, mesh=m), g),
                      ["emb_ids", "head_h"], ["emb_dy", "head_dy"],
                      lambda mod, ids, h: [mod(ids), mod.attend(h)]),
        "mha": (lambda m, g: MHA(**TP_MHA_KW, generator=g, mesh=m), ["attn_x"], ["attn_dy"],
                lambda mod, x: [mod(x)]),
    }
    res["layers"] = {}
    for name, (build, ins, cots, fn) in layers.items():
        whole = build(None, torch.Generator().manual_seed(3))
        ref = _layer_run(whole, [a[k] for k in ins], [a[k] for k in cots], fn)
        ref["grads"] = _grads(whole)
        split = build_sharded(build, mesh, torch.Generator().manual_seed(3))
        ours = _layer_run(split, [a[k] for k in ins], [a[k] for k in cots], fn)
        ours["grads"] = whole_grads(split, mesh)
        ours["sharded"] = sorted(tp_layout(split))
        res["layers"][name] = {"ref": ref, "tp": ours}

    sd = torch.load(params, weights_only=True)
    op = HyenaOperator(**TP_OP_KW, mesh=mesh)
    op.load_state_dict(shard_state_dict(sd["op"], mesh, tp_layout(op)))
    ou = _t(a["op_u"], True)
    oy = op(ou)
    (oy * _t(a["op_dy"])).sum().backward()
    res["op"] = {"y": oy.detach(), "du": ou.grad, "grads": whole_grads(op, mesh),
                 "aliases": _aliases(op)}

    tokens = torch.from_numpy(a["tokens"])
    targets = torch.roll(tokens, -1, dims=1)
    for key, m in (("lm_model4", mesh), ("lm_seq2_model2", mesh_sm)):
        lm = ConvLMHeadModel(**TP_LM_KW, mesh=m)
        layout = tp_layout(lm)
        lm.load_state_dict(shard_state_dict(sd["lm"], m, layout))
        cols = m.seq_columns(L)
        loss = lm_loss(lm(tokens[:, cols]), targets[:, cols]) / m.replicas
        loss.backward()
        (total,) = reduce_gradients(lm, [loss.detach()], m)
        grads = gather_state_dict({n: p.grad.clone() for n, p in lm.named_parameters()}, m,
                                  layout)
        res[key] = {"loss": total, "grads": grads, "layout": sorted(layout),
                    "aliases": _aliases(lm)}
        if key == "lm_model4":  # a clipped LAMB step on these gradients
            kw = dict(lr=1e-2, weight_decay=0.1, gradient_clip_val=0.05, optimizer_name="lamb")
            opt = build_optimizer(lm, mesh=m, **kw)[0]
            norm = opt.step()
            res["lamb"] = {"norm": norm, "params": gather_state_dict(
                {n: p.detach() for n, p in lm.named_parameters()}, m, layout)}
            whole = ConvLMHeadModel(**TP_LM_KW)
            whole.load_state_dict(sd["lm"])
            for n, p in whole.named_parameters():
                p.grad = grads[n].clone()
            ref_opt = build_optimizer(whole, **kw)[0]
            res["lamb_ref"] = {"norm": ref_opt.step(), "params": {
                n: p.detach() for n, p in whole.named_parameters()}}
    torch.save(res, Path(out) / f"tp_rank{launch.rank()}.pt")


def _seeded(module, generator):
    """`module` with its weights drawn N(0, 0.02) from `generator` in
    parameter order."""
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.02, generator=generator)
    return module


# ---- the mesh's remaining combinations (tests/test_torch_port_mesh_rest.py) ---

MR_B, MR_L, MR_D = 2, 64, 32
# MHA on a seq axis: causal with and without rotary, and bidirectional
MR_MHA = {"causal": dict(num_heads=4), "rotary": dict(num_heads=4, rotary_emb_dim=4),
          "bidirectional": dict(num_heads=4, causal=False)}
# an all-attention LM with learned positions (hg38_attention's layout)
MR_ATTN_LM = dict(d_model=MR_D, n_layer=2, d_inner=64, vocab_size=12, pad_vocab_size_multiple=8,
                  attn_layer_idx=[0, 1], attn_cfg=dict(num_heads=4),
                  max_position_embeddings=MR_L, embed_dropout=0.0,
                  layer=dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=MR_L + 2))
# SequenceDecoder (mode, l_output, masked); 40 positions span both ranks
MR_DECODERS = {"last_0": ("last", 0, False), "last_40": ("last", 40, False),
               "last_none": ("last", None, False), "first_3": ("first", 3, False),
               "first_40": ("first", 40, False), "pool_0": ("pool", 0, False),
               "pool_40": ("pool", 40, False), "pool_none": ("pool", None, False),
               "pool_mask": ("pool", 0, True), "sum_0": ("sum", 0, False),
               "sum_none": ("sum", None, False), "ragged": ("ragged", 0, False)}
MR_LENGTHS = (50, 20)  # each row's true length: the ragged ends and the masks
MR_D_OUT = 4
# the general Hyena path on a model axis of 2: M divides the heads (head
# split) or, with one head, head_dim (channel split)
MR_HYENA = {"heads2": dict(num_heads=2), "outer_heads2": dict(num_heads=2, outer_mixing=True),
            "ffn_one_head": dict(post_order_ffn=True),
            "all_heads2": dict(order=3, num_heads=2, num_blocks=2, outer_mixing=True,
                               post_order_ffn=True),
            "all_one_head": dict(order=3, num_blocks=2, outer_mixing=True, post_order_ffn=True)}
MR_HYENA_KW = dict(d_model=MR_D, l_max=MR_L, filter_order=16, filter_cfg=dict(emb_dim=5))
# the 4-D route (front4) at tests/test_torch_port_front4.py's plan: fft 4096
MR_F4_PLAN, MR_F4_N, MR_F4_L, MR_F4_D = (4, 8, 128), 4096, 1536, 8


def mesh_rest_inputs() -> dict:
    """The seeded numpy inputs of the mesh-rest checks."""
    rng = np.random.default_rng(7)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    mask = np.zeros((MR_B, MR_L), np.float32)
    for i, n in enumerate(MR_LENGTHS):
        mask[i, :n] = 1.0
    return {"x": f32(MR_B, MR_L, MR_D), "dy": f32(MR_B, MR_L, MR_D),
            "dec_dy": f32(MR_B, MR_L, MR_D_OUT), "mask": mask,
            "tokens": rng.integers(7, 11, size=(MR_B, MR_L + 1)).astype(np.int64),
            "f4_u": f32(1, MR_F4_L, MR_F4_D), "f4_dy": f32(1, MR_F4_L, MR_F4_D)}


def decoder_cotangent(a: dict, name: str) -> np.ndarray:
    """The cotangent of decoder case `name`'s output (B, l, d_out), or
    (B, d_out) for l_output 0."""
    _, l_output, _ = MR_DECODERS[name]
    if l_output is None:
        return a["dec_dy"]
    return a["dec_dy"][:, 0] if l_output == 0 else a["dec_dy"][:, :l_output]


def mesh_rest(out: str, params: str) -> None:
    """The mesh-rest checks on 2 ranks. A seq axis of 2: MHA (each case of
    MR_MHA) and the all-attention LM with learned positions on the rank's
    columns, every SequenceDecoder case and NDDecoder's pool (a
    per-sequence output's loss weighted by 1 / S on each rank, the train
    step's weighting), MHA with dropout against the same module whole from
    the same generator. A model axis of 2: the general Hyena cases and
    front4's operator (parameters from the JAX modules) and the general
    path with dropout against the whole operator from the same generator."""
    from hyena_dna_tpu_torch.models.attention import MHA
    from hyena_dna_tpu_torch.models.heads import NDDecoder, SequenceDecoder
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel as LM
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.parallel.sharding import shard_state_dict, tp_layout

    torch.set_num_threads(1)
    launch.initialize_distributed(torch.device("cpu"))
    seq = make_mesh(data=1, seq=2)
    model = make_mesh(data=1, seq=1, model=2)
    a, sd = mesh_rest_inputs(), torch.load(params, weights_only=True)
    cols = seq.seq_columns(MR_L)
    local = lambda name: np.ascontiguousarray(a[name][:, cols])
    res = {"coords": (seq.seq_index, model.model_index), "mha": {}, "decoders": {},
           "hyena": {}}

    for name, kw in MR_MHA.items():
        m = MHA(MR_D, **kw, mesh=seq)
        m.load_state_dict(sd["mha"][name])
        x = _t(local("x"), True)
        y = m(x)
        (y * _t(local("dy"))).sum().backward()
        res["mha"][name] = {"y": y.detach(), "dx": x.grad, "grads": _summed(_grads(m))}
    # dropout: the whole (B, L, H, hd) mask sliced at the rank's columns
    whole = MHA(MR_D, 4, dropout=0.3, generator=torch.Generator().manual_seed(1))
    split = MHA(MR_D, 4, dropout=0.3, mesh=seq)
    split.load_state_dict(whole.state_dict())
    with torch.no_grad():
        ref = whole.train()(_t(a["x"]), torch.Generator().manual_seed(5))[:, cols]
        y = split.train()(_t(local("x")), torch.Generator().manual_seed(5))
    res["mha_dropout"] = float((y - ref).abs().max() / ref.abs().max())

    lm = LM(**MR_ATTN_LM, mesh=seq)
    lm.load_state_dict(sd["attn_lm"], strict=False)
    tokens = torch.from_numpy(a["tokens"])
    x_tok, y_tok = tokens[:, :-1], tokens[:, 1:]
    loss = lm_loss(lm(x_tok[:, cols]), y_tok[:, cols]) / seq.seq
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total)
    res["attn_lm"] = {"loss": total, "grads": _summed(_grads(lm)), "aliases": _aliases(lm)}

    lengths = torch.tensor(MR_LENGTHS)
    for name, (mode, l_output, masked) in MR_DECODERS.items():
        dec = SequenceDecoder(MR_D, MR_D_OUT, l_output, mode, mesh=seq)
        dec.load_state_dict(sd["decoder"])
        x = _t(local("x"), True)
        kw = {"mask": _t(local("mask"))} if masked else {}
        y = dec(x, lengths=lengths if mode == "ragged" else None, **kw)
        dy = decoder_cotangent(a, name)
        per_token = l_output is None
        dy = np.ascontiguousarray(dy[:, cols]) if per_token else dy
        ((y * _t(dy)).sum() / (1 if per_token else seq.seq)).backward()
        res["decoders"][name] = {"y": y.detach(), "dx": x.grad, "grads": _summed(_grads(dec))}
    nd = NDDecoder(MR_D, MR_D_OUT, mesh=seq)
    nd.load_state_dict(sd["decoder"])
    x = _t(local("x"), True)
    y = nd(x)
    ((y * _t(a["dec_dy"][:, 0])).sum() / seq.seq).backward()
    res["decoders"]["nd_pool"] = {"y": y.detach(), "dx": x.grad, "grads": _summed(_grads(nd))}

    for name, kw in MR_HYENA.items():
        op = HyenaOperator(**MR_HYENA_KW, **kw, mesh=model)
        op.load_state_dict(shard_state_dict(sd["hyena"][name], model, tp_layout(op)))
        u = _t(a["x"], True)
        y = op(u)
        (y * _t(a["dy"])).sum().backward()
        res["hyena"][name] = {"y": y.detach(), "du": u.grad, "grads": whole_grads(op, model),
                              "aliases": _aliases(op), "split": op.split,
                              "layout": {k: v for k, v in tp_layout(op).items()}}
    res["hyena_dropout"] = {}
    for name in ("all_heads2", "all_one_head"):
        kw = dict(**MR_HYENA_KW, **MR_HYENA[name], dropout=0.2)
        op_whole, op_split = HyenaOperator(**kw), HyenaOperator(**kw, mesh=model)
        op_whole.load_state_dict(sd["hyena"][name])
        op_split.load_state_dict(shard_state_dict(sd["hyena"][name], model,
                                                  tp_layout(op_split)))
        with torch.no_grad():
            ref = op_whole.train()(_t(a["x"]), torch.Generator().manual_seed(9))
            y = op_split.train()(_t(a["x"]), torch.Generator().manual_seed(9))
        res["hyena_dropout"][name] = float((y - ref).abs().max() / ref.abs().max())

    FB.OUTER_BY_N[MR_F4_N] = MR_F4_PLAN  # tests/test_front4.py's plan, as the JAX side
    op = HyenaOperator(MR_F4_D, MR_F4_L, filter_order=16, filter_cfg=dict(emb_dim=5),
                       front4=True, mesh=model)
    op.load_state_dict(shard_state_dict(sd["front4"], model, tp_layout(op)))
    u = _t(a["f4_u"], True)
    y = op(u)
    (y * _t(a["f4_dy"])).sum().backward()
    res["front4"] = {"y": y.detach(), "du": u.grad, "grads": whole_grads(op, model),
                     "aliases": _aliases(op), "plan": op.front4_plan(1, MR_F4_L)}
    torch.save(res, Path(out) / f"mesh_rest_rank{launch.rank()}.pt")


def mesh_rest_world(out: str, params: str, jobs: list) -> None:
    """One world of 2 ranks for tests/test_torch_port_mesh_rest.py: the
    module checks (`mesh_rest`), then the trainer jobs (`trainers`)."""
    mesh_rest(out, params)
    trainers(out, jobs)
