"""The port's eval and serving layer against the JAX package, on the CPU:
presets (`evals/presets.py`, `hg38_inference --preset`), `generate_cli` in
both modes, `hg38_inference_decoder`, the ICL dataset, datamodule and
tuning loops (`data/icl.py`, `evals/{soft_prompting,instruction_tuned,
icl_cli}.py`), and the refusal of every new entry point without a card.
Every command-line tool runs with `--device cpu` on tiny checkpoints."""

import builtins
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.data.icl import ICLGenomicsDataset as JaxICL
from hyena_dna_tpu.data.loader import DataLoader as JaxLoader
from hyena_dna_tpu.evals import generate_cli as jax_generate_cli
from hyena_dna_tpu.evals import hg38_inference as jax_hg38
from hyena_dna_tpu.evals import hg38_inference_decoder as jax_decoder
from hyena_dna_tpu.evals import instruction_tuned as jax_it
from hyena_dna_tpu.evals import presets as jax_presets
from hyena_dna_tpu.evals import soft_prompting as jax_sp
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM

from hyena_dna_tpu_torch.data import datamodules as DM
from hyena_dna_tpu_torch.data.icl import ICLGenomicsDataset
from hyena_dna_tpu_torch.data.loader import DataLoader
from hyena_dna_tpu_torch.evals import generate_cli, hg38_inference, hg38_inference_decoder
from hyena_dna_tpu_torch.evals import icl_cli, presets
from hyena_dna_tpu_torch.evals.instruction_tuned import instruction_tune
from hyena_dna_tpu_torch.evals.soft_prompting import evaluate_soft_prompt, tune_soft_prompt
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from tests.test_torch_port_eval import _write_fasta


def _perturbed(params, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=p.shape).astype(np.float32), params)


# ----------------------------------------------------------------- presets

def test_512ksl_preset_builds_model():
    """tests/test_eval_clis.py:98 in the port (built on the meta device: no
    memory for the 524,290-long positional embeddings)."""
    cfg = presets.load_eval_preset("hyena_dna_512ksl")
    with torch.device("meta"):
        model = presets.build_model_from_preset(cfg["model"])
    assert model.d_model == 256 and model.n_layer == 8
    assert model.backbone.layers[0].mlp.fc1.out_features == 1024  # not 4 d_model
    assert model.backbone.remat
    mixer = model.backbone.layers[0].mixer
    assert mixer.l_max == 524290 and mixer.filter_fn.pos_emb.z.shape == (1, 524290, 33)
    assert mixer.filter_fn.modulation is None
    assert float(cfg["model"]["layer"]["w"]) == 14


def test_narrowed_512ksl_preset_matches_jax():
    """The preset's filter settings (emb_dim 33, modulate false, w 14, l_max
    524290, checkpointing on) at d 32 x 1 layer: the logits of the JAX
    preset model within 1e-5."""
    cfg = dict(presets.load_eval_preset("hyena_dna_512ksl")["model"], d_model=32, n_layer=1,
               d_inner=128)
    jm = jax_presets.build_model_from_preset(cfg)
    x = np.random.default_rng(0).integers(7, 11, size=(2, 96)).astype(np.int32)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    pm = presets.build_model_from_preset(cfg).eval()
    pm.load_state_dict(flax_to_torch_state_dict(params))
    ref, _ = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,mode,n_soft,lr", [
    ("soft_prompting_genomics", "soft_prompting", 16, 1e-3),
    ("instruction_tuned_genomics", "instruction_tuned", 16, 1e-4),
])
def test_icl_presets_feed_cli_args(name, mode, n_soft, lr):
    """tests/test_eval_clis.py:109 in the port, and the same fields as JAX."""
    fields = dict(mode="soft_prompting", lr=None, steps=500, n_soft=16, dataset_name="x",
                  shots=0, max_length=0, batch_size=0)
    args = presets.apply_icl_preset(SimpleNamespace(**fields), presets.load_eval_preset(name),
                                    explicit={"steps"})
    ref = jax_presets.apply_icl_preset(SimpleNamespace(**fields),
                                       jax_presets.load_eval_preset(name), explicit={"steps"})
    assert vars(args) == vars(ref)
    assert args.mode == mode and args.lr == lr and args.steps == 500
    assert args.shots == 2 and args.max_length == 256 and args.batch_size == 16
    assert args.dataset_name == "human_nontata_promoters" and args.n_soft == n_soft


def test_hg38_inference_preset_on_a_longsafari_dir_matches_jax(tmp_path):
    """`--preset` with a LongSafari directory (config.json + weights.ckpt
    written from a seeded port model): the JAX CLI's loss, rtol 1e-4."""
    model_cfg = dict(presets.load_eval_preset("hyena_dna_512ksl")["model"], d_model=32,
                     n_layer=1, d_inner=128)
    model_cfg["layer"] = dict(model_cfg["layer"], l_max=1026)
    preset = tmp_path / "tiny_512ksl.yaml"
    preset.write_text(json.dumps({"model": model_cfg}))  # JSON is YAML
    ckpt = tmp_path / "hyenadna-tiny"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(
        {k: v for k, v in model_cfg.items() if k != "_name_"}))
    model = presets.build_model_from_preset(model_cfg, generator=torch.Generator().manual_seed(3))
    torch.save({"state_dict": {"model." + k: v for k, v in model.state_dict().items()}},
               ckpt / "weights.ckpt")
    fasta = tmp_path / "g.fa"
    _write_fasta(fasta, {"chr14": 3000})
    argv = ["--preset", str(preset), "--ckpt", str(ckpt), "--fasta", str(fasta),
            "--max_length", "256", "--batch_size", "2", "--chr_ranges", "chr14:0-2048",
            "--limit_batches", "2"]
    ref = jax_hg38.main(argv)
    ours = hg38_inference.main(argv + ["--device", "cpu"])
    assert ours["tokens"] == ref["tokens"] == 4 * 256
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)


def test_load_params_refuses_orbax(tmp_path):
    (tmp_path / "run" / "0").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        hg38_inference.load_params(str(tmp_path / "run"), hg38_inference.build_model(8, 1, 16))


# ------------------------------------------------------------ generate_cli

@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    """A reference-named .pt of a seeded hg38 LM (d 32, 1 layer, L 64)."""
    model = hg38_inference.build_model(32, 1, 64, generator=torch.Generator().manual_seed(4))
    path = tmp_path_factory.mktemp("gen") / "weights.pt"
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--recurrent", "--n_modes", "24"]])
def test_generate_cli_greedy_matches_jax(tiny_pt, extra):
    argv = ["--ckpt", tiny_pt, "--prompt", "ACGTACGTAC", "--max_new_tokens", "8",
            "--d_model", "32", "--n_layer", "1", "--max_length", "64", "--temperature", "0"]
    ref = jax_generate_cli.main(argv + extra)
    out = generate_cli.main(argv + extra + ["--device", "cpu"])
    assert out["text"] == ref
    assert len(out["ids"]) == 18 and out["seconds"] > 0
    assert ("distill_seconds" in out) == bool(extra)


def test_generate_cli_samples(tiny_pt, capsys):
    """tests/test_eval_clis.py:61 in the port: top-k sampling keeps the
    prompt and prints nucleotides."""
    out = generate_cli.main(["--ckpt", tiny_pt, "--prompt", "ACGT", "--max_new_tokens", "8",
                             "--d_model", "32", "--n_layer", "1", "--max_length", "64",
                             "--top_k", "4", "--device", "cpu"])
    assert out["text"].startswith("ACGT") and set(out["text"]) <= set("ACGTN")
    assert capsys.readouterr().out.strip().splitlines()[-1] == out["text"]
    assert out["ids"][:4] == [7, 8, 9, 10]


# -------------------------------------------------- hg38_inference_decoder

D_MODEL, N_LAYER, MAX_LEN, D_OUT = 32, 2, 64, 3


@pytest.fixture(scope="module")
def decoder_ckpt(tmp_path_factory):
    """tests/test_inference_decoder.py's stack, JAX-initialised, written as
    a Lightning fine-tune checkpoint (`model.` prefix, `decoder.0.*`)."""
    backbone, decoder = jax_decoder.build_model(D_MODEL, N_LAYER, MAX_LEN, D_OUT)
    ids = jnp.zeros((1, MAX_LEN), jnp.int32)
    bp = _perturbed(backbone.init(jax.random.PRNGKey(0), ids)["params"], 1)
    h, _ = backbone.apply({"params": bp}, ids)
    dp = _perturbed(decoder.init(jax.random.PRNGKey(0), h)["params"], 2)
    sd = {"model." + k: v for k, v in flax_to_torch_state_dict(bp).items()}
    sd["model.decoder.0.output_transform.weight"] = torch.tensor(
        np.asarray(dp["output_transform"]["kernel"]).T)
    sd["model.decoder.0.output_transform.bias"] = torch.tensor(
        np.asarray(dp["output_transform"]["bias"]))
    sd["train_torchmetrics.num-tokens.count"] = torch.zeros(())
    path = tmp_path_factory.mktemp("dec") / "accuracy.ckpt"
    torch.save({"state_dict": sd}, path)
    ref = jax_decoder.HG38Inference(backbone, decoder, bp, dp, max_length=MAX_LEN)
    return str(path), ref, bp, dp


def _port_inference(ckpt):
    backbone, decoder = hg38_inference_decoder.build_model(D_MODEL, N_LAYER, MAX_LEN, D_OUT)
    hg38_inference_decoder.load_checkpoint(ckpt, backbone, decoder)
    return hg38_inference_decoder.HG38Inference(backbone, decoder, max_length=MAX_LEN)


def test_decoder_ckpt_key_mapping(decoder_ckpt):
    """The `decoder.0.*` head and the backbone land on the port's modules."""
    ckpt, _, bp, dp = decoder_ckpt
    infer = _port_inference(ckpt)
    np.testing.assert_array_equal(infer.decoder.output_transform.weight.detach().numpy(),
                                  np.asarray(dp["output_transform"]["kernel"]).T)
    np.testing.assert_array_equal(
        infer.backbone.backbone.embeddings.word_embeddings.weight.detach().numpy(),
        np.asarray(bp["backbone"]["embeddings"]["word_embeddings"]["embedding"]))


def test_decoder_predictions_match_jax(decoder_ckpt, tmp_path):
    ckpt, ref, _, _ = decoder_ckpt
    infer = _port_inference(ckpt)
    seqs = ["ACGTACGTAC", "TTGACANNAC"]
    logits = infer.predict_on_list(seqs)
    assert logits.shape == (2, D_OUT)
    np.testing.assert_allclose(logits, ref.predict_on_list(seqs), atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(0)
    xs = rng.integers(7, 11, size=(6, MAX_LEN)).astype(np.int32)
    ys = rng.integers(0, D_OUT, size=(6,)).astype(np.int32)
    loader = [(xs[:4], ys[:4]), (xs[4:], ys[4:])]
    preds, labels = infer.predict_from_loader(loader)
    ref_preds, _ = ref.predict_from_loader(loader)
    np.testing.assert_array_equal(preds, ref_preds)
    np.testing.assert_array_equal(labels, ys)

    # the CLI, and a checkpoint directory of the port's trainer
    argv = ["--ckpt", ckpt, "--d_model", str(D_MODEL), "--n_layer", str(N_LAYER),
            "--d_output", str(D_OUT), "--max_length", str(MAX_LEN), "--seqs", *seqs]
    out = hg38_inference_decoder.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(out["logits"], jax_decoder.main(argv)["logits"], atol=1e-5)
    state = {"backbone." + k: v for k, v in infer.backbone.state_dict().items()}
    state.update({"decoder." + k: v for k, v in infer.decoder.state_dict().items()})
    run = tmp_path / "checkpoints" / "best"
    run.mkdir(parents=True)
    torch.save({"model": state, "optimizer": {}, "step": 7}, run / "state_7.pt")
    np.testing.assert_array_equal(_port_inference(str(tmp_path / "checkpoints"))
                                  .predict_on_list(seqs), logits)


# --------------------------------------------------------------------- ICL

def _write_toy(root, splits=("train", "test"), n=24):
    """tests/test_generation_evals.py:72-89's set: the class is the motif of
    the first 4 characters."""
    rng = np.random.default_rng(0)
    for split in splits:
        for label, motif in (("neg", "TTTT"), ("pos", "AAAA")):
            d = root / "toy" / split / label
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"{i}.txt").write_text(motif + "".join(rng.choice(list("ACGT"), size=12)))
    return root


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _write_toy(tmp_path_factory.mktemp("icl"))


@pytest.mark.parametrize("kw", [
    dict(shots=0, max_length=16, use_padding=False, add_eos=False,
         label_to_token={0: "T", 1: "A"}),
    dict(shots=2, max_length=20),
    dict(shots=1, max_length=24, label_to_token={0: "[SEP]", 1: "N"}, rc_aug=True),
])
def test_icl_dataset_matches_jax(toy, kw):
    ours = ICLGenomicsDataset(split="train", dataset_name="toy", dest_path=str(toy), **kw)
    ref = JaxICL(split="train", dataset_name="toy", dest_path=str(toy), **kw)
    assert len(ours) == len(ref) == 48
    for idx in range(0, 48, 5):
        for a, b in zip(ours[idx], ref[idx]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
        seeded = ours.__getitem__(idx, rng=np.random.default_rng((3, idx)))
        for a, b in zip(seeded, ref.__getitem__(idx, rng=np.random.default_rng((3, idx)))):
            np.testing.assert_array_equal(a, b)


def test_icl_datamodule_matches_jax(toy):
    from hyena_dna_tpu.data.datamodules import ICLGenomicsDataModule as JaxDM

    kw = dict(dataset_name="toy", dest_path=str(toy), shots=1, max_length=20, batch_size=8)
    ours, ref = DM.DATASET_REGISTRY["icl_genomics"](**kw), JaxDM(**kw)
    ours.setup()
    ref.setup()
    assert ours.l_output == ref.l_output == 0 and ours.vocab_size == ref.vocab_size
    for a_loader, b_loader in ((ours.train_dataloader(), ref.train_dataloader()),
                               (ours.val_dataloader(), ref.val_dataloader())):
        pairs = list(zip(a_loader, b_loader))
        assert len(pairs) == len(b_loader) > 0
        for a, b in pairs:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


LM_KW = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
             embed_dropout=0.0, layer=dict(_name_="hyena", emb_dim=5, filter_order=16,
                                           l_max=40, w=10))


@pytest.fixture
def icl_setup(toy):
    """tests/test_generation_evals.py's ICL loader and toy LM on both sides."""
    kw = dict(split="train", shots=0, max_length=16, dataset_name="toy", dest_path=str(toy),
              use_padding=False, add_eos=False, label_to_token={0: "T", 1: "A"})
    loader = DataLoader(ICLGenomicsDataset(**kw), batch_size=8, shuffle=True, seed=0)
    ref_loader = JaxLoader(JaxICL(**kw), batch_size=8, shuffle=True, seed=0,
                           process_index=0, process_count=1)
    jm = JaxLM(**LM_KW)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16), jnp.int32))["params"], 1)
    pm = ConvLMHeadModel(**LM_KW)
    pm.load_state_dict(flax_to_torch_state_dict(params))
    return loader, ref_loader, jm, jax.tree_util.tree_map(jnp.asarray, params), pm


def _record_losses(monkeypatch, module):
    """The JAX loops log `float(loss)` each step at log_every=1: record it."""
    losses = []

    def recorder(v):
        losses.append(builtins.float(v))
        return losses[-1]

    monkeypatch.setattr(module, "float", recorder, raising=False)
    return losses


def test_soft_prompt_tuning_matches_jax(icl_setup, monkeypatch, capsys):
    """3 steps from the JAX initial soft matrix: the same losses within 1e-5
    relative; only the soft matrix moves."""
    loader, ref_loader, jm, params, pm = icl_setup
    x0 = jnp.asarray(next(iter(ref_loader))[0][:1])
    soft0 = jax_sp.SoftPromptModel(lm=jm, n_soft=4, d_model=32).init(
        jax.random.PRNGKey(0), x0, params)["params"]["soft_tokens"]
    ref_losses = _record_losses(monkeypatch, jax_sp)
    jax_sp.tune_soft_prompt(jm, params, ref_loader, n_soft=4, d_model=32, lr=3e-2, steps=3,
                            log_every=1)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    model, predict, losses = tune_soft_prompt(pm, loader, n_soft=4, d_model=32, lr=3e-2,
                                              steps=3, soft=torch.tensor(np.asarray(soft0)),
                                              log_every=0)
    assert len(ref_losses) == len(losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for name, val in pm.state_dict().items():
        torch.testing.assert_close(val, before[name], rtol=0, atol=0, msg=name)
    assert all(p.grad is None for p in pm.parameters())
    assert not torch.equal(model.soft_tokens.detach(), torch.tensor(np.asarray(soft0)))
    assert 0.0 <= evaluate_soft_prompt(predict, loader) <= 1.0


def test_instruction_tuning_matches_jax(icl_setup, monkeypatch):
    loader, ref_loader, jm, params, pm = icl_setup
    ref_losses = _record_losses(monkeypatch, jax_it)
    jax_it.instruction_tune(jm, params, ref_loader, lr=3e-3, steps=3, log_every=1)
    _, predict, losses = instruction_tune(pm, loader, lr=3e-3, steps=3, log_every=0)
    assert len(ref_losses) == len(losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert 0.0 <= evaluate_soft_prompt(predict, loader) <= 1.0


@pytest.mark.parametrize("mode", ["soft_prompting", "instruction_tuned"])
def test_icl_cli(tmp_path, mode, capsys):
    root = _write_toy(tmp_path, n=6)
    ckpt = tmp_path / "weights.pt"
    torch.save(hg38_inference.build_model(32, 1, 20 * 4, generator=torch.Generator()
                                          .manual_seed(0)).state_dict(), ckpt)
    result = icl_cli.main(["--mode", mode, "--ckpt", str(ckpt), "--dest_path", str(root),
                           "--dataset_name", "toy", "--shots", "1", "--max_length", "20",
                           "--d_model", "32", "--n_layer", "1", "--n_soft", "4",
                           "--steps", "3", "--batch_size", "4", "--device", "cpu"])
    assert result["mode"] == mode and result["shots"] == 1
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    assert 0.0 <= result["accuracy"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


# --------------------------------------------------------- no card, no run

@pytest.mark.parametrize("cli,argv", [
    (generate_cli, ["--ckpt", "unused.pt"]),
    (hg38_inference_decoder, ["--ckpt", "unused.pt", "--d_output", "2", "--seqs", "ACGT"]),
    (icl_cli, ["--ckpt", "unused.pt", "--dest_path", "unused"]),
])
def test_clis_raise_without_a_card(cli, argv, monkeypatch):
    """--device defaults to cuda; with no card each entry point raises
    before any work and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)

