"""The port's attention (`models/attention.py`), learned positions and the
attention configs against the JAX package, on the CPU, float32.

JAX parameters (perturbed off their zero biases) are carried to the port
with `utils/convert.py`; inputs are seeded numpy. Tolerances: outputs and
logits within 1e-5 of their max |value|; every gradient (the input's and
each parameter's) within 1e-4 of its own max |g|. The five attention
experiments are built through the port's config system at tiny overrides
and trained; `hg38_attention` is held to the JAX trainer (every train loss,
val / test loss, final parameters, as tests/test_torch_port_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.models import DNAEmbeddingModel as JaxDNA
from hyena_dna_tpu.models.attention import MHA as JaxMHA
from hyena_dna_tpu.utils.torch_import import convert_state_dict, load_torch_checkpoint
from hyena_dna_tpu_torch.models.attention import MHA
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel, DNAEmbeddingModel
from hyena_dna_tpu_torch.models.nn import dropout
from hyena_dna_tpu_torch.train.__main__ import build_config
from hyena_dna_tpu_torch.train.trainer import Trainer
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict, load_reference_state_dict
from test_torch_port_downstream_trainer import run_pair, species_dir
from test_torch_port_finetune import tiny_benchmark
from test_torch_port_trainer import one_torch_thread, tiny_genome

__all__ = ["one_torch_thread", "species_dir", "tiny_benchmark", "tiny_genome"]  # fixtures

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(params, seed):
    """The JAX init leaves biases at zero: move every parameter a little."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), to_np(params))


def assert_close(ours, ref, tol, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), f"{what}: {err} vs max {np.abs(ref).max()}"


def assert_param_grads(module, jax_grads):
    ref = flax_to_torch_state_dict(to_np(jax_grads), buffers=False)
    named = module.state_dict(keep_vars=True)  # the shared Sin `freq` under each name
    assert set(ref) <= set(named), set(ref) - set(named)
    for name, g in ref.items():
        ours = named[name].grad
        if ours is None:  # a parameter the output does not use: JAX gives zeros
            assert not g.any(), name
            continue
        assert_close(ours.numpy(), g.numpy(), GRAD_TOL, name)


@pytest.mark.parametrize("num_heads,rotary,scale", [(1, 0, None), (4, 0, None), (4, 8, None),
                                                    (2, 4, 0.3)])
def test_mha_matches_jax(num_heads, rotary, scale):
    """Forward, input gradient and every parameter gradient; with and
    without rotary embeddings, and an explicit softmax scale."""
    d, length, batch = 32, 24, 2
    rng = np.random.default_rng(num_heads + rotary)
    x = rng.standard_normal((batch, length, d)).astype(np.float32)
    w = rng.standard_normal((batch, length, d)).astype(np.float32)
    kw = dict(num_heads=num_heads, rotary_emb_dim=rotary, softmax_scale=scale, n_layer=2)
    jm = JaxMHA(d_model=d, **kw)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    pm = MHA(d, **kw)
    pm.load_state_dict(flax_to_torch_state_dict(params))

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * w)

    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = pm(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert_close(y.detach(), ref, OUT_TOL, "y")
    assert_close(xt.grad, gx, GRAD_TOL, "dx")
    assert_param_grads(pm, gp)


def test_mha_init_scales():
    """N(0, init_std) for Wqkv, / sqrt(2 n_layer) for out_proj, zero biases."""
    pm = MHA(256, 8, n_layer=8, init_std=0.05, generator=torch.Generator().manual_seed(0))
    assert abs(pm.Wqkv.weight.std().item() - 0.05) < 2e-3
    assert abs(pm.out_proj.weight.std().item() - 0.05 / 4) < 5e-4
    assert not pm.Wqkv.bias.any() and not pm.out_proj.bias.any()


def test_mha_dropout_drops_the_output_not_the_weights():
    """The JAX module drops the attention output after the product
    (`attention.py:61-65`), not SDPA's probabilities: with out_proj the
    identity, every element of the training output is 0 or the eval
    output / (1 - p), and the zeros are exactly `models/nn.py::dropout`'s
    mask on the (B, L, H, hd) output, drawn from the same generator."""
    d, heads, p = 16, 2, 0.5
    pm = MHA(d, heads, dropout=p, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pm.out_proj.weight.copy_(torch.eye(d))
        pm.out_proj.bias.zero_()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 12, d)).astype(np.float32))
    with torch.no_grad():
        ref = pm.eval()(x)
        y = pm.train()(x, torch.Generator().manual_seed(3))
        mask_of = dropout(ref.reshape(2, 12, heads, d // heads), p, True,
                          torch.Generator().manual_seed(3)).reshape(2, 12, d)
    kept = y != 0
    assert kept.any() and (~kept).any()
    torch.testing.assert_close(y[kept], ref[kept] / (1 - p), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(y, mask_of, rtol=1e-6, atol=1e-7)


def _layer(l_max):
    return dict(_name_="hyena", emb_dim=5, filter_order=16, short_filter_order=3,
                l_max=l_max, modulate=True, w=10)


def _mixed(jax_cls, port_cls, length=64, seed=0, **extra):
    """A 2-layer model with Hyena at layer 0 and 4-head MHA at layer 1, and
    a learned position table of `length` rows."""
    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
               residual_in_fp32=True, attn_layer_idx=(1,), attn_cfg=dict(num_heads=4),
               max_position_embeddings=length, embed_dropout=0.0, **extra)
    tokens = np.random.default_rng(seed).integers(0, 12, size=(2, length)).astype(np.int32)
    jm = jax_cls(layer=_layer(length + 2), **cfg)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens))["params"],
                       seed + 1)
    pm = port_cls(layer=_layer(length + 2), **cfg)
    pm.load_state_dict(flax_to_torch_state_dict(params))
    return jm, params, pm, tokens


@pytest.mark.parametrize("which", ["lm", "dna_embedding"])
def test_mixed_hyena_attention_model_matches_jax(which):
    """`ConvLMHeadModel` (logits) and `DNAEmbeddingModel` (hidden states)
    with a Hyena and an MHA layer and learned positions; then every
    parameter gradient of a weighted sum of the output."""
    jax_cls, port_cls = (JaxLM, ConvLMHeadModel) if which == "lm" else (JaxDNA, DNAEmbeddingModel)
    jm, params, pm, tokens = _mixed(jax_cls, port_cls)
    assert dict(pm.named_parameters())["backbone.embeddings.position_embeddings.weight"].shape \
        == (64, 32)
    ref, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(tokens))
    w = np.random.default_rng(5).standard_normal(ref.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(tokens))[0] * w)

    out = pm(torch.from_numpy(tokens).long())
    (out * torch.from_numpy(w)).sum().backward()
    assert_close(out.detach(), ref, OUT_TOL, which)
    assert_param_grads(pm, jax.jit(jax.grad(loss))(params))


def test_identity_mlp_mixed_model_matches_jax():
    """`identity_mlp` (no norm2, no MLP) with an attention mixer."""
    jm, params, pm, tokens = _mixed(JaxLM, ConvLMHeadModel, seed=4, identity_mlp=True)
    assert not any("mlp" in k for k in pm.state_dict())
    with torch.no_grad():
        out = pm(torch.from_numpy(tokens).long())
    assert_close(out, jax.jit(jm.apply)({"params": params}, jnp.asarray(tokens))[0], OUT_TOL,
                 "logits")


def test_pretrained_model_takes_attention():
    """`pretrained.HyenaDNAModel` passes `attn_layer_idx`, `attn_cfg` and
    `max_position_embeddings` through, as the JAX one does."""
    from hyena_dna_tpu.pretrained import HyenaDNAModel as JaxHyenaDNA
    from hyena_dna_tpu_torch.pretrained import HyenaDNAModel

    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, layer=_layer(66),
               attn_layer_idx=(0,), attn_cfg=dict(num_heads=2), max_position_embeddings=64,
               embed_dropout=0.0, pad_vocab_size_multiple=8)
    tokens = np.random.default_rng(8).integers(0, 12, size=(2, 64)).astype(np.int32)
    jm = JaxHyenaDNA(**cfg)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(8), jnp.asarray(tokens))["params"], 9)
    pm = HyenaDNAModel(**cfg)
    pm.load_state_dict(flax_to_torch_state_dict(params))
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(tokens).long())
    assert_close(out, jax.jit(jm.apply)({"params": params}, jnp.asarray(tokens)), OUT_TOL,
                 "hidden")


@pytest.mark.parametrize("mode", ["block", "res_g1", "res_g2"])
@pytest.mark.parametrize("residual_dtype", [None, "float16"])
def test_attention_under_checkpointing_equals_plain(mode, residual_dtype):
    """Remat cells take an attention mixer as they take Hyena: a 4-layer
    mixed stack (MHA at layers 1 and 2) with dropout on in the embedding,
    the residual and the attention gives the same logits, every gradient
    and the generator's end state bit for bit with checkpointing as
    without (tests/test_torch_port_remat.py's check), float32 residual or
    float16 (`residual_dtype`)."""
    from test_torch_port_remat import L, MODES, _assert_equal, _step, _tokens

    def model(**kw):
        return ConvLMHeadModel(d_model=16, n_layer=4, d_inner=64, vocab_size=12,
                               layer=_layer(L + 2), pad_vocab_size_multiple=8,
                               residual_in_fp32=True, residual_dtype=residual_dtype,
                               embed_dropout=0.1, resid_dropout=0.1, attn_layer_idx=(1, 2),
                               attn_cfg=dict(num_heads=2, dropout=0.1),
                               max_position_embeddings=L,
                               generator=torch.Generator().manual_seed(0), **kw)

    tokens = _tokens()
    _assert_equal(_step(model(**MODES[mode]), tokens), _step(model(), tokens))


def test_reference_ckpt_round_trip(tmp_path):
    """A reference-named Lightning `.ckpt` of an attention model (`model.`
    prefix, the tied `lm_head.weight`, a metric buffer) loads through
    `load_reference_state_dict` into a fresh port model with the same
    logits, and through the JAX importer into the JAX model with the same
    logits too: the names agree both ways."""
    jm, _, pm, tokens = _mixed(JaxLM, ConvLMHeadModel, seed=3)
    sd = {f"model.{k}": v.clone() for k, v in pm.state_dict().items()}
    sd["model.lm_head.weight"] = pm.backbone.embeddings.word_embeddings.weight.detach().clone()
    sd["train_torchmetrics.count"] = torch.zeros(())
    path = tmp_path / "attn.ckpt"
    torch.save({"state_dict": sd}, path)
    fresh = ConvLMHeadModel(layer=_layer(66), d_model=32, n_layer=2, d_inner=128, vocab_size=12,
                            pad_vocab_size_multiple=8, residual_in_fp32=True,
                            attn_layer_idx=(1,), attn_cfg=dict(num_heads=4),
                            max_position_embeddings=64).eval()
    fresh.load_state_dict(load_reference_state_dict(str(path)))
    pm.eval()
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        torch.testing.assert_close(fresh(t), pm(t), rtol=0, atol=0)
        ref, _ = jax.jit(jm.apply)(
            {"params": convert_state_dict(load_torch_checkpoint(str(path)))}, jnp.asarray(tokens))
        assert_close(fresh(t), ref, OUT_TOL, "logits through the JAX importer")


ATTN_TINY = ["model.d_model=32", "model.d_inner=128", "model.n_layer=2",
             "model.attn_cfg.num_heads=2", "trainer.precision=32", "trainer.max_epochs=1",
             "trainer.limit_train_batches=2", "trainer.log_every_n_steps=1",
             "dataset.num_workers=0"]


def _attention_run(tmp_path, name, extra, patch=None):
    cfg = build_config([f"experiment=hg38/{name}", *ATTN_TINY, *extra,
                        f"train.run_dir={tmp_path / name}"])
    cfg["mesh"] = {"data": 1}
    if patch:
        patch(cfg)
    model = cfg["model"]
    assert model["attn_layer_idx"] == [0, 1] and model["max_position_embeddings"] > 0
    trainer = Trainer(cfg, device="cpu")
    try:
        final = trainer.fit()
    finally:
        trainer.close()
    mixers = [type(layer.mixer).__name__ for layer in trainer.model.modules()
              if hasattr(layer, "mixer")]
    assert mixers == ["MHA", "MHA"], mixers
    return trainer, final


@pytest.mark.parametrize("name", ["hg38", "hg38_attention", "hg38_fixed_test_attention",
                                  "genomic_benchmark_attention", "species_attention"])
def test_attention_configs_build_and_train(tmp_path, name, tiny_genome, tiny_benchmark,
                                           species_dir):
    """Each shipped attention experiment through the port's config system at
    tiny overrides: both layers MHA, learned positions, finite losses (the
    test-only config evaluates its test split)."""
    fa, bed = tiny_genome
    hg38 = [f"dataset.fasta_file={fa}", f"dataset.bed_file={bed}", "dataset.max_length=64",
            "dataset.batch_size=4"]
    extra, patch = {
        "hg38": (hg38, None),
        "hg38_attention": (hg38, None),
        "hg38_fixed_test_attention": (
            [f"dataset.fasta_file={fa}", "dataset.max_length=64", "dataset.batch_size=4"],
            lambda cfg: cfg["dataset"].update(chr_ranges={"chr1": [0, 512]})),
        "genomic_benchmark_attention": (
            [f"dataset.dest_path={tiny_benchmark}", "dataset.dataset_name=toy_task",
             "dataset.max_length=32", "dataset.batch_size=8"], None),
        "species_attention": (
            [f"dataset.species_dir={species_dir}", "dataset.max_length=64",
             "dataset.total_size=32", "dataset.batch_size=8"], None),
    }[name]
    trainer, final = _attention_run(tmp_path, name, extra, patch)
    assert trainer.model.modules  # built
    assert np.isfinite(final["test/loss"])
    if name != "hg38_fixed_test_attention":
        assert trainer.global_step == 2


def test_hg38_attention_trainer_matches_jax(tmp_path, tiny_genome):
    """`experiment=hg38/hg38_attention` at tiny overrides, dropout off, on
    the port's Trainer and the JAX one from the same initial parameters."""
    fa, bed = tiny_genome
    argv = ["experiment=hg38/hg38_attention", f"dataset.fasta_file={fa}",
            f"dataset.bed_file={bed}", "dataset.max_length=64", "dataset.batch_size=4",
            "model.d_model=32", "model.d_inner=128", "model.attn_cfg.num_heads=4",
            "model.attn_cfg.dropout=0.0", "model.embed_dropout=0.0", "trainer.precision=32",
            "trainer.max_epochs=1", "trainer.limit_train_batches=3",
            "trainer.log_every_n_steps=1", "scheduler.warmup_t=2", "dataset.num_workers=0"]
    run_pair(tmp_path, argv)
