"""The LM-level options of the port held against the JAX package on the CPU:
`identity_mlp` (and its fall-back from residual to block cells),
`residual_dtype`, `init_std`, `inputs_embeds` and `HyenaOperator(inner_remat)`.

JAX parameters are carried over with `utils/convert.py` (biases made
nonzero); logits at rtol = atol = 2e-4 as tests/test_torch_port_model.py,
1e-3 with a float16 or bfloat16 residual stream (its roundings may fall a
step apart on the two sides). `inner_remat` changes nothing in the port:
outputs and gradients the same bits with and without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.models.lm import DNAEmbeddingModel as JaxDNAEmbeddingModel
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel, DNAEmbeddingModel
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from test_torch_port_trainer import one_torch_thread  # noqa: F401  (an autouse fixture)

L = 64
LAYER = dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=L + 2, w=10)
CFG = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
           embed_dropout=0.0)
TOKENS = np.random.default_rng(0).integers(0, 12, size=(2, L)).astype(np.int32)


def _pair(jax_cls=JaxLM, port_cls=ConvLMHeadModel, **kw):
    jm = jax_cls(layer=LAYER, **CFG, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(TOKENS))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = port_cls(layer=LAYER, **CFG, **kw).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm


@pytest.mark.parametrize("kw,tol", [
    ({"identity_mlp": True}, 2e-4),
    ({"identity_mlp": True, "residual_in_fp32": True}, 2e-4),
    ({"residual_dtype": "float16"}, 1e-3),
    ({"residual_dtype": "bfloat16", "residual_in_fp32": True}, 1e-3),
    ({"residual_dtype": "float32"}, 2e-4)])
def test_backbone_option_matches_jax(kw, tol):
    jkw = {k: (jnp.dtype(v) if k == "residual_dtype" else v) for k, v in kw.items()}
    jm = JaxLM(layer=LAYER, **CFG, **jkw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(TOKENS))["params"]
    pm = ConvLMHeadModel(layer=LAYER, **CFG, **kw).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    if kw.get("identity_mlp"):
        assert not hasattr(pm.backbone.layers[0], "mlp")
    ref, _ = jm.apply({"params": params}, jnp.asarray(TOKENS))
    with torch.no_grad():
        out = pm(torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_identity_mlp_residual_cells_fall_back_to_block_cells():
    """With identity_mlp the residual cut is off: checkpointing runs block
    cells and gives the plain model's logits and gradients, bit for bit."""
    kw = dict(identity_mlp=True)
    plain = ConvLMHeadModel(layer=LAYER, **CFG, **kw, generator=torch.Generator().manual_seed(2))
    remat = ConvLMHeadModel(layer=LAYER, **CFG, **kw, checkpoint_mixer=True,
                            remat_residual_only=True, remat_group_size=2)
    remat.load_state_dict(plain.state_dict())
    assert not remat.backbone.residual_cells and remat.backbone.remat
    x = torch.from_numpy(TOKENS).long()
    for m in (plain, remat):
        cross_entropy(m(x[:, :-1]), x[:, 1:]).backward()
    grads = dict(plain.named_parameters())
    for name, p in remat.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name


def test_init_std_scales_the_embeddings_only():
    """As the JAX LMBackbone: init_std draws the embedding table; every
    other weight keeps the GPT-2 0.02."""
    port = ConvLMHeadModel(d_model=128, n_layer=2, d_inner=512, vocab_size=256, layer=LAYER,
                           init_std=0.1, generator=torch.Generator().manual_seed(0))
    jm = JaxLM(d_model=128, n_layer=2, d_inner=512, vocab_size=256, layer=LAYER, init_std=0.1)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ref = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for name in ("backbone.embeddings.word_embeddings.weight",
                 "backbone.layers.0.mixer.in_proj.weight", "backbone.layers.0.mlp.fc1.weight"):
        ours = float(dict(port.named_parameters())[name].detach().std())
        want = float(ref[name].std())
        assert abs(ours / want - 1) < 0.05, (name, ours, want)
    assert abs(float(port.backbone.embeddings.word_embeddings.weight.detach().std()) - 0.1) < 5e-3


@pytest.mark.parametrize("jax_cls,port_cls", [(JaxLM, ConvLMHeadModel),
                                              (JaxDNAEmbeddingModel, DNAEmbeddingModel)])
def test_inputs_embeds_matches_jax(jax_cls, port_cls):
    jm, params, pm = _pair(jax_cls, port_cls)
    emb = np.random.default_rng(3).standard_normal((2, L, 32)).astype(np.float32)
    ref, _ = jm.apply({"params": params}, None, inputs_embeds=jnp.asarray(emb))
    with torch.no_grad():
        out = pm(None, inputs_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    # the embeddings of the ids through inputs_embeds give the ids' output
    with torch.no_grad():
        ids = torch.from_numpy(TOKENS).long()
        np.testing.assert_array_equal(
            pm(None, inputs_embeds=pm.backbone.embeddings(ids)).numpy(), pm(ids).numpy())


def test_inner_remat_changes_nothing():
    """As tests/test_hyena.py:254, and in the port the same bits."""
    kw = dict(d_model=16, l_max=64, filter_order=16, filter_cfg=dict(emb_dim=5))
    torch.manual_seed(0)
    a = HyenaOperator(**kw)
    b = HyenaOperator(**kw, inner_remat=True)
    b.load_state_dict(a.state_dict())
    u = torch.randn(2, 64, 16)
    outs = []
    for op in (a, b):
        ui = u.clone().requires_grad_()
        y = op(ui)
        (y ** 2).sum().backward()
        outs.append((y.detach(), ui.grad, {n: p.grad for n, p in op.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for name, g in outs[0][2].items():
        assert torch.equal(g, outs[1][2][name]), name


def test_inner_remat_layer_config_matches_jax():
    """`inner_remat: true` in the layer config builds and matches the JAX model."""
    layer = dict(LAYER, inner_remat=True)
    jm = JaxLM(layer=layer, **CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(TOKENS))["params"]
    pm = ConvLMHeadModel(layer=layer, **CFG).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    ref, _ = jm.apply({"params": params}, jnp.asarray(TOKENS))
    with torch.no_grad():
        out = pm(torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
