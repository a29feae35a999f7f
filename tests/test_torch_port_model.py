"""The port's model stack against the JAX package, on the CPU.

JAX parameters are carried to the port with `utils/convert.py`; the JAX
Hyena layers take their Pallas front in interpret mode, the route they take
on the TPU. Hidden states and logits match at rtol = atol = 2e-4, the
tolerance of the golden reference-parity test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.models.filters import HyenaFilter as JaxFilter
from hyena_dna_tpu.models.filters import positional_embedding_init as jax_pos_emb
from hyena_dna_tpu.utils.torch_import import convert_state_dict

from hyena_dna_tpu_torch.models.filters import HyenaFilter, positional_embedding_init
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

GOLDEN = Path(__file__).parent / "golden" / "reference_parity.npz"
TOL = dict(rtol=2e-4, atol=2e-4)


def _layer(l_max, **extra):
    return dict(_name_="hyena", emb_dim=5, filter_order=16, short_filter_order=3,
                l_max=l_max, modulate=True, w=10, **extra)


def _jax_and_port(d_model, n_layer, L, seed=0, B=2):
    cfg = dict(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model, vocab_size=12,
               pad_vocab_size_multiple=8, residual_in_fp32=True)
    tokens = np.random.default_rng(seed).integers(0, 12, size=(B, L)).astype(np.int32)
    jm = JaxLM(layer=_layer(L + 2, use_pallas_front=True, pallas_interpret=True), **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens))["params"]
    # the JAX init leaves biases at zero; make them nonzero so they are tested
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = ConvLMHeadModel(layer=_layer(L + 2), **cfg).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm, tokens


@pytest.mark.parametrize("d_model,L", [(32, 256), (64, 1024), (48, 300)])
def test_slice_matches_jax_lm(d_model, L):
    """2 layers; L=300 is not a multiple of the Pallas tile, so the JAX side
    takes its unfused route there and the port still runs kernel A's math."""
    jm, params, pm, tokens = _jax_and_port(d_model, 2, L)
    ref_logits, _ = jm.apply({"params": params}, jnp.asarray(tokens))
    ref_hidden = jm.apply({"params": params}, jnp.asarray(tokens),
                          method=lambda m, x: m.backbone(x))
    with torch.inference_mode():
        t = torch.from_numpy(tokens).long()
        hidden, logits = pm.backbone(t), pm(t)
    assert logits.dtype == torch.float32 and logits.shape == (2, L, 16)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_convert_is_inverse_of_torch_import():
    _, params, _, _ = _jax_and_port(32, 2, 64)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = {k: v.numpy() for k, v in flax_to_torch_state_dict(params).items()}
    back = convert_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, val in flat_a:
        np.testing.assert_array_equal(flat_b[path], val, err_msg=str(path))


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    return z["tokens"], z["hidden"], z["logits"], sd


def _golden_model(sd):
    layer = dict(_name_="hyena", emb_dim=5, filter_order=64, l_max=1026, modulate=True,
                 w=10, lr=6e-4, wd=0.0, lr_pos_emb=0.0, shift=0.05, short_filter_order=3)
    model = ConvLMHeadModel(d_model=128, n_layer=2, d_inner=512, vocab_size=12,
                            pad_vocab_size_multiple=8, residual_in_fp32=True, layer=layer)
    model.load_state_dict(sd)  # reference names: no key surgery
    return model.eval()


def test_golden_hidden_parity(golden):
    tokens, ref_hidden, _, sd = golden
    with torch.inference_mode():
        hidden = _golden_model(sd).backbone(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(hidden.numpy(), ref_hidden, **TOL)


def test_golden_logits_parity(golden):
    tokens, _, ref_logits, sd = golden
    with torch.inference_mode():
        logits = _golden_model(sd)(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_filter_matches_jax(out_dtype):
    d, L, seq_len = 24, 100, 130
    jf = JaxFilter(d_model=d, emb_dim=5, order=16, seq_len=seq_len, w=10,
                   modulation_shift=0.05)
    params = jf.init(jax.random.PRNGKey(3), jnp.zeros((1, d, L)), L)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    ref = jf.apply({"params": params}, L, out_dtype=getattr(jnp, out_dtype),
                   method=JaxFilter.filter)
    pf = HyenaFilter(d, emb_dim=5, order=16, seq_len=seq_len, w=10, modulation_shift=0.05)
    sd = flax_to_torch_state_dict({"filter_fn": jax.tree_util.tree_map(np.asarray, params)})
    pf.load_state_dict({k[len("filter_fn."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        ours = pf.filter(L, out_dtype=getattr(torch, out_dtype))
    assert ours.shape == (1, L, d) and ours.dtype == getattr(torch, out_dtype)
    tol = 2e-5 if out_dtype == "float32" else 1e-2
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_positional_embedding_matches_jax():
    np.testing.assert_allclose(positional_embedding_init(5, 257).numpy(),
                               np.asarray(jax_pos_emb(5, 257)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key,value", [("inner_factor", 2), ("order", 1),
                                       ("num_heads", 3), ("_name_", "s4")])
def test_unported_configs_raise(key, value):
    """The general Hyena path and attention are ported (heads, outer mixing,
    order 3 and `_name_: mha` build; tests/test_torch_port_hyena_general.py
    holds them to JAX): what still raises is what the JAX package refuses
    too (inner_factor > 1, order < 2, heads that do not divide d_model) and
    a mixer name no registry has."""
    layer = _layer(66)
    layer[key] = value
    with pytest.raises((NotImplementedError, ValueError),
                       match="inner_factor|order must|multiple of num_heads|unknown mixer"):
        ConvLMHeadModel(d_model=16, n_layer=1, d_inner=64, vocab_size=12, layer=layer)


def test_init_is_seeded():
    def make(seed):
        return ConvLMHeadModel(d_model=16, n_layer=2, d_inner=64, vocab_size=12,
                               layer=_layer(34),
                               generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(1), make(1), make(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.layers.0.mixer.in_proj.weight"],
                           c["backbone.layers.0.mixer.in_proj.weight"])
    std = a["backbone.layers.0.mixer.in_proj.weight"].std().item()
    assert 0.015 < std < 0.025
