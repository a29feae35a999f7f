"""The port's general Hyena path (`models/hyena.py` off the fused route:
order > 2, heads, blocks, outer mixing, the post-order FFN, other short
filters, `inner_remat`), the filter's options and its conv
(`models/filters.py`), and the plain conv modes of `ops/fftconv.py`,
against the JAX package on the CPU, float32.

The cases are tests/test_hyena.py's general ones. JAX parameters
(perturbed off their zero biases) go to the port with `utils/convert.py`.
Tolerances: the operator's output within 1e-5 of max |y|; the input's and
every parameter's gradient within 1e-4 of its own max |g|; the filter
banks and the plain convs within 1e-5 of their max.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import HyenaFilter as JaxFilter
from hyena_dna_tpu.models import HyenaOperator as JaxOperator
from hyena_dna_tpu.ops.fftconv import fftconv_aliased as jax_aliased
from hyena_dna_tpu.ops.fftconv import fftconv_ref as jax_fftconv_ref
from hyena_dna_tpu_torch.models.blocks import make_mixer
from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.ops import fftconv as FC
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from test_torch_port_attention import assert_close, assert_param_grads, perturbed

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def run_operator(kw, length=None, batch=2, seed=0, fused_ok=False):
    """The JAX operator and the port's from the same parameters on the same
    input: output, input gradient and every parameter gradient."""
    jm = JaxOperator(**kw)
    length = length or kw["l_max"]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((batch, length, kw["d_model"])).astype(np.float32)
    w = rng.standard_normal(u.shape).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(u))["params"], seed + 1)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * w)

    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(u))
    gp, gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(u))
    pm = HyenaOperator(**kw)
    assert not pm.fused or fused_ok
    pm.load_state_dict(flax_to_torch_state_dict(params))
    ut = torch.tensor(u, requires_grad=True)
    y = pm(ut)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.shape == u.shape
    assert_close(y.detach(), ref, OUT_TOL, "y")
    assert_close(ut.grad, gu, GRAD_TOL, "du")
    assert_param_grads(pm, gp)
    return pm


GENERAL_CASES = {
    "order3": dict(d_model=16, l_max=64, order=3, filter_order=32,
                   filter_cfg=dict(emb_dim=3, w=1)),
    "multi_head": dict(d_model=32, l_max=128, order=2, filter_order=32, num_heads=4,
                       filter_cfg=dict(emb_dim=5, w=10)),
    "multi_block": dict(d_model=16, l_max=128, order=2, filter_order=32, num_blocks=2,
                        filter_cfg=dict(emb_dim=5, w=10)),
    "heads_and_blocks_order3": dict(d_model=24, l_max=128, order=3, filter_order=32,
                                    num_heads=2, num_blocks=2, filter_cfg=dict(emb_dim=3, w=1)),
    "outer_mixing": dict(d_model=16, l_max=64, order=2, filter_order=16, outer_mixing=True,
                         filter_cfg=dict(emb_dim=3, w=1)),
    "post_order_ffn": dict(d_model=32, l_max=64, order=3, filter_order=16, num_heads=4,
                           post_order_ffn=True, filter_cfg=dict(emb_dim=3, w=1)),
    "order3_inner_remat": dict(d_model=16, l_max=64, order=3, filter_order=16,
                               inner_remat=True, filter_cfg=dict(emb_dim=5)),
    "order4_short_filter_4": dict(d_model=16, l_max=64, order=4, filter_order=16,
                                  short_filter_order=4, filter_cfg=dict(emb_dim=3)),
    "multi_head_gelu": dict(d_model=16, l_max=64, order=2, filter_order=16, num_heads=2,
                            activation="gelu", filter_cfg=dict(emb_dim=3)),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_operator_matches_jax(case):
    kw = GENERAL_CASES[case]
    pm = run_operator(kw, seed=len(case))
    assert not pm.fused
    assert pm.plain_3d == (case in ("order3", "order3_inner_remat", "order4_short_filter_4"))


@pytest.mark.parametrize("kw", [dict(order=2, num_heads=1), dict(order=3, num_heads=2)])
def test_input_longer_than_l_max(kw):
    """L > l_max: only the filter is cut to l_max, the sequence keeps its
    length (tests/test_hyena.py::test_hyena_operator_input_longer_than_lmax);
    order 2 with one head takes the fused route (kernel A's plain version)."""
    pm = run_operator(dict(d_model=16, l_max=64, filter_order=16,
                           filter_cfg=dict(emb_dim=3, w=1), **kw), length=96, batch=1, seed=6,
                      fused_ok=True)
    assert pm.fused == (kw["order"] == 2)


FILTER_OPTIONS = [  # each option once, each route more than once
    ("fused", dict(normalized=True)), ("tail_3d", dict(linear_mixer=True)),
    ("generic", dict(use_bias=False)), ("tail_3d", dict(use_bias=False)),
    ("generic", dict(bidirectional=True)),
    ("fused", dict(normalized=True, use_bias=False, num_inner_mlps=1)),
    ("generic", dict(normalized=True, linear_mixer=True))]


@pytest.mark.parametrize("route,options", FILTER_OPTIONS)
def test_filter_options_match_jax(route, options):
    """The filter options on the three routes: order 2 one head (the fused
    route, kernel A's plain version), order 3 (`_tail_3d`), two heads
    (`_tail_generic`, which alone honours `use_bias`, as in JAX)."""
    kw = dict(d_model=16, l_max=64, filter_order=16,
              filter_cfg=dict(emb_dim=5, w=10, **options))
    kw.update({"fused": dict(order=2), "tail_3d": dict(order=3),
               "generic": dict(order=2, num_heads=2)}[route])
    pm = run_operator(kw, seed=2, fused_ok=True)
    assert pm.fused == (route == "fused")


def test_filter_bank_options_match_jax():
    """`filter()` with `normalized` (the L1 norm over the channels in
    float32) and with `linear_mixer` (one bias-free Linear, no Sin)."""
    for options in ({"normalized": True}, {"linear_mixer": True}):
        jf = JaxFilter(d_model=12, emb_dim=5, order=8, seq_len=64, w=10, **options)
        params = perturbed(jf.init(jax.random.PRNGKey(0), 64, method=JaxFilter.filter)["params"],
                           3)
        pf = HyenaFilter(12, emb_dim=5, order=8, seq_len=64, w=10, **options)
        sd = flax_to_torch_state_dict({"filter_fn": params})
        pf.load_state_dict({k[len("filter_fn."):]: v for k, v in sd.items()})
        ref = jf.apply({"params": params}, 64, method=JaxFilter.filter)
        with torch.no_grad():
            assert_close(pf.filter(64), ref, OUT_TOL, str(options))
        if "linear_mixer" in options:
            assert [type(m).__name__ for m in pf.implicit_filter] == ["Linear"]


@pytest.mark.parametrize("layout,lk", [("3d", 32), ("5d", 32), ("3d_aliased", 64),
                                       ("5d_aliased", 64)])
def test_filter_conv_matches_jax(layout, lk):
    """`HyenaFilter.forward` on (N, C, L) and (B, H, C, Z, L), with a bank
    as long as the block (`fftconv_chunked`, kernels B and C on the card)
    and longer than it (`fftconv_aliased`, circular at exactly 2L)."""
    c, length = 6, 32
    shape = (3, c, length) if layout.startswith("3d") else (2, 2, c, 2, length)
    rng = np.random.default_rng(lk)
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((c, lk)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    jf = JaxFilter(d_model=c, seq_len=64)
    params = jf.init(jax.random.PRNGKey(0), 64, method=JaxFilter.filter)["params"]
    bias_j = bias.reshape(1, c, 1)
    ref = jf.apply({"params": params}, jnp.asarray(x), length, k=jnp.asarray(k),
                   bias=jnp.asarray(bias_j))
    pf = HyenaFilter(c, seq_len=64)
    xt = torch.tensor(x, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    y = pf(xt, length, k=kt, bias=torch.from_numpy(bias))
    assert_close(y.detach(), ref, OUT_TOL, layout)
    w = rng.standard_normal(shape).astype(np.float32)
    gx, gk = jax.grad(lambda x, k: jnp.sum(jf.apply({"params": params}, x, length, k=k,
                                                    bias=jnp.asarray(bias_j)) * w),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    (y * torch.from_numpy(w)).sum().backward()
    assert_close(xt.grad, gx, GRAD_TOL, "dx")
    assert_close(kt.grad, gk, GRAD_TOL, "dk")


@pytest.mark.parametrize("mode", ["causal", "aliased"])
def test_plain_conv_modes_match_jax(mode):
    """The port's plain causal `fftconv_ref` and `fftconv_aliased` (a filter
    longer than the signal) against their JAX twins."""
    rng = np.random.default_rng(len(mode))
    u = rng.standard_normal((2, 4, 48)).astype(np.float32)
    k = rng.standard_normal((4, 48 if mode == "causal" else 80)).astype(np.float32)
    D = rng.standard_normal(4).astype(np.float32)
    jax_conv, ours = ((jax_fftconv_ref, FC.fftconv_ref) if mode == "causal"
                      else (jax_aliased, FC.fftconv_aliased))
    ref = jax_conv(jnp.asarray(u), jnp.asarray(k), jnp.asarray(D))
    assert_close(ours(*map(torch.from_numpy, (u, k, D))), ref, OUT_TOL, mode)


def test_make_mixer_maps_the_general_keys():
    """A reference-style layer config with the general and filter keys
    builds the general operator with those filter options."""
    op = make_mixer(24, {"_name_": "hyena", "l_max": 64, "order": 3, "num_heads": 2,
                         "num_blocks": 2, "outer_mixing": True, "post_order_ffn": True,
                         "bias": False, "normalized": True, "linear_mixer": False,
                         "bidirectional": False, "emb_dim": 5, "lr": 1e-3,
                         "filter_args": {"seq_len": 99, "order": 8}})
    assert (op.order, op.num_heads, op.num_blocks, op.outer_mixing, op.post_order_ffn) == \
        (3, 2, 2, True, True)
    assert not op.filter_fn.use_bias and op.filter_fn.normalized
    assert op.filter_fn.d_model == 12 * 2 and op.ord_proj_w.shape == (3, 2, 2)


@pytest.mark.parametrize("kw,err", [(dict(inner_factor=2), NotImplementedError),
                                    (dict(order=1), ValueError),
                                    (dict(num_heads=3), ValueError),
                                    (dict(num_blocks=3), ValueError)])
def test_operator_refuses_what_the_jax_package_refuses(kw, err):
    with pytest.raises(err):
        HyenaOperator(d_model=16, l_max=64, **kw)


def test_init_weights_is_the_operators_one_rule():
    """`HyenaOperator.init_weights` draws `ord_proj_w` (N(0, 1/sqrt(head_dim)))
    and the rest; the LM and the 'layer' encoder initialise through it, so
    the LM's operator holds the draws of a standalone operator given the
    generator in the same state, and no builder leaves `ord_proj_w` unset."""
    from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
    from hyena_dna_tpu_torch.tasks.encoders import LayerEncoder

    cfg = {"_name_": "hyena", "l_max": 32, "order": 3, "num_heads": 2,
           "post_order_ffn": True, "filter_order": 8}
    op = make_mixer(16, dict(cfg))
    op.init_weights(torch.Generator().manual_seed(0))
    w = op.ord_proj_w.detach()
    assert abs(float(w.std()) * math.sqrt(op.head_dim) - 1) < 0.5
    lm = ConvLMHeadModel(16, 2, 32, 8, layer=dict(cfg),
                         generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    torch.empty(8, 16).normal_(0.0, 0.02, generator=g)  # the token table first
    alone = make_mixer(16, dict(cfg))
    alone.init_weights(g, n_layer=2)
    mixer = lm.backbone.layers[0].mixer
    for name, p in alone.state_dict().items():
        torch.testing.assert_close(mixer.state_dict()[name], p, rtol=0, atol=0, msg=name)
    enc = LayerEncoder(16, layer=dict(cfg), generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(enc.layer.layer.ord_proj_w).all()
