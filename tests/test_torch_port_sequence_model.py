"""The port's generic backbone and its layers against the JAX package, on
the CPU, float32: `SequenceModel` / `SequenceResidualBlock`, the residual
functions and pools, `FF`, `LongConv` / `LongConvKernel`, `BlockFFT`, the
DCTs (`models/sequence_model.py`, `long_conv.py`, `block_fft.py`,
`dxt.py`), the `nn.py` activations, `Normalization`, `Gate` and
`stochastic_depth`, and the registries.

JAX parameters (perturbed off their zero biases) go to the port with
`utils/convert.py`. Tolerances: outputs within 1e-5 of their max |value|;
the input's and every parameter's gradient within 1e-4 of its own max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import block_fft as JB
from hyena_dna_tpu.models import dxt as JD
from hyena_dna_tpu.models import long_conv as JL
from hyena_dna_tpu.models import nn as JN
from hyena_dna_tpu.models import sequence_model as JS
from hyena_dna_tpu_torch.models import block_fft as PB
from hyena_dna_tpu_torch.models import dxt as PD
from hyena_dna_tpu_torch.models import long_conv as PL
from hyena_dna_tpu_torch.models import nn as PN
from hyena_dna_tpu_torch.models import sequence_model as PS
from hyena_dna_tpu_torch.utils import registry as R
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from test_torch_port_attention import assert_close, assert_param_grads, perturbed

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def first(out):
    return out[0] if isinstance(out, tuple) else out


def run_pair(jm, pm, x, *call_args, seed=0, grads=True, jax_kw=None):
    """Init the JAX module on x, carry its parameters to the port module,
    and compare the output and (with `grads`) the input's and every
    parameter's gradient of a weighted sum of it."""
    jax_kw = jax_kw or {}
    variables = jm.init(KEY, jnp.asarray(x), *call_args, **jax_kw)
    params = perturbed(variables.get("params", {}), seed + 1)
    if params:
        pm.load_state_dict(flax_to_torch_state_dict(params), strict=True)

    def apply(p, x):
        return first(jm.apply({"params": p}, x, *call_args, **jax_kw))

    ref = np.asarray(apply(params, jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=grads)
    y = first(pm(xt, *call_args))
    assert_close(y.detach(), ref, OUT_TOL, "y")
    if grads:
        w = np.random.default_rng(seed + 7).standard_normal(ref.shape).astype(np.float32)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(apply(p, x) * w), argnums=(0, 1)))(
            params, jnp.asarray(x))
        (y * torch.from_numpy(w)).sum().backward()
        assert_close(xt.grad, gx, GRAD_TOL, "dx")
        if params:
            assert_param_grads(pm, gp)
    return pm, params


def features(shape=(2, 16, 8), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["tanh", "relu", "gelu", "gelu_tanh", "swish", "silu",
                                  "sigmoid", "softplus", "sqrelu", "laplace", "sin", "glu",
                                  "id", None])
def test_activations_match_jax(name):
    x = features((3, 10))
    assert_close(PN.activation_fn(name)(torch.from_numpy(x)),
                 JN.activation_fn(name)(jnp.asarray(x)), OUT_TOL, str(name))


@pytest.mark.parametrize("norm", ["layer", "rms", "group", "none"])
def test_normalization_matches_jax(norm):
    run_pair(JN.Normalization(d=64, norm_type=norm), PN.Normalization(64, norm),
             features((2, 6, 64)), seed=1, grads=norm != "none")


@pytest.mark.parametrize("mechanism", ["N", "G", "FS", "BE", "BR", "TE", "TR", "TS", "UR", "R"])
def test_gate_matches_jax(mechanism):
    run_pair(JN.Gate(size=6, mechanism=mechanism), PN.Gate(8, 6, mechanism),
             features((2, 5, 8)), seed=2, grads=mechanism != "N")


def test_stochastic_depth_rows():
    """Row mode drops whole batch rows and scales survivors; eval is the
    identity; one seed gives one draw."""
    x = torch.ones(64, 3, 4)
    y = PN.stochastic_depth(x, 0.5, "row", True, torch.Generator().manual_seed(0))
    rows = y.reshape(64, -1)
    assert set(rows.unique().tolist()) <= {0.0, 2.0}
    assert (rows == rows[:, :1]).all() and 0 < (rows[:, 0] == 0).sum() < 64
    same = PN.stochastic_depth(x, 0.5, "row", True, torch.Generator().manual_seed(0))
    assert torch.equal(y, same)
    assert PN.stochastic_depth(x, 0.5, "row", False) is x
    batch = PN.stochastic_depth(x, 0.5, "batch", True, torch.Generator().manual_seed(1))
    assert len(batch.unique()) == 1


def test_identity_and_ff_match_jax():
    x = features()
    run_pair(JS.SequenceIdentity(d_model=8), PS.SequenceIdentity(8), x)
    run_pair(JS.FF(d_input=8, expand=2, activation="gelu"), PS.FF(8, expand=2), x, seed=3)
    run_pair(JS.FF(d_input=8, expand=3, d_output=4, activation="relu"),
             PS.FF(8, expand=3, d_output=4, activation="relu"), x, seed=4)


@pytest.mark.parametrize("name,kw", [("R", {}), ("R", dict(alpha=0.5, beta=2.0)), ("F", {}),
                                     ("D", {}), ("D", dict(l2=False)), ("A", dict(gamma=0.5)),
                                     ("A", dict(scalar=False)), ("H", {}),
                                     ("H", dict(elemwise=True, scaling_correction=True))])
def test_residuals_match_jax(name, kw):
    x, y = features(seed=1), features(seed=2)
    jm = JS.RESIDUAL_REGISTRY[name](i_layer=4, d_input=8, d_model=8, **kw)
    pm = PS.RESIDUAL_REGISTRY[name](i_layer=4, d_input=8, d_model=8, **kw)
    params = perturbed(jm.init(KEY, jnp.asarray(x), jnp.asarray(y)).get("params", {}), 5)
    if params:
        pm.load_state_dict(flax_to_torch_state_dict(params))
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        assert_close(pm(torch.from_numpy(x), torch.from_numpy(y)), ref, OUT_TOL, name)


@pytest.mark.parametrize("name,kw", [("avg", dict(stride=4)), ("avg", dict(stride=3, expand=2)),
                                     ("sample", dict(stride=2, expand=2)),
                                     ("linear", dict(stride=4)), ("linear", dict(stride=2,
                                                                                expand=2))])
def test_pools_match_jax(name, kw):
    x = features((2, 16, 8), seed=3)
    pm, _ = run_pair(JS.POOL_REGISTRY[name](d_input=8, **kw),
                     PS.POOL_REGISTRY[name](d_input=8, **kw), x, seed=6)
    assert pm.d_output == 8 * kw.get("expand", 1)


@pytest.mark.parametrize("kw", [dict(stride=2), dict(stride=4, causal=True),
                                dict(stride=2, expand=2)])
def test_up_pool_matches_jax(kw):
    run_pair(JS.UpAvgPool(d_input=8, **kw), PS.UpAvgPool(8, **kw), features(seed=4), seed=7)


SEQUENCE_MODELS = {
    "hyena": dict(d_model=16, n_layers=2, residual="R", norm="layer",
                  layer={"_name_": "hyena", "l_max": 32, "filter_order": 16,
                         "filter_cfg": {"emb_dim": 5}}),
    "ff_pool": dict(d_model=8, n_layers=2, layer={"_name_": "ff", "expand": 2}, residual="R",
                    norm="layer", pool={"_name_": "avg", "stride": 2}, track_norms=False),
    "mixed_postnorm": dict(d_model=16, n_layers=1, prenorm=False, residual="H", norm="rms",
                           layer=[{"_name_": "long-conv", "l_max": 32},
                                  {"_name_": "ff", "activation": "sqrelu"},
                                  {"_name_": "mha", "num_heads": 2}]),
    "repeat_linear_pool": dict(d_model=8, n_layers=1, n_repeat=2, residual="A", norm="rms",
                               layer={"_name_": "long-conv", "l_max": 32, "postact": None},
                               pool={"_name_": "linear", "stride": 2}),
    "hyena_order3_heads": dict(d_model=16, n_layers=1, residual="D", norm="layer",
                               layer={"_name_": "hyena", "l_max": 32, "order": 3,
                                      "num_heads": 2, "filter_order": 16,
                                      "filter_cfg": {"emb_dim": 3}}),
}


@pytest.mark.parametrize("case", sorted(SEQUENCE_MODELS))
def test_sequence_model_matches_jax(case):
    """The backbone's output, every gradient, and its output norms (the
    JAX `metrics` collection) where tracked."""
    cfg = SEQUENCE_MODELS[case]
    jm = JS.SequenceModel(**cfg)
    pm = PS.SequenceModel(**cfg)
    x = features((2, 32, cfg["d_model"]), seed=len(case))
    _, params = run_pair(jm, pm, x, seed=len(case))
    if pm.track_norms:
        _, mets = jm.apply({"params": params}, jnp.asarray(x), mutable=["metrics"])
        assert_close(pm.output_norms, mets["metrics"]["output_norms"], OUT_TOL, "norms")
        assert pm.output_norms.shape == (len(pm.layers) + 1,)


def test_sequence_model_dropout_draws_from_the_generator():
    pm = PS.SequenceModel(8, n_layers=2, dropout=0.5, layer={"_name_": "ff"}, residual="R",
                          generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(features())
    a = pm(x, generator=torch.Generator().manual_seed(1))[0]
    b = pm(x, generator=torch.Generator().manual_seed(1))[0]
    c = pm.eval()(x)[0]
    assert torch.equal(a, b) and not torch.allclose(a, c)


LONG_CONVS = {
    "plain": dict(activation="id", postact=None),
    "glu": {},
    "bidirectional": dict(bidirectional=True, postact=None, activation="id"),
    "channels2": dict(channels=2, activation="gelu"),
    "ma_smoothing": dict(kernel_cfg=dict(use_ma_smoothing=True, ma_window_len=5, lam=0.0)),
    "smooth_freq": dict(kernel_cfg=dict(use_ma_smoothing=True, smooth_freq=True, lam=0.0),
                        postact=None),
    # block plans of distinct sizes (64 = 16 x 4, 32 x 2): the flax module
    # names one parameter per size and cannot make a repeated one twice
    "block_fft": dict(block_fft_conv=True, block_fft_conv_args=dict(max_m=16), postact=None),
    "block_fft_learn_ifft": dict(block_fft_conv=True, learn_ifft=True,
                                 block_fft_conv_args=dict(max_m=32), postact=None),
}


@pytest.mark.parametrize("case", sorted(LONG_CONVS))
def test_long_conv_matches_jax(case):
    """`LongConv` at l_max = L and at L < l_max (the kernel cut)."""
    kw = LONG_CONVS[case]
    for length in (32, 24) if case in ("plain", "glu") else (32,):
        jm = JL.LongConv(d_model=8, l_max=32, **kw)
        pm = PL.LongConv(8, l_max=32, **kw)
        run_pair(jm, pm, features((2, length, 8), seed=length), seed=length)


@pytest.mark.parametrize("init", ["random", "double_exp"])
def test_long_conv_kernel_init_shapes(init):
    k = PL.LongConvKernel(4, 16, weight_init=init, generator=torch.Generator().manual_seed(0))
    out, state = k()
    assert k.kernel.shape == out.shape == (1, 4, 16) and state is None
    ref = JL.LongConvKernel(H=4, L=16, weight_init=init).init(KEY)["params"]["kernel"]
    assert abs(float(k.kernel.detach().std()) / float(jnp.std(ref)) - 1) < 0.5


@pytest.mark.parametrize("n,max_m", [(16, 16), (64, 4), (256, 16), (128, 8)])
def test_block_fft_matches_jax_and_numpy(n, max_m):
    x = features((3, n), seed=n) + 1j * features((3, n), seed=n + 1)
    ours = PB.block_fft(torch.from_numpy(x.astype(np.complex64)), n, max_m)
    ref = JB.block_fft(jnp.asarray(x.astype(np.complex64)), n, max_m)
    assert_close(ours.abs(), jnp.abs(ref), OUT_TOL, "block_fft")
    assert_close(ours.real, np.fft.fft(x).real, 1e-5, "vs numpy")


@pytest.mark.parametrize("kw", [dict(learn_dft_matrices=False), dict(), dict(learn_additive=True)])
def test_block_fft_module_matches_jax(kw):
    """The learnable module, forward and inverse, from the JAX parameters;
    the port shares one matrix per block size over the depths, so a plan
    that repeats a size (64 = 4 x 4 x 4) runs too."""
    x = (features((2, 128), seed=1) + 1j * features((2, 128), seed=2)).astype(np.complex64)
    jm = JB.BlockFFT(N=128, max_m=16, **kw)  # blocks 16 x 8 (see LONG_CONVS)
    params = jm.init(KEY, jnp.asarray(x)).get("params", {})
    pm = PB.BlockFFT(N=128, max_m=16, **kw)
    if params:
        params = perturbed(params, 3)
        pm.load_state_dict(flax_to_torch_state_dict(params))
    for fwd in (True, False):
        ref = jm.apply({"params": params}, jnp.asarray(x), forward=fwd)
        with torch.no_grad():
            ours = pm(torch.from_numpy(x), forward=fwd)
        assert_close(torch.view_as_real(ours), np.stack([np.real(ref), np.imag(ref)], -1),
                     OUT_TOL, f"forward={fwd}")
    x64 = torch.from_numpy(x[:, :64])
    exact = PB.BlockFFT(N=64, max_m=4, learn_dft_matrices=False)(x64)
    torch.testing.assert_close(PB.BlockFFT(N=64, max_m=4)(x64), exact)


def test_block_fft_parameters_are_made_at_construction():
    """The parameters are those of the plan at N, made in the constructor:
    a call at a length whose plan uses only those sizes leaves the
    state_dict as it was, and one whose plan needs another size raises (the
    flax module's call raises for a parameter its init did not make), also
    inside `LongConv`."""
    pm = PB.BlockFFT(N=256, max_m=16)  # plan [16, 16]
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    assert sorted(before) == ["mat_16_im", "mat_16_re"]
    x = torch.from_numpy(features((2, 16), seed=3)).to(torch.complex64)
    pm(x, N=16)  # plan [16]
    after = pm.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    with pytest.raises(ValueError, match="no block of size 4"):
        pm(x, N=64)  # plan [16, 4]
    assert sorted(pm.state_dict()) == sorted(before)
    conv = PL.LongConv(8, l_max=64, block_fft_conv=True, postact=None)  # N 128: [16, 8]
    names = sorted(conv.state_dict())
    with pytest.raises(ValueError, match="no block of size 4"):
        conv(torch.zeros(1, 32, 8))  # fft 64: [16, 4]
    assert sorted(conv.state_dict()) == names


@pytest.mark.parametrize("norm", ["backward", "ortho"])
@pytest.mark.parametrize("mode", ["dense", "2n", "4n"])
def test_dct_matches_jax(norm, mode):
    x = features((3, 24), seed=5)
    assert_close(PD.dct(torch.from_numpy(x), norm, mode), JD.dct(jnp.asarray(x), norm, mode),
                 OUT_TOL, "dct")
    assert_close(PD.idct(torch.from_numpy(x), norm), JD.idct(jnp.asarray(x), norm),
                 OUT_TOL, "idct")


def test_idct_inverts_ortho_dct():
    x = torch.from_numpy(features((2, 33), seed=6))
    torch.testing.assert_close(PD.idct(PD.dct(x, "ortho"), "ortho"), x, rtol=1e-5, atol=1e-5)


def test_registries_build_every_layer_and_model():
    """Every entry of the JAX layer and model registries has a port entry
    that builds; the encoders' 'layer' builds the non-Hyena layers too."""
    from hyena_dna_tpu.utils import registry as JR
    from hyena_dna_tpu_torch.tasks import encoders as E

    assert set(JR.LAYER_REGISTRY) == set(R.LAYER_REGISTRY)
    assert set(JR.MODEL_REGISTRY) == set(R.MODEL_REGISTRY)
    x = torch.from_numpy(features((2, 16, 8)))
    for cfg in ({"_name_": "id"}, {"_name_": "ff"}, {"_name_": "mha", "num_heads": 2},
                {"_name_": "hyena", "l_max": 16, "filter_order": 8},
                {"_name_": "long-conv", "l_max": 16}):
        layer = PS.make_layer(8, cfg, generator=torch.Generator().manual_seed(0))
        assert first(layer(x)).shape == x.shape
        assert E.LayerEncoder(8, layer=cfg, generator=torch.Generator())(x).shape == x.shape
    model = R.MODEL_REGISTRY["model"](d_model=8, layer={"_name_": "ff"}, residual="R")
    assert model(x)[0].shape == x.shape
