"""The port's fused MLP (kernels F and F', `ops/mlp_fused.py`) against the
JAX `ops/pallas_mlp.py::mlp_fused`, on the CPU.

The JAX kernel runs in interpret mode; the port's wrappers, given CPU
tensors, run the plain versions, which round every product's inputs to
bf16 where the JAX `_mm` does. Forward at the JAX test's 5e-2
(`tests/test_pallas_hyena.py:146-165`); gradients against `jax.vjp` of the
Pallas `mlp_fused` at 2e-2 of each gradient's max|g| (both sides round the
same bf16 operands; the sums differ in order, and a rounding that flips
between them moves a bf16 input by one step, 2^-8).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models.blocks import Mlp as JaxMlp
from hyena_dna_tpu.ops import pallas_mlp as PM

from hyena_dna_tpu_torch.models.blocks import Block, Mlp
from hyena_dna_tpu_torch.ops import mlp_fused as MF
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

FWD_TOL = 5e-2
GRAD_TOL = 2e-2


def _inputs(n, d, dh, d_out, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32) * 0.5,
            rng.normal(size=(d, dh)).astype(np.float32) * 0.05,
            rng.normal(size=(dh,)).astype(np.float32) * 0.1,
            rng.normal(size=(dh, d_out)).astype(np.float32) * 0.05,
            rng.normal(size=(d_out,)).astype(np.float32) * 0.1)


def _jax_dtype(dtype):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,d,dh,d_out,dtype", [
    (256, 128, 256, 128, "float32"),
    (384, 128, 256, 256, "float32"),
    (256, 256, 128, 128, "bfloat16"),
    (128, 384, 256, 384, "float32"),  # past the width the card path once refused
    (128, 384, 128, 384, "bfloat16"),
])
def test_mlp_fused_forward_matches_jax(n, d, dh, d_out, dtype):
    args = _inputs(n, d, dh, d_out, seed=n + d)
    jargs = [jnp.asarray(args[0], _jax_dtype(dtype))] + [jnp.asarray(a) for a in args[1:]]
    ref = PM.mlp_fused(*jargs, True)
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].to(getattr(torch, dtype))
    y = MF.mlp_fused(*targs)
    assert y.dtype == targs[0].dtype and y.shape == (n, d_out)
    np.testing.assert_allclose(y.float().numpy(), _np(ref), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("n,d,dh,d_out,dtype", [
    (384, 128, 256, 128, "float32"),  # three sequential grid steps on the JAX side
    (256, 128, 128, 256, "bfloat16"),
    (128, 384, 256, 384, "float32"),  # past the width the card path once refused
    (256, 384, 128, 384, "bfloat16"),
])
def test_mlp_fused_grads_match_jax_vjp(n, d, dh, d_out, dtype):
    args = _inputs(n, d, dh, d_out, seed=7 + n)
    dy = np.random.default_rng(3).normal(size=(n, d_out)).astype(np.float32)
    jdt = _jax_dtype(dtype)
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    _, vjp = jax.vjp(lambda *a: PM.mlp_fused(*a, True), *jargs)
    ref = vjp(jnp.asarray(dy, jdt))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a) for a in args]
    leaves[0] = leaves[0].to(tdt)
    leaves = [t.requires_grad_() for t in leaves]
    y = MF.mlp_fused(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(tdt))
    for name, g, r, leaf in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, ref, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        r = _np(r)
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err <= GRAD_TOL, (name, err)


def _bwd_ref_against_autograd(n, d, dh, d_out, seed):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(n, d, dh, d_out, seed=seed))
    dy = torch.randn(n, d_out, generator=torch.Generator().manual_seed(1))
    got = MF.mlp_fused_bwd_ref(x, dy, w1, b1, w2)
    r = lambda t: t.to(torch.bfloat16).double()
    leaves = [r(x).requires_grad_(), r(w1).requires_grad_(), b1.double().requires_grad_(),
              r(w2).requires_grad_(), b2.double().requires_grad_()]
    pre = leaves[0] @ leaves[1] + leaves[2]
    y = MF.gelu_tanh(pre) @ leaves[3] + leaves[4]
    want = torch.autograd.grad(y, leaves, dy.double())
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        err = (g.double() - w).abs().max() / w.abs().max()
        assert err <= GRAD_TOL, (name, err.item())


def test_mlp_fused_bwd_ref_is_the_autograd_of_the_forward():
    """The plain backward is the gradient of the plain forward with its
    bf16-rounded operands held fixed: against autograd of the same math on
    the rounded values, in float64."""
    _bwd_ref_against_autograd(128, 128, 128, 128, seed=5)


def test_mlp_fused_bwd_ref_is_the_autograd_at_a_wide_mixed_width():
    """The same at d = 384 -> 1536 -> 256: wider than F' once took on the
    card, with d != d_out."""
    _bwd_ref_against_autograd(128, 384, 1536, 256, seed=6)


def _jax_mlp(d, dh, d_out, x, use_fused):
    m = JaxMlp(hidden_features=dh, out_features=d_out, use_fused=use_fused)
    return m, m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]


def test_mlp_module_fused_matches_jax(monkeypatch):
    """`Mlp(use_fused=True)` with the JAX module's parameters (converted by
    `utils/convert.py`) against the JAX `Mlp(use_fused=True)` with its
    Pallas kernel in interpret mode (as `tests/test_pallas_hyena.py` forces
    it): output at 5e-2, and every gradient at 2e-2 of its max."""
    x = np.random.default_rng(1).normal(size=(2, 128, 128)).astype(np.float32) * 0.5
    jm, params = _jax_mlp(128, 256, 128, x, True)
    rng = np.random.default_rng(2)  # nonzero biases
    params = jax.tree_util.tree_map(lambda p: p + 0.01 * rng.normal(size=p.shape), params)
    monkeypatch.setattr(PM, "mlp_fused", functools.partial(PM.mlp_fused, interpret=True))
    y_ref, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), params, jnp.asarray(x))
    dy = np.random.default_rng(4).normal(size=y_ref.shape).astype(np.float32)
    g_params, g_x = vjp(jnp.asarray(dy))
    port = Mlp(128, 256, use_fused=True, out_features=128)
    port.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    inner = MF.MlpFused.apply
    monkeypatch.setattr(MF.MlpFused, "apply", lambda *a: calls.append(1) or inner(*a))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    y.backward(torch.from_numpy(dy))
    assert calls == [1]  # the fused route ran
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=FWD_TOL, rtol=FWD_TOL)
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, g_params), buffers=False)
    got = {n: p.grad for n, p in port.named_parameters()}
    got["x"], want["x"] = xt.grad, torch.from_numpy(np.array(g_x))
    for name, g in got.items():
        err = (g - want[name]).abs().max() / want[name].abs().max()
        assert err <= GRAD_TOL, (name, err.item())


@pytest.mark.parametrize("shape,hidden,d_out,fused", [
    ((2, 128, 128), 256, 128, True),
    ((2, 100, 128), 256, 128, False),   # N = 200: no 128-row tile
    ((2, 128, 96), 256, 96, False),     # d not a multiple of 128
    ((2, 128, 128), 192, 128, False),   # dh not a multiple of 128
    ((2, 128, 128), 256, 64, False),    # d_out not a multiple of 128
])
def test_mlp_takes_the_kernel_under_the_jax_rule(shape, hidden, d_out, fused, monkeypatch):
    """The fused route engages exactly where the JAX `Mlp` takes its kernel
    (`blocks.py:150-165`); elsewhere the two products run, as in JAX."""
    calls = []
    inner = MF.MlpFused.apply
    monkeypatch.setattr(MF.MlpFused, "apply", lambda *a: calls.append(1) or inner(*a))
    m = Mlp(shape[-1], hidden, use_fused=True, out_features=d_out)
    y = m(torch.randn(*shape))
    assert y.shape == (*shape[:-1], d_out)
    assert bool(calls) == fused
    assert MF.applies(shape[0] * shape[1], shape[-1], hidden, d_out) == fused


def test_mlp_bf16_fused_matches_two_products():
    """`Mlp(use_fused=True, dtype=bfloat16)` against `use_fused=False` on the
    same weights: the same bf16 products, summed in another order."""
    torch.manual_seed(0)
    a = Mlp(128, 256, dtype=torch.bfloat16, use_fused=True)
    b = Mlp(128, 256, dtype=torch.bfloat16)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 64, 128)
    ya, yb = a(x), b(x)
    assert ya.dtype == yb.dtype == torch.bfloat16
    assert (ya.float() - yb.float()).abs().max() <= FWD_TOL * yb.float().abs().max()


def test_block_does_not_set_use_fused():
    """The JAX `Block` builds its Mlp without `use_fused` (`blocks.py:229-234`)."""
    block = Block(128, 512, dict(_name_="hyena", l_max=64, filter_order=16, emb_dim=5))
    assert block.mlp.use_fused is False


def test_kernel_checks_refuse_what_f_does_not_take():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(128, 128, 128, 128, seed=0))
    MF._check(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiples of 64"):
        MF._check(x[:100], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 must be"):
        MF._check(x, w1, b1, w2[:64], b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MF._check(x.half(), w1, b1, w2, b2)
    big = torch.zeros(128, 2048)
    MF._check(big, torch.zeros(2048, 128), b1, w2, b2)  # any width: streamed through d


@pytest.mark.parametrize("d,d_out", [(256, 256), (384, 384), (512, 512), (512, 256),
                                     (1024, 1024), (256, 512)])
def test_kernel_checks_take_every_width_the_jax_rule_takes(d, d_out):
    """Kernels F and F' stream x, dy and the weights through d and d_out in
    fixed slabs, so their shared memory does not grow with the width:
    `_check` takes d_model 384, 512 and 1024, which the JAX rule fuses, and
    mixed widths, with dh = 4 d."""
    args = (torch.zeros(128, d), torch.zeros(d, 4 * d), torch.zeros(4 * d),
            torch.zeros(4 * d, d_out), torch.zeros(d_out))
    MF._check(*args)
    assert MF.applies(128, d, 4 * d, d_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_scratch_only_for_float32_inputs(dtype):
    """The C entries round float32 x and dy to bf16 once per call, into
    scratch the wrapper allocates with x's (dy's) shape; bf16 inputs are
    read as they are, with no scratch."""
    t = torch.zeros(192, 320, dtype=getattr(torch, dtype))
    scratch = MF._bf16_scratch(t)
    if dtype == "bfloat16":
        assert scratch is None
    else:
        assert scratch.dtype == torch.bfloat16 and scratch.shape == t.shape


@pytest.mark.parametrize("d,dh,d_out", [(256, 1024, 256), (64, 256, 320), (512, 2048, 512)])
def test_bwd_workspace_takes_whole_partial_sums(d, dh, d_out):
    """F''s workspace is the C helper's count of floats, a whole number of
    (d dh + dh d_out + dh) partial sums, beside the buffer of the summed
    gradients; a count the helper refuses (-1 past an int) or one that
    splits a sum is refused."""
    total = d * dh + dh * d_out + dh
    part, grads = MF._workspace(32 * total, d, dh, d_out, "cpu")
    assert part.shape == (32 * total,) and grads.shape == (total,)
    assert part.dtype == grads.dtype == torch.float32
    for bad in (-1, 0, 32 * total + 1):
        with pytest.raises(ValueError, match="no workspace"):
            MF._workspace(bad, d, dh, d_out, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_backward_is_the_plain_version_bit_for_bit(dtype):
    """On the CPU the wrapper is `mlp_fused_bwd_ref` itself, float32 x
    included: the plain versions did not change with the kernels."""
    x, w1, b1, w2, _ = (torch.from_numpy(a) for a in _inputs(192, 128, 256, 64, seed=9))
    x = x.to(getattr(torch, dtype))
    dy = torch.randn(192, 64, generator=torch.Generator().manual_seed(2)).to(x.dtype)
    for got, want in zip(MF.mlp_fused_bwd(x, dy, w1, b1, w2),
                         MF.mlp_fused_bwd_ref(x, dy, w1, b1, w2)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_wgmma_probe_refuses_what_it_does_not_take():
    """The probe entry runs on the card only, on bf16 a (64, 64), b (64, 256)
    and a mode of PROBE_MODES (N = 128, 192, 256 for each of three forms)."""
    assert sorted(MF.PROBE_MODES.values()) == [128] * 3 + [192] * 3 + [256] * 3
    a, b = torch.zeros(64, 64, dtype=torch.bfloat16), torch.zeros(64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma_probe"):
        MF.wgmma_probe(a, b, 0)  # CPU tensors
    with pytest.raises(ValueError, match="no kernel"):
        MF.wgmma_probe(a.to("meta"), b.to("meta"), 0)
