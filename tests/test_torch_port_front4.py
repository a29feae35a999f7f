"""The port's 4-D conv-layout route against the JAX package, on the CPU.

Kernels A4 and A4' (`ops/fused_front.py::fused_proj_conv_gate4`), the 4-D
conv (`ops/fftconv.py::fftconv_outer_4d`) and `HyenaOperator(front4=True)`,
given CPU tensors, run their plain versions; the JAX side runs its Pallas
kernels in interpret mode at `tests/test_front4.py`'s shapes: the outer plan
(4, 8, 128) injected at fft 4096 (rows_pad 16, lp 2048), L 1536, D 8, tile
512, with its `outer_plan` fixture's float32 store and dot dtypes. The
port's own plan table is patched the same way. Tolerances are that test's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.fftconv  # noqa: F401  (module registration)
import hyena_dna_tpu.ops.pallas_fftconv_n3 as PO
from hyena_dna_tpu.models import HyenaOperator as JaxHyenaOperator
from hyena_dna_tpu.ops.pallas_hyena import fused_proj_conv_gate4 as jax_front4

from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.ops import fftconv as TF
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

F = sys.modules["hyena_dna_tpu.ops.fftconv"]

PLAN = (4, 8, 128)
N = 4 * 8 * 128
ROWS, M = 16, 128
L = 1536
D = 8
TILE = 512


@pytest.fixture
def outer_plan(monkeypatch):
    """tests/test_front4.py's fixture, and the port's plan table at N."""
    monkeypatch.setattr(PO, "_STORE_DTYPE", jnp.float32)
    monkeypatch.setattr(PO, "_DOT_DTYPE", jnp.float32)
    monkeypatch.setitem(PO._OUTER_BY_N, N, PLAN)
    monkeypatch.setattr(F, "PALLAS_FFTCONV_INTERPRET", True)
    monkeypatch.setitem(FB.OUTER_BY_N, N, PLAN)


def _front_inputs(seed=0):
    """The inputs of tests/test_front4.py::_front_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, L, D)).astype(np.float32),
            rng.normal(size=(D, 3 * D)).astype(np.float32) * 0.1,
            rng.normal(size=(3 * D,)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3 * D)).astype(np.float32),
            rng.normal(size=(3 * D,)).astype(np.float32) * 0.1)


def test_front4_forward_matches_jax():
    """Kernel A4's plain version (what the CPU runs) against the Pallas
    `fused_proj_conv_gate4` in interpret mode, at 1e-4; the tail is zero."""
    args = _front_inputs()
    ref = jax_front4(*map(jnp.asarray, args), ROWS, M, TILE, True)
    got = FF.fused_proj_conv_gate4(*map(torch.from_numpy, args), ROWS, M, TILE)
    for g, r in zip(got, ref):
        assert g.shape == (1, D, ROWS, M)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
        assert not g.reshape(1, D, -1)[..., L:].any()


def test_front4_vjp_matches_jax():
    """The gradients of `fused_proj_conv_gate4` (kernel A4''s plain version)
    against the Pallas VJP in interpret mode, at 2e-3 / 1e-3, for the loss
    of tests/test_front4.py."""
    args = _front_inputs(seed=2)

    def loss4(*a):
        vx4, x04 = jax_front4(*a, ROWS, M, TILE, True)
        return jnp.sum(vx4 ** 2) + jnp.sum(jnp.sin(x04))

    ref = jax.grad(loss4, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    vx4, x04 = FF.fused_proj_conv_gate4(*leaves, ROWS, M, TILE)
    grads = torch.autograd.grad((vx4 ** 2).sum() + torch.sin(x04).sum(), leaves)
    for name, g, r in zip(("du", "dw", "dbp", "dwc", "dbc"), grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3, rtol=1e-3, err_msg=name)


def test_front4_bwd_ignores_the_tail():
    """`reference_bwd4` reads only the first L times of its cotangents."""
    args = [torch.from_numpy(a) for a in _front_inputs(seed=3)]
    g = torch.Generator().manual_seed(0)
    dvx4, dx04 = (torch.randn(1, D, ROWS, M, generator=g) for _ in range(2))
    zero_tail = [t.reshape(1, D, -1).clone() for t in (dvx4, dx04)]
    for t in zero_tail:
        t[..., L:] = 0
    a = FF.reference_bwd4(*args, dvx4, dx04)
    b = FF.reference_bwd4(*args, *(t.reshape(1, D, ROWS, M) for t in zero_tail))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _conv_loss_f64(u4, k4, Dv):
    """sum(y ** 2) of the flat padded conv in float64 on `torch.fft`: the
    anchor both float32 sides are measured against."""
    b, c = u4.shape[:2]
    u, k = u4.reshape(b, c, -1), k4.reshape(c, -1)
    n = 2 * u.shape[-1]
    y = torch.fft.irfft(torch.fft.rfft(u, n=n) * torch.fft.rfft(k, n=n), n=n)[..., :u.shape[-1]]
    return ((y + u * Dv[:, None]) ** 2).sum()


def test_fftconv_outer_4d_matches_jax(outer_plan):
    """`fftconv_outer_4d` (value and the gradients of u4, k4, D) against the
    JAX `fftconv_outer_4d` with its Pallas kernels in interpret mode, on its
    decaying filter: the value at 1e-5, each gradient within 1e-5 of its
    max|g| (the gradients reach ~1e4, where one float32 ulp is ~1e-3, so an
    elementwise absolute bound would test the FFT's summation order), and
    the port within 1e-6 of max|g| of a float64 conv of the same inputs."""
    n1, r, m = PLAN
    lp = ROWS * M
    rng = np.random.default_rng(3)
    u = rng.normal(size=(1, 4, ROWS, M)).astype(np.float32)
    k = (rng.normal(size=(4, lp)) * np.exp(-np.arange(lp) / (lp // 8))).astype(np.float32)
    k = k.reshape(4, ROWS, M)
    Dv = rng.normal(size=(4,)).astype(np.float32)
    ref_v, ref_g = jax.value_and_grad(
        lambda *a: jnp.sum(F.fftconv_outer_4d(*a, n1, r, m) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (u, k, Dv)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (u, k, Dv)]
    val = (TF.fftconv_outer_4d(*leaves, n1, r, m) ** 2).sum()
    grads = torch.autograd.grad(val, leaves)
    leaves64 = [torch.from_numpy(a).double().requires_grad_() for a in (u, k, Dv)]
    anchor = torch.autograd.grad(_conv_loss_f64(*leaves64), leaves64)
    np.testing.assert_allclose(val.item(), float(ref_v), rtol=1e-5)
    for name, g, want, g64 in zip(("du4", "dk4", "dD"), grads, ref_g, anchor):
        g, want, g64 = g.double().numpy(), np.asarray(want, np.float64), g64.numpy()
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), name
        assert np.abs(g - g64).max() <= 1e-6 * np.abs(g64).max(), name


def _operators(seed=0):
    """The JAX HyenaOperator (Pallas front in interpret mode) and the port's
    `front4=True` one, the JAX parameters carried by `utils/convert.py`
    (as tests/test_front4.py builds it: filter_order 16, emb_dim 5)."""
    op = JaxHyenaOperator(d_model=D, l_max=L, filter_order=16, filter_cfg=dict(emb_dim=5),
                          use_pallas_front=True, pallas_interpret=True)
    x = np.random.default_rng(seed).normal(size=(1, L, D)).astype(np.float32)
    params = op.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)  # nonzero biases, so they are tested
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    port = HyenaOperator(D, L, filter_order=16, filter_cfg=dict(emb_dim=5), front4=True)
    port.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return op, params, port, x


def _port_grads(port, x):
    xt = torch.from_numpy(x)
    y = port(xt)
    (y ** 2).sum().backward()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad()
    return y.detach(), grads


def _assert_grads_close(got: dict, want: dict, tol: float):
    for name, g in got.items():
        w = want[name].numpy() if hasattr(want[name], "numpy") else want[name]
        scale = np.abs(w).max() + 1e-9
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=tol, atol=tol,
                                   err_msg=name)


def test_hyena_operator_front4_matches_jax(outer_plan, monkeypatch):
    """`HyenaOperator(front4=True)` against the JAX operator under
    `HYENA_FRONT4=1` (its Pallas front, conv and VJPs in interpret mode):
    output at 2e-4, every parameter gradient at 5e-3 of its max (the
    tolerances of tests/test_front4.py's route parity)."""
    monkeypatch.setenv("HYENA_FRONT4", "1")
    op, params, port, x = _operators()
    calls = []
    inner = TF.FFTConvOuter4D.apply
    monkeypatch.setattr(TF.FFTConvOuter4D, "apply", lambda *a: calls.append(a[-3:]) or inner(*a))
    assert port.front4_plan(1, L) == (*PLAN, ROWS, TILE)
    y, grads = _port_grads(port, x)
    assert calls == [PLAN]  # the 4-D route ran
    ref = op.apply({"params": params}, jnp.asarray(x))
    g_ref = jax.grad(lambda p: jnp.sum(op.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
    _assert_grads_close(grads, flax_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, g_ref), buffers=False), 5e-3)


def test_hyena_operator_front4_matches_flat(outer_plan):
    """The port's 4-D route against its own flat route on the same weights:
    output at 2e-4, every gradient at 5e-3 of its max."""
    _, _, port, x = _operators(seed=1)
    y4, g4 = _port_grads(port, x)
    port.front4 = False
    y, g = _port_grads(port, x)
    np.testing.assert_allclose(y4.numpy(), y.numpy(), atol=2e-4, rtol=1e-3)
    _assert_grads_close(g4, g, 5e-3)


def test_front4_route_declines():
    """The route engages only where the JAX one does: no plan at fft 1024
    (as tests/test_front4.py::test_front4_route_requires_plan), none for an
    even batch below 2^19, none when L exceeds the filter's l_max, and not
    without `front4`."""
    assert HyenaOperator(D, 512, filter_order=16, front4=True).front4_plan(1, 512) is None
    op = HyenaOperator(D, 1 << 16, filter_order=16, front4=True)
    assert op.front4_plan(1, 1 << 16) == (4, 256, 128, 512, 512)  # fft 2^17, odd B
    assert op.front4_plan(2, 1 << 16) is None
    assert op.front4_plan(2, 1 << 18) is None  # past l_max
    big = HyenaOperator(D, 1 << 19, filter_order=16, front4=True)
    assert big.front4_plan(2, 1 << 19) == (16, 256, 256, 2048, 512)  # fft 2^20, any B
    assert HyenaOperator(D, 1 << 16, filter_order=16).front4_plan(1, 1 << 16) is None
    assert FB.plan_outer(1 << 21, 256, 1000448, 1) == (16, 512, 256)
    assert FB.plan_outer(1 << 16, 256, 32768, 1) is None


@pytest.mark.parametrize("length,rows,m,tile,what", [
    (1500, 16, 128, 512, "L % tile_l"),
    (1536, 16, 128, 192, "tile_l % m"),
    (1536, 14, 128, 512, r"\(rows_pad \* m\) % tile_l"),
    (2560, 16, 128, 512, "rows_pad \\* m >= L"),
    (1536, 64, 32, 512, "8 % \\(tile_l // m\\)"),
    (1536, 12, 256, 256, "rows_pad % 8"),
])
def test_front4_preconditions_raise(length, rows, m, tile, what):
    """Each tiling precondition of the Pallas kernels raises (the JAX
    wrapper left them unchecked)."""
    args = [torch.zeros(1, length, D), torch.zeros(D, 3 * D), torch.zeros(3 * D),
            torch.zeros(3, 3 * D), torch.zeros(3 * D)]
    with pytest.raises(ValueError, match=what):
        FF.fused_proj_conv_gate4(*args, rows, m, tile)
