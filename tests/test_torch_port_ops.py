"""Port ops against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart. Where the JAX function is a Pallas kernel it runs in interpret
mode, as the JAX package's own tests run it; the port's wrappers, given CPU
tensors, run their kernels' plain versions. Tolerances are those of the JAX
tests of the same kernels.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.fftconv  # noqa: F401  (module registration)
import hyena_dna_tpu.ops.pallas_fftconv as PF
import hyena_dna_tpu.ops.pallas_fftconv_n3 as PO
from hyena_dna_tpu.ops.layer_norm import LayerNormF32 as JaxLayerNorm
from hyena_dna_tpu.ops.pallas_hyena import _reference_fwd, fused_proj_conv_gate
from hyena_dna_tpu.ops.short_conv import short_conv_1d as jax_short_conv

from hyena_dna_tpu_torch.ops import fftconv as TF
from hyena_dna_tpu_torch.ops.fused_fftconv import _channel_spectra, fftconv_fused
from hyena_dna_tpu_torch.ops.fused_front import fused_proj_conv_gate as port_front
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d

JF = sys.modules["hyena_dna_tpu.ops.fftconv"]


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _front_inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * 0.1).astype(np.float32)
    bp = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    wc = rng.normal(size=(3, 3 * D)).astype(np.float32)
    bc = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    return u, w, bp, wc, bc


def test_short_conv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 40)).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    ref = np.asarray(jax_short_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    ours = short_conv_1d(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_matches_jax(with_residual):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    res = rng.normal(size=(2, 16, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ln = LayerNormF32(32)
    ln.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    if with_residual:
        ref_y, ref_r = JaxLayerNorm().apply(params, jnp.asarray(x), jnp.asarray(res))
        y, r = ln(_t(x), _t(res))
        np.testing.assert_allclose(r.detach().numpy(), np.asarray(ref_r), rtol=1e-6, atol=1e-6)
    else:
        ref_y = JaxLayerNorm().apply(params, jnp.asarray(x))
        y = ln(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,tile", [(128, 32), (96, 32), (64, 64)])
def test_fused_front_matches_pallas_interpret(L, tile):
    """Several length tiles, so the conv crosses tile boundaries."""
    args = _front_inputs(2, L, 16, seed=L)
    vx_ref, x0_ref = fused_proj_conv_gate(*map(jnp.asarray, args), tile, True)
    vx, x0 = port_front(*map(_t, args))
    assert vx.shape == x0.shape == (2, 16, L)
    np.testing.assert_allclose(vx.numpy(), np.asarray(vx_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("L", [77, 1])
def test_fused_front_ragged_length_matches_reference(L):
    """Kernel A takes any L; the Pallas kernel needs L % 32 == 0, so a
    ragged L is held against the JAX `_reference_fwd`."""
    args = _front_inputs(3, L, 8, seed=5)
    vx_ref, x0_ref = _reference_fwd(*map(jnp.asarray, args))
    vx, x0 = port_front(*map(_t, args))
    np.testing.assert_allclose(vx.numpy(), np.asarray(vx_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_ref), atol=1e-5, rtol=1e-5)


def _conv_data(B, C, L, seed=0, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = Lk or L
    u = rng.normal(size=(B, C, L)).astype(np.float32)
    k = (rng.normal(size=(C, Lk)) * np.exp(-np.arange(Lk) / max(16, Lk // 8))
         ).astype(np.float32)
    D = rng.normal(size=(C,)).astype(np.float32)
    return u, k, D


@pytest.fixture
def f32_pallas(monkeypatch):
    """Pallas conv kernels with f32 dots and spectra: the structure check of
    the JAX tests, which kernel B (f32 throughout) can be held to."""
    for mod in (PO, PF):
        monkeypatch.setattr(mod, "_STORE_DTYPE", jnp.float32)
        monkeypatch.setattr(mod, "_DOT_DTYPE", jnp.float32)


@pytest.mark.parametrize("plan,B,C", [
    ((16, 32, 32), 2, 3),
    ((8, 32, 64), 1, 2),
    ((16, 16, 128), 2, 1),
    ((4, 64, 32), 3, 2),
])
def test_conv_matches_pallas_outer(plan, B, C, f32_pallas):
    n1, r, m = plan
    u, k, D = _conv_data(B, C, n1 * r * m // 2)
    ref = PO.fftconv_outer_fwd(*map(jnp.asarray, (u, k, D)), n1, r, m, interpret=True)
    ours = fftconv_fused(*map(_t, (u, k, D)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("packed,B", [(True, 2), (False, 1), (False, 3)])
def test_conv_matches_pallas_fused(packed, B, f32_pallas):
    """The (r, m, cb) = (64, 64, 2) plan at fft 4096; packed needs even B."""
    r, m, cb = 64, 64, 2
    u, k, D = _conv_data(B, 4, (r // 2) * m, seed=23)
    k *= 0.05
    fwd = PF.fftconv_fused_fwd_packed if packed else PF.fftconv_fused_fwd
    y = fwd(*map(jnp.asarray, (u, k, D)), r, m, cb, interpret=True, save_spectrum=True)[0]
    ours = fftconv_fused(*map(_t, (u, k, D)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(y), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("B,dtype", [(1, "float32"), (2, "float32"),
                                     (3, "bfloat16"), (2, "bfloat16")])
def test_conv_matches_jax_fftconv_ref(B, dtype):
    """Odd and even B, f32 and bf16 I/O (bf16: both sides round the same
    f32 result once, so the tolerance is one bf16 step of the output)."""
    u, k, D = _conv_data(B, 5, 300, seed=B)
    jdt = getattr(jnp, dtype)
    ref = JF.fftconv_ref(jnp.asarray(u, jdt), jnp.asarray(k, jdt), jnp.asarray(D))
    tdt = getattr(torch, dtype)
    ours = TF.fftconv(_t(u).to(tdt), _t(k).to(tdt), _t(D))
    assert ours.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_conv_shorter_filter_matches_jax():
    """k shorter than u (a sequence past the filter's l_max)."""
    u, k, D = _conv_data(2, 3, 200, seed=9, Lk=120)
    ref = JF.fftconv_ref(*map(jnp.asarray, (u, k, D)))
    ours = TF.fftconv(*map(_t, (u, k, D)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_gated_conv_matches_jax():
    u, k, D = _conv_data(2, 4, 256, seed=3)
    x0 = np.random.default_rng(4).normal(size=u.shape).astype(np.float32)
    ref = JF.fftconv_gated(*map(jnp.asarray, (u, x0, k, D)))
    ours = TF.fftconv_gated(*map(_t, (u, x0, k, D)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [10, 16, 17, 2049, 1 << 20])
def test_next_fast_fft_size_matches_jax(n):
    assert TF.next_fast_fft_size(n) == JF.next_fast_fft_size(n)


# The training path's pieces that need no kernel: autograd passes through
# them, and their gradients match the JAX package's.

@pytest.mark.parametrize("with_residual", [False, True])
def test_layer_norm_grads_match_jax(with_residual):
    """LayerNormF32 alone and in its (y, res_out) add+LN form: gradients of
    x, the residual, scale and bias against jax.vjp of the JAX module."""
    rng = np.random.default_rng(2)
    x, res, dy, dres = (rng.normal(size=(2, 16, 32)).astype(np.float32) for _ in range(4))
    scale, bias = (rng.normal(size=(32,)).astype(np.float32) for _ in range(2))

    def jax_fn(x, res, scale, bias):
        params = {"params": {"scale": scale, "bias": bias}}
        return JaxLayerNorm().apply(params, x, res if with_residual else None)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, res, scale, bias)))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dres)) if with_residual else jnp.asarray(dy))
    ln = LayerNormF32(32)
    ln.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    xt, rt = _t(x).requires_grad_(), _t(res).requires_grad_()
    if with_residual:
        torch.autograd.backward(ln(xt, rt), (_t(dy), _t(dres)))
    else:
        ln(xt).backward(_t(dy))
    ours = [xt.grad, rt.grad, ln.weight.grad, ln.bias.grad]
    for a, b, name in zip(ours, ref, ("dx", "dres", "dscale", "dbias")):
        if not with_residual and name == "dres":
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


def test_short_conv_grads_match_jax():
    rng = np.random.default_rng(3)
    x, dy = (rng.normal(size=(2, 6, 40)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _, vjp = jax.vjp(jax_short_conv, *map(jnp.asarray, (x, w, b)))
    ref = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_() for a in (x, w, b)]
    short_conv_1d(*args).backward(_t(dy))
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,C,L", [(2, 3, 100), (1, 4, 2048)])
def test_saved_spectrum_plain_version(B, C, L):
    """Kernel B's saved spectrum (plain version): the forward returns the
    conv unchanged, and the spectrum splits back into each channel's rfft."""
    u, k, D = _conv_data(B, C, L, seed=L)
    y, spec = fftconv_fused(*map(_t, (u, k, D)), save_spectrum=True)
    n = TF.next_fast_fft_size(2 * L)
    assert spec.shape == (B, (C + 1) // 2, n, 2) and spec.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), TF.fftconv_ref(*map(_t, (u, k, D))).numpy(),
                               rtol=1e-6, atol=1e-6)
    split = _channel_spectra(spec, C, n)
    ref = np.fft.rfft(u.astype(np.float64), n=n)
    np.testing.assert_allclose(split.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
