"""The port's named conv entries and `add_ln_fused` against the JAX Pallas
entries of the same names, on the CPU.

Each JAX entry runs in interpret mode with float32 dot and store dtypes (the
structure check of the JAX tests, which kernels B and C, float32
throughout, can be held to); the port's entries, given CPU tensors, run the
plain versions of kernels B and C. The plan tables of both sides are
patched to small fft sizes where a test needs it, as the JAX tests patch
theirs. Tolerances are the JAX tests' of the same kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.pallas_fftconv as PF
import hyena_dna_tpu.ops.pallas_fftconv3 as P3
import hyena_dna_tpu.ops.pallas_fftconv_n3 as PO
import hyena_dna_tpu.ops.pallas_ln as pln
from hyena_dna_tpu.ops.fftconv import _nat_chain

from hyena_dna_tpu_torch.ops import add_ln as AL
from hyena_dna_tpu_torch.ops import fused_fftconv as FB


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _data(B, C, L, seed=0):
    """tests/test_fftconv3.py's inputs: a decaying filter."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, C, L)).astype(np.float32)
    k = (rng.normal(size=(C, L)) * np.exp(-np.arange(L) / max(16, L // 8))).astype(np.float32)
    D = rng.normal(size=(C,)).astype(np.float32)
    dy = rng.normal(size=(B, C, L)).astype(np.float32)
    return u, k, D, dy


@pytest.fixture
def f32_pallas(monkeypatch):
    for mod in (PF, PO, P3):
        monkeypatch.setattr(mod, "_STORE_DTYPE", jnp.float32)
        monkeypatch.setattr(mod, "_DOT_DTYPE", jnp.float32)
    monkeypatch.setattr(P3, "_TW1_DTYPE", jnp.float32)


# (a) the forward entries of rows 2-4; their conjugate-filter mode, which no
# JAX caller sets, is refused

@pytest.mark.parametrize("name,B", [("fftconv_fused_fwd_packed", 2),
                                    ("fftconv_fused_fwd", 1), ("fftconv_fused_fwd", 3)])
@pytest.mark.parametrize("conj", [False, True])
def test_fused_fwd_entries_match_pallas(name, B, conj, f32_pallas, monkeypatch):
    """The (r, m, cb) = (64, 64, 2) plan at fft 4096 patched into both
    tables (tests/test_fftconv.py's); packed takes even B, unpacked odd.
    With `conj_filter` the port refuses."""
    r, m, cb = 64, 64, 2
    monkeypatch.setitem(FB.CB_BY_N, r * m, cb)
    u, k, D, _ = _data(B, 4, (r // 2) * m, seed=23 + B)
    k *= 0.05
    if conj:
        with pytest.raises(NotImplementedError, match="conj_filter"):
            getattr(FB, name)(*map(_t, (u, k, D)), r, m, cb, conj_filter=True)
        return
    ref = getattr(PF, name)(*map(jnp.asarray, (u, k, D)), r, m, cb, interpret=True)
    y, spec = getattr(FB, name)(*map(_t, (u, k, D)), r, m, cb, save_spectrum=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)
    assert torch.equal(spec, FB.pair_spectrum_ref(_t(u), r * m))  # the port's layout


@pytest.mark.parametrize("plan,B,C", [((16, 32, 32), 3, 2), ((4, 64, 32), 1, 2)])
def test_outer_fwd_entry_matches_pallas(plan, B, C, f32_pallas, monkeypatch):
    """The flat outer entry at tests/test_fftconv_outer.py's small plans
    (odd B below 2^19, as its route took), at 2e-4."""
    n1, r, m = plan
    monkeypatch.setitem(FB.OUTER_BY_N, n1 * r * m, plan)
    u, k, D, _ = _data(B, C, (n1 // 2) * r * m, seed=n1)
    ref = PO.fftconv_outer_fwd(*map(jnp.asarray, (u, k, D)), n1, r, m, interpret=True)
    y = FB.fftconv_outer_fwd(*map(_t, (u, k, D)), n1, r, m)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("call,match", [
    (lambda u, k, D: FB.fftconv_fused_fwd_packed(u[:1], k, D, 256, 256, 8), "packed route"),
    (lambda u, k, D: FB.fftconv_fused_fwd(u, k, D, 256, 256, 8), "unpacked route"),
    (lambda u, k, D: FB.fftconv_outer_fwd(u[:1], k, D, 2, 128, 256), "outer route"),
    (lambda u, k, D: FB.fftconv_fused_fwd_packed(u, k, D, 96, 512, 8), "does not split"),
    (lambda u, k, D: FB.fftconv_fused_fwd_packed(u[..., :-1], k, D, 256, 256, 8), "padded"),
    (lambda u, k, D: FB.fftconv_fused_fwd_packed(u, k[:, :-1], D, 256, 256, 8), "k must be"),
    (lambda u, k, D: FB.fftconv_fused_fwd_packed(u, k, D, 256, 256, 3), "channel block"),
    (lambda u, k, D: FB.fftconv_fused_bwd_packed(u, u, k, D, 256, 256), "takes its plan"),
])
def test_entries_refuse_what_their_routes_did_not_take(call, match):
    """Plans that do not split 2 Lp, unpadded operands, channel blocks that
    do not divide C, and fft sizes or parities the TPU route did not take,
    all refused before anything runs (fft 2^16 here)."""
    u = torch.zeros(2, 8, 32768)
    with pytest.raises((ValueError, TypeError), match=match):
        call(u, torch.zeros(8, 32768), torch.zeros(8))


def test_fwd_route_mirrors_jax():
    """Which forward entry the JAX routing took, by fft size and batch."""
    assert FB.fwd_route(1 << 16, 4) == "packed"
    assert FB.fwd_route(1 << 16, 1) == "unpacked"
    assert FB.fwd_route(1 << 17, 2) == "packed"
    assert FB.fwd_route(1 << 17, 1) == "outer"
    assert FB.fwd_route(1 << 18, 2) == "unpacked"  # split backward, saved spectrum
    assert FB.fwd_route(1 << 18, 1) == "outer"
    assert FB.fwd_route(1 << 19, 2) == "outer"
    assert FB.fwd_route(1 << 15, 2) is None


# (b) the narrow entries (rows 11-12)

def test_narrow_entries_match_pallas(f32_pallas, monkeypatch):
    """fft 8192 with a narrow cb patched in on both sides, as
    tests/test_fftconv.py:627 does: the port's `plan` gives the JAX plan;
    forward at 2e-3, gradients at 5e-2 (its tolerances)."""
    monkeypatch.setitem(PF._CB_BY_N_NARROW, 8192, 2)
    monkeypatch.setitem(FB.CB_BY_N_NARROW, 8192, 2)
    u, k, D, dy = _data(3, 4, 4096, seed=53)
    k *= 0.05
    plan = FB.plan(8192, 4, 4096, FB.nat_chain(8192))
    assert plan == PF.plan(8192, 4, 4096, _nat_chain(8192)) == (128, 64, 2)
    assert FB.nat_chain(1 << 20) == _nat_chain(1 << 20)
    args = tuple(map(jnp.asarray, (u, k, D)))
    ref = PF.fftconv_fused_fwd_narrow(*args, *plan, interpret=True)
    y = FB.fftconv_fused_fwd_narrow(*map(_t, (u, k, D)), *plan)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=2e-3, rtol=1e-3)
    ref_g = PF.fftconv_fused_bwd_narrow(args[0], jnp.asarray(dy), *args[1:], *plan,
                                        interpret=True)
    got = FB.fftconv_fused_bwd_narrow(_t(u), _t(dy), _t(k), _t(D), *plan)
    for name, g, want in zip(("du", "dk", "dD"), got, ref_g):
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=5e-2, rtol=5e-3,
                                   err_msg=name)


def test_narrow_bwd_returns_a_float32_dk_for_bf16_operands():
    """The JAX narrow and 3-factor backward return dk in float32 whatever
    the operands' dtype: the port's do too, unrounded."""
    u, k, D, dy = (_t(a) for a in _data(1, 2, 64, seed=1))
    bf = [t.to(torch.bfloat16) for t in (u, dy, k)]
    du, dk, dD = FB.fftconv_fused_bwd_narrow(bf[0], bf[1], bf[2], D, 8, 16, 1)
    assert du.dtype == torch.bfloat16 and dk.dtype == dD.dtype == torch.float32
    want = FB.fftconv_bwd_ref(bf[0], bf[1], bf[2], D, dk_dtype=torch.float32)[1]
    assert torch.equal(dk, want)
    du3, dk3, _ = FB.fftconv3_bwd(bf[0], bf[1], bf[2], D, 4, 4, 8, 1)
    assert dk3.dtype == torch.float32 and torch.equal(du3, du)


# (c) the 3-factor entries (rows 19-20)

@pytest.mark.parametrize("factors,cb,B", [
    ((8, 4, 4), 2, 3),
    ((8, 4, 4), 1, 2),
    ((16, 8, 4), 4, 1),
    ((4, 4, 8), 2, 2),
])
@pytest.mark.parametrize("conj", [False, True])
def test_fftconv3_fwd_matches_pallas(factors, cb, B, conj, f32_pallas):
    """tests/test_fftconv3.py's factor sets at 1e-4; the conjugate mode is
    refused."""
    f1, f2, f3 = factors
    lp = (f1 // 2) * f2 * f3
    u, k, D, _ = _data(B, 4 if cb <= 2 else 8, lp)
    if conj:
        with pytest.raises(NotImplementedError, match="conj_filter"):
            FB.fftconv3_fwd(*map(_t, (u, k, D)), f1, f2, f3, cb, conj_filter=True)
        return
    ref = P3.fftconv3_fwd(*map(jnp.asarray, (u, k, D)), f1, f2, f3, cb, interpret=True)
    y = FB.fftconv3_fwd(*map(_t, (u, k, D)), f1, f2, f3, cb)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factors,cb,B", [((8, 4, 4), 2, 3), ((16, 8, 4), 4, 1)])
def test_fftconv3_bwd_matches_pallas(factors, cb, B, f32_pallas):
    """du at 1e-4, dk at 2e-4 absolute (tests/test_fftconv3.py's), dD at 1e-4."""
    f1, f2, f3 = factors
    lp = (f1 // 2) * f2 * f3
    u, k, D, dy = _data(B, 4 if cb <= 2 else 8, lp, seed=1)
    ref = P3.fftconv3_bwd(*map(jnp.asarray, (u, dy, k, D)), f1, f2, f3, cb, interpret=True)
    got = FB.fftconv3_bwd(*map(_t, (u, dy, k, D)), f1, f2, f3, cb)
    for name, g, want, atol in zip(("du", "dk", "dD"), got, ref, (1e-4, 2e-4, 1e-4)):
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4, atol=atol,
                                   err_msg=name)


def test_plan3_matches_jax():
    for n in (1 << 19, 1 << 20, 1 << 21, 1 << 18):
        for c, seqlen in ((256, n // 2), (3, n // 2), (256, n // 2 + 1)):
            assert FB.plan3(n, c, seqlen) == P3.plan3(n, c, seqlen), (n, c, seqlen)


# (d) the dk spectrum (row 8)

def _natural(re, im, r, m):
    """The TPU's permuted (r, C, m) pair in natural frequency order, (C, n):
    frequency p + r q sits at [p, c, q]."""
    z = np.asarray(re) + 1j * np.asarray(im)
    return z.transpose(1, 2, 0).reshape(z.shape[1], r * m)


@pytest.mark.parametrize("B", [1, 3])
def test_dk_spec_matches_pallas_in_natural_order(B, f32_pallas):
    """The batch sum of DY conj(U) at fft 4096, both sides in natural
    order, at 1e-4 of its max."""
    r, m, cb = 64, 64, 2
    u, _, _, dy = _data(B, 4, (r // 2) * m, seed=9)
    ref = _natural(*PF.fftconv_fused_dk_spec(jnp.asarray(u), jnp.asarray(dy), r, m, cb,
                                              interpret=True), r, m)
    re, im = FB.fftconv_fused_dk_spec(_t(u), _t(dy), r, m, cb)
    assert re.shape == im.shape == (4, r * m) and re.dtype == torch.float32
    got = re.numpy() + 1j * im.numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("C", [4, 5])
def test_dk_spec_pair_split(C):
    """The wrapper's split of kernel C's output: channel-pair spectra in the
    four-step layout (row f1, natural f2), as the kernel's dk-spectrum mode
    stores them, split back into the per-channel sums in natural order."""
    n = 256
    q = torch.fft.fft(torch.randn(C, n, generator=torch.Generator().manual_seed(C)))
    if C % 2:
        q = torch.cat([q, torch.zeros(1, n, dtype=q.dtype)])
    w = q[0::2] + 1j * q[1::2]  # the pair spectra of two real signals
    n1, n2 = FB._four_step(n)
    stored = w.reshape(-1, n2, n1).transpose(-1, -2).reshape(-1, n)
    got = FB._split_pairs(torch.view_as_real(stored)[None], C, n)[0]
    assert torch.allclose(got, q[:C], atol=1e-5)


# (e) add_ln_fused (rows 24-25)

def test_add_ln_fused_matches_pallas():
    """`add_ln_fused` against the JAX entry in interpret mode on bf16 rows:
    res_out the same bits, y at 2e-2, the gradients at
    tests/test_pallas_ln.py's tolerances."""
    rng = np.random.default_rng(0)
    n, d = 512, 256
    hj, rj = (jnp.asarray(rng.normal(size=(n, d)) * s, jnp.bfloat16) for s in (1.0, 3.0))
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    cw = rng.normal(size=(n, d)).astype(np.float32)

    def jax_loss(h, r, s, b):
        y, ro = pln.add_ln_fused(h, r, s, b, 1e-5, jnp.bfloat16, True)
        return jnp.sum(y.astype(jnp.float32) * cw) + jnp.sum(ro.astype(jnp.float32) ** 2) * 1e-2

    y_ref, ro_ref = pln.add_ln_fused(hj, rj, jnp.asarray(scale), jnp.asarray(bias), 1e-5,
                                     jnp.bfloat16, True)
    g_ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(hj, rj, jnp.asarray(scale),
                                                     jnp.asarray(bias))
    to_t = lambda j: torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)
    leaves = [to_t(hj).requires_grad_(), to_t(rj).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    y, ro = AL.add_ln_fused(*leaves, 1e-5, torch.bfloat16)
    assert y.dtype == ro.dtype == torch.bfloat16
    np.testing.assert_array_equal(ro.detach().float().numpy(), np.asarray(ro_ref, np.float32))
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(y_ref, np.float32), rtol=0,
                               atol=2e-2)
    ((y.float() * torch.from_numpy(cw)).sum() + (ro.float() ** 2).sum() * 1e-2).backward()
    for t, want, tol in zip(leaves, g_ref, (6e-2, 6e-2, 2e-1, 2e-1)):
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=tol)


def test_add_ln_fused_refuses_what_kernel_d_does_not_take():
    h = torch.zeros(8, 64, dtype=torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="2-D"):
        AL.add_ln_fused(h[None], h[None], w, b, 1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        AL.add_ln_fused(h.float(), h, w, b, 1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        AL.add_ln_fused(h, h, w, b, 1e-5, torch.float32)
