"""The precision scheme of the front-end kernels (A, A', A4, A4'), on the CPU.

The kernels run every product on the tensor cores with W, dproj and float32
u split into bf16 pairs hi + lo (bf16 u enters whole); `ops/fused_front.py`'s
`split_reference_fwd` / `split_reference_bwd` are that arithmetic in plain
PyTorch. Here it is held to the plain versions `reference_fwd` /
`reference_bwd` at the tolerances `chip_smoke.py` holds the kernels to (TOL:
bf16 u: vx, x0 and du at the bf16 one, dW, dbp, dwc and dbc at the float32
one; float32 u: every output at the float32 one), on
`chip_smoke.py::front_inputs`' scales. The bf16 outputs are compared before
their final rounding, which both sides share. The chosen products must pass
with margin; fewer products must not, which is why the kernels issue them.
The float32 scheme is also held to the JAX Pallas kernel in interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.ops.pallas_hyena import fused_proj_conv_gate as jax_front

from hyena_dna_tpu_torch.ops import fused_front as FF

# chip_smoke.py's TOL: |out - ref| <= frac * max|ref| + rel * |ref|
BF16_TOL = (2e-3, 2 ** -7)
F32_TOL = (1e-4, 1e-4)
SHAPES = [(2, 1024, 64), (1, 2048, 256)]  # (B, L, d): B * L up to a few thousand rows


def _inputs(B, L, d, seed, dtype=torch.bfloat16):
    """u, dvx, dx0 in `dtype` and float32 parameters at chip_smoke.py's
    scales."""
    r = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(dtype)
    f = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    u = bf(B, L, d)
    w = f(r.standard_normal((d, 3 * d)) * 0.02)
    bp = f(r.standard_normal(3 * d) * 0.02)
    wc = f((r.random((3, 3 * d)) * 2 - 1) / math.sqrt(3))
    bc = f((r.random(3 * d) * 2 - 1) / math.sqrt(3))
    return u, w, bp, wc, bc, bf(B, d, L), bf(B, d, L)


def _share(out, ref, tol):
    """max over elements of |out - ref| / its tolerance (1.0: at the limit)."""
    frac, rel = tol
    ref = ref.double()
    return ((out.double() - ref).abs() / (frac * ref.abs().max() + rel * ref.abs())).max().item()


def _plain(u, w, bp, wc, bc, dvx, dx0):
    """The plain versions on the same values in float32: no final rounding."""
    f = lambda t: t.float()
    return (FF.reference_fwd(f(u), w, bp, wc, bc),
            FF.reference_bwd(f(u), w, bp, wc, bc, f(dvx), f(dx0)))


def test_split_bf16_pair_is_within_2_to_the_minus_17():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000).astype(np.float32))
    x = x * torch.exp2(torch.linspace(-20, 20, x.numel()))
    hi, lo = FF.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -17 * x.double().abs()).all())


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_forward_pair_products_pass_with_margin(B, L, d):
    """proj = u W_hi + u W_lo: vx and x0 within a tenth of the bf16 budget."""
    args = _inputs(B, L, d, d)
    (vx_ref, x0_ref), _ = _plain(*args)
    vx, x0 = FF.split_reference_fwd(*args[:5])
    assert _share(vx, vx_ref, BF16_TOL) < 0.1
    assert _share(x0, x0_ref, BF16_TOL) < 0.1


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_backward_pair_products_pass_with_margin(B, L, d):
    """du from three pair products within a tenth of the bf16 budget; dW from
    two, and dbp, dwc, dbc, within half the float32 budget."""
    args = _inputs(B, L, d, d + 1)
    _, ref = _plain(*args)
    out = FF.split_reference_bwd(*args)
    assert _share(out[0], ref[0], BF16_TOL) < 0.1
    for got, want in zip(out[1:], ref[1:]):
        assert got.shape == want.shape
        assert _share(got, want, F32_TOL) < 0.5


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_two_products_for_du_leave_no_margin(B, L, d):
    """du = dproj_hi W_hi^T + dproj_lo W_hi^T (W rounded once) comes within
    a factor of two of the bf16 budget: the third product is the margin."""
    args = _inputs(B, L, d, d + 1)
    _, ref = _plain(*args)
    du = FF.split_reference_bwd(*args, du_terms="hh lh")[0]
    assert _share(du, ref[0], BF16_TOL) > 0.5


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_single_rounding_of_w_fails_the_dw_tolerance(B, L, d):
    """proj = u bf16(W): dW (through dconv) misses the float32 tolerance."""
    args = _inputs(B, L, d, d + 2)
    _, ref = _plain(*args)
    out = FF.split_reference_bwd(*args, proj_terms="hh")
    assert _share(out[1], ref[1], F32_TOL) > 1.0


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_single_rounding_of_dproj_fails_the_dw_tolerance(B, L, d):
    """dW = u^T bf16(dproj) misses the float32 tolerance by an order of
    magnitude."""
    args = _inputs(B, L, d, d + 3)
    _, ref = _plain(*args)
    out = FF.split_reference_bwd(*args, dw_terms="hh")
    assert _share(out[1], ref[1], F32_TOL) > 5.0


# float32 u: u enters as a pair too; every output is held to the float32
# tolerance, du included
F32_PRODUCTS = [("proj_terms", FF.PROJ_TERMS[torch.float32]), ("du_terms", FF.DU_TERMS),
                ("dw_terms", FF.DW_TERMS[torch.float32])]


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_float32_pair_products_pass_with_margin(B, L, d):
    """proj = u_hi W_hi + u_hi W_lo + u_lo W_hi, du from three pair
    products, dW = u_hi^T dproj_hi + u_hi^T dproj_lo + u_lo^T dproj_hi: vx,
    x0, du, dW, dbp, dwc and dbc within half the float32 budget."""
    args = _inputs(B, L, d, d + 4, torch.float32)
    ref_fwd, ref_bwd = _plain(*args)
    for got, want in zip(FF.split_reference_fwd(*args[:5]), ref_fwd):
        assert _share(got, want, F32_TOL) < 0.5
    for got, want in zip(FF.split_reference_bwd(*args), ref_bwd):
        assert got.shape == want.shape
        assert _share(got, want, F32_TOL) < 0.5


@pytest.mark.parametrize("B,L,d", SHAPES)
def test_float32_forward_without_u_lo_fails(B, L, d):
    """proj = u_hi W_hi + u_hi W_lo (u rounded once): vx and x0 miss the
    float32 tolerance."""
    args = _inputs(B, L, d, d + 5, torch.float32)
    ref, _ = _plain(*args)
    out = FF.split_reference_fwd(*args[:5], proj_terms="hh hl")
    assert max(_share(got, want, F32_TOL) for got, want in zip(out, ref)) > 1.0


@pytest.mark.parametrize("which,drop", [(k, t) for k, terms in F32_PRODUCTS
                                        for t in terms.split()])
@pytest.mark.parametrize("B,L,d", SHAPES)
def test_float32_each_product_is_needed(B, L, d, which, drop):
    """Any one of the nine pair products left out (u_lo from the projection
    or from dW among them) puts some output of A' past the float32
    tolerance: the kernels issue all nine and no fourth of a kind (ll)."""
    args = _inputs(B, L, d, d + 6, torch.float32)
    _, ref = _plain(*args)
    terms = " ".join(t for t in dict(F32_PRODUCTS)[which].split() if t != drop)
    out = FF.split_reference_bwd(*args, **{which: terms})
    assert max(_share(got, want, F32_TOL) for got, want in zip(out, ref)) > 1.0


def test_float32_scheme_matches_pallas_interpret():
    """The float32 pair scheme against the JAX `fused_proj_conv_gate` (the
    Pallas kernel in interpret mode, several length tiles) at 2e-4."""
    B, L, d, tile = 2, 128, 32, 32
    u, w, bp, wc, bc = _inputs(B, L, d, 9, torch.float32)[:5]
    vx_ref, x0_ref = jax_front(*(jnp.asarray(t.numpy()) for t in (u, w, bp, wc, bc)), tile,
                               True)
    vx, x0 = FF.split_reference_fwd(u, w, bp, wc, bc)
    np.testing.assert_allclose(vx.numpy(), np.asarray(vx_ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_ref), atol=2e-4, rtol=2e-4)
