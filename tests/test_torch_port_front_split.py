"""The precision scheme of the bf16 front-end kernels (A, A', A4, A4'), on the CPU.

On bf16 u the kernels run every product on the tensor cores with W and
dproj (float32) split into bf16 pairs hi + lo; `ops/fused_front.py`'s
`split_reference_fwd` / `split_reference_bwd` are that arithmetic in plain
PyTorch. Here it is held to the plain versions `reference_fwd` /
`reference_bwd` at the tolerances `chip_smoke.py` holds the kernels to (TOL:
vx, x0 and du at the bf16 one, dW, dbp, dwc and dbc at the float32 one), on
`chip_smoke.py::front_inputs`' scales. The bf16 outputs are compared before
their final rounding, which both sides share. The chosen products must pass
with margin; fewer products must not, which is why the kernels issue them.
"""

import math

import numpy as np
import pytest
import torch

from hyena_dna_tpu_torch.ops import fused_front as FF

# chip_smoke.py's TOL: |out - ref| <= frac * max|ref| + rel * |ref|
BF16_TOL = (2e-3, 2 ** -7)
F32_TOL = (1e-4, 1e-4)
SHAPES = [(2, 1024, 64), (1, 2048, 256)]  # (B, L, d): B * L up to a few thousand rows


def _inputs(B, L, d, seed):
    """bf16 u, dvx, dx0 and float32 parameters at chip_smoke.py's scales."""
    r = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
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
