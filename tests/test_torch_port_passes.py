"""`utils/profile_passes.py` without a card: the roles it gives each launch
of one call of kernel B, C, E or E' (their order, and the bytes each role
moves, here summed from the shapes written out), the launch kinds it reads
off the kernels' names, and its argument parser. The script measures only
on the card; what it counts is checked here."""

import subprocess
import sys

import pytest

from hyena_dna_tpu_torch.utils import profile_passes as P

B, C, L, N, SIZE = 2, 6, 1024, 2048, 2  # bf16 I/O, fft 2 L
SLAB = 3 * N * 8          # one complex64 scratch of n per channel pair (3 pairs)
SIG = B * C * L * SIZE    # one (B, C, L) signal
FILT = C * L * SIZE       # the filter, as long as u
FWD, ROWS, INV = P.FWD, P.ROWS, P.INV

K_CHAIN = [("k columns", FWD), ("k rows (in place)", ROWS)]
GRAD = [("rows", ROWS), ("du columns", INV), ("dk columns", INV)]
# (kernel, route): the roles in launch order, and their bytes summed
EXPECTED = {
    ("B", "forward"): (K_CHAIN + [("u columns", FWD), ("rows", ROWS), ("y columns", INV)],
                       FILT + SLAB + 2 * SLAB + SIG + B * SLAB + 3 * B * SLAB
                       + B * SLAB + 2 * SIG),
    ("C", "retransform"): (K_CHAIN + [("dy columns", FWD), ("u columns", FWD)] + GRAD,
                           FILT + 3 * SLAB + 2 * (SIG + B * SLAB) + 4 * B * SLAB + SLAB
                           + B * SLAB + SIG + SLAB + FILT),
    ("C", "spectrum"): (K_CHAIN + [("dy columns", FWD)] + GRAD,
                        FILT + 3 * SLAB + SIG + B * SLAB + 4 * B * SLAB + SLAB
                        + B * SLAB + SIG + SLAB + FILT),
    ("E", "y"): (K_CHAIN + [("u columns", FWD), ("rows", ROWS), ("y columns", INV)],
                 FILT + 3 * SLAB + SIG + B * SLAB + 3 * B * SLAB + B * SLAB + 2 * SIG),
    ("E", "spec"): (K_CHAIN + [("u columns", FWD), ("rows (+ u's spectrum)", ROWS),
                               ("y columns", INV)],
                    FILT + 3 * SLAB + SIG + B * SLAB + 4 * B * SLAB + B * SLAB + 2 * SIG),
    ("E", "specv"): (K_CHAIN + [("u columns", FWD), ("rows (+ u's spectrum)", ROWS),
                                ("y columns", INV)],
                     FILT + 3 * SLAB + SIG + B * SLAB + 4 * B * SLAB + B * SLAB + 3 * SIG),
    ("E'", "specv"): (K_CHAIN + [("dv columns (+ dx0)", FWD)] + GRAD,
                      FILT + 3 * SLAB + 4 * SIG + B * SLAB + 4 * B * SLAB + SLAB
                      + B * SLAB + SIG + SLAB + FILT),
    ("E'", "spec"): (K_CHAIN + [("v rows", ROWS), ("dx0 columns", INV), ("dv columns", FWD)]
                     + GRAD,
                     FILT + 3 * SLAB + 3 * B * SLAB + B * SLAB + 2 * SIG + 2 * SIG + B * SLAB
                     + 4 * B * SLAB + SLAB + B * SLAB + SIG + SLAB + FILT),
    ("E'", "retransform"): (K_CHAIN + [("u columns", FWD), ("v rows", ROWS),
                                       ("dx0 columns", INV), ("dv columns", FWD)] + GRAD,
                            FILT + 3 * SLAB + SIG + B * SLAB + 4 * B * SLAB + B * SLAB
                            + 2 * SIG + 2 * SIG + B * SLAB + 4 * B * SLAB + SLAB + B * SLAB
                            + SIG + SLAB + FILT),
}


@pytest.mark.parametrize("kernel,route", sorted(EXPECTED))
def test_pass_bytes_roles_and_total(kernel, route):
    roles = P.pass_bytes(kernel, route, B, C, L, N, SIZE)
    want_roles, want_total = EXPECTED[(kernel, route)]
    assert [(role, kind) for role, kind, _ in roles] == want_roles
    assert sum(nbytes for _, _, nbytes in roles) == want_total
    assert all(nbytes > 0 for _, _, nbytes in roles)


def test_every_route_has_roles():
    assert {(k, r) for k, routes in P.ROUTES.items() for r in routes} == set(EXPECTED)


@pytest.mark.parametrize("name,kind", [
    ("void conv_bwd::cols_in_kernel<__nv_bfloat16, 16>(__nv_bfloat16 const*, int)", FWD),
    ("void conv_gbwd::cols_in_dv_kernel<float, 8>(float const*)", FWD),
    ("void conv_gfwd::cols_in_delta_kernel<__nv_bfloat16, 16>(__nv_bfloat16 const*)", FWD),
    ("void conv_fwd::cols_fwd_kernel<float, 0>(float const*, int, int)", FWD),
    ("void conv_bwd::rows_grad_cluster_kernel<16, true>(float2*)", ROWS),
    ("void conv_gbwd::rows_grad_kernel<8, false>(float2*)", ROWS),
    ("void conv_gfwd::rows_conv_kernel<16>(float2 const*, int)", ROWS),
    ("void conv_gbwd::rows_fwd_kernel<16>(float2*, conv_gbwd::Plan)", ROWS),
    ("void conv_gbwd::cols_inv_dx0_kernel<float, 16>(float2 const*)", INV),
    ("void conv_gfwd::cols_inv_gate_kernel<__nv_bfloat16, 16>(float2 const*)", INV),
])
def test_launch_kind_from_name(name, kind):
    assert P.launch_kind(name) == kind


def test_launch_kind_refuses_other_kernels():
    with pytest.raises(ValueError):
        P.launch_kind("void at::native::vectorized_elementwise_kernel<4>()")


@pytest.mark.parametrize("spec,want", [
    ("C:4x32768:bf16:spectrum", ("C", 4, 32768, "bfloat16", "spectrum")),
    ("C:1x1000448:bf16", ("C", 1, 1000448, "bfloat16", "retransform")),
    ("B:1x450048:f32", ("B", 1, 450048, "float32", "forward")),
    ("E:4x32768:bf16", ("E", 4, 32768, "bfloat16", "y")),
    ("E'", None), ("E:4x32768:bf16:retransform", None), ("F:4x32768:bf16", None),
    ("E':2x65536:bf16", ("E'", 2, 65536, "bfloat16", "specv")),
])
def test_parse(spec, want):
    if want is None:
        with pytest.raises(ValueError):
            P.parse(spec)
    else:
        assert P.parse(spec) == want


def test_import_touches_no_card():
    """Importing the script initialises no CUDA (the tests import every
    module of the port on hosts without a card)."""
    code = ("import torch; from hyena_dna_tpu_torch.utils import profile_passes; "
            "assert not torch.cuda.is_initialized()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
