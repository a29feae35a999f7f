"""The port's copies of the JAX package's helper modules, each against its
JAX function on the same numpy inputs: `ops/legacy.py` (Toeplitz, Krylov,
powers, Vandermonde) at tests/test_legacy_ops.py's tolerances,
`utils/permutations.py` exactly, `ops/fftconv.py::fftconv_h3` at 1e-5,
and `utils/profiling.py` (its operation count equal to the JAX one; the
timers on the host, the card's refusals without a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.ops import legacy as JL
from hyena_dna_tpu.ops.fftconv import fftconv_h3 as jax_fftconv_h3
from hyena_dna_tpu.utils import permutations as JP
from hyena_dna_tpu.utils.profiling import flops_estimate as jax_flops_estimate
from hyena_dna_tpu_torch.ops import legacy as TL
from hyena_dna_tpu_torch.ops.fftconv import fftconv_h3
from hyena_dna_tpu_torch.utils import permutations as TP
from hyena_dna_tpu_torch.utils import profiling

RNG = np.random.default_rng(0)
F32 = lambda *shape: RNG.normal(size=shape).astype(np.float32)
CPLX = lambda n: (RNG.normal(size=n) + 1j * RNG.normal(size=n)).astype(np.complex64)


def _both(name, *args, **kw):
    """(port, JAX) results of the helper `name` on the same numpy inputs."""
    ours = getattr(TL, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in args], **kw)
    ref = getattr(JL, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                              for a in args], **kw)
    return np.asarray(ours), np.asarray(ref)


A4, B4, C4 = F32(4, 4) * 0.5, F32(4), F32(4)
U16, V16 = F32(3, 16), F32(3, 16)
X = (-0.1 + 1j * RNG.normal(size=4)).astype(np.complex64)
CASES = {
    "construct_toeplitz": (("construct_toeplitz", F32(2, 5)), {}, 0.0),
    "construct_toeplitz_f": (("construct_toeplitz", F32(5), 0.5), {}, 0.0),
    "toeplitz_multiply": (("triangular_toeplitz_multiply", U16, V16), {}, 1e-4),
    "toeplitz_multiply_padded": (("triangular_toeplitz_multiply_padded", F32(3, 16),
                                  F32(3, 16)), {}, 1e-4),
    "causal_convolution_matrix": (("causal_convolution", U16, V16), {"fast": False}, 1e-4),
    "causal_convolution_fft": (("causal_convolution", U16, V16), {}, 1e-4),
    "krylov": (("krylov", 8, A4, B4), {}, 1e-4),
    "krylov_c": (("krylov", 8, A4, B4, C4), {}, 1e-4),
    "krylov_batched": (("krylov", 5, F32(2, 3, 3) * 0.5, F32(2, 3)), {}, 1e-4),
    "krylov_sequential": (("krylov_sequential", 8, A4, B4), {}, 1e-4),
    "krylov_sequential_c": (("krylov_sequential", 8, A4, B4, C4), {}, 1e-4),
    "power": (("power", 13, F32(3, 3) * 0.7), {}, 1e-3),
    "power_v": (("power", 6, F32(3, 3) * 0.5, F32(3)), {}, 1e-4),
    "vandermonde_naive": (("vandermonde_naive", CPLX(4), X, 8), {"conj": False}, 1e-2),
    "vandermonde_naive_conj": (("vandermonde_naive", CPLX(4), X, 8), {}, 1e-2),
    "log_vandermonde": (("log_vandermonde", CPLX(4), np.log(X), 8), {"conj": False}, 1e-2),
    "log_vandermonde_transpose": (("log_vandermonde_transpose", F32(8), CPLX(4), np.log(X), 8),
                                  {}, 1e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_op_matches_jax(case):
    (name, *args), kw, atol = CASES[case]
    ours, ref = _both(name, *args, **kw)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=1e-3 if atol >= 1e-2 else 1e-5)


def test_krylov_returns_the_last_power():
    ours, a_ours = TL.krylov(8, torch.from_numpy(A4), torch.from_numpy(B4), return_power=True)
    ref, a_ref = JL.krylov(8, jnp.asarray(A4), jnp.asarray(B4), return_power=True)
    np.testing.assert_allclose(np.asarray(a_ours), np.asarray(a_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,args", [("bitreversal_po2", (8,)), ("bitreversal_po2", (64,)),
                                       ("bitreversal_permutation", (6,)),
                                       ("bitreversal_permutation", (100,)),
                                       ("transpose_permutation", (2, 3)),
                                       ("transpose_permutation", (16, 8)),
                                       ("snake_permutation", (2, 3)),
                                       ("snake_permutation", (5, 7))])
def test_permutation_matches_jax(name, args):
    np.testing.assert_array_equal(getattr(TP, name)(*args), getattr(JP, name)(*args))


@pytest.mark.parametrize("head_dim,h,rev", [(1, 8, False), (1, 8, True), (2, 2, False),
                                            (4, 4, True)])
def test_fftconv_h3_matches_jax(head_dim, h, rev):
    """Each head's outer product, the conv and the contraction; a head_dim
    above 1 at one head, the layout the JAX function takes."""
    b, length = 2, 100
    k, q, v = F32(b, h, length), F32(b, h, length), F32(b, h, length)
    ssm, D = F32(h, length) * 0.1, F32(h)
    rev_k = F32(h, length) * 0.1 if rev else None
    ours = fftconv_h3(*map(torch.from_numpy, (k, ssm, D, q, v)), head_dim=head_dim,
                      ssm_kernel_rev=None if rev_k is None else torch.from_numpy(rev_k))
    ref = jax_fftconv_h3(*map(jnp.asarray, (k, ssm, D, q, v)), head_dim=head_dim,
                         ssm_kernel_rev=None if rev_k is None else jnp.asarray(rev_k))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("kw", [dict(d_model=256, n_layer=8, d_inner=1024, seq_len=32768),
                                dict(d_model=128, n_layer=2, d_inner=512, seq_len=1024,
                                     order=3, train=False)])
def test_flops_estimate_matches_jax(kw):
    assert profiling.flops_estimate(**kw) == pytest.approx(jax_flops_estimate(**kw), rel=1e-12)


def test_profiling_on_the_host_and_refusals(tmp_path, monkeypatch):
    """The timers on the host with device="cpu"; the card's helpers raise
    without a card rather than time the host."""
    x = torch.randn(64, 64, requires_grad=True)
    stats = profiling.benchmark(lambda a: a @ a, x, iters=3, device="cpu")
    assert set(stats) == {"mean_ms", "p50_ms", "min_ms", "max_ms", "warmup_ms"}
    assert stats["min_ms"] <= stats["p50_ms"] <= stats["max_ms"]
    both = profiling.benchmark_fwd_bwd(lambda p: (p[0] @ p[0]).sum(), [x], iters=2,
                                       device="cpu")
    assert set(both) == {"fwd", "fwd_bwd"}
    with profiling.trace(str(tmp_path / "trace"), device="cpu"):
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: profiling.benchmark(lambda: None),
                 lambda: profiling.device_memory_stats()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
