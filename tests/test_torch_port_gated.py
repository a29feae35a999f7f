"""The port's gate-fused conv (kernels E and E') against the JAX package, on the CPU.

The same numpy inputs go through the JAX gated conv and the port's. The
JAX side runs its packed gated Pallas kernels in interpret mode, at the
size its own tests monkeypatch (`tests/test_fftconv_gated.py`: n = 4096,
cb = 8, float32 store and dot dtypes, `PALLAS_GATED_FFTCONV` forced on);
the port's `GATED_FFT_SIZES` is lowered to the same n. The port's wrappers,
given CPU tensors, run their kernels' plain versions. Tolerances are
stated beside each check.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.fftconv  # noqa: F401 (module registration, as the JAX test does)
import hyena_dna_tpu.ops.pallas_fftconv as PF
from hyena_dna_tpu.models import HyenaOperator as JaxHyenaOperator

from hyena_dna_tpu_torch import bench
from hyena_dna_tpu_torch.evals.hg38_inference import build_model
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.ops import fftconv as TF
from hyena_dna_tpu_torch.ops import gated_fftconv as GE
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

F = sys.modules["hyena_dna_tpu.ops.fftconv"]

N = 4096
L = N // 2
MODES = ("specv", "spec", "retransform")


@pytest.fixture
def gated_small(monkeypatch):
    """The fixture of tests/test_fftconv_gated.py, and the port's plan at n."""
    monkeypatch.setattr(PF, "_STORE_DTYPE", jnp.float32)
    monkeypatch.setattr(PF, "_DOT_DTYPE", jnp.float32)
    monkeypatch.setattr(F, "MXU_SPECTRUM_DTYPE", jnp.float32)
    monkeypatch.setattr(F, "PALLAS_GATED_FFTCONV", True)
    monkeypatch.setattr(F, "_use_mxu_fft", lambda n, rows=1: n >= N)
    monkeypatch.setattr(F, "PALLAS_FFTCONV_INTERPRET", True)
    monkeypatch.setitem(PF._CB_BY_N, N, 8)
    monkeypatch.setattr(TF, "GATED_FFT_SIZES", (N,))


def _data(B, C, seed=0, Lk=L):
    """numpy u, x0, k (decaying, as the JAX test's), D, dy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, C, L)).astype(np.float32)
    x0 = rng.normal(size=(B, C, L)).astype(np.float32)
    k = (rng.normal(size=(C, Lk)) * np.exp(-np.arange(Lk) / 256)).astype(np.float32)
    D = rng.normal(size=(C,)).astype(np.float32)
    dy = rng.normal(size=(B, C, L)).astype(np.float32)
    return u, x0, k, D, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_gated_ref_matches_pallas_forward(gated_small):
    """Kernel E's plain version (y and the saved v) against the Pallas
    forward with save_v, at 2e-4 (the JAX test's forward tolerance)."""
    u, x0, k, D, _ = _data(2, 16)
    r, m, cb = F._gated_plan(jnp.asarray(u), jnp.asarray(k), N)
    y_ref, v_ref = PF.fftconv_fused_fwd_packed_gated(
        jnp.asarray(u), jnp.asarray(x0), jnp.asarray(k), jnp.asarray(D), r, m, cb,
        interpret=True, save_v=True)
    y, v = GE.fftconv_gated_ref(*_t(u, x0, k, D), save_v=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", MODES)
def test_gated_conv_grads_match_jax(gated_small, monkeypatch, mode):
    """`GatedFFTConv` on `mode`'s route: y and the gradients of u, x0, k and
    D against the JAX `fftconv_gated` VJP in the same `PALLAS_GATED_MODE`,
    each within 2e-3 of its max|ref| (the JAX test's gradient tolerance)."""
    monkeypatch.setattr(F, "PALLAS_GATED_MODE", mode)
    u, x0, k, D, dy = _data(4, 16, seed=1)
    y_ref, vjp = jax.vjp(F.fftconv_gated, *map(jnp.asarray, (u, x0, k, D)))
    refs = vjp(jnp.asarray(dy))
    leaves = [t.requires_grad_() for t in _t(u, x0, k, D)]
    counts = GE.KERNEL.launches, GE.KERNEL_BWD.launches
    y = TF.fftconv_gated(*leaves, mode=mode)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert (GE.KERNEL.launches, GE.KERNEL_BWD.launches) == counts  # CPU: plain versions
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=2e-4, atol=2e-4)
    for name, got, want in zip(("du", "dx0", "dk", "dD"), grads, refs):
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 2e-3, (name, rel)


def test_gated_conv_forward_saves_by_mode(gated_small, monkeypatch):
    """What the forward keeps for the backward: spectrum and v (specv),
    spectrum (spec), u (retransform); with no gradient needed, no mode at
    all; past SAVE_SPECTRUM_MAX_BYTES specv and spec turn to retransform."""
    u, x0, k, D, _ = _t(*_data(2, 8)[:4], np.zeros(1))
    assert TF.gated_plan(u, k) and TF.gated_mode("specv", u) == "specv"
    seen = []
    monkeypatch.setattr(TF.GatedFFTConv, "apply", lambda *a: seen.append(a[-1]))
    TF.fftconv_gated(u, x0, k, D, mode="spec")
    TF.fftconv_gated(u.requires_grad_(), x0, k, D, mode="spec")
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    spec_bytes = 2 * 4 * N * 8
    monkeypatch.setattr(FB, "SAVE_SPECTRUM_MAX_BYTES", spec_bytes)
    TF.fftconv_gated(u, x0, k, D, mode="spec")
    TF.fftconv_gated(u, x0, k, D, mode="specv")  # v's bytes tip it over
    assert seen == [None, "spec", "spec", "retransform"]
    with pytest.raises(ValueError):
        TF.fftconv_gated(u, x0, k, D, mode="fused")


def test_gated_plan_covers_the_jax_shapes(gated_small):
    """Even B, C % 8 == 0 and the plan's FFT sizes, as JAX `_gated_plan`;
    elsewhere `fftconv_gated` is the composite."""
    u, x0, k, D, _ = _t(*_data(2, 16)[:4], np.zeros(1))
    assert TF.gated_plan(u, k) == (F._gated_plan(jnp.asarray(u.numpy()), jnp.asarray(k.numpy()),
                                                 N) is not None)
    assert not TF.gated_plan(u[:1], k)
    assert not TF.gated_plan(u[:, :12], k[:12])
    assert not TF.gated_plan(u[..., :1000], k[:, :1000])
    y = TF.fftconv_gated(u[:1], x0[:1], k, D, mode="specv")
    np.testing.assert_allclose(y.numpy(), TF.fftconv_gated(u, x0, k, D, mode="specv")[:1].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Lk", [L, 1500])
def test_plain_routes_match_autograd_of_the_composite(Lk):
    """Each route's plain version against autograd through the composite
    (float64 transforms, gate after), 1e-5 of each max: float32 transforms."""
    u, x0, k, D, dy = _data(4, 6, seed=2, Lk=Lk)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (u, x0, k, D)]
    n = TF.next_fast_fft_size(2 * L)
    uu, xx, kk, DD = leaves
    v = torch.fft.irfft(torch.fft.rfft(uu, n=n) * torch.fft.rfft(kk, n=n), n=n)[..., :L]
    refs = torch.autograd.grad((v + uu * DD[:, None]) * xx, leaves, torch.from_numpy(dy).double())
    u, x0, k, D, dy = _t(u, x0, k, D, dy)
    _, v, spec = GE.fftconv_gated_ref(u, x0, k, D, save_v=True, save_spectrum=True)
    routes = {"specv": GE.fftconv_gated_bwd_specv_ref(spec, v, dy, x0, k, D),
              "spec": GE.fftconv_gated_bwd_spec_ref(spec, dy, x0, k, D),
              "retransform": GE.fftconv_gated_bwd_retransform_ref(u, dy, x0, k, D)}
    for route, out in routes.items():
        for name, got, want in zip(("du", "dx0", "dk", "dD"), out, refs):
            assert got.shape == want.shape and got.dtype == torch.float32, (route, name)
            rel = ((got.double() - want).abs().max() / want.abs().max()).item()
            assert rel < 1e-5, (route, name, rel)


def test_tpu_entry_points_refuse_what_their_routes_did_not_take():
    """The four torch entry points take the packed TPU route's shapes (fft
    2^16-2^17, even B, C % 8 == 0) and refuse the rest; at a taken shape
    each is its route."""
    rng = np.random.default_rng(3)
    sig = lambda b, c, l: torch.from_numpy(rng.normal(size=(b, c, l)).astype(np.float32))
    k, D = torch.from_numpy(rng.normal(size=(8, 1000)).astype(np.float32) * 0.05), torch.ones(8)
    for shape in ((1, 8, 32768), (2, 12, 32768), (2, 8, 16384), (2, 8, 65537)):
        u = sig(*shape)
        kk, DD = (k, D) if shape[1] == 8 else (torch.zeros(shape[1], 1000), torch.ones(shape[1]))
        with pytest.raises(ValueError, match="TPU route"):
            GE.fftconv_fused_fwd_packed_gated(u, u, kk, DD)
        with pytest.raises(ValueError, match="TPU route"):
            GE.fftconv_fused_bwd_spec_packed_gated(None, u, u, kk, DD)
        with pytest.raises(ValueError, match="TPU route"):
            GE.fftconv_fused_bwd_specv_packed_gated(None, u, u, u, kk, DD)
        with pytest.raises(ValueError, match="TPU route"):
            GE.fftconv_fused_bwd_packed_gated(u, u, u, kk, DD)
    u, x0, dy = sig(2, 8, 40000), sig(2, 8, 40000), sig(2, 8, 40000)  # fft 2^17
    y, v, spec = GE.fftconv_fused_fwd_packed_gated(u, x0, k, D, save_spectrum=True, save_v=True)
    assert torch.equal(y, GE.fftconv_gated_ref(u, x0, k, D))
    for got, want in zip(GE.fftconv_fused_bwd_specv_packed_gated(spec, v, dy, x0, k, D),
                         GE.fftconv_gated_bwd_specv(spec, v, dy, x0, k, D)):
        assert torch.equal(got, want)
    assert len(GE.fftconv_fused_bwd_spec_packed_gated(spec, dy, x0, k, D)) == 4
    du, dx0, dk, dD = GE.fftconv_fused_bwd_packed_gated(u, dy, x0, k, D)
    assert dk.shape == k.shape and dD.shape == D.shape and du.shape == dx0.shape == u.shape


def _operators(d, seed, mode, dtype=jnp.float32, pallas_front=False):
    """The JAX HyenaOperator and the port's `gated_conv=mode` one, with the
    JAX parameters carried across by `utils/convert.py`."""
    extra = dict(use_pallas_front=True, pallas_interpret=True) if pallas_front else {}
    op = JaxHyenaOperator(d_model=d, l_max=L, filter_order=8, filter_cfg=dict(emb_dim=5, w=10),
                          dtype=dtype, **extra)
    x = np.random.default_rng(seed).normal(size=(2, L, d)).astype(np.float32)
    params = op.init(jax.random.PRNGKey(seed), jnp.asarray(x, dtype))["params"]
    rng = np.random.default_rng(seed + 1)  # nonzero biases, so they are tested
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    port = HyenaOperator(d, L, filter_order=8, filter_cfg=dict(emb_dim=5, w=10),
                         dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32,
                         gated_conv=mode)
    port.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return op, params, port, x


def _operator_parity(op, params, port, x, dtype, val_tol, grad_tol):
    def loss(p, xx):
        return jnp.sum(op.apply({"params": p}, xx).astype(jnp.float32) ** 2)

    xj = jnp.asarray(x, dtype)
    y_ref = op.apply({"params": params}, xj)
    g_ref = flax_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params, xj)), buffers=False)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(port.dtype)
    counts = GE.KERNEL.launches, GE.KERNEL_BWD.launches
    calls = []
    orig = TF.GatedFFTConv.apply
    TF.GatedFFTConv.apply = lambda *a: calls.append(a[-1]) or orig(*a)
    try:
        y = port(xt)
        (y.float() ** 2).sum().backward()
    finally:
        TF.GatedFFTConv.apply = orig
    assert calls == [port.gated_conv]  # the gated route ran, on its plain versions
    assert (GE.KERNEL.launches, GE.KERNEL_BWD.launches) == counts
    want = np.asarray(y_ref.astype(jnp.float32))
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=val_tol, atol=val_tol)
    for name, p in port.named_parameters():
        want = g_ref[name].numpy()
        scale = np.abs(want).max() + 1e-9
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale, rtol=grad_tol,
                                   atol=grad_tol, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_hyena_operator_gated_matches_jax(gated_small, monkeypatch, mode):
    """`HyenaOperator(gated_conv=mode)` against the JAX operator with the
    gated route forced in the same mode (d = 16, L = 2048): values at 2e-3,
    every gradient at 5e-3 of its max, as `test_hyena_operator_gated_parity`
    holds the JAX gated operator to its composite."""
    monkeypatch.setattr(F, "PALLAS_GATED_MODE", mode)
    op, params, port, x = _operators(16, 3, mode)
    _operator_parity(op, params, port, x, jnp.float32, 2e-3, 5e-3)


def test_bf16_hyena_operator_gated_matches_jax(gated_small):
    """The bf16 operator (bfloat16 activations, float32 conv I/O below
    2^15, as both packages keep it) on the fused front, gated (specv) on
    both sides: the output within 2e-2, each gradient within 2e-2 of its
    max, the bf16 model tolerances of tests/test_torch_port_bf16.py."""
    op, params, port, x = _operators(16, 5, "specv", jnp.bfloat16, pallas_front=True)
    _operator_parity(op, params, port, x, jnp.bfloat16, 2e-2, 2e-2)


def _lm(gated_conv, seed=0):
    return build_model(16, 2, L, generator=torch.Generator().manual_seed(seed),
                       gated_conv=gated_conv)


@pytest.mark.parametrize("mode", MODES)
def test_two_layer_model_gated_matches_composite(gated_small, mode):
    """A 2-layer port model with the gate fused (`mode`) against the same
    weights with it off, on the CPU: logits and loss at 1e-5, every
    parameter gradient at 1e-4 of its max (float32 transforms either way)."""
    on, off = _lm(mode).eval(), _lm(None).eval()
    off.load_state_dict(on.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(6).integers(7, 12, size=(2, L + 1)))
    results = []
    for model in (on, off):
        logits = model(tokens[:, :-1])
        loss = cross_entropy(logits, tokens[:, 1:])
        loss.backward()
        results.append((logits.detach(), loss.item(), dict(model.named_parameters())))
    (lo, lso, po), (lf, lsf, pf) = results
    np.testing.assert_allclose(lo.numpy(), lf.numpy(), rtol=1e-5, atol=1e-5)
    assert abs(lso - lsf) <= 1e-5 * abs(lsf)
    for name, p in po.items():
        ref = pf[name].grad
        assert p.grad is not None, name
        assert (p.grad - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-12, name


def test_bench_gated_on_cpu_at_a_tiny_shape(capsys, monkeypatch):
    """`bench --gated_conv specv` runs the gated route and names its metric
    apart from the composite's."""
    monkeypatch.setattr(TF, "GATED_FFT_SIZES", (128,))
    modes = []
    orig = TF.GatedFFTConv.apply
    monkeypatch.setattr(TF.GatedFFTConv, "apply", lambda *a: modes.append(a[-1]) or orig(*a))
    result = bench.main(["--device", "cpu", "--precision", "bf16", "--gated_conv", "specv",
                         "--batch", "2", "--length", "64", "--d_model", "64", "--n_layer", "2",
                         "--steps", "2", "--windows", "1", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "hg38_trainstep_tokens_per_sec_L64_d64x2_bf16_gated_specv"
    assert line["gated_conv"] == "specv" and line["value"] > 0
    assert modes == ["specv"] * 2 * 3  # 2 layers, 3 steps
    losses = result["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
