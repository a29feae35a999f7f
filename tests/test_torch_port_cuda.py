"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no card is present (the check runs in
a fixture, not at import, so every test worker collects the same tests).
On a machine with a card:
`python -m pytest --noconftest tests/test_torch_port_cuda.py`.
Tolerances as in `chip_smoke.py`: float32 sums in another order; bfloat16
I/O may land one bf16 step apart; parameter gradients are sums over every
(batch, time) row, taken in another order (1e-3 of the largest |g|; 3e-2
in the bf16 model, whose cotangents round to bf16 on both sides).
"""

import numpy as np
import pytest
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model
from hyena_dna_tpu_torch.ops import add_ln as AL
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
BF16_TOL = (2e-3, 2 ** -7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, atol_frac, rtol):
    out, ref = out.float().cpu(), ref.float().cpu()
    tol = atol_frac * ref.abs().max() + rtol * ref.abs()
    assert bool(((out - ref).abs() <= tol).all()), (out - ref).abs().max()


@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (1, 1, 16), (3, 130, 40), (1, 4096, 256)])
def test_fused_front_matches_plain(card, B, L, d):
    g = torch.Generator().manual_seed(L)
    args = [torch.randn(B, L, d, generator=g), torch.randn(d, 3 * d, generator=g) * 0.05,
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(3, 3 * d, generator=g),
            torch.randn(3 * d, generator=g) * 0.1]
    before = FF.KERNEL.launches
    vx, x0 = FF.fused_proj_conv_gate(*(a.to(card) for a in args))
    assert FF.KERNEL.launches == before + 1
    vx_ref, x0_ref = FF.reference_fwd(*args)
    _close(vx, vx_ref, 1e-4, 1e-4)
    _close(x0, x0_ref, 1e-4, 1e-4)


@pytest.mark.parametrize("B,C,L,Lk,dtype", [
    (1, 1, 8, 8, "float32"), (2, 3, 100, 100, "float32"), (3, 4, 5000, 5000, "bfloat16"),
    (2, 6, 40000, 30000, "float32"), (1, 2, (1 << 20) - 5, (1 << 20) - 5, "bfloat16"),
])
def test_fftconv_matches_plain(card, B, C, L, Lk, dtype):
    g = torch.Generator().manual_seed(C)
    dt = getattr(torch, dtype)
    u = torch.randn(B, C, L, generator=g).to(dt)
    k = (torch.randn(C, Lk, generator=g) * torch.exp(-torch.arange(Lk) / (Lk / 8))).to(dt)
    D = torch.randn(C, generator=g)
    before = FB.KERNEL.launches
    y = FB.fftconv_fused(u.to(card), k.to(card), D.to(card))
    assert FB.KERNEL.launches == before + 1 and y.dtype == dt
    ref = fftconv_ref(u.to(card), k.to(card), D.to(card))
    if dtype == "float32":
        _close(y, ref, 1e-4, 1e-4)
    else:
        _close(y, ref, 2e-3, 2 ** -7)


def test_wrappers_reject_what_kernels_do_not_take(card):
    u = torch.zeros(1, 4, 8, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        FB.fftconv_fused(u, u[0], torch.zeros(4, device=card))
    with pytest.raises(ValueError):
        FB.fftconv_fused(u.float(), u[0].float().t(), torch.zeros(4, device=card))


def test_model_on_card_matches_cpu(card):
    model = build_model(64, 2, 1000, generator=torch.Generator().manual_seed(0)).eval()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(7, 12, size=(2, 1000)))
    with torch.inference_mode():
        cpu = model(tokens)
        ours = model.to(card)(tokens.to(card)).cpu()
    np.testing.assert_allclose(ours.numpy(), cpu.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (1, 1, 16), (3, 130, 40), (2, 61, 32),
                                   (1, 4096, 256)])
def test_fused_front_bwd_matches_plain(card, B, L, d):
    g = torch.Generator().manual_seed(L + d)
    args = [torch.randn(B, L, d, generator=g), torch.randn(d, 3 * d, generator=g) * 0.05,
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(3, 3 * d, generator=g),
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(B, d, L, generator=g),
            torch.randn(B, d, L, generator=g)]
    before = FF.KERNEL_BWD.launches
    out = FF.front_bwd(*(a.to(card) for a in args))
    assert FF.KERNEL_BWD.launches == before + 1
    for got, ref in zip(out, FF.reference_bwd(*args)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close(got, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("B,C,L,Lk,dtype", [
    (1, 1, 8, 8, "float32"), (2, 3, 100, 60, "float32"), (3, 5, 5000, 5000, "bfloat16"),
    (2, 6, 40000, 30000, "float32"), (1, 4, 1 << 17, 1 << 17, "bfloat16"),
    (2, 3, 70000, 65000, "float32"),
])
@pytest.mark.parametrize("route", ["retransform", "spectrum"])
def test_fftconv_bwd_matches_plain(card, B, C, L, Lk, dtype, route):
    g = torch.Generator().manual_seed(C + L)
    dt = getattr(torch, dtype)
    u = torch.randn(B, C, L, generator=g).to(dt).to(card)
    dy = torch.randn(B, C, L, generator=g).to(dt).to(card)
    k = (torch.randn(C, Lk, generator=g) * torch.exp(-torch.arange(Lk) / (Lk / 8))).to(dt).to(card)
    D = torch.randn(C, generator=g).to(card)
    before = FB.KERNEL_BWD.launches
    if route == "spectrum":
        y, spec = FB.fftconv_fused(u, k, D, save_spectrum=True)
        ref_spec = FB.pair_spectrum_ref(u, next_fast_fft_size(2 * L))
        _close(spec, ref_spec, 1e-5, 1e-4)
        _close(y, fftconv_ref(u, k, D), *((1e-4, 1e-4) if dtype == "float32" else (2e-3, 2 ** -7)))
        out = FB.fftconv_bwd_spectrum(spec, dy, k, D)
    else:
        out = FB.fftconv_bwd_retransform(u, dy, k, D)
    assert FB.KERNEL_BWD.launches == before + 1
    ref = FB.fftconv_bwd_ref(u, dy, k, D)
    for got, want, name in zip(out, ref, ("du", "dk", "dD")):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if dtype == "float32" or name == "dD":
            _close(got, want, 1e-4, 1e-4)
        else:
            _close(got, want, 2e-3, 2 ** -7)


def test_model_grads_on_card_match_cpu(card):
    """Every parameter gets a gradient on the card, from the kernels, close
    to the CPU's through the plain versions."""
    model = build_model(64, 2, 1000, generator=torch.Generator().manual_seed(0)).eval()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(7, 12, size=(2, 1001)))
    x, y = tokens[:, :-1], tokens[:, 1:]
    cross_entropy(model(x), y).backward()
    cpu = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.to(card)
    counts = [(k, k.launches) for k in (FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD)]
    cross_entropy(model(x.to(card)), y.to(card)).backward()
    assert all(k.launches == n + 2 for k, n in counts)  # one each per layer
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, cpu[name], 1e-3, 1e-3)


# kernels D and D' (the fused residual-add + LN) and kernels A, A' on bf16

@pytest.mark.parametrize("n,d", [(1, 256), (7, 64), (1000, 128), (4099, 256), (333, 512),
                                 (257, 768), (65, 1024), (20000, 256)])
def test_add_ln_matches_plain(card, n, d):
    """Ragged N and every width the kernels take, each direction one launch;
    res_out is the same single rounding (equal bits), y and d_total one bf16
    step, dscale and dbias float32 sums over N rows in another order. Kernel
    D' sums them in a fixed order: two runs give the same bits."""
    g = torch.Generator().manual_seed(n + d)
    h = torch.randn(n, d, generator=g).to(BF16).to(card)
    r = (torch.randn(n, d, generator=g) * 3).to(BF16).to(card)
    w = (1 + 0.1 * torch.randn(d, generator=g)).to(card)
    b = (0.1 * torch.randn(d, generator=g)).to(card)
    dy, dup = (torch.randn(n, d, generator=g).to(BF16).to(card) for _ in range(2))
    before = AL.KERNEL.launches
    y, ro = AL.add_ln_fwd(h, r, w, b, 1e-5)
    assert AL.KERNEL.launches == before + 1 and y.dtype == ro.dtype == BF16
    y_ref, ro_ref = AL.add_ln_ref(h, r, w, b)
    assert torch.equal(ro, ro_ref)
    _close(y, y_ref, *BF16_TOL)
    before = AL.KERNEL_BWD.launches
    out = AL.add_ln_bwd(ro, dy, dup, w, 1e-5)
    assert AL.KERNEL_BWD.launches == before + 1
    ref = AL.add_ln_bwd_ref(ro, dy, dup, w)
    assert [t.dtype for t in out] == [BF16, torch.float32, torch.float32]
    _close(out[0], ref[0], *BF16_TOL)
    _close(out[1], ref[1], 1e-4, 1e-4)
    _close(out[2], ref[2], 1e-4, 1e-4)
    again = AL.add_ln_bwd(ro, dy, dup, w, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_add_ln_autograd_launches_d_and_d_prime(card):
    """`add_ln` on CUDA bf16 tensors goes through kernels D and D', once each."""
    g = torch.Generator().manual_seed(0)
    h, r = (torch.randn(2, 300, 256, generator=g).to(BF16).to(card).requires_grad_()
            for _ in range(2))
    w = torch.ones(256, device=card, requires_grad=True)
    b = torch.zeros(256, device=card, requires_grad=True)
    counts = (AL.KERNEL.launches, AL.KERNEL_BWD.launches)
    y, ro = AL.add_ln(h, r, w, b)
    (y.float().sum() + ro.float().square().sum()).backward()
    assert (AL.KERNEL.launches, AL.KERNEL_BWD.launches) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(h.grad, r.grad) and w.grad.dtype == torch.float32


@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (3, 130, 40), (1, 4096, 256)])
def test_fused_front_bf16_matches_plain(card, B, L, d):
    """Kernels A and A' on bf16 u, dvx, dx0 (float32 parameters): vx, x0 and
    du in bf16, one bf16 step from the plain version, which computes in
    float32 on the same values; dW, dbp, dwc, dbc float32."""
    g = torch.Generator().manual_seed(L + d)
    u = torch.randn(B, L, d, generator=g).to(BF16)
    params = [torch.randn(d, 3 * d, generator=g) * 0.05, torch.randn(3 * d, generator=g) * 0.1,
              torch.randn(3, 3 * d, generator=g), torch.randn(3 * d, generator=g) * 0.1]
    cot = [torch.randn(B, d, L, generator=g).to(BF16) for _ in range(2)]
    args = [t.to(card) for t in [u] + params]
    before = FF.KERNEL.launches
    vx, x0 = FF.front_fwd(*args)
    assert FF.KERNEL.launches == before + 1 and vx.dtype == x0.dtype == BF16
    for got, ref in zip((vx, x0), FF.reference_fwd(*args)):
        _close(got, ref, *BF16_TOL)
    before = FF.KERNEL_BWD.launches
    out = FF.front_bwd(*args, *(c.to(card) for c in cot))
    assert FF.KERNEL_BWD.launches == before + 1
    ref = FF.reference_bwd(*args, *(c.to(card) for c in cot))
    for i, (got, want) in enumerate(zip(out, ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want, *(BF16_TOL if i == 0 else (1e-4, 1e-4)))


def test_bf16_wrappers_reject_what_kernels_do_not_take(card):
    x = torch.zeros(8, 256, device=card, dtype=BF16)
    w = torch.ones(256, device=card)
    with pytest.raises(TypeError):
        AL.add_ln_fwd(x.float(), x, w, w, 1e-5)
    with pytest.raises(TypeError):
        AL.add_ln_fwd(x, x, w.to(BF16), w, 1e-5)
    with pytest.raises(ValueError, match="take d"):
        AL.add_ln_fwd(x[:, :96].contiguous(), x[:, :96].contiguous(), w[:96], w[:96], 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        AL.add_ln_fwd(x[:, ::2], x[:, ::2], w[:128], w[:128], 1e-5)
    with pytest.raises(ValueError):
        AL.add_ln_fwd(x, x.cpu(), w, w, 1e-5)
    with pytest.raises(TypeError):
        AL.add_ln_bwd(x, x.float(), x, w, 1e-5)
    u = torch.zeros(1, 8, 4, device=card, dtype=BF16)
    p = [torch.zeros(4, 12, device=card), torch.zeros(12, device=card),
         torch.zeros(3, 12, device=card), torch.zeros(12, device=card)]
    with pytest.raises(TypeError):
        FF.front_bwd(u, *p, torch.zeros(1, 4, 8, device=card), torch.zeros(1, 4, 8, device=card))
    with pytest.raises(TypeError):
        FF.front_fwd(u.half(), *p)


def test_bf16_model_on_card_matches_cpu(card):
    """The bf16 model with a bf16 residual (d=256, the width kernels D and D'
    run at; 2 layers): logits within 2e-2 of max(1, max|logit|), every
    parameter's gradient within 3e-2 of its largest entry, and each kernel
    launched as the main path launches it (A, A', B, C once per layer; D,
    D' 2 n_layer times: 2 n_layer - 1 block units plus ln_f)."""
    model = build_model(256, 2, 1000, generator=torch.Generator().manual_seed(0),
                        dtype=BF16, residual_in_fp32=False).eval()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(7, 12, size=(2, 1001)))
    x, y = tokens[:, :-1], tokens[:, 1:]
    logits_cpu = model(x)
    cross_entropy(logits_cpu, y).backward()
    cpu = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.to(card)
    kernels = (FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD, AL.KERNEL, AL.KERNEL_BWD)
    counts = [k.launches for k in kernels]
    logits = model(x.to(card))
    cross_entropy(logits, y.to(card)).backward()
    assert [k.launches - n for k, n in zip(kernels, counts)] == [2, 2, 2, 2, 4, 4]
    assert logits.dtype == BF16
    scale = max(1.0, logits_cpu.float().abs().max().item())
    assert (logits.float().cpu() - logits_cpu.float()).abs().max().item() <= 2e-2 * scale
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, cpu[name], 3e-2, 0.0)


# kernels E and E' (the gate-fused conv and its backward routes)

def _gated_inputs(B, C, L, Lk, dtype, card, seed):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    u, x0, dy = (torch.randn(B, C, L, generator=g).to(dt).to(card) for _ in range(3))
    k = (torch.randn(C, Lk, generator=g) * torch.exp(-torch.arange(Lk) / (Lk / 8))).to(dt)
    return u, x0, dy, k.to(card), torch.randn(C, generator=g).to(card)


def _io_tol(dtype):
    return (1e-4, 1e-4) if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("B,C,L,Lk,dtype", [
    (1, 1, 8, 8, "float32"), (2, 3, 100, 60, "float32"), (3, 5, 5000, 5000, "bfloat16"),
    (2, 8, 32768, 30000, "bfloat16"), (2, 6, 65536, 65536, "float32"),
])
def test_fftconv_gated_matches_plain(card, B, C, L, Lk, dtype):
    """Kernel E with and without v and the spectrum: y and v within the I/O
    tolerance, the spectrum as kernel B saves it."""
    import time

    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    u, x0, _, k, D = _gated_inputs(B, C, L, Lk, dtype, card, B + C + L)
    before = GE.KERNEL.launches
    y, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    assert GE.KERNEL.launches == before + 1 and y.dtype == v.dtype == u.dtype
    y_ref, v_ref, spec_ref = GE.fftconv_gated_ref(u, x0, k, D, True, True)
    _close(y, y_ref, *_io_tol(dtype))
    _close(v, v_ref, *_io_tol(dtype))
    _close(spec, spec_ref, 1e-5, 1e-4)
    assert torch.equal(GE.fftconv_gated_fused(u, x0, k, D), y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    GE.fftconv_gated_fused(u, x0, k, D)
    torch.cuda.synchronize()
    print(f"kernel E B={B} C={C} L={L} {dtype}: {1e3 * (time.perf_counter() - t0):.3f} ms")


@pytest.mark.parametrize("B,C,L,Lk,dtype", [
    (1, 1, 8, 8, "float32"), (2, 3, 100, 60, "float32"), (3, 5, 5000, 5000, "bfloat16"),
    (2, 8, 32768, 30000, "bfloat16"), (2, 6, 65536, 65536, "float32"),
])
@pytest.mark.parametrize("route", ["specv", "spec", "retransform"])
def test_fftconv_gated_bwd_matches_plain(card, B, C, L, Lk, dtype, route):
    """Kernel E' on each route against its plain version (du, dx0, dk in the
    I/O tolerance, dD float32), with the same bits over two runs."""
    import time

    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    u, x0, dy, k, D = _gated_inputs(B, C, L, Lk, dtype, card, B + C + L + 1)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    args = {"specv": (spec, v), "spec": (spec,), "retransform": (u,)}[route] + (dy, x0, k, D)
    fn = getattr(GE, f"fftconv_gated_bwd_{route}")
    ref_fn = getattr(GE, f"fftconv_gated_bwd_{route}_ref")
    before = GE.KERNEL_BWD.launches
    out = fn(*args)
    assert GE.KERNEL_BWD.launches == before + 1
    for got, want, name in zip(out, ref_fn(*args), ("du", "dx0", "dk", "dD")):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        _close(got, want, *((1e-4, 1e-4) if name == "dD" else _io_tol(dtype)))
    assert all(torch.equal(a, b) for a, b in zip(out, fn(*args)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    print(f"kernel E' {route} B={B} C={C} L={L} {dtype}: "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms")


def test_gated_wrappers_reject_what_kernels_do_not_take(card):
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    u = torch.zeros(2, 8, 16, device=card)
    k, D = torch.zeros(8, 16, device=card), torch.zeros(8, device=card)
    with pytest.raises(TypeError):
        GE.fftconv_gated_fused(u, u.to(BF16), k, D)
    with pytest.raises(TypeError):
        GE.fftconv_gated_fused(u.half(), u.half(), k.half(), D)
    with pytest.raises(ValueError):
        GE.fftconv_gated_fused(u, u.cpu(), k, D)
    with pytest.raises(ValueError):
        GE.fftconv_gated_fused(u, u[:, :, :8], k, D)
    with pytest.raises(ValueError, match="contiguous"):
        GE.fftconv_gated_fused(u, u.transpose(0, 1).contiguous().transpose(0, 1), k, D)
    with pytest.raises(ValueError):
        GE.fftconv_gated_bwd_spec(torch.zeros(2, 4, 16, 2, device=card), u, u, k, D)
    with pytest.raises(ValueError):
        GE.fftconv_fused_fwd_packed_gated(u, u, k, D)  # fft 32: not a TPU route size


@pytest.mark.parametrize("mode", ["specv", "spec", "retransform"])
def test_gated_conv_autograd_card_matches_cpu(card, mode, monkeypatch):
    """`GatedFFTConv` on the card (kernels E and E') against the CPU (their
    plain versions): y and every input's gradient."""
    from hyena_dna_tpu_torch.ops import fftconv as F
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    monkeypatch.setattr(F, "GATED_FFT_SIZES", (4096,))
    g = torch.Generator().manual_seed(7)
    ins = [torch.randn(2, 16, 2048, generator=g), torch.randn(2, 16, 2048, generator=g),
           torch.randn(16, 2000, generator=g) * 0.05, torch.randn(16, generator=g)]
    dy = torch.randn(2, 16, 2048, generator=g)
    results = []
    for device in ("cpu", card):
        leaves = [t.to(device).requires_grad_() for t in ins]
        counts = (GE.KERNEL.launches, GE.KERNEL_BWD.launches)
        y = F.fftconv_gated(*leaves, mode=mode)
        grads = torch.autograd.grad(y, leaves, dy.to(device))
        launched = (GE.KERNEL.launches - counts[0], GE.KERNEL_BWD.launches - counts[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 1))
        results.append([y] + list(grads))
    for got, want in zip(results[1], results[0]):
        _close(got, want, 1e-4, 1e-4)


# kernels A4 and A4' (the 4-D conv layout): (B, L, d, rows_pad, m, tile_l)
FRONT4_SHAPES = [(1, 1536, 8, 16, 128, 512), (2, 512, 40, 8, 128, 256),
                 (1, 131072, 256, 1024, 128, 512)]


def _front4_args(B, L, d, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, L, d, generator=g).to(dtype), torch.randn(d, 3 * d, generator=g) * 0.05,
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(3, 3 * d, generator=g),
            torch.randn(3 * d, generator=g) * 0.1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,d,rows,m,tile", FRONT4_SHAPES)
def test_fused_front4_matches_plain(card, B, L, d, rows, m, tile, dtype):
    """Kernel A4 against `reference_fwd4`; the tail past L is exactly zero."""
    args = _front4_args(B, L, d, L + d, getattr(torch, dtype))
    before = FF.KERNEL4.launches
    vx4, x04 = FF.fused_proj_conv_gate4(*(a.to(card) for a in args), rows, m, tile)
    assert FF.KERNEL4.launches == before + 1 and vx4.shape == (B, d, rows, m)
    ref = FF.reference_fwd4(*args, rows, m)
    tol = (1e-4, 1e-4) if dtype == "float32" else BF16_TOL
    for out, want in zip((vx4, x04), ref):
        _close(out, want, *tol)
        assert not out.reshape(B, d, -1)[..., L:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,d,rows,m,tile", FRONT4_SHAPES)
def test_fused_front4_bwd_matches_plain(card, B, L, d, rows, m, tile, dtype):
    """Kernel A4' against `reference_bwd4`, the cotangents random in the tail
    too (both ignore it); du in the I/O dtype, the parameter gradients 1e-3
    of their max (sums over B * L rows in another order)."""
    dt = getattr(torch, dtype)
    args = _front4_args(B, L, d, L + 2 * d, dt)
    g = torch.Generator().manual_seed(7)
    args += [torch.randn(B, d, rows, m, generator=g).to(dt) for _ in range(2)]
    before = FF.KERNEL4_BWD.launches
    out = FF.front4_bwd(*(a.to(card) for a in args))
    assert FF.KERNEL4_BWD.launches == before + 1
    ref = FF.reference_bwd4(*args)
    _close(out[0], ref[0], *((1e-4, 1e-4) if dtype == "float32" else BF16_TOL))
    for got, want in zip(out[1:], ref[1:]):
        _close(got, want, 1e-3, 1e-3)


@pytest.mark.parametrize("B,L,plan", [(1, 1536, (4, 8, 128)), (3, 100000, (16, 128, 128))])
def test_outer4_entries_are_the_flat_kernels(card, B, L, plan):
    """`fftconv_outer_fwd4` / `fftconv_outer_bwd4` give the bits of kernel B
    and kernel C's retransform route on the padded flat operands."""
    n1, r, m = plan
    rows = n1 // 2 * r
    lp = rows * m
    g = torch.Generator().manual_seed(L)
    pad = lambda t: torch.nn.functional.pad(t, (0, lp - L)).to(card)
    u, dy = (pad(torch.randn(B, 4, L, generator=g)) for _ in range(2))
    k = pad(torch.randn(4, L, generator=g) * torch.exp(-torch.arange(L) / 64.0))
    D = torch.randn(4, generator=g).to(card)
    four = lambda t: t.reshape(*t.shape[:-1], rows, m)
    y4 = FB.fftconv_outer_fwd4(four(u), four(k), D, *plan)
    grads4 = FB.fftconv_outer_bwd4(four(u), four(dy), four(k), D, *plan)
    flat = [FB.fftconv_fused(u, k, D), *FB.fftconv_bwd_retransform(u, dy, k, D)]
    for a, b in zip((y4, *grads4), flat):
        assert torch.equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("remat", [("block", 1, False), ("residual", 2, False),
                                   ("residual", 3, True)])
def test_remat_grads_on_card_match_plain(card, remat, monkeypatch):
    """A 4-layer bf16 model (float32 residual) in training mode with dropout,
    checkpointed (and on the 4-D route), against the plain model on the
    card: logits and every gradient within 1e-6 of each max|g| (the same
    bits are expected). The outer plan table is patched so the 4-D route
    engages at L = 1536."""
    monkeypatch.setitem(FB.OUTER_BY_N, 4096, (4, 8, 128))
    mode, group, front4 = remat
    tokens = torch.from_numpy(np.random.default_rng(0).integers(7, 12, size=(1, 1537))).to(card)
    runs = []
    for kw in ({}, dict(checkpoint_mixer=True, remat_residual_only=mode == "residual",
                        remat_group_size=group, front4=front4)):
        model = build_model(64, 4, 1536, generator=torch.Generator().manual_seed(0),
                            dtype=BF16, residual_in_fp32=True, **kw).to(card).train()
        logits = model(tokens[:, :-1], generator=torch.Generator(card).manual_seed(1))
        cross_entropy(logits, tokens[:, 1:]).backward()
        runs.append((logits.detach().float(), {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = runs
    assert (la - lb).abs().max() <= 1e-6 * la.abs().max()
    for name in ga:
        assert (ga[name] - gb[name]).abs().max() <= 1e-6 * ga[name].abs().max(), name
