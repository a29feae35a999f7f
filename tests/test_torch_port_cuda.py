"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no card is present (the check runs in
a fixture, not at import, so every test worker collects the same tests).
On a machine with a card:
`python -m pytest --noconftest tests/test_torch_port_cuda.py`. The
`second_card` tests (kernels and the model on cuda:1 while the current
device is 0) skip on fewer than two cards: `-k "tensors_card or two_cards
or second_card"` on a multi-card host.
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
from hyena_dna_tpu_torch.ops import mlp_fused as MF
from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
BF16_TOL = (2e-3, 2 ** -7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_card_numerics()
    return torch.device("cuda")


def _close(out, ref, atol_frac, rtol):
    out, ref = out.float().cpu(), ref.float().cpu()
    tol = atol_frac * ref.abs().max() + rtol * ref.abs()
    assert bool(((out - ref).abs() <= tol).all()), (out - ref).abs().max()


@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (1, 1, 16), (3, 130, 40), (1, 4096, 256),
                                   (2, 61, 32), (1, 250, 320)])
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
                                   (1, 4096, 256), (1, 250, 320)])
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
    # N2 = 4096 rows at fft 2^20 and 2^21, B = 1 (dk formed in u's buffer)
    # and B = 3 (the batch sum in shared memory); fft 2^11 and 2^14 (8 x 256 and
    # 64 x 256 splits)
    (1, 3, 300000, 200000, "bfloat16"), (3, 3, 300000, 300000, "float32"),
    (1, 5, 600000, 600000, "bfloat16"), (3, 3, 600000, 450000, "float32"),
    (2, 5, 1000, 700, "float32"), (2, 3, 8192, 8192, "bfloat16"),
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


@pytest.mark.parametrize("B,L", [(1, 300000), (3, 600000)])
def test_fftconv_bwd_same_bits_twice(card, B, L):
    """Kernel C at N2 = 4096 (fft 2^20, B = 1; fft 2^21, the batch sum):
    fixed-order sums, so a second run gives the same bits."""
    g = torch.Generator().manual_seed(L)
    u, dy = (torch.randn(B, 3, L, generator=g).to(BF16).to(card) for _ in range(2))
    k = (torch.randn(3, L, generator=g) * 0.05).to(BF16).to(card)
    D = torch.randn(3, generator=g).to(card)
    first = FB.fftconv_bwd_retransform(u, dy, k, D)
    for a, b in zip(first, FB.fftconv_bwd_retransform(u, dy, k, D)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["retransform", "spectrum", "dk_spec"])
def test_fftconv_bwd_scratch_sizes_from_c(card, route, monkeypatch):
    """Kernel C's workspace comes from its library's C helper: the wrapper
    allocates what `hyena_fftconv_bwd_ws_slabs` says, and the kernel refuses
    any other size, before any launch."""
    lib = FB.KERNEL_BWD.lib()
    assert lib.hyena_fftconv_bwd_ws_slabs(0, 4, 1, 1) == -1
    assert lib.hyena_fftconv_bwd_ws_slabs(3, 5, 1, 1) > lib.hyena_fftconv_bwd_ws_slabs(3, 5, 0, 1)
    B, C, L = 2, 5, 4096  # L = n / 2: the padded operands of the dk-spectrum entry
    g = torch.Generator().manual_seed(7)
    u, dy = (torch.randn(B, C, L, generator=g).to(card) for _ in range(2))
    k, D = torch.randn(C, L, generator=g).to(card), torch.randn(C, generator=g).to(card)
    n = next_fast_fft_size(2 * L)
    spec = FB.fftconv_fused(u, k, D, save_spectrum=True)[1]
    run = {"retransform": lambda: FB.fftconv_bwd_retransform(u, dy, k, D),
           "spectrum": lambda: FB.fftconv_bwd_spectrum(spec, dy, k, D),
           "dk_spec": lambda: FB.fftconv_fused_dk_spec(u, dy, 2, n // 2, 1)}[route]
    real = FB._bwd_workspace
    sizes = []

    def recorded(*args):
        ws, slabs = real(*args)
        sizes.append(slabs)
        return ws, slabs

    monkeypatch.setattr(FB, "_bwd_workspace", recorded)
    run()
    retransform, with_k = route != "spectrum", route != "dk_spec"
    assert sizes == [lib.hyena_fftconv_bwd_ws_slabs(B, C, int(retransform), int(with_k))]

    def one_slab_fewer(*args):
        ws, slabs = real(*args)
        return ws[1:], slabs - 1

    monkeypatch.setattr(FB, "_bwd_workspace", one_slab_fewer)
    before = FB.KERNEL_BWD.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        run()
    assert FB.KERNEL_BWD.launches == before


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


@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (3, 130, 40), (1, 4096, 256), (1, 1, 16),
                                   (2, 61, 128), (1, 61, 40), (1, 250, 320)])
def test_fused_front_bf16_matches_plain(card, B, L, d):
    """Kernels A and A' on bf16 u, dvx, dx0 (float32 parameters): vx, x0 and
    du in bf16, one bf16 step from the plain version, which computes in
    float32 on the same values; dW, dbp, dwc, dbc float32. The tensor-core
    bodies take d in 16-channel groups and 256-input chunks (d = 320: two),
    K and N zero-filled past d, and any L (one 120-time tile at L <= 120)."""
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


SLICES = [(4, 300, 256, 64, "float32"), (4, 300, 256, 128, "bfloat16"),
          (2, 200, 256, 64, "bfloat16"), (1, 130, 320, 40, "bfloat16"),
          (2, 61, 64, 20, "float32"), (1, 4096, 256, 128, "float32")]


@pytest.mark.parametrize("B,L,d_in,d_c,dtype", SLICES)
def test_fused_front_channel_slice_matches_plain(card, B, L, d_in, d_c, dtype):
    """Kernels A and A' on a tensor-parallel rank's slice: u (B, L, d_in)
    projected onto W (d_in, 3 d_c), d_c < d_in, against the plain versions
    (float32: 1e-4; bf16: one bf16 step in vx, x0 and du, 1e-4 in the
    float32 parameter gradients). du (B, L, d_in) is the rank's partial sum;
    the rank's slice of a whole W gives the whole front end's rows."""
    g = torch.Generator().manual_seed(L + d_c)
    dt = getattr(torch, dtype)
    u = torch.randn(B, L, d_in, generator=g).to(dt)
    params = [torch.randn(d_in, 3 * d_c, generator=g) * 0.05,
              torch.randn(3 * d_c, generator=g) * 0.1, torch.randn(3, 3 * d_c, generator=g),
              torch.randn(3 * d_c, generator=g) * 0.1]
    cot = [torch.randn(B, d_c, L, generator=g).to(dt) for _ in range(2)]
    tol = BF16_TOL if dt == BF16 else (1e-4, 1e-4)
    args = [t.to(card) for t in [u] + params]
    before = (FF.KERNEL.launches, FF.KERNEL_BWD.launches)
    vx, x0 = FF.front_fwd(*args)
    assert vx.shape == x0.shape == (B, d_c, L)
    for got, ref in zip((vx, x0), FF.reference_fwd(*args)):
        _close(got, ref, *tol)
    out = FF.front_bwd(*args, *(c.to(card) for c in cot))
    assert (FF.KERNEL.launches, FF.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref = FF.reference_bwd(*args, *(c.to(card) for c in cot))
    for i, (got, want) in enumerate(zip(out, ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want, *(tol if i == 0 else (1e-4, 1e-4)))


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


ROUTES = ("specv", "spec", "retransform")


def _bwd_args(route, u, v, spec, dy, x0, k, D):
    """Kernel E''s arguments on `route`: what the route saved, then dy, x0, k, D."""
    return {"specv": (spec, v), "spec": (spec,), "retransform": (u,)}[route] + (dy, x0, k, D)


def _io_tol(dtype):
    return (1e-4, 1e-4) if dtype == "float32" else BF16_TOL


# B = 1 (E''s row pass keeps K's rows on chip), odd C, B = 3 (dk's batch
# sum), and fft 2^20 (N2 = 4096: E''s row pass over a 2-CTA cluster)
GATED_SHAPES = [
    (1, 1, 8, 8, "float32"), (2, 3, 100, 60, "float32"), (3, 5, 5000, 5000, "bfloat16"),
    (2, 8, 32768, 30000, "bfloat16"), (2, 6, 65536, 65536, "float32"),
    (1, 5, 40000, 40000, "bfloat16"), (3, 7, 30000, 20000, "float32"),
    (1, 4, 450048, 450048, "bfloat16"), (3, 3, 300000, 250000, "float32"),
]


@pytest.mark.parametrize("B,C,L,Lk,dtype", GATED_SHAPES)
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


@pytest.mark.parametrize("B,C,L,Lk,dtype", GATED_SHAPES)
@pytest.mark.parametrize("route", ["specv", "spec", "retransform"])
def test_fftconv_gated_bwd_matches_plain(card, B, C, L, Lk, dtype, route):
    """Kernel E' on each route against its plain version (du, dx0, dk in the
    I/O tolerance, dD float32), with the same bits over two runs."""
    import time

    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    u, x0, dy, k, D = _gated_inputs(B, C, L, Lk, dtype, card, B + C + L + 1)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    args = _bwd_args(route, u, v, spec, dy, x0, k, D)
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


@pytest.mark.parametrize("route", ["specv", "spec", "retransform"])
def test_fftconv_gated_bwd_adds_d_once(card, route):
    """A large D against a tiny k, so that du is nearly dv * D: E' adds D
    to K once (k's slab holds K + D, and the row pass adds none), against
    the route's plain version and against dv * D itself."""
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    u, x0, dy, k, _ = _gated_inputs(2, 6, 4096, 4096, "float32", card, 5)
    k, D = k * 1e-4, torch.linspace(50.0, 100.0, 6, device=card)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    args = _bwd_args(route, u, v, spec, dy, x0, k, D)
    du = getattr(GE, f"fftconv_gated_bwd_{route}")(*args)[0]
    _close(du, getattr(GE, f"fftconv_gated_bwd_{route}_ref")(*args)[0], 1e-4, 1e-4)
    _close(du, dy * x0 * D[:, None], 1e-2, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("log_n", range(4, 22))
def test_fftconv_gated_every_fft_size(card, log_n, dtype):
    """Kernels E and E' at every power-of-two FFT size from 16 to 2^21 (B = 1
    from 2^18, odd C at odd log_n), every route of E' against its plain
    version, a second run the same bits."""
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    n = 1 << log_n
    B, C = (2 if log_n < 18 else 1), (3 if log_n % 2 else 4)
    u, x0, dy, k, D = _gated_inputs(B, C, n // 2, n // 2, dtype, card, log_n)
    y, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    for got, want in zip((y, v), GE.fftconv_gated_ref(u, x0, k, D, True)):
        _close(got, want, *_io_tol(dtype))
    for route in ROUTES:
        args = _bwd_args(route, u, v, spec, dy, x0, k, D)
        fn = getattr(GE, f"fftconv_gated_bwd_{route}")
        out = fn(*args)
        for got, want, name in zip(out, getattr(GE, f"fftconv_gated_bwd_{route}_ref")(*args),
                                   ("du", "dx0", "dk", "dD")):
            _close(got, want, *((1e-4, 1e-4) if name == "dD" else _io_tol(dtype)))
        assert all(torch.equal(a, b) for a, b in zip(out, fn(*args))), route


@pytest.mark.parametrize("route", ["specv", "spec", "retransform"])
def test_fftconv_gated_bwd_workspace_from_c(card, route, monkeypatch):
    """Kernel E''s workspace comes from its library's C helper (dv's
    scratch, u's on the retransform route, k's slab: no slab of its own for
    dk), and the kernel refuses any other size before any launch."""
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE

    lib = GE.KERNEL_BWD.lib()
    B, C, L = 3, 5, 1000
    pairs = (C + 1) // 2
    assert lib.hyena_fftconv_gated_bwd_ws_slabs(0, C, 0) == -1
    assert lib.hyena_fftconv_gated_bwd_ws_slabs(B, C, 3) == -1
    want = (B * (2 if route == "retransform" else 1) + 1) * pairs
    assert lib.hyena_fftconv_gated_bwd_ws_slabs(B, C, ROUTES.index(route)) == want
    u, x0, dy, k, D = _gated_inputs(B, C, L, L, "float32", card, 9)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    args = _bwd_args(route, u, v, spec, dy, x0, k, D)
    fn = getattr(GE, f"fftconv_gated_bwd_{route}")
    real = GE._bwd_workspace
    sizes = []

    def recorded(*a):
        ws, slabs = real(*a)
        sizes.append(slabs)
        return ws, slabs

    monkeypatch.setattr(GE, "_bwd_workspace", recorded)
    fn(*args)
    assert sizes == [want]

    def one_slab_fewer(*a):
        ws, slabs = real(*a)
        return ws[1:], slabs - 1

    monkeypatch.setattr(GE, "_bwd_workspace", one_slab_fewer)
    before = GE.KERNEL_BWD.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fn(*args)
    assert GE.KERNEL_BWD.launches == before


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


# kernels A4 and A4' on a tensor-parallel rank's slice: (B, L, d_in, d_c,
# rows_pad, m, tile_l), W (d_in, 3 d_c) with d_c < d_in
FRONT4_SLICES = [(1, 1536, 8, 4, 16, 128, 512), (2, 512, 64, 20, 8, 128, 256),
                 (1, 131072, 256, 128, 1024, 128, 512), (1, 131072, 256, 64, 1024, 128, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,d_in,d_c,rows,m,tile", FRONT4_SLICES)
def test_fused_front4_channel_slice_matches_plain(card, B, L, d_in, d_c, rows, m, tile, dtype):
    """Kernels A4 and A4' on a rank's W (d_in, 3 d_c) against
    `reference_fwd4` / `reference_bwd4` (the tail past L exactly zero; vx4,
    x04 and the partial du at the dtype's tolerance, the parameter
    gradients 1e-3 of their max, sums over B * L rows in another order)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(L + d_c)
    u = torch.randn(B, L, d_in, generator=g).to(dt)
    params = [torch.randn(d_in, 3 * d_c, generator=g) * 0.05,
              torch.randn(3 * d_c, generator=g) * 0.1, torch.randn(3, 3 * d_c, generator=g),
              torch.randn(3 * d_c, generator=g) * 0.1]
    cot = [torch.randn(B, d_c, rows, m, generator=g).to(dt) for _ in range(2)]
    tol = (1e-4, 1e-4) if dtype == "float32" else BF16_TOL
    args = [t.to(card) for t in [u] + params]
    before = (FF.KERNEL4.launches, FF.KERNEL4_BWD.launches)
    vx4, x04 = FF.fused_proj_conv_gate4(*args, rows, m, tile)
    assert vx4.shape == x04.shape == (B, d_c, rows, m)
    for out, want in zip((vx4, x04), FF.reference_fwd4(*args, rows, m)):
        _close(out, want, *tol)
        assert not out.reshape(B, d_c, -1)[..., L:].any()
    out = FF.front4_bwd(*args, *(c.to(card) for c in cot))
    assert (FF.KERNEL4.launches, FF.KERNEL4_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref = FF.reference_bwd4(*args, *(c.to(card) for c in cot))
    assert out[0].shape == (B, L, d_in) and out[1].shape == (d_in, 3 * d_c)
    _close(out[0], ref[0], *tol)
    for got, want in zip(out[1:], ref[1:]):
        _close(got, want, 1e-3, 1e-3)


@pytest.mark.parametrize("mode", sorted(FF.PROBE_MODES))
def test_wgmma_probe_matches_matmul(card, mode):
    """csrc/wgmma.cuh alone: one 64 x N x 64 bf16 product in each layout and
    descriptor form the front-end kernels use, against a float32 matmul of
    the same values (bf16 products are exact in float32; the sums of 64
    terms in another order)."""
    g = torch.Generator().manual_seed(mode)
    a, b = (torch.randn(64, 64, generator=g).to(BF16) for _ in range(2))
    n = FF.PROBE_MODES[mode]
    before = FF.KERNEL.launches
    c = FF.wgmma_probe(a.to(card), b.to(card), mode)
    assert FF.KERNEL.launches == before + 1 and c.shape == (64, n)
    _close(c, a.float() @ b.float()[:, :n], 1e-6, 1e-5)


def _front_bf16_args(B, L, d, seed, dtype=BF16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, L, d, generator=g).to(dtype), torch.randn(d, 3 * d, generator=g) * 0.05,
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(3, 3 * d, generator=g),
            torch.randn(3 * d, generator=g) * 0.1, torch.randn(B, d, L, generator=g).to(dtype),
            torch.randn(B, d, L, generator=g).to(dtype)]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("B,L,d", [(2, 200, 64), (1, 4096, 256), (1, 250, 320)])
def test_fused_front_bwd_bf16_same_bits_twice(card, B, L, d, dtype):
    """Kernel A' on bf16 (and float32) u twice on the same inputs: the same
    bits in du and every parameter gradient (fixed-order sums, no atomics)."""
    args = [a.to(card) for a in _front_bf16_args(B, L, d, 5 + d, dtype)]
    first, second = FF.front_bwd(*args), FF.front_bwd(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("B,L,d,rows,m,tile", FRONT4_SHAPES)
def test_fused_front4_bf16_bits_equal_flat(card, B, L, d, rows, m, tile, dtype):
    """Kernels A4 and A4' against A and A' on the same bf16 (and float32)
    values: the flat view of the 4-D outputs is A's outputs bit for bit
    (zero past L), and A4' gives A''s bits in du and every gradient (its dW
    runs depend on B, L and d only); the 4-D cotangents are A's padded with
    noise past L."""
    u, w, bp, wc, bc, dvx, dx0 = (a.to(card) for a in _front_bf16_args(B, L, d, 11 + L, dtype))
    vx, x0 = FF.front_fwd(u, w, bp, wc, bc)
    vx4, x04 = FF.front4_fwd(u, w, bp, wc, bc, rows, m)
    for flat, four in ((vx, vx4), (x0, x04)):
        four = four.reshape(B, d, -1)
        assert torch.equal(four[..., :L], flat) and not four[..., L:].any()
    noise = lambda t: torch.cat([t, torch.randn(B, d, rows * m - L, device=card).to(dtype)], -1)
    cot4 = [noise(t).reshape(B, d, rows, m).contiguous() for t in (dvx, dx0)]
    for x, y in zip(FF.front_bwd(u, w, bp, wc, bc, dvx, dx0),
                    FF.front4_bwd(u, w, bp, wc, bc, *cot4)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("B,L,d", [(1, 1, 16), (2, 200, 64), (1, 250, 320), (4, 32768, 256),
                                   (1, 1000448, 256)])
def test_front_bf16_scratch_sizes_from_c(card, B, L, d, dtype, monkeypatch):
    """The entries' scratch sizes (bf16 and float32 u alike) come from their
    libraries' C helpers: the four libraries agree on the split-W size and
    the two backward ones on the dW run count (so A4' takes A''s runs), and
    kernel A' refuses a run count other than its own, before any launch."""
    libs = [k.lib() for k in (FF.KERNEL, FF.KERNEL4, FF.KERNEL_BWD, FF.KERNEL4_BWD)]
    numel = {lib.hyena_front_ws_numel(d, d) for lib in libs}
    runs = {lib.hyena_front_bwd_runs(B, L, d, d) for lib in libs[2:]}
    assert len(numel) == len(runs) == 1 and min(numel) > 0 and min(runs) >= 1
    if B * L > 4096:
        return
    real = FF._bwd_buffers

    def one_run_more(kernel, u, d_c):
        dw, dparams, (ws, _, _), (r,) = real(kernel, u, d_c)
        new = lambda *shape: torch.empty(shape, device=u.device, dtype=torch.float32)
        return dw, dparams, (ws, new((r + 1) * 5 * 3 * d), new(r + 1, d, 3 * d)), (r + 1,)

    monkeypatch.setattr(FF, "_bwd_buffers", one_run_more)
    before = FF.KERNEL_BWD.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        FF.front_bwd(*(a.to(card) for a in _front_bf16_args(B, L, d, 3, dtype)))
    assert FF.KERNEL_BWD.launches == before


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


@pytest.mark.parametrize("n,d,dh,d_out,dtype", [
    (128, 128, 128, 128, "float32"), (640, 256, 1024, 256, "bfloat16"),
    (256, 128, 192, 384, "bfloat16"), (192, 320, 64, 64, "float32"), (64, 64, 64, 64, "bfloat16"),
    # the widths past the old shared-memory limit, dh = 4 d
    (256, 384, 1536, 384, "bfloat16"), (192, 512, 2048, 512, "float32"),
    (128, 1024, 4096, 1024, "bfloat16"), (128, 256, 1024, 512, "bfloat16"),
    # 128-row tiles: N below one tile and a ragged last tile; d = 64 beside
    # d_out = 320 (five panels); both dtypes at the hg38 width
    (64, 256, 1024, 256, "bfloat16"), (192, 256, 512, 256, "bfloat16"),
    (256, 64, 256, 320, "bfloat16"), (320, 256, 1024, 256, "float32"),
])
def test_mlp_fused_matches_plain(card, n, d, dh, d_out, dtype):
    """Kernels F and F' against `mlp_fused_ref` / `mlp_fused_bwd_ref`: the
    same bf16 operands, float32 sums in another order, so a rounding of h
    or dh to bf16 may flip between them and move a term by a bf16 step:
    every output at the bf16 tolerance, as in `chip_smoke.py`."""
    g = torch.Generator().manual_seed(n + d_out)
    dt = getattr(torch, dtype)
    x = (torch.randn(n, d, generator=g) * 0.5).to(dt).to(card)
    w1 = (torch.randn(d, dh, generator=g) * 0.05).to(card)
    b1 = (torch.randn(dh, generator=g) * 0.1).to(card)
    w2 = (torch.randn(dh, d_out, generator=g) * 0.05).to(card)
    b2 = (torch.randn(d_out, generator=g) * 0.1).to(card)
    dy = torch.randn(n, d_out, generator=g).to(dt).to(card)
    before = (MF.KERNEL.launches, MF.KERNEL_BWD.launches)
    y = MF.mlp_fused_fwd(x, w1, b1, w2, b2)
    out = MF.mlp_fused_bwd(x, dy, w1, b1, w2)
    assert (MF.KERNEL.launches, MF.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == dt and out[0].dtype == dt
    _close(y, MF.mlp_fused_ref(x, w1, b1, w2, b2), *BF16_TOL)
    ref = MF.mlp_fused_bwd_ref(x, dy, w1, b1, w2)
    for got, want, name in zip(out, ref, ("dx", "dw1", "db1", "dw2", "db2")):
        assert got.shape == want.shape, name
        _close(got, want, *BF16_TOL)
    again = MF.mlp_fused_bwd(x, dy, w1, b1, w2)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # fixed-order sums


@pytest.mark.parametrize("mode", sorted(MF.PROBE_MODES))
def test_mlp_wgmma_probe_matches_matmul(card, mode):
    """The product forms kernels F and F' add to csrc/wgmma.cuh, alone: one
    64 x N x 64 bf16 product at N = 128, 192, 256 with b MN-major across
    panels, b K-major, and a and b MN-major, against a float32 matmul of the
    same values (bf16 products are exact in float32; the sums of 64 terms in
    another order)."""
    g = torch.Generator().manual_seed(100 + mode)
    a = torch.randn(64, 64, generator=g).to(BF16)
    b = torch.randn(64, 256, generator=g).to(BF16)
    n = MF.PROBE_MODES[mode]
    before = MF.KERNEL.launches
    c = MF.wgmma_probe(a.to(card), b.to(card), mode)
    assert MF.KERNEL.launches == before + 1 and c.shape == (64, n)
    _close(c, a.float() @ b.float()[:, :n], 1e-6, 1e-5)


def test_mlp_bwd_workspace_from_c(card):
    """F''s workspace size comes from its library's C helper: a whole
    number of (d dh + dh d_out + dh) partial sums, and -1 past an int."""
    lib = MF.KERNEL_BWD.lib()
    for d, dh, d_out in ((256, 1024, 256), (64, 256, 320), (1024, 4096, 1024)):
        numel = lib.hyena_mlp_bwd_ws_numel(d, dh, d_out)
        total = d * dh + dh * d_out + dh
        assert numel > 0 and numel % total == 0
        MF._workspace(numel, d, dh, d_out, card)
    assert lib.hyena_mlp_bwd_ws_numel(16384, 65536, 16384) == -1


def test_mlp_module_fused_on_card_matches_two_products(card):
    from hyena_dna_tpu_torch.models.blocks import Mlp

    torch.manual_seed(0)
    fused = Mlp(256, 1024, dtype=BF16, use_fused=True).to(card)
    plain = Mlp(256, 1024, dtype=BF16).to(card)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 512, 256, device=card)
    outs = []
    for m in (fused, plain):
        xx = x.clone().requires_grad_()
        y = m(xx)
        y.float().square().sum().backward()
        outs.append((y, xx.grad, *(p.grad for p in m.parameters())))
    for a, b in zip(*outs):
        _close(a, b, 2e-2, 2 ** -7)


@pytest.mark.parametrize("B,C,L,dtype", [(1, 3, 64, "float32"), (3, 4, 4096, "bfloat16"),
                                         (2, 5, 1 << 16, "float32")])
def test_dk_spec_matches_plain(card, B, C, L, dtype):
    """Kernel C's dk-spectrum mode (transforms and the batch sum only)
    against `fftconv_dk_spec_ref`, in natural order, at 1e-4 of its max."""
    g = torch.Generator().manual_seed(L + C)
    dt = getattr(torch, dtype)
    u, dy = (torch.randn(B, C, L, generator=g).to(dt).to(card) for _ in range(2))
    n = 2 * L
    r = 1 << ((n.bit_length()) // 2)
    before = FB.KERNEL_BWD.launches
    re, im = FB.fftconv_fused_dk_spec(u, dy, r, n // r, 1)
    assert FB.KERNEL_BWD.launches == before + 1
    want_re, want_im = FB.fftconv_dk_spec_ref(u, dy, n)
    scale = torch.complex(want_re, want_im).abs().max()
    assert (torch.complex(re, im) - torch.complex(want_re, want_im)).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("log_n", range(4, 22))
def test_fftconv_every_fft_size(card, log_n, dtype):
    """Kernel B at every power-of-two FFT size from 16 to 2^21 (the plan's
    edges: N2 < 16 below 2^8, N1 = 512 from 2^18), odd C at odd log_n,
    against `fftconv_ref`; its saved spectrum against `pair_spectrum_ref`
    and read back through kernel C's spectrum route against
    `fftconv_bwd_ref`; a second run gives the same bits. Up to the short
    path's cut the saved-spectrum call keeps the four-step passes and the
    plain call takes the short path, so there the second plain call is held
    to the first."""
    n = 1 << log_n
    B, C, L = (2 if log_n < 18 else 1), (3 if log_n % 2 else 4), n // 2
    g = torch.Generator().manual_seed(log_n)
    dt = getattr(torch, dtype)
    u = torch.randn(B, C, L, generator=g).to(dt).to(card)
    dy = torch.randn(B, C, L, generator=g).to(dt).to(card)
    k = (torch.randn(C, L, generator=g) * torch.exp(-torch.arange(L) / (L / 8))).to(dt).to(card)
    D = torch.randn(C, generator=g).to(card)
    tol = (1e-4, 1e-4) if dtype == "float32" else BF16_TOL
    before = FB.KERNEL.launches
    y, spec = FB.fftconv_fused(u, k, D, save_spectrum=True)
    again = FB.fftconv_fused(u, k, D)
    if FB.short_path(n):
        assert torch.equal(again, FB.fftconv_fused(u, k, D))
        _close(again, fftconv_ref(u, k, D), *tol)
    else:
        assert torch.equal(y, again)
    assert FB.KERNEL.launches == before + 2 + FB.short_path(n)
    _close(y, fftconv_ref(u, k, D), *tol)
    _close(spec, FB.pair_spectrum_ref(u, n), 1e-5, 1e-4)
    out = FB.fftconv_bwd_spectrum(spec, dy, k, D)
    for got, want, name in zip(out, FB.fftconv_bwd_ref(u, dy, k, D), ("du", "dk", "dD")):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        _close(got, want, *((1e-4, 1e-4) if name == "dD" else tol))


# Kernels B and C's short path (csrc/fft_short.cuh): chip_smoke.py's phase-2
# cases, every FFT size from 2^4 to the cut (read from the header), odd C
# with k as long as u at L = n / 2, B = 3 with L = n / 2 - 1 and a shorter k
# in bf16, and the shipped lengths 1023 and 1026 in both dtypes.
SHORT_LOG_SIZES = range(4, FB.short_max_log_n() + 1)
SHORT_CASES = ([(1, 5, 1 << (e - 1), 1 << (e - 1), "float32") for e in SHORT_LOG_SIZES]
               + [(3, 4, (1 << (e - 1)) - 1, max(1, 3 * ((1 << (e - 1)) - 1) // 4), "bfloat16")
                  for e in SHORT_LOG_SIZES]
               + [(3, 7, 1023, 1023, "float32"), (3, 7, 1023, 700, "bfloat16"),
                  (1, 3, 1026, 1026, "bfloat16"), (3, 5, 1026, 900, "float32")])


def _short_inputs(card, B, C, L, Lk, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    u, dy = (torch.randn(B, C, L, generator=g).to(dt).to(card) for _ in range(2))
    k = (torch.randn(C, Lk, generator=g) * 0.05
         * torch.exp(-torch.arange(Lk) / (Lk / 8))).to(dt).to(card)
    return u, dy, k, torch.randn(C, generator=g).to(card)


@pytest.mark.parametrize("B,C,L,Lk,dtype", SHORT_CASES)
def test_fftconv_short_path_matches_plain(card, B, C, L, Lk, dtype):
    """Kernel B and kernel C's retransform route on the short path (one
    launch of each wrapper a call) against `fftconv_ref` and
    `fftconv_bwd_ref`; C's dk in the I/O dtype and, for bf16, in float32."""
    u, dy, k, D = _short_inputs(card, B, C, L, Lk, dtype, L + C)
    assert FB.short_path(next_fast_fft_size(2 * L))
    tol = (1e-4, 1e-4) if dtype == "float32" else BF16_TOL
    before = FB.KERNEL.launches
    y = FB.fftconv_fused(u, k, D)
    assert FB.KERNEL.launches == before + 1 and y.dtype == u.dtype
    _close(y, fftconv_ref(u, k, D), *tol)
    for dk_dtype in ((None, torch.float32) if dtype == "bfloat16" else (None,)):
        before = FB.KERNEL_BWD.launches
        out = FB.fftconv_bwd_retransform(u, dy, k, D, dk_dtype=dk_dtype)
        assert FB.KERNEL_BWD.launches == before + 1
        ref = FB.fftconv_bwd_ref(u, dy, k, D, dk_dtype=dk_dtype)
        for got, want, name in zip(out, ref, ("du", "dk", "dD")):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            _close(got, want, *((1e-4, 1e-4) if got.dtype == torch.float32 else tol))


@pytest.mark.parametrize("B,C,L,dtype", [(32, 128, 1024, "float32"), (3, 7, 1026, "bfloat16"),
                                         (64, 6, 2048, "float32"), (5, 9, 4096, "bfloat16")])
def test_fftconv_short_path_same_bits_twice(card, B, C, L, dtype):
    """Kernel C's short path sums its dk partials in a fixed order (no
    atomics): a second call gives the same bits in du, dk and dD, and
    kernel B's y too."""
    u, dy, k, D = _short_inputs(card, B, C, L, L, dtype, 3)
    first = (FB.fftconv_fused(u, k, D), *FB.fftconv_bwd_retransform(u, dy, k, D))
    second = (FB.fftconv_fused(u, k, D), *FB.fftconv_bwd_retransform(u, dy, k, D))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fftconv_short_path_slices_from_c(card):
    """The number S of kernel C's dk partials a pair comes from its library:
    1 <= S <= B up to the cut, 0 above it, -1 for shapes refused."""
    cut = FB.short_max_log_n()
    for B, C in ((1, 3), (32, 128), (128, 128), (3, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            assert 1 <= FB.short_slices(B, C, 1 << cut, dtype, card) <= B
            assert FB.short_slices(B, C, 16, dtype, card) <= B
            assert FB.short_slices(B, C, 2 << cut, dtype, card) == 0
    with pytest.raises(ValueError):
        FB.short_slices(0, 4, 2048, torch.float32, card)


@pytest.mark.parametrize("mode", ["pool", "sum"])
def test_sequence_decoder_bf16_matches_cpu(card, mode):
    """The decoder's running sums over a 1024-long bf16 window: card and CPU
    within one bf16 step of the float64 sums (both accumulate in float32)."""
    from hyena_dna_tpu_torch.models.heads import SequenceDecoder

    x = (torch.randn(32, 1024, 128, generator=torch.Generator().manual_seed(0)) + 0.5).to(BF16)
    dec = SequenceDecoder(128, None, l_output=0, mode=mode)
    ref = torch.cumsum(x.double(), dim=-2)[:, -1]
    if mode == "pool":
        ref = ref / 1024
    for out in (dec(x.to(card)).cpu(), dec(x)):
        assert out.dtype == BF16
        _close(out, ref, 0.0, 2 ** -7)



def test_recurrent_prefill_parallel_on_card_matches_cpu(card):
    """The closed-form prefill (its conv on kernel B, once per layer) on the
    card against the CPU: last logits within 1e-4 of max|logit|, every
    state within 1e-4 of its max|s|."""
    from hyena_dna_tpu_torch.recurrent import RecurrentLM, distill

    model = build_model(64, 2, 4096, generator=torch.Generator().manual_seed(3)).eval()
    rec_cpu = distill(model, n_modes=32, fit_len=1024)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(7, 12, size=(2, 3000)))
    st_cpu, lg_cpu = rec_cpu.prefill_parallel(rec_cpu.init_state(2), tokens)
    rec = RecurrentLM(model.to(card), [x.numpy() for x in rec_cpu.lam],
                      [x.numpy() for x in rec_cpu.c])
    before = FB.KERNEL.launches
    st, lg = rec.prefill_parallel(rec.init_state(2), tokens.to(card))
    assert FB.KERNEL.launches == before + 2
    _close(lg, lg_cpu, 1e-4, 0.0)
    for ours, ref in zip(st["layers"], st_cpu["layers"]):
        for key in ("sc", "s"):
            _close(ours[key], ref[key], 1e-4, 0.0)


def test_generation_step_launches_a_and_b_per_layer(card):
    """Each generated token is one full forward: kernels A and B once per
    layer, and no backward kernel."""
    from hyena_dna_tpu_torch.generation import generate

    model = build_model(64, 3, 512, generator=torch.Generator().manual_seed(4)).to(card).eval()
    kernels = (FF.KERNEL, FB.KERNEL, FF.KERNEL_BWD, FB.KERNEL_BWD)
    before = [k.launches for k in kernels]
    out = generate(model, torch.full((2, 100), 7, dtype=torch.long), 5, temperature=0.0)
    assert out.shape == (2, 105) and out.device.type == "cuda"
    assert [k.launches - b for k, b in zip(kernels, before)] == [15, 15, 0, 0]


@pytest.fixture
def second_card():
    """cuda:1, with cuda:0 the current device; skips on fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    set_card_numerics()
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1000, 40000])  # B and C: the short path, the four-step passes
def test_kernels_run_on_their_tensors_card(second_card, dtype, L):
    """Kernels A, A', B and C on cuda:1 while the current device is 0: each
    launches once, on its tensors' card (its outputs there), matches its
    plain version, and leaves the current device at 0."""
    g = torch.Generator().manual_seed(L)
    dt, B, d = getattr(torch, dtype), 2, 64
    params = [torch.randn(d, 3 * d, generator=g) * 0.05, torch.randn(3 * d, generator=g) * 0.1,
              torch.randn(3, 3 * d, generator=g), torch.randn(3 * d, generator=g) * 0.1]
    u, dvx, dx0, x, dy = (torch.randn(*shape, generator=g).to(dt)
                          for shape in ((B, L, d),) + ((B, d, L),) * 4)
    k = (torch.randn(d, L, generator=g) * 0.05 * torch.exp(-torch.arange(L) / (L / 8))).to(dt)
    D = torch.randn(d, generator=g)
    on = lambda *ts: [t.to(second_card) for t in ts]
    kernels = (FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD)
    before = [kern.launches for kern in kernels]
    outs = [FF.front_fwd(*on(u, *params)), FF.front_bwd(*on(u, *params, dvx, dx0)),
            (FB.fftconv_fused(*on(x, k, D)),), FB.fftconv_bwd_retransform(*on(x, dy, k, D))]
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [1, 1, 1, 1]
    assert torch.cuda.current_device() == 0
    refs = [FF.reference_fwd(u, *params), FF.reference_bwd(u, *params, dvx, dx0),
            (fftconv_ref(x, k, D),), FB.fftconv_bwd_ref(x, dy, k, D)]
    tol = (1e-4, 1e-4) if dtype == "float32" else BF16_TOL
    for out, ref in zip(outs, refs):
        for got, want in zip(out, ref):
            assert got.device == second_card and got.dtype == want.dtype
            _close(got, want, *((1e-4, 1e-4) if got.dtype == torch.float32 else tol))


def test_kernels_refuse_tensors_on_two_cards(second_card):
    """Inputs split over cuda:0 and cuda:1 raise; nothing is copied across
    and no kernel launches."""
    u, w = torch.randn(1, 8, 16, device=second_card), torch.randn(16, 48, device="cuda:0")
    x, k = torch.randn(1, 4, 64, device=second_card), torch.randn(4, 64, device="cuda:0")
    before = (FF.KERNEL.launches, FB.KERNEL.launches)
    with pytest.raises(ValueError, match="is on cuda:0"):
        FF.front_fwd(u, w, *(torch.zeros(s, device=second_card) for s in (48, (3, 48), 48)))
    with pytest.raises(ValueError, match="is on cuda:0"):
        FB.fftconv_fused(x, k, torch.zeros(4, device=second_card))
    assert (FF.KERNEL.launches, FB.KERNEL.launches) == before


def test_model_on_second_card_matches_cpu(second_card):
    """The whole model moved to cuda:1, the current device 0 (as
    `hg38_inference --device cuda:1` runs it): its loss and every parameter
    gradient from the kernels match the CPU's through the plain versions."""
    model = build_model(64, 2, 1000, generator=torch.Generator().manual_seed(0)).eval()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(7, 12, size=(2, 1001)))
    x, y = tokens[:, :-1], tokens[:, 1:]
    loss_cpu = cross_entropy(model(x), y)
    loss_cpu.backward()
    cpu = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.to(second_card)
    counts = [(k, k.launches) for k in (FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD)]
    loss = cross_entropy(model(x.to(second_card)), y.to(second_card))
    loss.backward()
    assert all(k.launches == n + 2 for k, n in counts)  # one each per layer
    assert torch.cuda.current_device() == 0
    _close(loss.detach(), loss_cpu.detach(), 0.0, 1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.device == second_card, name
        _close(p.grad, cpu[name], 1e-3, 1e-3)
