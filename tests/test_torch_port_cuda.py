"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no card is present (the check runs in
a fixture, not at import, so every test worker collects the same tests).
On a machine with a card:
`python -m pytest --noconftest tests/test_torch_port_cuda.py`.
Tolerances as in `chip_smoke.py`: float32 sums in another order; bfloat16
I/O may land one bf16 step apart; parameter gradients are sums over every
(batch, time) row, taken in another order (1e-3 of the largest |g|).
"""

import numpy as np
import pytest
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy

pytestmark = pytest.mark.cuda


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
