"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where no card is present (the check runs in
a fixture, not at import, so every test worker collects the same tests).
On a machine with a card: `python -m pytest tests/test_torch_port_cuda.py`.
Tolerances as in `chip_smoke.py`: float32 sums in another order; bfloat16
I/O may land one bf16 step apart.
"""

import numpy as np
import pytest
import torch

from hyena_dna_tpu_torch.evals.hg38_inference import build_model
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref

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
