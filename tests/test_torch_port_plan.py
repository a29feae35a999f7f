"""The four-step plan that kernels B, C, E and E' share (`kPlanLogN1` in
`csrc/fft_common.cuh`, which `ops/fused_fftconv.py::_four_step` reads to lay
out the saved spectrum for `pair_spectrum_ref` and `_split_pairs`) against
the rule the header states. Runs anywhere: it reads the table from the
header."""

import pytest
import torch

from hyena_dna_tpu_torch.ops import fused_fftconv as FB

LOG_SIZES = range(4, 22)  # every FFT size the kernels take, 16 to 2^21


def _classed(log_m):
    return log_m in (3, 4, 6, 8, 9, 12)  # 8, 16, 64, 256, 512, 4096 points


@pytest.mark.parametrize("log_n", LOG_SIZES)
def test_four_step_matches_the_kernels_table(log_n):
    n1, n2 = FB._four_step(1 << log_n)
    assert len(FB._plan_log_n1()) == 22  # kMaxLogN + 1
    assert n1 * n2 == 1 << log_n and n1 <= 512 and n2 <= 4096
    assert n1 == 1 << FB._plan_log_n1()[log_n]


@pytest.mark.parametrize("log_n", LOG_SIZES)
def test_four_step_takes_radix_class_factors(log_n):
    """Both factors in a radix-16 or radix-8 class wherever such a split
    exists (the most balanced one), else the balanced split; the
    saved-spectrum sizes 2^16-2^18 keep 256 x 256, 256 x 512, 512 x 512."""
    n1, n2 = FB._four_step(1 << log_n)
    a, b = n1.bit_length() - 1, n2.bit_length() - 1
    splits = [x for x in range(1, 10) if log_n - x <= 12 and _classed(x) and _classed(log_n - x)]
    if splits:
        assert _classed(a) and _classed(b)
        assert abs(a - b) == min(abs(log_n - 2 * x) for x in splits)
    else:
        assert log_n in (4, 5, 19) and a == min(log_n // 2, 9)
    saved = {16: (256, 256), 17: (256, 512), 18: (512, 512), 20: (256, 4096), 14: (64, 256)}
    if log_n in saved:
        assert (n1, n2) == saved[log_n]


@pytest.mark.parametrize("C", [4, 5])
def test_saved_spectrum_round_trips_at_a_changed_plan(C):
    """`pair_spectrum_ref` -> `_split_pairs` at fft 2^14 (64 x 256, a split
    the plan rule changed) gives back each channel's spectrum."""
    n = 1 << 14
    u = torch.randn(2, C, n // 2, generator=torch.Generator().manual_seed(C), dtype=torch.float64)
    spec = FB.pair_spectrum_ref(u.float(), n)
    got = FB._split_pairs(spec, C, n)
    want = torch.fft.fft(u, n=n)
    assert got.shape == want.shape
    assert (got.to(torch.complex128) - want).abs().max() <= 1e-4 * want.abs().max()
