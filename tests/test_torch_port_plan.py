"""The four-step plan that kernels B, C, E and E' share (`kPlanLogN1` in
`csrc/fft_common.cuh`, which `ops/fused_fftconv.py::_four_step` reads to lay
out the saved spectrum for `pair_spectrum_ref` and `_split_pairs`) against
the rule the header states; the short path's cut (`kShortMaxLogN` in
`csrc/fft_short.cuh`), which the wrapper reads to skip kernel B's four-step
scratch, and the shipped configs that fall at or below it. Runs anywhere:
it reads the table and the cut from the headers."""

import re

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


def test_short_path_cut_is_read_from_the_source(tmp_path, monkeypatch):
    """`ops/fused_fftconv.py` takes the short path's cut from
    `kShortMaxLogN` in csrc/fft_short.cuh (at least 2^12), and follows an
    edited header."""
    from hyena_dna_tpu_torch import _cuda

    header = (_cuda.CSRC / "fft_short.cuh").read_text()
    stated = int(re.search(r"constexpr int kShortMaxLogN = (\d+);", header).group(1))
    assert FB.short_max_log_n() == stated >= 12
    assert FB.short_path(1 << stated) and not FB.short_path(2 << stated)
    assert not FB.short_path(1 << 11, saved_spectrum=True)
    for src in _cuda.CSRC.glob("*.cuh"):
        (tmp_path / src.name).write_text(src.read_text())
    (tmp_path / "fft_short.cuh").write_text(
        header.replace(f"kShortMaxLogN = {stated};", "kShortMaxLogN = 13;"))
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    FB.short_max_log_n.cache_clear()
    try:
        assert FB.short_max_log_n() == 13 and FB.short_path(1 << 13)
    finally:
        monkeypatch.undo()
        FB.short_max_log_n.cache_clear()
    assert FB.short_max_log_n() == stated


@pytest.mark.parametrize("L,save,scratch", [(1024, False, False), (2048, False, False),
                                            (1024, True, True), (8192, False, True)])
def test_short_path_skips_kernel_b_scratch(L, save, scratch, monkeypatch):
    """Kernel B's wrapper passes a null four-step scratch on the short path
    (n <= the cut, no saved spectrum) and a full one elsewhere; k's spectrum
    (ceil(C/2) n complex64) always. The launch is recorded, not run."""
    from hyena_dna_tpu_torch import _cuda

    calls = []
    monkeypatch.setattr(_cuda, "on_card", lambda t: True)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: None)
    monkeypatch.setattr(FB.KERNEL, "launch", lambda fn, *args: calls.append(args))
    u, k, D = torch.zeros(2, 3, L), torch.zeros(3, L), torch.zeros(3)
    FB.fftconv_fused(u, k, D, save_spectrum=save)
    (args,) = calls
    assert (args[4].value is not None) == scratch  # u, k, D, y, scratch, kspec, uspec
    assert args[5].value is not None and (args[6].value is not None) == save


# The shipped Hyena configs whose convs run on the short path (fft 2^13 or
# below): each one's filter length l_max bounds its conv's L; the seqlen
# curricula's first stages (L 1024 and 4096; the species curriculum's 1024,
# 2048 and 4096) before the callback grows L past 4096.
SHORT_CONFIGS = ["hg38_hyena", "hg38_hyena_icl", "hg38_fixed_test", "genomic_benchmark",
                 "genomic_benchmark_scratch", "genomic_benchmark_load_finetuned_model",
                 "nucleotide_transformer", "chromatin_profile", "species_classification"]
SHORT_STAGES = {"hg38_hyena_seqlen_warmup": 2, "species_seqlen_warmup_reload": 3}


@pytest.mark.parametrize("name", SHORT_CONFIGS + sorted(SHORT_STAGES))
def test_shipped_short_configs_fall_at_or_below_the_cut(name):
    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size
    from hyena_dna_tpu_torch.train.__main__ import build_config

    cfg = build_config([f"experiment=hg38/{name}"])
    assert cfg["model"]["layer"]["_name_"] == "hyena"
    if name in SHORT_STAGES:
        stages = cfg["callbacks"]["seqlen_warmup_reload"]["stage_params"]
        lengths = [int(st["seq_len"]) for st in stages[:SHORT_STAGES[name]]]
    else:
        lengths = [int(cfg["model"]["layer"]["l_max"])]
    for length in lengths:
        assert length <= 4096
        assert FB.short_path(next_fast_fft_size(2 * length))
