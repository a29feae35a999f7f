"""The benchmark's operation and byte counts against hand counts, and its
bounds against kernel times measured on the card."""

from __future__ import annotations

import math

import pytest

from benchmark.counts import flops as F
from benchmark.counts import roofline as R
from benchmark.counts.groups import group_of

D = 256
MODEL = {"d_model": 256, "n_layer": 8, "d_inner": 1024, "vocab_size": 12,
         "pad_vocab_size_multiple": 8,
         "layer": {"emb_dim": 5, "filter_order": 64, "short_filter_order": 3}}


def test_front_counts_by_hand():
    # kernel A, 4 x 32768 x 256, bf16 u: u read, vx and x0 written (2 bytes), W,
    # biases and the short conv (float32) read once; one product 2 x N x 256 x 768
    nbytes, ops = R.front_fwd(4, 32768, D, D, 2)
    assert nbytes == 2 * (4 * 32768 * 256 * 3) + 4 * (256 * 768 + 9 * 256 + 6 * 256)
    assert nbytes == 202_128_384
    assert ops == 51_539_607_552 + 131_072 * (768 * 7 + 256)
    # float32 u: the bytes double, the product counts once
    nbytes32, ops32 = R.front_fwd(4, 32768, D, D, 4)
    assert nbytes32 == 4 * (4 * 32768 * 256 * 3) + 801_792 == 403_454_976
    assert ops32 == ops
    assert R.bound_s(nbytes32, ops32) == pytest.approx(403_454_976 / 3.35e12)
    # kernel A': three products (the projection again, du, dW)
    nb, ob = R.front_bwd(4, 32768, D, D, 2)
    assert nb == 2 * (4 * 32768 * 256 * 4) + 4 * (2 * 256 * 768 + 11 * 768)
    assert ob == 3 * 51_539_607_552 + 131_072 * 768 * 16
    assert R.bound_s(nb, ob) == pytest.approx(156_229_435_392 / 989e12)


def test_conv_counts_by_hand():
    # kernel B, 4 x 256 x 32768 bf16, fft 2^16: u, y (B C L) and k (C L) at 2 bytes, D
    nbytes, ops = R.conv_fwd(4, D, 32768, 2)
    assert nbytes == 2 * (2 * 4 * 256 * 32768 + 256 * 32768) + 4 * 256 == 150_995_968
    assert ops == 1024 * (5 * 65536 * 16 + 3 * 65536 + 65536) + 256 * 2.5 * 65536 * 16
    # kernel C at the 1M step's 1 x 256 x 1,000,448, fft 2^21: u, dy, du, k, dk, D, dD
    nb, ob = R.conv_bwd(1, D, 1_000_448, 2, 2)
    assert R.fft_size(1_000_448) == 2 ** 21
    assert nb == 2 * (4 * 256 * 1_000_448) + 2 * 256 * 1_000_448 + 8 * 256
    assert ob == (3 * 256 + 2 * 256) * 2.5 * 2 ** 21 * 21 + 256 * 4 * 2 ** 21


def test_model_operations_by_hand():
    # per token at L = 32768 (fft 2^16): in_proj 393,216, short conv 4,608, gates
    # and skip 1,024, the long conv 256 (3 x 2.5 x 65536 x 16 + 3 x 65536) / 32768
    # = 62,976, out_proj 131,072, MLP 1,048,576; 8 layers and the head 2 x 256 x 16
    assert F.forward_per_token(MODEL, 32768) == 8 * 1_641_472 + 8_192
    # the filter: 8 layers x 2 x L x (5 x 64 + 2 x 64 x 64 + 64 x 256)
    assert F.filter_forward(MODEL, 32768) == 8 * 2 * 32768 * 24_896
    step = F.train_step_flops(MODEL, 8, 32768)
    assert step == 3 * (8 * 32768 * 13_139_968 + 13_052_674_048)
    # at the 1M rows (1,000,445 tokens, fft 2^21) the conv is 256 (7.5 x 2^21 x 21
    # + 3 x 2^21) / L a token
    L = 1_000_445
    conv = 256 * (7.5 * 2 ** 21 * 21 + 3 * 2 ** 21) / L
    assert F.forward_per_token(MODEL, L) == pytest.approx(8 * (1_641_472 - 62_976 + conv)
                                                          + 8_192)
    assert 39e6 < F.train_step_flops(MODEL, 8, L) / (8 * L) < 44e6


# kernel times measured on the card (PERF.md's kernel table: chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700 W): (count, arguments, ms)
MEASURED = [
    ("A bf16 4 x 32768", R.front_fwd, (4, 32768, D, D, 2), 0.508),
    ("A f32 4 x 32768", R.front_fwd, (4, 32768, D, D, 4), 0.687),
    ("A' bf16 4 x 32768", R.front_bwd, (4, 32768, D, D, 2), 1.865),
    ("A' f32 4 x 32768", R.front_bwd, (4, 32768, D, D, 4), 2.903),
    ("A f32 1 x 1,000,448", R.front_fwd, (1, 1_000_448, D, D, 4), 5.029),
    ("B bf16 4 x 32768", R.conv_fwd, (4, D, 32768, 2), 1.004),
    ("B bf16 1 x 1,000,448", R.conv_fwd, (1, D, 1_000_448, 2), 12.284),
    ("B bf16 1 x 450,048", R.conv_fwd, (1, D, 450_048, 2), 5.466),
    ("C bf16 4 x 32768 retransform", R.conv_bwd, (4, D, 32768, 2, 2), 1.184),
    ("C bf16 1 x 1,000,448", R.conv_bwd, (1, D, 1_000_448, 2, 2), 16.333),
    ("C bf16 1 x 450,048", R.conv_bwd, (1, D, 450_048, 2, 2), 6.813),
]


@pytest.mark.parametrize("name,count,args,ms", MEASURED, ids=[m[0] for m in MEASURED])
def test_no_bound_exceeds_a_measured_time(name, count, args, ms):
    bound_ms = 1e3 * R.bound_s(*count(*args))
    assert 0 < bound_ms < ms, name


def test_kernel_groups():
    assert group_of("void front_fwd::kernel<4, float>(...)") == "kernel_a"
    assert group_of("void front_bwd::pass1<4>(...)") == "kernel_a_bwd"
    assert group_of("void conv_fwd::rows<16, 0>(...)") == "kernel_b"
    assert group_of("void conv_bwd::rows_grad<16, 0>(...)") == "kernel_c"
    assert group_of("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") == "matmul"
    assert group_of("void at::native::elementwise_kernel<128, 4, ...>") == "other"
    assert math.isclose(R.PEAK_FLOPS, 989e12) and math.isclose(R.HBM_BYTES_PER_S, 3.35e12)
