#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no final
line:

1. build    every hand-written kernel from `hyena_dna_tpu_torch/csrc` (one
            nvcc per source, twelve sources, started together; ptxas's
            register, stack and spill readings of the front-end kernels
            (float32 and bf16 u), of F and F' and of the passes of C, E
            and E' are kept
            for their rows,
            read from the log beside a library built before): kernels A and
            A' (the front end forward and backward), A4 and A4' (the same on
            the 4-D conv layout), B and C (the FFT conv forward and
            backward), D and D' (the fused residual-add + LN forward and
            backward), E and E' (the gate-fused FFT conv forward and
            backward), F and F' (the fused MLP forward and backward); a
            second line holds the readings of the four-step passes' third
            class (`kSchedLogN1` / `kSchedLogN2` in csrc/fft_common.cuh:
            the 128-point columns of fft 2^19 and the 4-point passes of 2^4
            and 2^5, each at its compile-time schedule) beside the build's
            seconds;
   cold     two processes, started together, each pointing `_cuda.BUILD_DIR`
            at one fresh directory and building kernel D there with the real
            nvcc at its first launch (as torchrun's ranks do on a cold
            `_build/`), wait for each other and build at once; both must
            load the library and hold D to its plain version at 64 x 256
            bf16 rows, and one library, its log and no temporary file must
            be left. The line carries each process's build seconds;
   device   kernels A, A', B and C on `cuda:1` while the current device is 0
            (the wrappers launch under their tensors' card), float32 at the
            trainer's 32 x 1024 x 128 (B and C on their short path) and bf16
            at 4 x 32768 x 256 (the four-step passes), each held to its
            plain version at TOL, the current device still 0 after. It
            needs two cards: on one, the line says so and the phase passes.
            The line carries the guard's host microseconds a launch
            (`torch.cuda.device`, which `Kernel.launch` enters, entered and
            left on the current card);
2. kernels  `csrc/wgmma.cuh` alone: one 64 x N x 64 bf16 product in each
            layout the bf16 front-end kernels use, and in each layout F and
            F' add (N = 128, 192, 256; MN-major operands across panels),
            against a float32 matmul. Then each kernel against its plain
            PyTorch version on the card, in the working dtype, at the
            shapes of the TPU routes it replaces, with the tolerances
            below; kernel, plain and library-call times.
            Kernels A and A' in float32 and in bfloat16; D and D' at the
            bf16 model's 4 x 32768 x 256 rows; B and C through the named
            entry of each TPU row with its plan on padded operands, C at
            the flat 1M step's unpadded 1 x 1,000,448, B and C at the
            450k step's 1 x 450,048 (fft 2^20) and through the outer
            entries at stage 3 of `hg38_large_1m`'s curriculum, 1 x 262,144
            (fft 2^19, plan (16, 128, 256)), each call of B and C run twice
            for the same bits, then the routes no
            default path takes: the narrow plan at fft 2^19, the 3-factor
            plans at fft 2^19-2^21, kernel C's dk-spectrum
            mode at 4 x 32768; kernels B and C's short path
            (csrc/fft_short.cuh, fft 2^4 to its cut 2^13) at every FFT size
            to the cut (B 1 and 3, odd C, k shorter than u, L 1023 and
            1026, float32 and bf16, C's dk in float32 too), two calls of C
            bit-equal, the saved-spectrum modes (which keep the four-step
            passes) once at fft 2^11, and B and C timed at the species
            curriculum's first three stages (128 x 1024, 64 x 2048 and
            32 x 4096 at d 128, float32); E and E' on each route at 4 x 32768 and 2 x
            65536, and E' through its generic wrappers on the specv and
            spec routes at B = 1 (1 x 32768) and at fft 2^20 (1 x 450,048,
            its row pass over a 2-CTA cluster); A4 and A4' at 1 x 1,000,448
            and 1 x 131072; F and F' at
            the MLP width (256 -> 1024 -> 256) on 4 x 32768 bf16 rows and
            1 x 32768 float32 rows, and at 512 -> 2048 -> 512 on 4 x 32768
            bf16 rows; the 4-D conv entries bit-equal to the flat
            kernel B / C calls. Then this slice's path: `Mlp(256, 1024,
            use_fused=True)` in bf16, forward and backward at 4 x 32768, its
            launch counts zeroed just before and read just after (F and F'
            once each), held against the two-product route;
3. parity   the full-width model (d=256 x 8 layers, random weights from a
            seeded torch.Generator) on the CPU through the plain versions and
            on the card through the kernels: logits at (B=2, L=8192)
            (float32 conv I/O) and (B=1, L=32768) (bfloat16 conv I/O), then
            the loss and every parameter's gradient at the same two shapes;
            then the same four checks of the bf16 model (bfloat16
            activations and residual stream, as every hg38 config trains);
            then, with the gate-fused conv (kernels E and E'), the logits,
            loss and every gradient of the bf16 model on the specv route at
            (B=2, L=24576) (float32 conv I/O) and (B=2, L=32768) (bfloat16
            conv I/O), and of the float32 model at (B=2, L=24576) on the
            spec and the retransform routes; then, on the card alone at 1 x
            131072 in bf16, residual cells g 2 against no checkpointing and
            the 4-D route against the flat one, each the same bits in the
            logits and every gradient, and the plain step's repeat the same
            bits too; last the float32 model with residual cells and the
            4-D route, card against CPU, at 1 x 65536;
4. serving  the port's `hg38_inference.main` on a synthetic FASTA and a
            reference-named `.pt`: 2 batches of 4 x 32768 tokens, then one
            1,000,448-token window. Kernel A must run n_layer times per
            batch, kernel B at least as often;
5. training the port's `bench.main` (forward, backward, clip, AdamW) at
            4 x 32768 and at 1 x 131072 in float32, then at 4 x 32768 in
            bf16 (`--precision bf16`): the loss must be finite and lower
            after the steps than at step 0; kernels A and A' must run
            n_layer times per step, kernels B and C at least as often, and
            in bf16 kernels D and D' 2 n_layer times per step (2 n_layer - 1
            block units plus ln_f; never in float32). Then the bf16 step at
            4 x 32768 with `--gated_conv` specv, spec and retransform: kernels
            E and E' n_layer times per step, B and C never, D and D' as
            before; each step's ms is printed beside the composite bf16
            step's of the same run. Then the long-context steps: 1 x
            1,000,448 bf16 with a float32 residual and residual cells (g 2,
            g 1, g 2 on the 4-D route), 1 x 450,048 with block cells, and
            1 x 262,144 with residual cells g 2 and a float32 residual (the
            singlechip config's cells at stage 3 of `hg38_large_1m`'s
            curriculum, fft 2^19).
            F and F' never run in a training step (`Block` does not set
            `use_fused`, as in the JAX package).
6. trainer  the port's trainer (`python -m hyena_dna_tpu_torch.train`,
            `train/__main__.py`) at the full width of hyenadna-tiny-1k
            (d_model 128, 2 layers, batch 32, bf16 with a float32
            residual) on synthetic data written by
            `scripts/make_synthetic_genome.py` (4M bases, 1024-base
            windows) and `scripts/make_synthetic_gb.py` (its default
            8000 / 2000 sequences): `experiment=hg38/hg38_hyena` for 48
            steps, writing checkpoints/last, then
            `experiment=hg38/genomic_benchmark` from that checkpoint for
            one epoch. Every train step must launch kernels A, A', B and C
            twice each (one per layer) and nothing else; both losses must
            fall (the mean of the last 8 logged below the first 8) and the
            fine-tune's test accuracy exceed 0.5. Each run prints its
            median step time (a per-step time, not the trainer's
            throughput), the trainer's logged `train/tokens_per_sec` (LM
            runs only) and the loop's tokens over its wall time from the
            first step's start to the last's end. Then the fine-tune's
            first 3 steps with dropout off, on the card and on the CPU
            (plain versions), each loss within 5e-3 relative (PERF.md
            section 2, the bf16 model). Phase 2 checks A and A' in bf16 at
            the trainer's 32 x 1024 x 128 (two 64-column `wgmma` panels)
            and B and C at its 32 x 128 x 1024, fft 2^11, float32 conv I/O,
            and all four at phase 8's 4 x 32768 x 128 (bf16, fft 2^16, C
            retransforming). The pretraining's dataset takes the fused C++
            fetch.
7. generation  serving and generation at the full width of the hg38 LM
            (d_model 256, 8 layers, d_inner 1024). (a) `hg38_inference
            --preset hyena_dna_512ksl` on a LongSafari-layout directory
            (config.json + reference-named weights.ckpt) written from a
            seeded preset model, 2 batches of 2 x 32768 of phase 4's FASTA:
            the loss finite, kernel A n_layer times a batch, B at least as
            often; then `from_pretrained` of that directory, one 1 x 32768
            forward on the card. (b) `generate_cli` at temperature 0 on a
            seeded hg38 LM (l_max 2048): a 4096-base prompt and 32 new
            tokens, kernels A and B n_layer times per token and nothing
            else; the first 4 tokens against the CPU's plain run, each equal
            or, where they differ, a near tie (the CPU's top-2 margin within
            phase 3's float32 logits tolerance). (c) `recurrent.distill` of
            that model (64 modes, the fit over its whole 2048-long filter, on
            the host: its seconds and `fit_rel_err`); `prefill_parallel` at 2
            x 16384 on the card (kernel B n_layer times, nothing else)
            against the CPU (last logits and every state within 1e-4 of
            their max); at 1 x 2048 against the model's own forward and at
            1 x 131072 (fft 2^18) against the model's forward with the
            distilled filter in place of the implicit one, each within 5e-2
            of max|logit| (the error against the model's own forward at 1 x
            131072, where the model cuts its filter at l_max and the
            recurrence does not, is printed beside it); then 256 greedy
            steps. (d) `tests/golden/recurrent_drift.npz` (a trained d 128 x
            2 checkpoint) through `utils/convert.py`: the held-out
            perplexity of the parallel model and of the distilled recurrence
            on the card within 1e-3 relative. (e) `icl_cli --mode
            soft_prompting` from that checkpoint, 32 steps on a synthetic
            k-shot set: every step launches A, B, A' and C once per layer,
            the evaluation A and B, and the loss falls (the mean of the
            last 8 below the first 8). It prints both decoders' tokens per
            second, the prefill and distill seconds and every part's
            launches.
8. downstream  the data layer's downstream paths at the shipped configs'
            width (d_model 128, 2 layers, d_inner 512, bf16 with a float32
            residual), on phase 6's genome and checkpoint and data made from
            a seed. (a) `HG38Dataset` on the valid split at 1024 and 32768
            with shift and rc augmentation: the fused C++ fetch
            (`data/native.py`) taken, its ids equal to the Python path's for
            every window, each path's windows/s (phase 6's pretraining must
            take the native path too). (b) `experiment=hg38/chromatin_profile`
            as shipped (919 labels, batch 64, 1000-base windows) from phase
            6's checkpoint, on hg19 coordinate CSVs (label 0 GC content above
            0.5, the rest sparse noise) lifted through a synthetic chain
            (a gap, a '-' strand chain, unmapped stretches): the kept rows
            and the saved hg38 CSVs equal the plain lookup's, the val and
            test `auroc_macro` / `auroc_median` in [0, 1], the loss falls,
            A, A', B and C twice a step, the first 3 losses card against CPU
            within 5e-3. (c) `experiment=hg38/species_seqlen_warmup_reload`
            on five synthetic species (one gzipped chromosome set): its six
            stages 128 x 1024 ... 4 x 32768 one epoch each, each stage's
            batch shape and step count, the last at fft 2^16, the launches
            per step of the checkpointed cells (A 4, A' 2, B 2, C 2), median
            step ms and peak GiB a stage. (d) `experiment=hg38/
            species_classification` from scratch, 64 steps of 32 x 1024,
            with (b)'s checks but the liftover and AUROC ones.
9. models    the model layer at the shipped configs' width (bf16 with a float32
            residual), on phase 6's genome and GenomicBenchmarks data. (a)
            `experiment=hg38/hg38_attention` as shipped (d_model 128, 2
            layers of 8-head MHA, 1024 learned positions, batch 256 x 1023),
            48 steps (4 epochs of 12: the synthetic train split holds 13
            batches): no kernel launched, the loss falls; the median step
            ms, peak GiB, and one more step under `torch.profiler` with
            SDPA's share of its device time; then the first 3 losses with
            dropout off at batch 32, card against CPU within 5e-3. (b)
            `experiment=hg38/genomic_benchmark_attention` as shipped, one
            epoch: test accuracy above 0.5. (c) `experiment=hg38/hg38_hyena`
            with MHA at layer 1 (8 heads, 1024 positions), 16 steps: A, A',
            B and C once a step, the loss falls, the first 3 losses card vs
            CPU. (d) `HyenaOperator(order=3)` at d_model 256, 4 x 32768
            bf16 (fft 2^16), one head (`_tail_3d`) then two
            (`_tail_generic`): forward and backward, B and C twice each, A
            and A' never, output, input gradient and the filter bank's
            parameter gradients against the same operator with plain convs
            on the card (1e-2 / 2e-2 / 1e-3 of max);
            then `num_blocks=2` (`fftconv_aliased`, no launch) in float32 at
            4 x 8192 against the CPU (1e-4). (e) `SequenceModel` (long-conv,
            ff, mha) as an LM and `AdaptiveLMModel` with `AdaptiveLMTask`,
            16 AdamW steps each at d_model 128 on 16 x 1024 windows, float32:
            the loss falls, no launch, the first loss card vs CPU within
            1e-4 relative.
10. parallel data and sequence parallelism (`hyena_dna_tpu_torch/parallel/`,
            `ops/distributed.py`) on the one card: 4 ranks spawned after the
            build (one card, so the backend rule gives gloo; its rank 0
            prints the backend and the rank-to-device map), with no
            collective staged through host memory (gloo takes the card's
            tensors in every collective the port issues). (a) `seq_fftconv`
            and `seq_short_conv` on each rank's columns of a seeded 1 x 256 x
            450,000 bf16 operand (fft 2^20, channel pencils 1 x 64 x 450,000)
            against kernels B and C on the whole tensor in one process: y, du,
            and dk, dD on the rank's channel rows (zero elsewhere), each
            bit-equal or within the bf16 kernel tolerance (which one is
            printed); the halo conv on 1 x 768 x 450,000 bit-equal to
            `short_conv_1d`; B and C once and four all-to-alls a rank; each
            all-to-all's ms and bytes. (b) `experiment=hg38/hg38_medium_450k`
            as shipped on its seq 4 mesh (d 256 x 8, batch 1, L 450,000, bf16,
            float32 residual, mixer and MLP checkpoint cells), phase 6's
            genome, 3 steps, `accumulate_grad_batches` 2 (8 shipped), warmup
            0: losses finite, equal on every rank, the last below the first;
            B and C 8 times a micro-step on every rank and nothing else; the
            step and micro-step ms, tokens/s, each rank's peak GiB; the
            card is synchronised before each collective in (b) and (d), and
            a step's host seconds inside the collectives and waiting for the
            card before them are printed apart, each with its share of the
            step. (c) the same
            model with dropout off, one micro-step on a seeded 1 x 450,000
            row: the 4 ranks' loss and every all-reduced gradient against one
            process on the card (mesh 1, the fused route), loss 5e-3
            relative, gradients 5e-2 of each max|g|. (d)
            `experiment=hg38/hg38_large_1m` on a data 2 x seq 2 mesh (2 x 8
            shipped), max_length 131,073, batch 2 (a row a data rank),
            `accumulate_grad_batches` 1, the curriculum off, 3 steps: (b)'s
            checks.
11. tensor  tensor parallelism, the mesh's model axis
            (`parallel/sharding.py`, `ops/distributed.py`'s TP
            collectives), 4 ranks on the one card over gloo, phase 6's
            genome. (a) kernels A and A' on a rank's channel slice: u 4 x
            32768 x 256 (d_in) onto W (256, 3 d_c) at d_c 128 and 64 (a
            model axis of 2 and of 4), float32 and bf16, against their plain
            versions at TOL, with ms, bound and library (cuBLAS + cuDNN
            depthwise conv + gate) times; B and C on 11b's 1 x 64 x 131,072
            bf16 slice. (b) `experiment=hg38/hg38_large_1m_singlechip` at
            full width (d 256 x 8, d_inner 1024, order-2 Hyena, bf16,
            float32 residual, residual cells g 2) on `mesh.model=4`, cut:
            max_length 1,000,446 -> 131,073, batch 1, `accumulate_grad_batches`
            8 -> 1, warmup 1000 -> 0, 2 steps, one val and one test batch:
            losses finite, equal on every rank, the last below the first; A
            20, A', B and C 8 a step on every rank at the slice shapes (1 x
            131,072 x 256 -> 64 a chunk) and nothing else; step ms, tokens/s,
            peak GiB a rank, a step's host seconds inside the collectives and
            waiting for the card before them. (c) its model, dropout off, one
            micro-step on a seeded 1 x 131,072 row: the ranks' loss and every
            gathered whole gradient against one process on the card (mesh 1),
            loss 5e-3 relative, gradients 5e-2 of each max|g|. (d)
            `experiment=hg38/hg38_large_1m` on seq 2 x model 2 (data 2 x seq
            8 shipped), 131,073 tokens, batch 1, the curriculum off: (c)'s
            check, B and C 8 a micro-step on every rank.
12. mesh_rest  the mesh combinations the seq and model axes took last,
            4 ranks on the one card over gloo, phase 6's genome. (a) kernels
            A4 and A4' on a rank's channel slice: u 1 x 131,072 x 256 onto
            W (256, 3 d_c) at d_c 128 and 64, float32 and bf16, the 4-D plan
            (16, 128, 128), against their plain versions at TOL (A4's tail
            exactly zero), with ms, bound and library times. (b)
            `experiment=hg38/hg38_large_1m_singlechip model.layer.front4=true`
            on `mesh.model=4` at phase 11's cut (131,073, batch 1), 2 steps:
            losses finite, equal on every rank and falling; A4 20, A4', B and
            C 8 a step on every rank and nothing else; then one micro-step,
            dropout off, against one process (phase 11c's check). (c)
            `experiment=hg38/species_classification` (d 128, 2 layers, pool
            head) at max_length 131,072 on `mesh.seq=4`, batch 4 (32 shipped),
            on human and mouse genomes of 140,000-base chromosomes made from
            a seed: 2 steps (losses finite and equal on every rank, not
            asked to fall: the shipped warm-up keeps the lr near 1e-6; B and
            C twice a step, the sequence-sharded route), an evaluation
            (loss and accuracy finite and the same on every rank), and a
            micro-step against one process. (d)
            `experiment=hg38/hg38_attention` (8 heads, learned positions) at
            max_length 8,193 on data 2 x seq 2, batch 4, attention dropout
            off, `last_k_ppl` 1024: 2 steps (no kernel), an evaluation (loss
            and `last_k_ppl` finite and the same on every rank), and a
            micro-step against one process. (e) phase 9d's order-3 operator (d 256, bf16)
            with two heads, `post_order_ffn` and `outer_mixing` on the model
            pairs of data 2 x model 2 at 1 x 32768: each rank one head, B and C
            twice, y, du and every gathered gradient against the operator
            whole on the card (1e-2 / 2e-2 / 5e-2 of max).
Launch counts are zeroed just before this slice's path in phase 2 and
before each request of phases 4 and 5, each run of phases 6, 8 and 9 and
each part of phases 7 and 9, and read just after it; in phases 10-12 on
each rank before each of its runs.

It then prints the whole run's seconds, the card's name and power limit,
one JSON line
{"kernels": [...]} with each kernel's launches on those paths, its error,
times and bound at the main paths' 4 x 32768 shape (kernels A and A' in
float32, with their bf16 numbers under "bf16"; kernels E and E' on the
specv route, the gated step's; A4 and A4' at the 1M step's shape; every
row of B, C, E, E', A4, A4', F and F' under "routes"; A, A', B and C
at the trainer's shapes under "trainer" and at the species curriculum's
last stage (4 x 32768 x 128 bf16, fft 2^16) under "species"; B and C on
their short path (the trainer's shape and the curriculum's first three
stages) under "short"; phase 9's
launches (9c's mixed stack and 9d's general Hyena path) under
"models_launches"; B and C at phase 10's channel pencils (and at
`hg38_large_1m` stage 3's 1 x 32 x 262,144 on seq 8) with the ranks'
launches under "parallel"; A, A', B and C at phase 11's channel slices
with the ranks' launches under "tensor_parallel"; A4 and A4' at phase
12a's channel slices and every kernel's launches in phase 12 under
"mesh_rest"; the bf16 rows of A and
A'; A, A', A4, A4', F and F' with their tensor-core kernels' ptxas
readings, B, C, E and E' with their passes' readings), and last
{"ok": true, "device": {...}}. Times come from CUDA events around repeated
launches after a warm-up. `bound_ms` is the larger of the bytes the function
must move (inputs read once, outputs written once) at 3.35 TB/s and its
operations at 67 TFLOP/s for float32 inputs or at the bf16 tensor cores'
989 TFLOP/s for bf16 inputs and for the bf16 products of F and F' (H100
SXM data sheet), the least time the card could take. Kernels A, A', A4 and
A4' run every product on the tensor cores: for float32 u a float32-accurate
product is counted as three bf16 products (FRONT_PRODUCTS) and their
float32 rows also carry the CUDA-core bound, `cuda_core_bound_ms`.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import gzip
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense tensor-core rate: the least time for bf16-input products
D_MODEL, N_LAYER = 256, 8
LN_EPS = 1e-5

# Kernel vs plain: |kernel - plain| <= ATOL_FRAC * max|plain| + RTOL * |plain|.
# float32: both sum in float32 in other orders (a 256-term dot product for
# kernel A, a 2^21-point transform for kernel B). bfloat16 I/O: both round
# a float32 result once, so an element may land one bf16 step (2^-8) apart.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 2 ** -7)}
# Card vs CPU logits of the whole model, 8 layers deep: float32, and bf16
# conv I/O (roundings that flip between the two sides compound per layer).
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# Card vs CPU gradients of the whole model, each parameter's |error| against
# its own max |g|: float32 sums over up to 2^15 rows per parameter in other
# orders; bf16 conv I/O adds per-layer roundings that may flip by one bf16
# step (2^-8) on either side, over 8 layers forward and back. Loss: relative.
GRAD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# The bf16 model (bfloat16 activations and residual), card vs CPU: logits at
# the JAX package's own bf16 model tolerance (tests/test_pallas_ln.py, 5e-2),
# taken against max(1, max|logit|). Gradients: every activation and
# cotangent rounds to bf16 on both sides (cuBLAS and the CPU sum bf16
# products in other orders), so an element may land a bf16 step (2^-8)
# apart at each of ~10 roundings per layer, over 8 layers forward and back:
# each parameter within 5e-2 of its max |g|. Loss: float32 from bf16
# logits, which may differ by a step.
MODEL_BF16 = {"logits": 5e-2, "grads": 5e-2, "loss": 5e-3}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, budget_ms: float = 400.0) -> float:
    """Mean time of one call, from CUDA events around repeated calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(out, ref, dtype: str):
    """(max abs err, max rel err); raise if outside TOL[dtype]."""
    atol_frac, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    scale = ref.abs().max().item()
    ok = bool((err <= atol_frac * scale + rtol * ref.abs()).all())
    max_abs = err.max().item()
    max_rel = max_abs / max(scale, 1e-30)
    if not ok or not math.isfinite(max_abs):
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{max_abs:.3e} (max |plain| {scale:.3e}, tol {TOL[dtype]})")
    return max_abs, max_rel


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# bf16 products per matrix product of kernels A, A', A4, A4': the least
# time for a float32-accurate product on the tensor cores is three bf16 pair
# products (csrc/fused_front_tc.cuh's split), whatever the kernel issues
FRONT_PRODUCTS = {"float32": 3, "bfloat16": 1}


def front_bound(nbytes: float, product_flops: float, other_flops: float, dtype: str) -> dict:
    """`bound_ms`, `bound_by` of a front-end kernel at the tensor cores' rate
    (FRONT_PRODUCTS), and for float32 u the CUDA-core bound beside them."""
    ms, by = bound(nbytes, FRONT_PRODUCTS[dtype] * product_flops + other_flops, BF16_FLOPS)
    out = {"bound_ms": ms, "bound_by": by}
    if dtype == "float32":
        out["cuda_core_bound_ms"] = bound(nbytes, product_flops + other_flops)[0]
    return out


def front_inputs(B, L, dtype, seed, d=D_MODEL, d_c=None):
    """u (B, L, d) in `dtype`, float32 parameters at the model's init
    scales for a chunk width d_c (default d; a tensor-parallel rank's
    d / M)."""
    import torch

    d_c = d_c or d
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(B, L, d, device="cuda", generator=g).to(getattr(torch, dtype))
    w = torch.randn(d, 3 * d_c, device="cuda", generator=g) * 0.02
    bp = torch.randn(3 * d_c, device="cuda", generator=g) * 0.02
    wc = (torch.rand(3, 3 * d_c, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    bc = (torch.rand(3 * d_c, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)
    return g, (u, w, bp, wc, bc)


def front_shape(B, L, d, d_c, dtype) -> str:
    """A front-end row's shape: d, or d_in and d_c for a channel slice."""
    return (f"B={B} L={L} d={d} {dtype}" if d_c == d
            else f"B={B} L={L} d_in={d} d_c={d_c} {dtype}")


def check_wgmma(probe, b_cols: int, phase: str, seed: int):
    """`csrc/wgmma.cuh` alone, through one library's test entry (kernel A's
    `hyena_front_wgmma_probe`, b 64 x 64; kernel F's `hyena_mlp_wgmma_probe`,
    b 64 x 256): each product form its kernels use against a float32 matmul
    of the same bf16 values (exact products, 64-term sums in another order:
    1e-5 relative)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for mode, n in probe.PROBE_MODES.items():
        a = torch.randn(64, 64, device="cuda", generator=g).to(torch.bfloat16)
        b = torch.randn(64, b_cols, device="cuda", generator=g).to(torch.bfloat16)
        ref = a.float() @ b.float()[:, :n]
        err = (probe.wgmma_probe(a, b, mode) - ref).abs().max().item()
        if not err <= 1e-5 * ref.abs().max().item():
            raise AssertionError(f"{phase} mode {mode} (N={n}) disagrees with matmul: {err:.3e}")
        errs[mode] = err
    return {"phase": phase, "max_abs_err": errs, "ok": True}


# the kernels whose ptxas readings the run prints: the tensor-core kernels
# behind each front-end entry (csrc/fused_front_tc.cuh; each kernel per u
# type and panel count, `<f32,4>` and `<bf16,4>` at d = 256) and behind
# kernels F and F' (csrc/mlp_fused*.cu), with their helper kernels, the
# passes of kernels B, C, E and E' (csrc/fftconv{,_bwd}.cu,
# csrc/fftconv_gated{,_bwd}.cu), and the short path's kernels of B and C
# (csrc/fft_short.cuh)
PTXAS_KERNELS = {"fused_front": ("split_w_kernel", "front_fwd_tc_kernel"),
                 "fused_front4": ("split_w_kernel", "front_fwd_tc_kernel"),
                 "fused_front_bwd": ("split_w_kernel", "front_bwd_du_kernel", "front_bwd_dw_kernel",
                                     "front_bwd_sum_kernel"),
                 "fused_front4_bwd": ("split_w_kernel", "front_bwd_du_kernel",
                                      "front_bwd_dw_kernel", "front_bwd_sum_kernel"),
                 "mlp_fused": ("mlp_fwd_kernel", "round_bf16_kernel"),
                 "mlp_fused_bwd": ("mlp_bwd_rows_kernel", "mlp_bwd_weights_kernel",
                                   "sum_splits_kernel", "round_bf16_kernel"),
                 "fftconv": ("cols_fwd_kernel", "rows_fwd_kernel", "rows_conv_kernel",
                             "cols_inv_kernel", "short_kspec_kernel", "short_conv_kernel"),
                 "fftconv_bwd": ("cols_in_kernel", "rows_fwd_kernel", "rows_grad_kernel",
                                 "rows_grad_cluster_kernel", "cols_inv_kernel",
                                 "short_kspec_kernel", "short_grad_kernel", "short_dk_kernel"),
                 "fftconv_gated": ("cols_in_delta_kernel", "cols_in_kernel", "rows_fwd_kernel",
                                   "rows_conv_kernel", "cols_inv_gate_kernel"),
                 "fftconv_gated_bwd": ("cols_in_delta_kernel", "cols_in_kernel",
                                       "cols_in_dv_kernel", "rows_fwd_kernel", "rows_conv_kernel",
                                       "cols_inv_dx0_kernel", "rows_grad_kernel",
                                       "rows_grad_cluster_kernel", "cols_inv_kernel")}


def ptxas_readings(build_log, function: str) -> dict:
    """ptxas's readings (`-Xptxas -v`) in one library's nvcc output for the
    kernels whose mangled name contains `function`: {name: {"registers",
    "stack", "spill_stores", "spill_loads"}}; {} for no output."""
    out, name = {}, None
    for line in (build_log or "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or function not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(zip(("stack", "spill_stores", "spill_loads"),
                                                map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_ptxas(kernels) -> dict:
    """{library name: {kernel: ptxas readings}} for the kernels of
    PTXAS_KERNELS, from the libraries' build logs (this run's build, or the
    log kept beside a library built before); a kernel instantiated per
    panel count (or FFT radix class: 16, 8, 0 for any size) is keyed
    `name<panels>`, per output type too `name<bf16,panels>` or
    `name<f32,panels>` (d = 256 runs `<4>`), and kernel C's row passes
    that keep dk's batch sum (B > 1) `name<radix,sum>`."""
    out = {}
    for k in kernels:
        for fn in PTXAS_KERNELS.get(k.name, ()):
            for mangled, reading in ptxas_readings(k.build_log, fn).items():
                inst = re.search(fn + r"I(13__nv_bfloat16|f)?Li(\d+)E(?:Lb([01])E)?", mangled)
                dtype = {"13__nv_bfloat16": "bf16,", "f": "f32,"}.get(inst and inst.group(1), "")
                total = ",sum" if inst and inst.group(3) == "1" else ""
                key = f"{fn}<{dtype}{inst.group(2)}{total}>" if inst else fn
                out.setdefault(k.name, {})[key] = reading
    return out


def check_front(FF, B, L, seed, dtype="float32", d=D_MODEL, d_c=None):
    """Kernel A against `reference_fwd` (float32 arithmetic on u's values;
    bf16 u: vx and x0 rounded once, see ops/fused_front.py); d_c: the
    chunk width of a tensor-parallel rank's slice (default d)."""
    import torch
    import torch.nn.functional as F

    d_c = d_c or d
    _, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed, d, d_c)
    vx, x0 = FF.fused_proj_conv_gate(u, w, bp, wc, bc)
    torch.cuda.synchronize()
    vx_ref, x0_ref = FF.reference_fwd(u, w, bp, wc, bc)
    err = [compare(vx, vx_ref, dtype), compare(x0, x0_ref, dtype)]
    conv_w = wc.t().contiguous()[:, None, :].to(u.dtype)
    lw, lbp, lbc = w.to(u.dtype), bp.to(u.dtype), bc.to(u.dtype)

    def library():  # torch.matmul + cuDNN depthwise conv1d + gate, in u's dtype
        proj = torch.matmul(u, lw) + lbp
        conv = F.conv1d(proj.transpose(1, 2), conv_w, lbc, padding=2,
                        groups=3 * d_c)[..., :L]
        return conv[:, 2 * d_c:] * conv[:, d_c:2 * d_c], conv[:, :d_c]

    size = u.element_size()
    nbytes = size * (B * L * d + 2 * B * d_c * L) + 4 * (d * 3 * d_c + 3 * 3 * d_c + 2 * 3 * d_c)
    return {"name": "fused_front", "shape": front_shape(B, L, d, d_c, dtype),
            "max_abs_err": max(e[0] for e in err), "max_rel_err": max(e[1] for e in err),
            "ms": time_ms(lambda: FF.fused_proj_conv_gate(u, w, bp, wc, bc)),
            "plain_ms": time_ms(lambda: FF.reference_fwd(u, w, bp, wc, bc)),
            "library_ms": time_ms(library),
            **front_bound(nbytes, B * L * 2 * d * 3 * d_c, B * L * (3 * d_c * 7 + d_c), dtype)}


def check_conv(FB, B, L, dtype, route, seed, entry=None, plan=(), C=D_MODEL):
    """Kernel B through `entry` (a named TPU-row entry with its plan, on
    operands padded to L; by default the generic `fftconv_fused`) against
    `fftconv_ref`, and a second call the same bits."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    n = next_fast_fft_size(2 * L)
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    D = torch.randn(C, device="cuda", generator=g)
    entry = entry or FB.fftconv_fused
    y = entry(u, k, D, *plan)
    torch.cuda.synchronize()
    max_abs, max_rel = compare(y, fftconv_ref(u, k, D), dtype)
    if not torch.equal(entry(u, k, D, *plan), y):
        raise AssertionError(f"kernel B: a second call at B={B} C={C} L={L} gave other bits")
    uf, kf = u.float(), k.float()

    def library():  # cuFFT through torch.fft
        return torch.fft.irfft(torch.fft.rfft(uf, n=n) * torch.fft.rfft(kf, n=n), n=n)

    size = u.element_size()
    nbytes = size * (2 * B * C * L + C * L) + 4 * C
    log_n = int(math.log2(n))
    flops = B * C * (5 * n * log_n + 3 * n + 2 * L) + C * 2.5 * n * log_n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "entry": entry.__name__, "plan": list(plan),
            "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": time_ms(lambda: entry(u, k, D, *plan)),
            "plain_ms": time_ms(lambda: fftconv_ref(u, k, D)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_front_bwd(FF, B, L, seed, dtype="float32", d=D_MODEL, d_c=None):
    """Kernel A' against `reference_bwd` (du in u's dtype, the parameter
    gradients float32); d_c as `check_front`'s (du is then the rank's
    partial sum)."""
    import torch
    import torch.nn.functional as F

    d_c = d_c or d
    g, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed, d, d_c)
    dvx = torch.randn(B, d_c, L, device="cuda", generator=g).to(u.dtype)
    dx0 = torch.randn(B, d_c, L, device="cuda", generator=g).to(u.dtype)
    args = (u, w, bp, wc, bc, dvx, dx0)
    out = FF.front_bwd(*args)
    torch.cuda.synchronize()
    ref = FF.reference_bwd(*args)
    errs = {name: compare(o, r, dtype if name == "du" else "float32")
            for name, o, r in zip(("du", "dw", "dbp", "dwc", "dbc"), out, ref)}
    leaves = [t.detach().clone().to(u.dtype).requires_grad_() for t in (u, w, bp)]
    conv_w = wc.t().contiguous()[:, None, :].to(u.dtype).requires_grad_()
    conv_b = bc.detach().clone().to(u.dtype).requires_grad_()

    def library():  # autograd through torch.matmul + cuDNN depthwise conv1d + gate
        lu, lw, lbp = leaves
        with torch.enable_grad():
            proj = torch.matmul(lu, lw) + lbp
            conv = F.conv1d(proj.transpose(1, 2), conv_w, conv_b, padding=2,
                            groups=3 * d_c)[..., :L]
            outs = (conv[:, 2 * d_c:] * conv[:, d_c:2 * d_c], conv[:, :d_c])
            return torch.autograd.grad(outs, leaves + [conv_w, conv_b], (dvx, dx0))

    size = u.element_size()
    nbytes = (size * (2 * B * L * d + 2 * B * d_c * L)
              + 4 * (2 * d * 3 * d_c + 11 * 3 * d_c))
    return {"name": "fused_front_bwd", "shape": front_shape(B, L, d, d_c, dtype),
            "route": "pallas_hyena.py:395", "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: FF.front_bwd(*args)),
            "plain_ms": time_ms(lambda: FF.reference_bwd(*args)),
            "library_ms": time_ms(library),
            **front_bound(nbytes, 3 * 2 * B * L * d * 3 * d_c, B * L * 3 * d_c * 16, dtype)}


def front4_plan(L, plan):
    """(rows_pad, m, tile_l) of the HyenaOperator 4-D route for (L, plan)."""
    from hyena_dna_tpu_torch.models.hyena import front4_tile

    n1, r, m = plan
    rows = (n1 // 2) * r
    return rows, m, front4_tile(L, rows * m, m)


def front4_library(u, w, bp, wc, bc, rows, m):
    """torch.matmul + cuDNN depthwise conv1d + gate + zero pad, in u's dtype:
    the one-call-each yardstick of kernel A4 (W (d_in, 3 d))."""
    import torch
    import torch.nn.functional as F

    b, L = u.shape[:2]
    d = w.shape[1] // 3
    proj = torch.matmul(u, w.to(u.dtype)) + bp.to(u.dtype)
    conv = F.conv1d(proj.transpose(1, 2), wc.t().contiguous()[:, None, :].to(u.dtype),
                    bc.to(u.dtype), padding=2, groups=3 * d)[..., :L]
    pad = lambda t: F.pad(t, (0, rows * m - L)).reshape(b, d, rows, m)
    return pad(conv[:, 2 * d:] * conv[:, d:2 * d]), pad(conv[:, :d])


def check_front4(FF, B, L, plan, dtype, seed, d_c=None):
    """Kernel A4 against `reference_fwd4` (kernel A's tolerance); the tail
    past L must be exactly zero; d_c as `check_front`'s (a rank's W (d,
    3 d_c))."""
    import torch

    d = D_MODEL
    d_c = d_c or d
    rows, m, tile = front4_plan(L, plan)
    _, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed, d, d_c)
    vx4, x04 = FF.fused_proj_conv_gate4(u, w, bp, wc, bc, rows, m, tile)
    torch.cuda.synchronize()
    vx_ref, x0_ref = FF.reference_fwd4(u, w, bp, wc, bc, rows, m)
    err = [compare(vx4, vx_ref, dtype), compare(x04, x0_ref, dtype)]
    tail = max(int(torch.count_nonzero(t.reshape(B, d_c, -1)[..., L:])) for t in (vx4, x04))
    if tail:
        raise AssertionError(f"kernel A4 left {tail} nonzero values past L={L}")
    size, lp = u.element_size(), rows * m
    nbytes = (size * (B * L * d + 2 * B * d_c * lp)
              + 4 * (d * 3 * d_c + 3 * 3 * d_c + 2 * 3 * d_c))
    return {"name": "fused_front4", "shape": front_shape(B, L, d, d_c, dtype),
            "plan": list(plan), "rows_pad": rows, "m": m, "tile_l": tile, "tail_nonzero": tail,
            "route": "pallas_hyena.py:197",
            "max_abs_err": max(e[0] for e in err), "max_rel_err": max(e[1] for e in err),
            "ms": time_ms(lambda: FF.fused_proj_conv_gate4(u, w, bp, wc, bc, rows, m, tile)),
            "plain_ms": time_ms(lambda: FF.reference_fwd4(u, w, bp, wc, bc, rows, m)),
            "library_ms": time_ms(lambda: front4_library(u, w, bp, wc, bc, rows, m)),
            **front_bound(nbytes, B * L * 2 * d * 3 * d_c, B * L * (3 * d_c * 7 + d_c), dtype)}


def check_front4_bwd(FF, B, L, plan, dtype, seed, d_c=None):
    """Kernel A4' against `reference_bwd4`, with cotangents that are random
    in the tail too (both must ignore it); d_c as `check_front4`'s (du is
    then the rank's partial sum)."""
    import torch

    d = D_MODEL
    d_c = d_c or d
    rows, m, tile = front4_plan(L, plan)
    g, (u, w, bp, wc, bc) = front_inputs(B, L, dtype, seed, d, d_c)
    dvx4 = torch.randn(B, d_c, rows, m, device="cuda", generator=g).to(u.dtype)
    dx04 = torch.randn(B, d_c, rows, m, device="cuda", generator=g).to(u.dtype)
    args = (u, w, bp, wc, bc, dvx4, dx04)
    out = FF.front4_bwd(*args)
    torch.cuda.synchronize()
    ref = FF.reference_bwd4(*args)
    errs = {name: compare(o, r, dtype if name == "du" else "float32")
            for name, o, r in zip(("du", "dw", "dbp", "dwc", "dbc"), out, ref)}
    leaves = [t.detach().clone().requires_grad_() for t in (u, w, bp, wc, bc)]

    def library():  # autograd through front4_library
        with torch.enable_grad():
            return torch.autograd.grad(front4_library(*leaves, rows, m), leaves, (dvx4, dx04))

    size = u.element_size()
    nbytes = (size * (2 * B * L * d + 2 * B * d_c * L)
              + 4 * (2 * d * 3 * d_c + 11 * 3 * d_c))
    return {"name": "fused_front4_bwd", "shape": front_shape(B, L, d, d_c, dtype),
            "plan": list(plan), "route": "pallas_hyena.py:448",
            "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: FF.front4_bwd(*args)),
            "plain_ms": time_ms(lambda: FF.reference_bwd4(*args)),
            "library_ms": time_ms(library),
            **front_bound(nbytes, 3 * 2 * B * L * d * 3 * d_c, B * L * 3 * d_c * 16, dtype)}


def check_outer4(FB, B, L, plan, dtype, seed):
    """The 4-D conv entries against the flat kernel B / C calls: on the same
    padded (B, C, lp) operands the same bits (the same kernels on the same
    data), and on the unpadded (B, C, L) ones within kernel B's tolerance."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    n1, r, m = plan
    rows, C, dt = (n1 // 2) * r, D_MODEL, getattr(torch, dtype)
    lp = rows * m
    pad = lambda t: torch.nn.functional.pad(t, (0, lp - L))
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    dy = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    D = torch.randn(C, device="cuda", generator=g)
    u4, dy4, k4 = (pad(t).reshape(*t.shape[:-1], rows, m) for t in (u, dy, k))
    y4 = FB.fftconv_outer_fwd4(u4, k4, D, *plan)
    grads4 = FB.fftconv_outer_bwd4(u4, dy4, k4, D, *plan)
    flat = [FB.fftconv_fused(pad(u), pad(k), D),
            *FB.fftconv_bwd_retransform(pad(u), pad(dy), pad(k), D)]
    torch.cuda.synchronize()
    same = [torch.equal(a.reshape(b.shape), b) for a, b in zip((y4, *grads4), flat)]
    if not all(same):
        raise AssertionError(f"4-D conv entries differ from the flat calls: {same}")
    y, du, dk, dD = (FB.fftconv_fused(u, k, D), *FB.fftconv_bwd_retransform(u, dy, k, D))
    cut = lambda t: t.reshape(*t.shape[:-2], lp)[..., :L]
    errs = {"y": compare(cut(y4), y, dtype), "du": compare(cut(grads4[0]), du, dtype),
            "dk": compare(cut(grads4[1]), dk, dtype), "dD": compare(grads4[2], dD, "float32")}
    return {"phase": "outer4", "shape": f"B={B} C={C} L={L} lp={lp} {dtype}", "plan": list(plan),
            "bit_equal_padded": same, "vs_unpadded_max_abs_err": {k_: v[0] for k_, v in errs.items()},
            "fwd4_ms": time_ms(lambda: FB.fftconv_outer_fwd4(u4, k4, D, *plan)),
            "flat_fwd_ms": time_ms(lambda: FB.fftconv_fused(u, k, D)),
            "bwd4_ms": time_ms(lambda: FB.fftconv_outer_bwd4(u4, dy4, k4, D, *plan)),
            "flat_bwd_ms": time_ms(lambda: FB.fftconv_bwd_retransform(u, dy, k, D)),
            "ok": True}


def card_pair(build_model, cross_entropy, kernels, B, L, seed, base, other, label):
    """The bf16 model (float32 residual, as the long-context config) on the
    card in two settings of `remat_kwargs` with the same weights, the same
    batch and the same dropout generator seed (training mode): logits and
    every gradient, the tied embedding's included, the same bits
    (checkpointing and the 4-D route only change what is stored; every port
    kernel sums in a fixed order, and the one-hot token lookup's backward is
    a cuBLAS product). `base` runs twice, and its repeat must give the same
    bits too."""
    import torch

    runs = []
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L + 1)).astype(np.int64)).cuda()
    state = None
    for kw in (base, other, base):
        model = build_model(D_MODEL, N_LAYER, L, generator=torch.Generator().manual_seed(seed),
                            dtype=torch.bfloat16, residual_in_fp32=True,
                            **remat_kwargs(*kw)).cuda().train()
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        logits = model(tokens[:, :-1], generator=torch.Generator("cuda").manual_seed(seed))
        cross_entropy(logits, tokens[:, 1:]).backward()
        torch.cuda.synchronize()
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        runs.append((logits.detach().float(), {n: p.grad for n, p in model.named_parameters()},
                     launches, torch.cuda.max_memory_allocated() / 2 ** 30))
        del model, logits
        torch.cuda.empty_cache()

    def diff(a, b):  # (logit err, worst grad err over its max, its name, unequal params)
        (la, ga, _, _), (lb, gb, _, _) = a, b
        errs = {n: ((ga[n] - gb[n]).abs().max() / ga[n].abs().max().clamp_min(1e-30)).item()
                for n in ga}
        name = max(errs, key=errs.get)
        return ((la - lb).abs().max().item() / max(la.abs().max().item(), 1e-30), errs[name],
                name, sum(not torch.equal(ga[n], gb[n]) for n in ga) + (not torch.equal(la, lb)))

    logit_err, worst, worst_name, unequal = diff(runs[0], runs[1])
    rep_logit, rep_worst, rep_name, rep_unequal = diff(runs[0], runs[2])
    launches = [r[2] for r in runs]
    expect = [expected_launches("bf16", 1, None, *kw, residual="fp32")
              for kw in (base, other, base)]
    ok = unequal == 0 and rep_unequal == 0 and launches == expect
    log({"phase": "grad_parity", "label": label, "B": B, "L": L, "precision": "bf16",
         "residual": "fp32", "base": list(base), "other": list(other),
         "logits_err_over_max": logit_err, "worst_grad_err_over_max": worst,
         "worst_param": worst_name, "tol": "equal bits", "unequal_tensors": unequal,
         "repeat_logits_err_over_max": rep_logit, "repeat_worst_grad_err_over_max": rep_worst,
         "repeat_worst_param": rep_name, "repeat_unequal_tensors": rep_unequal,
         "launches": launches[:2], "peak_gib": [r[3] for r in runs[:2]], "ok": ok})
    if not ok:
        raise AssertionError(f"{label}: {other} disagrees with {base} on the card")


def check_add_ln(AL, B, L, seed):
    """Kernels D and D' against `add_ln_ref` and `add_ln_bwd_ref` on the bf16
    model's B*L rows of d: res_out must be the same bits (one rounding on
    both sides), y and d_total within one bf16 step, dscale and dbias float32
    sums over the rows in another order. Returns the two kernels' rows."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d, bf = B * L, D_MODEL, torch.bfloat16
    h = torch.randn(n, d, device="cuda", generator=g).to(bf)
    r = (torch.randn(n, d, device="cuda", generator=g) * 3).to(bf)
    w = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    b = 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(n, d, device="cuda", generator=g).to(bf)
    dup = torch.randn(n, d, device="cuda", generator=g).to(bf)
    y, ro = AL.add_ln_fwd(h, r, w, b, LN_EPS)
    torch.cuda.synchronize()
    y_ref, ro_ref = AL.add_ln_ref(h, r, w, b, LN_EPS)
    if not torch.equal(ro, ro_ref):
        raise AssertionError("kernel D's res_out differs from the plain rounding")
    fwd_err = [compare(y, y_ref, "bfloat16"), compare(ro, ro_ref, "bfloat16")]
    out = AL.add_ln_bwd(ro, dy, dup, w, LN_EPS)
    torch.cuda.synchronize()
    ref = AL.add_ln_bwd_ref(ro, dy, dup, w, LN_EPS)
    bwd_err = {name: compare(o, rf, "bfloat16" if name == "d_total" else "float32")
               for name, o, rf in zip(("d_total", "dscale", "dbias"), out, ref)}
    lw, lb = w.to(bf), b.to(bf)

    def library_fwd(hh=h, rr=r, ww=lw, bb=lb):  # the add, one rounding, then F.layer_norm
        ro_l = (hh.float() + rr.float()).to(bf)
        return F.layer_norm(ro_l, (d,), ww, bb, LN_EPS), ro_l

    leaves = [t.detach().clone().requires_grad_() for t in (h, r, lw, lb)]

    def library_bwd():  # torch.autograd.grad through library_fwd
        with torch.enable_grad():
            return torch.autograd.grad(library_fwd(*leaves), leaves, (dy, dup))

    shape = f"B={B} L={L} d={d} bfloat16 (N={n} rows)"
    # each direction reads two and writes two bf16 (N, d) tensors: 8 bytes per element
    fwd_bytes, bwd_bytes = 8 * n * d + 8 * d, 8 * n * d + 12 * d
    fb, fby = bound(fwd_bytes, 12 * n * d)
    bb_, bby = bound(bwd_bytes, 16 * n * d)
    return [
        {"name": "add_ln", "shape": shape, "route": "pallas_ln.py:102",
         "max_abs_err": max(e[0] for e in fwd_err), "max_rel_err": max(e[1] for e in fwd_err),
         "ms": time_ms(lambda: AL.add_ln_fwd(h, r, w, b, LN_EPS)),
         "plain_ms": time_ms(lambda: AL.add_ln_ref(h, r, w, b, LN_EPS)),
         "library_ms": time_ms(library_fwd), "bound_ms": fb, "bound_by": fby},
        {"name": "add_ln_bwd", "shape": shape, "route": "pallas_ln.py:130",
         "errors": {k: v[0] for k, v in bwd_err.items()},
         "max_abs_err": max(e[0] for e in bwd_err.values()),
         "max_rel_err": max(e[1] for e in bwd_err.values()),
         "ms": time_ms(lambda: AL.add_ln_bwd(ro, dy, dup, w, LN_EPS)),
         "plain_ms": time_ms(lambda: AL.add_ln_bwd_ref(ro, dy, dup, w, LN_EPS)),
         "library_ms": time_ms(library_bwd), "bound_ms": bb_, "bound_by": bby}]


def check_conv_bwd(FB, entry, B, L, dtype, route, seed, plan=(), C=D_MODEL):
    """Kernel C through one TPU row's entry point, with its plan on operands
    padded to L, against `fftconv_bwd_ref` (du in the I/O dtype, dk in it
    or float32 as the entry returns it, dD float32), and a second call the
    same bits. A spectrum-route entry gets u's spectrum from kernel B's
    `save_spectrum`."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    n = next_fast_fft_size(2 * L)
    u = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    dy = torch.randn(B, C, L, device="cuda", generator=g).to(dt)
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    D = torch.randn(C, device="cuda", generator=g)
    spectrum = getattr(entry, "spectrum", False)  # the TPU row read u's saved spectrum
    x = FB.fftconv_fused(u, k, D, save_spectrum=True)[1] if spectrum else u
    out = entry(x, dy, k, D, *plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(entry(x, dy, k, D, *plan), out)):
        raise AssertionError(f"kernel C: a second call at B={B} C={C} L={L} gave other bits")
    dk_dtype = out[1].dtype
    ref = FB.fftconv_bwd_ref(u, dy, k, D, dk_dtype=dk_dtype)
    errs = {name: compare(o, r, "float32" if o.dtype == torch.float32 else dtype)
            for name, o, r in zip(("du", "dk", "dD"), out, ref)}
    plain_bwd = (FB.fftconv_bwd_spectrum_ref if spectrum
                 else lambda *a: FB.fftconv_bwd_ref(*a, dk_dtype=dk_dtype))
    uf, dyf, kf = u.float(), dy.float(), k.float()

    def library():  # cuFFT through torch.fft
        dy_f = torch.fft.rfft(dyf, n=n)
        du = torch.fft.irfft(dy_f * torch.fft.rfft(kf, n=n).conj(), n=n)[..., :L] + dyf * D[:, None]
        dk = torch.fft.irfft((dy_f * torch.fft.rfft(uf, n=n).conj()).sum(0), n=n)[..., :L]
        return du, dk, (dyf * uf).sum((0, 2))

    size = u.element_size()
    x_bytes = x.numel() * x.element_size()
    nbytes = x_bytes + size * (2 * B * C * L + C * L) + out[1].element_size() * C * L + 8 * C
    log_n = int(math.log2(n))
    transforms = (2 if spectrum else 3) * B * C + 2 * C
    flops = transforms * 2.5 * n * log_n + B * C * 4 * n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_bwd", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "entry": entry.__name__, "plan": list(plan),
            "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: entry(x, dy, k, D, *plan)),
            "plain_ms": time_ms(lambda: plain_bwd(x, dy, k, D)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def gated_inputs(B, L, dtype, seed):
    """u, x0, dy in `dtype`, a decaying filter k, float32 D (C = d_model)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, dt = D_MODEL, getattr(torch, dtype)
    u, x0, dy = (torch.randn(B, C, L, device="cuda", generator=g).to(dt) for _ in range(3))
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).to(dt)
    return u, x0, dy, k, torch.randn(C, device="cuda", generator=g)


def check_gated(GE, B, L, dtype, variant, seed):
    """Kernel E against `fftconv_gated_ref` with one set of outputs: y alone
    ("y"), y, v and u's spectrum ("specv"), or y and the spectrum ("spec")."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    u, x0, _, k, D = gated_inputs(B, L, dtype, seed)
    C, n = D_MODEL, next_fast_fft_size(2 * L)
    save = {"save_v": variant == "specv", "save_spectrum": variant != "y"}
    out = GE.fftconv_gated_fused(u, x0, k, D, **save)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = GE.fftconv_gated_ref(u, x0, k, D, **save)
    ref = ref if isinstance(ref, tuple) else (ref,)
    names = ["y"] + ["v"] * save["save_v"] + ["spectrum"] * save["save_spectrum"]
    errs = {nm: compare(o, r, "float32" if nm == "spectrum" else dtype)
            for nm, o, r in zip(names, out, ref)}
    uf, x0f, kf = u.float(), x0.float(), k.float()

    def library():  # cuFFT through torch.fft, the gate and skip term as elementwise work
        v = torch.fft.irfft(torch.fft.rfft(uf, n=n) * torch.fft.rfft(kf, n=n), n=n)[..., :L]
        v = v + uf * D[:, None]
        return ((v * x0f).to(u.dtype), v.to(u.dtype)) if save["save_v"] else (v * x0f).to(u.dtype)

    size, pairs = u.element_size(), (C + 1) // 2
    nbytes = (size * ((3 + save["save_v"]) * B * C * L + C * L) + 4 * C
              + save["save_spectrum"] * 8 * B * pairs * n)
    log_n = int(math.log2(n))
    flops = B * C * (5 * n * log_n + 3 * n + 3 * L) + C * 2.5 * n * log_n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_gated", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": variant, "errors": {k_: v[0] for k_, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: GE.fftconv_gated_fused(u, x0, k, D, **save)),
            "plain_ms": time_ms(lambda: GE.fftconv_gated_ref(u, x0, k, D, **save)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_gated_bwd(GE, route, B, L, dtype, seed, generic=False):
    """Kernel E' on one route, through the torch entry point of that route's
    TPU kernel (or, `generic`, the route's own wrapper, which takes any
    shape), against the route's plain version (du, dx0, dk in the I/O
    dtype, dD float32). The saved spectrum and v come from kernel E."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    u, x0, dy, k, D = gated_inputs(B, L, dtype, seed)
    C, n = D_MODEL, next_fast_fft_size(2 * L)
    _, v, spec = GE.fftconv_gated_fused(u, x0, k, D, save_v=True, save_spectrum=True)
    saved = {"specv": (spec, v), "spec": (spec,), "retransform": (u,)}[route]
    entry = getattr(GE, f"fftconv_gated_bwd_{route}") if generic else {
        "specv": GE.fftconv_fused_bwd_specv_packed_gated,
        "spec": GE.fftconv_fused_bwd_spec_packed_gated,
        "retransform": GE.fftconv_fused_bwd_packed_gated}[route]
    plain = getattr(GE, f"fftconv_gated_bwd_{route}_ref")
    args = saved + (dy, x0, k, D)
    out = entry(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    errs = {nm: compare(o, r, "float32" if nm == "dD" else dtype)
            for nm, o, r in zip(("du", "dx0", "dk", "dD"), out, ref)}
    uf, x0f, dyf, kf = u.float(), x0.float(), dy.float(), k.float()

    def library():  # cuFFT through torch.fft computing du, dx0, dk, dD from u, x0, dy, k, D
        u_f, k_f = torch.fft.rfft(uf, n=n), torch.fft.rfft(kf, n=n)
        vv = torch.fft.irfft(u_f * k_f, n=n)[..., :L] + uf * D[:, None]
        dv = dyf * x0f
        dv_f = torch.fft.rfft(dv, n=n)
        du = torch.fft.irfft(dv_f * k_f.conj(), n=n)[..., :L] + dv * D[:, None]
        dk = torch.fft.irfft((dv_f * u_f.conj()).sum(0), n=n)[..., :L]
        return du.to(u.dtype), (dyf * vv).to(u.dtype), dk.to(u.dtype), (dv * uf).sum((0, 2))

    size = u.element_size()
    saved_bytes = sum(t.numel() * t.element_size() for t in saved)
    nbytes = saved_bytes + size * (4 * B * C * L + 2 * C * L) + 8 * C
    log_n = int(math.log2(n))
    transforms = {"specv": 2, "spec": 3, "retransform": 4}[route] * B * C + 2 * C
    flops = transforms * 2.5 * n * log_n + B * C * 6 * n
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "fftconv_gated_bwd", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": route, "entry": entry.__name__,
            "errors": {k_: v_[0] for k_, v_ in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: entry(*args)), "plain_ms": time_ms(lambda: plain(*args)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


def check_dk_spec(FB, B, L, dtype, plan, seed):
    """Kernel C's dk-spectrum mode through the JAX `fftconv_fused_dk_spec`
    entry against `fftconv_dk_spec_ref` (both (C, n) float32 re and im, in
    natural frequency order)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, dt = D_MODEL, getattr(torch, dtype)
    n = plan[0] * plan[1]
    u, dy = (torch.randn(B, C, L, device="cuda", generator=g).to(dt) for _ in range(2))
    out = FB.fftconv_fused_dk_spec(u, dy, *plan)
    torch.cuda.synchronize()
    ref = FB.fftconv_dk_spec_ref(u, dy, n)
    errs = {name: compare(o, r, "float32") for name, o, r in zip(("re", "im"), out, ref)}
    uf, dyf = u.float(), dy.float()

    def library():  # cuFFT through torch.fft: the half spectrum holds the same sums
        return (torch.fft.rfft(dyf, n=n) * torch.fft.rfft(uf, n=n).conj()).sum(0)

    log_n = int(math.log2(n))
    nbytes = u.element_size() * 2 * B * C * L + 8 * C * n
    bound_ms, bound_by = bound(nbytes, 2 * B * C * 2.5 * n * log_n + B * C * 8 * n)
    return {"name": "fftconv_bwd", "shape": f"B={B} C={C} L={L} fft=2^{log_n} {dtype}",
            "route": "dk_spec pallas_fftconv.py:599", "entry": "fftconv_fused_dk_spec",
            "plan": list(plan), "errors": {k: v[0] for k, v in errs.items()},
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": time_ms(lambda: FB.fftconv_fused_dk_spec(u, dy, *plan)),
            "plain_ms": time_ms(lambda: FB.fftconv_dk_spec_ref(u, dy, n)),
            "library_ms": time_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}


# Kernels B and C's short path (csrc/fft_short.cuh, n <= 2^kShortMaxLogN):
# (B, C, L, Lk, dtype) at every FFT size from 2^4 to the cut, odd C with k as
# long as u at L = n / 2, then B = 3 with L = n / 2 - 1 and a shorter k in
# bf16; and the shipped lengths that are not powers of two, 1023 (fft 2^11)
# and 1026 (fft 2^12), in both dtypes, k shorter in one of each.
def short_cases(max_log_n: int) -> list:
    cases = []
    for log_n in range(4, max_log_n + 1):
        n = 1 << log_n
        cases += [(1, 5, n // 2, n // 2, "float32"),
                  (3, 4, n // 2 - 1, max(1, 3 * (n // 2 - 1) // 4), "bfloat16")]
    return cases + [(3, 7, 1023, 1023, "float32"), (3, 7, 1023, 700, "bfloat16"),
                    (1, 3, 1026, 1026, "bfloat16"), (3, 5, 1026, 900, "float32")]


def conv_inputs(g, B, C, L, Lk, dtype):
    """u, dy (B, C, L) and a decaying filter k (C, Lk) in `dtype`, float32 D."""
    import torch

    dt = getattr(torch, dtype)
    u, dy = (torch.randn(B, C, L, device="cuda", generator=g).to(dt) for _ in range(2))
    decay = torch.exp(-torch.arange(Lk, device="cuda") / (Lk / 8))
    k = (torch.randn(C, Lk, device="cuda", generator=g) * 0.05 * decay).to(dt)
    return u, dy, k, torch.randn(C, device="cuda", generator=g)


def check_short_path(FB, seed: int) -> dict:
    """Kernels B and C's short path at every case of `short_cases` against
    `fftconv_ref` and `fftconv_bwd_ref` at TOL (C's dk in the I/O dtype and,
    for bf16 I/O, in float32 too), one launch of each wrapper a call; kernel C
    twice at the trainer's 32 x 128 x 1024 and at 3 x 7 x 1026 bf16, the same
    bits in du, dk and dD (and kernel B's y); then the saved-spectrum modes,
    which keep the four-step passes by design, once at fft 2^11: kernel B's
    save_spectrum against `pair_spectrum_ref`, kernel C's spectrum route and
    its dk-spectrum mode against their plain versions."""
    import torch

    from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref, next_fast_fft_size

    cut = FB.short_max_log_n()
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst, sizes = {}, set()
    cases = short_cases(cut)
    for B, C, L, Lk, dtype in cases:
        n = next_fast_fft_size(2 * L)
        if not FB.short_path(n):
            raise AssertionError(f"fft {n} is above the short path's cut 2^{cut}")
        u, dy, k, D = conv_inputs(g, B, C, L, Lk, dtype)
        before = FB.KERNEL.launches, FB.KERNEL_BWD.launches
        outs = [("y", FB.fftconv_fused(u, k, D), fftconv_ref(u, k, D))]
        dk_dtypes = (None, torch.float32) if dtype == "bfloat16" else (None,)
        for dk_dtype in dk_dtypes:
            got = FB.fftconv_bwd_retransform(u, dy, k, D, dk_dtype=dk_dtype)
            want = FB.fftconv_bwd_ref(u, dy, k, D, dk_dtype=dk_dtype)
            outs += [(name + ("_f32" if dk_dtype else ""), o, r)
                     for name, o, r in zip(("du", "dk", "dD"), got, want)]
        torch.cuda.synchronize()
        launched = (FB.KERNEL.launches - before[0], FB.KERNEL_BWD.launches - before[1])
        if launched != (1, len(dk_dtypes)):
            raise AssertionError(f"short path {(B, C, L, Lk, dtype)}: launches {launched}")
        for name, o, r in outs:
            if o.dtype != r.dtype or o.shape != r.shape:
                raise AssertionError(f"short path {name}: {o.dtype} {tuple(o.shape)} against "
                                     f"{r.dtype} {tuple(r.shape)}")
            key = f"{name} {dtype}"
            rel = compare(o, r, "float32" if o.dtype == torch.float32 else dtype)[1]
            worst[key] = max(worst.get(key, 0.0), rel)
        sizes.add(n)
    same_bits = {}
    for B, C, L, dtype in ((32, TRAINER_D, 1024, "float32"), (3, 7, 1026, "bfloat16")):
        u, dy, k, D = conv_inputs(g, B, C, L, L, dtype)
        runs = [(FB.fftconv_fused(u, k, D), *FB.fftconv_bwd_retransform(u, dy, k, D))
                for _ in range(2)]
        same_bits[f"{B}x{C}x{L} {dtype}"] = all(torch.equal(a, b) for a, b in zip(*runs))
    if not all(same_bits.values()):
        raise AssertionError(f"short path: two calls differ in their bits: {same_bits}")
    u, dy, k, D = conv_inputs(g, 2, 6, 1024, 1024, "float32")
    y, spec = FB.fftconv_fused(u, k, D, save_spectrum=True)
    saved = {"y": compare(y, fftconv_ref(u, k, D), "float32")[1],
             "spectrum": compare(spec, FB.pair_spectrum_ref(u, 2048), "float32")[1]}
    for name, o, r in zip(("du", "dk", "dD"), FB.fftconv_bwd_spectrum(spec, dy, k, D),
                          FB.fftconv_bwd_ref(u, dy, k, D)):
        saved[f"spectrum route {name}"] = compare(o, r, "float32")[1]
    for name, o, r in zip(("re", "im"), FB.fftconv_fused_dk_spec(u, dy, 32, 64, 1),
                          FB.fftconv_dk_spec_ref(u, dy, 2048)):
        saved[f"dk_spec {name}"] = compare(o, r, "float32")[1]
    return {"phase": "short_path", "cut": 1 << cut, "fft_sizes": sorted(sizes),
            "cases": len(cases), "max_rel_err": worst, "same_bits": same_bits,
            "saved_spectrum_modes_at_fft_2048": saved, "ok": True}


def mlp_inputs(B, L, dtype, seed, d=D_MODEL):
    """x and dy (B L rows) in `dtype`, float32 parameters at an MLP of width
    d -> 4 d -> d (the hg38 model's d_model by default) and its init scales."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dh, dt = 4 * d, getattr(torch, dtype)
    x = torch.randn(B * L, d, device="cuda", generator=g).to(dt)
    dy = torch.randn(B * L, d, device="cuda", generator=g).to(dt)
    w1 = torch.randn(d, dh, device="cuda", generator=g) * 0.02
    b1 = torch.randn(dh, device="cuda", generator=g) * 0.02
    w2 = torch.randn(dh, d, device="cuda", generator=g) * 0.02 / math.sqrt(2 * N_LAYER)
    b2 = torch.randn(d, device="cuda", generator=g) * 0.02
    return x, dy, (w1, b1, w2, b2)


def library_mlp(x, w1, b1, w2, b2):
    """The cuBLAS route, `Mlp(use_fused=False)` in x's dtype with these weights."""
    import torch

    from hyena_dna_tpu_torch.models.blocks import Mlp

    m = Mlp(w1.shape[0], w1.shape[1], dtype=x.dtype, out_features=w2.shape[1]).cuda()
    with torch.no_grad():
        for lin, w, b in ((m.fc1, w1, b1), (m.fc2, w2, b2)):
            lin.weight.copy_(w.t())
            lin.bias.copy_(b)
    return m


def check_mlp(MF, B, L, dtype, seed, d=D_MODEL):
    """Kernels F and F' against `mlp_fused_ref` and `mlp_fused_bwd_ref` at
    an MLP of width d -> 4 d -> d (the hg38 model's by default). Every
    product takes bf16 operands on both sides, so a rounding of h or dh that
    flips between them moves a term by a bf16 step: y, dx and the float32
    weight gradients at the bf16 TOL. Returns the two kernels' rows."""
    import torch

    x, dy, (w1, b1, w2, b2) = mlp_inputs(B, L, dtype, seed, d)
    n, d = x.shape
    dh, d_out = w1.shape[1], w2.shape[1]
    y = MF.mlp_fused_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    fwd_err = compare(y, MF.mlp_fused_ref(x, w1, b1, w2, b2), "bfloat16")
    out = MF.mlp_fused_bwd(x, dy, w1, b1, w2)
    torch.cuda.synchronize()
    ref = MF.mlp_fused_bwd_ref(x, dy, w1, b1, w2)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    bwd_err = {nm: compare(o, r, "bfloat16") for nm, o, r in zip(names, out, ref)}
    lib = library_mlp(x, w1, b1, w2, b2)
    leaves = [x.detach().clone().requires_grad_(), *lib.parameters()]

    def library_bwd():  # forward + backward of the cuBLAS route
        with torch.enable_grad():
            return torch.autograd.grad(lib(leaves[0]), leaves, dy)

    size, weights = x.element_size(), d * dh + dh * d_out
    fwd_bytes = size * n * (d + d_out) + 2 * weights + 4 * (dh + d_out)
    bwd_bytes = size * n * (2 * d + d_out) + 2 * weights + 4 * (weights + dh + d_out) + 4 * dh
    fb, fby = bound(fwd_bytes, 2 * n * (d * dh + dh * d_out), BF16_FLOPS)
    bb_, bby = bound(bwd_bytes, 2 * n * dh * (3 * d + 2 * d_out), BF16_FLOPS)
    shape = f"B={B} L={L} d={d} dh={dh} d_out={d_out} {dtype}"
    return [
        {"name": "mlp_fused", "shape": shape, "route": "pallas_mlp.py:104",
         "max_abs_err": fwd_err[0], "max_rel_err": fwd_err[1],
         "ms": time_ms(lambda: MF.mlp_fused_fwd(x, w1, b1, w2, b2)),
         "plain_ms": time_ms(lambda: MF.mlp_fused_ref(x, w1, b1, w2, b2)),
         "library_ms": time_ms(lambda: lib(x)), "bound_ms": fb, "bound_by": fby},
        {"name": "mlp_fused_bwd", "shape": shape, "route": "pallas_mlp.py:129",
         "errors": {k: v[0] for k, v in bwd_err.items()},
         "max_abs_err": max(e[0] for e in bwd_err.values()),
         "max_rel_err": max(e[1] for e in bwd_err.values()),
         "ms": time_ms(lambda: MF.mlp_fused_bwd(x, dy, w1, b1, w2)),
         "plain_ms": time_ms(lambda: MF.mlp_fused_bwd_ref(x, dy, w1, b1, w2)),
         "library_ms": time_ms(library_bwd), "bound_ms": bb_, "bound_by": bby}]


def mlp_module(kernels, B, L, seed):
    """This slice's path: `Mlp(256, 1024, use_fused=True, dtype=bfloat16)`
    forward and backward on B x L tokens, the launch counts zeroed just
    before and read just after (kernels F and F' once each, nothing else),
    held against `use_fused=False` on the same weights: the output within
    the bf16 model's card-vs-CPU logit tolerance (2e-2 of its max; the
    two-product route rounds pre to bf16 before its GeLU, F keeps it
    float32) and every gradient within 3e-2 of its max|g| (GRAD_TOL)."""
    import torch

    from hyena_dna_tpu_torch.models.blocks import Mlp

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, L, D_MODEL, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(B, L, D_MODEL, device="cuda", generator=g).to(torch.bfloat16)
    torch.manual_seed(seed)
    fused = Mlp(D_MODEL, 4 * D_MODEL, dtype=torch.bfloat16, use_fused=True).cuda()
    plain = Mlp(D_MODEL, 4 * D_MODEL, dtype=torch.bfloat16).cuda()
    plain.load_state_dict(fused.state_dict())
    runs = []
    for m in (fused, plain):
        leaf = x.clone().requires_grad_()
        for k in kernels:
            k.launches = 0
        y = m(leaf)
        grads = torch.autograd.grad(y, [leaf, *m.parameters()], dy)
        torch.cuda.synchronize()
        runs.append((y, grads, {k.name: k.launches for k in kernels}))
    (y, grads, launches), (y_ref, grads_ref, _) = runs
    y_err = ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item()
    names = ["x", *(n for n, _ in fused.named_parameters())]
    errs = {n: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for n, a, b in zip(names, grads, grads_ref)}
    expect = {k.name: int(k.name in ("mlp_fused", "mlp_fused_bwd")) for k in kernels}
    ok = (y_err <= LOGIT_TOL["bfloat16"] and all(v <= GRAD_TOL["bfloat16"] for v in errs.values())
          and all(math.isfinite(v) for v in [y_err, *errs.values()]) and launches == expect)
    log({"phase": "mlp_module", "B": B, "L": L, "d": D_MODEL, "dh": 4 * D_MODEL,
         "dtype": "bfloat16", "y_err_over_max": y_err, "grad_err_over_max": errs,
         "tol": [LOGIT_TOL["bfloat16"], GRAD_TOL["bfloat16"]], "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("Mlp(use_fused=True) disagrees with the two-product route")
    return launches


def model_kwargs(precision: str) -> dict:
    """`build_model` arguments of the float32 model (float32 residual) or the
    bf16 model (bfloat16 activations and residual stream)."""
    import torch

    if precision == "bf16":
        return {"dtype": torch.bfloat16, "residual_in_fp32": False}
    return {}


def front_runs(remat: str, group: int, n: int = N_LAYER) -> int:
    """Forward runs of each layer's front end in one train step of an n-layer
    model (models/lm.py): n without checkpointing, 2n with block cells or
    residual cells of one, 2n + sum_j (g_j - 1) with residual groups (an
    outer recompute runs the first g_j - 1 cells of its group again)."""
    if remat == "off":
        return n
    if remat == "block" or group == 1:
        return 2 * n
    return 2 * n + sum(min(group, n - i0) - 1 for i0 in range(0, n, group))


def expected_launches(precision: str, per_pass: int, gated: str | None = None,
                      remat: str = "off", group: int = 1, front4: bool = False,
                      residual: str | None = None, n: int = N_LAYER) -> dict:
    """Launches of each kernel in `per_pass` forward+backward passes: A (A4
    on the 4-D route) `front_runs` times, A' (A4') once per layer; B, C once
    per layer (the conv output is saved across checkpointed cells), or with
    the gate-fused conv E, E' once per layer and B, C never; with a bf16
    residual D, D' 2 n_layer times (2 n_layer - 1 block units plus ln_f),
    and with block cells D 2 n_layer - 1 times more for the recomputed
    units; never with a float32 residual (`residual` defaults to the
    precision); `n` layers."""
    if (residual or precision) == "bf16":
        if remat not in ("off", "block"):
            raise ValueError("no launch count for residual cells with a bf16 residual")
        d_fwd, d_bwd = 2 * n + (2 * n - 1) * (remat == "block"), 2 * n
    else:
        d_fwd = d_bwd = 0
    conv, gconv = (0, n * per_pass) if gated else (n * per_pass, 0)
    fronts, backs = front_runs(remat, group, n) * per_pass, n * per_pass
    a, a4 = ((0, 0), (fronts, backs)) if front4 else ((fronts, backs), (0, 0))
    return {"fused_front": a[0], "fused_front_bwd": a[1],
            "fused_front4": a4[0], "fused_front4_bwd": a4[1],
            "fftconv": conv, "fftconv_bwd": conv, "add_ln": d_fwd * per_pass,
            "add_ln_bwd": d_bwd * per_pass, "fftconv_gated": gconv, "fftconv_gated_bwd": gconv,
            "mlp_fused": 0, "mlp_fused_bwd": 0}


def grad_parity(build_model, cross_entropy, kernels, B, L, dtype, seed, precision="fp32",
                gated=None, remat=None):
    """Logits, loss and every parameter gradient of the full-width model,
    card (kernels A, A', B, C or with `gated` E, E'; D, D' in bf16) against
    CPU (their plain versions). `remat`: (mode, group size, front4) of
    checkpointing and the 4-D route, as `bench.py` sets them."""
    import torch

    t0 = time.perf_counter()
    mode, group, front4 = remat or ("off", 1, False)
    model = build_model(D_MODEL, N_LAYER, max(L, 32768),
                        generator=torch.Generator().manual_seed(seed),
                        gated_conv=gated, **model_kwargs(precision),
                        **remat_kwargs(mode, group, front4)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L + 1)).astype(np.int64))
    x, y = tokens[:, :-1], tokens[:, 1:]
    logits_cpu = model(x)
    loss_cpu = cross_entropy(logits_cpu, y)
    loss_cpu.backward()
    card_model = copy.deepcopy(model).to("cuda")
    card_model.zero_grad(set_to_none=True)
    before = {k.name: k.launches for k in kernels}
    logits_card = card_model(x.to("cuda"))
    loss_card = cross_entropy(logits_card, y.to("cuda"))
    loss_card.backward()
    torch.cuda.synchronize()
    logit_err = (logits_card.detach().float().cpu() - logits_cpu.detach().float()).abs().max().item()
    logit_scale = max(1.0, logits_cpu.detach().float().abs().max().item())
    launches = {k.name: k.launches - before[k.name] for k in kernels}
    worst, worst_name, missing = 0.0, None, []
    cpu_grads = dict(model.named_parameters())
    for name, p in card_model.named_parameters():
        if p.grad is None:
            missing.append(name)
            continue
        ref = cpu_grads[name].grad
        ratio = (p.grad.cpu() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_name = ratio, name
    loss_err = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    bf16 = precision == "bf16"
    grad_tol = MODEL_BF16["grads"] if bf16 else GRAD_TOL[dtype]
    loss_tol = MODEL_BF16["loss"] if bf16 else LOSS_RTOL[dtype]
    logit_tol = MODEL_BF16["logits"] if bf16 else LOGIT_TOL[dtype]
    ok = (not missing and math.isfinite(worst) and worst <= grad_tol and loss_err <= loss_tol
          and math.isfinite(logit_err) and logit_err <= logit_tol * logit_scale
          and launches == expected_launches(precision, 1, gated, mode, group, front4))
    log({"phase": "grad_parity", "precision": precision, "gated_conv": gated or "off",
         "remat": mode, "remat_group_size": group, "front4": front4,
         "B": B, "L": L, "conv_io": dtype, "logits_max_abs_err": logit_err,
         "max_abs_logit": logit_scale, "logit_tol": logit_tol,
         "loss_cpu": loss_cpu.item(), "loss_card": loss_card.item(), "loss_rel_err": loss_err,
         "worst_grad_err_over_max": worst, "worst_param": worst_name, "tol": grad_tol,
         "params": len(cpu_grads), "missing_grads": missing, "launches": launches,
         "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"card gradients disagree with the CPU at B={B} L={L}")


def remat_kwargs(mode: str, group: int, front4: bool) -> dict:
    """`build_model` arguments of `bench.py --remat mode --remat_group_size
    group [--front4]`."""
    return {"checkpoint_mixer": mode != "off", "remat_residual_only": mode == "residual",
            "remat_group_size": group, "front4": front4}


def train(bench, kernels, batch, length, seed, precision="fp32", gated=None, residual=None,
          remat="off", group=1, front4=False, save_filter=False, steps=3):
    """A few timed train steps through the port's bench entry point."""
    import torch

    argv = ["--batch", str(batch), "--length", str(length), "--d_model", str(D_MODEL),
            "--n_layer", str(N_LAYER), "--warmup", "1", "--windows", "2", "--steps", str(steps),
            "--device", "cuda", "--seed", str(seed), "--precision", precision,
            "--gated_conv", gated or "off", "--remat", remat, "--remat_group_size", str(group)]
    argv += (["--residual", residual] if residual else []) + ["--front4"] * front4
    argv += ["--save_filter"] * save_filter
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    result = bench.main(argv)
    launches = {k.name: k.launches for k in kernels}
    steps = result["steps_run"]
    expect = expected_launches(precision, steps, gated, remat, group, front4, residual)
    losses = result["losses"]
    # without checkpointing B and C are checked to run at least once per
    # layer; in checkpointed runs every count is exact
    loose = ("fftconv", "fftconv_bwd") if remat == "off" and not gated else ()
    ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and all(launches[n] == expect[n] for n in expect if n not in loose)
          and all(launches[n] >= expect[n] for n in loose))
    log({"phase": "training", "precision": precision, "gated_conv": gated or "off",
         "residual": result["residual"], "remat": remat, "remat_group_size": group,
         "save_filter": save_filter, "front4": front4, "metric": result["metric"],
         "batch": batch, "L": length, "steps": steps,
         "step_ms": result["step_ms"], "window_step_ms": result["window_step_ms"],
         "tokens_per_s": result["value"],
         "loss_first": losses[0], "loss_last": losses[-1],
         "launches_per_step": {n: c / steps for n, c in launches.items()},
         "expected_per_step": {n: c / steps for n, c in expect.items()},
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "bench_peak_memory_gib": result["peak_memory_gib"], "ok": ok})
    if not ok:
        raise AssertionError(f"training at {batch} x {length} failed its checks")
    torch.cuda.empty_cache()
    return launches, result["step_ms"]


def slice_parity(build_model, B, L, dtype, seed, precision="fp32"):
    import torch

    model = build_model(D_MODEL, N_LAYER, 32768, generator=torch.Generator().manual_seed(seed),
                        **model_kwargs(precision)).eval()
    tokens = torch.from_numpy(
        np.random.default_rng(seed).integers(7, 12, size=(B, L)).astype(np.int64))
    with torch.inference_mode():
        cpu = model(tokens)
        card_model = copy.deepcopy(model).to("cuda")
        card = card_model(tokens.to("cuda")).cpu()
    err = (card.float() - cpu.float()).abs().max().item()
    scale = cpu.float().abs().max().item()
    tol = MODEL_BF16["logits"] if precision == "bf16" else LOGIT_TOL[dtype]
    ok = math.isfinite(err) and err <= tol * max(1.0, scale) and card.dtype == cpu.dtype
    log({"phase": "parity", "precision": precision, "B": B, "L": L, "conv_io": dtype,
         "max_abs_err": err, "max_abs_logit": scale, "tol": tol, "ok": ok})
    if not ok or card.shape != (B, L, 16):
        raise AssertionError(f"card logits disagree with the CPU at B={B} L={L}")


def write_fasta(path: Path, n_bases: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n_bases)].copy()
    seq[rng.random(n_bases) < 0.001] = ord("N")
    width = 80
    lines = [seq[i:i + width].tobytes() for i in range(0, n_bases, width)]
    path.write_bytes(b">chrS synthetic\n" + b"\n".join(lines) + b"\n")


def serve(cli, kernels, tmp: Path, fasta: Path, max_length: int, batch_size: int,
          n_windows: int, seed: int):
    import torch

    ckpt = tmp / f"weights_{max_length}.pt"
    model = cli.build_model(D_MODEL, N_LAYER, max_length,
                            generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), ckpt)
    del model
    argv = ["--ckpt", str(ckpt), "--fasta", str(fasta), "--max_length", str(max_length),
            "--d_model", str(D_MODEL), "--n_layer", str(N_LAYER),
            "--batch_size", str(batch_size),
            "--chr_ranges", f"chrS:0-{n_windows * max_length}", "--device", "cuda"]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    result = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    batches = math.ceil(n_windows / batch_size)
    expect = N_LAYER * batches
    ok = (math.isfinite(result["loss"]) and result["tokens"] == n_windows * max_length
          and launches["fused_front"] == expect and launches["fftconv"] >= expect)
    log({"phase": "serving", "batch": batch_size, "L": max_length, "batches": batches,
         "loss": result["loss"], "tokens": result["tokens"],
         "tokens_per_s_eval": result["tokens"] / result["eval_seconds"],
         "tokens_per_s_request": result["tokens"] / wall,
         "eval_seconds": result["eval_seconds"], "request_seconds": wall,
         "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"serving request at L={max_length} failed its checks")
    return launches


# Phase 6, the port's trainer at the full width of hyenadna-tiny-1k
# (configs/experiment/hg38/hg38_hyena.yaml, genomic_benchmark.yaml: d_model
# 128, 2 layers, batch 32, L 1023 / 1024, bf16 with a float32 residual).
TRAINER_D = 128
PRETRAIN_STEPS = 48  # a few dozen steps of the pretraining epoch
PARITY_STEPS = 3  # the fine-tune's first steps, card against the CPU
TRAINER_LAUNCHES = {"fused_front": 2, "fused_front_bwd": 2, "fftconv": 2, "fftconv_bwd": 2}
# card vs CPU train loss of the same steps (PERF.md section 2, the bf16 model)
TRAINER_LOSS_RTOL = 5e-3


# (entry, fft size) of each kernel B and C call while `record_fft` is on
FFT_CALLS: list = []


@contextlib.contextmanager
def record_fft(FB):
    """Record the FFT size of every conv forward (kernel B) and backward
    (kernel C) entry the model calls, into FFT_CALLS."""
    from hyena_dna_tpu_torch.ops.fftconv import next_fast_fft_size

    names = ("fftconv_fused", "fftconv_bwd_retransform", "fftconv_bwd_spectrum")
    saved = {name: getattr(FB, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            signal = args[0] if name == "fftconv_fused" else args[1]  # u, or dy
            FFT_CALLS.append((name, next_fast_fft_size(2 * signal.shape[-1])))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(FB, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(FB, name, fn)


def run_trainer(cli, kernels, argv, device=None, step_peaks=False):
    """What `python -m hyena_dna_tpu_torch.train <argv>` runs
    (`train/__main__.py::main`: build_config, Trainer, fit, close), with
    the train step wrapped to read each step's launches, its input shape,
    the FFT sizes it ran (FFT_CALLS, under `record_fft`) and its start and
    end on the host clock (synchronised before and after). Launch counts are
    zeroed just before and read just after the run. Returns a namespace:
    final metrics, the run's metrics.jsonl records, per-step launches, (start,
    end) seconds, shapes and FFT sizes, launches of the whole run, the peak
    GiB of the run (with `step_peaks`, of each step alone in `step_peak`),
    and the trainer."""
    import torch

    cuda = device is None
    trainer = cli.Trainer(cli.build_config(argv), device=device)
    run = types.SimpleNamespace(per_step=[], spans=[], shapes=[], ffts=[], step_peak=[],
                                trainer=trainer)
    step = trainer.train_step

    def counted(state, batch, generator=None):
        before = {k.name: k.launches for k in kernels}
        fft0 = len(FFT_CALLS)
        if cuda:
            torch.cuda.synchronize()
            if step_peaks:
                torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(state, batch, generator)
        if cuda:
            torch.cuda.synchronize()
        run.spans.append((t0, time.perf_counter()))
        run.per_step.append({k.name: k.launches - before[k.name] for k in kernels})
        run.shapes.append(tuple(batch[0].shape))
        run.ffts.append([n for _, n in FFT_CALLS[fft0:]])
        if cuda and step_peaks:
            run.step_peak.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    trainer.train_step = counted
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    try:
        run.final = trainer.fit()
    finally:
        trainer.close()
    run.launches = {k.name: k.launches for k in kernels}
    run.records = [json.loads(line) for line in open(Path(trainer.run_dir) / "metrics.jsonl")]
    run.peak = (max(run.step_peak) if step_peaks else
                torch.cuda.max_memory_allocated() / 2 ** 30) if cuda else None
    return run


def train_losses(records):
    return [r["train/loss"] for r in records if "train/loss" in r]


def trainer_phase(kernels, tmp: Path, seed: int) -> dict:
    """Pretrain (`experiment=hg38/hg38_hyena`, PRETRAIN_STEPS steps, writing
    checkpoints/last) and fine-tune from that checkpoint
    (`experiment=hg38/genomic_benchmark`, one epoch) on synthetic data from
    the repository's scripts; then the fine-tune's first PARITY_STEPS steps
    with dropout off on the card and on the CPU (plain kernel versions).
    The pretraining's hg38 dataset must take the fused C++ fetch. Returns
    the launches of the three card runs."""
    from hyena_dna_tpu_torch.train import __main__ as cli

    genome, gb = tmp / "genome", tmp / "gb"
    for script, args in (("make_synthetic_genome.py", [genome, "--bases", "4000000",
                                                       "--chroms", "2"]),
                         ("make_synthetic_gb.py", [gb])):
        subprocess.run([sys.executable, str(ROOT / "scripts" / script), *map(str, args),
                        "--seed", str(seed)], check=True, timeout=600, capture_output=True)
    ckpt = tmp / "pretrain" / "checkpoints" / "last"
    runs = {
        "pretrain": ["experiment=hg38/hg38_hyena",
                     f"dataset.bed_file={genome / 'synthetic_hg38.bed'}",
                     f"dataset.fasta_file={genome / 'synthetic_hg38.fa'}",
                     f"train.run_dir={tmp / 'pretrain'}",
                     f"trainer.limit_train_batches={PRETRAIN_STEPS}", "trainer.max_epochs=1",
                     "trainer.log_every_n_steps=1"],
        "finetune": ["experiment=hg38/genomic_benchmark", f"dataset.dest_path={gb}",
                     "dataset.dataset_name=synthetic_promoters",
                     f"train.run_dir={tmp / 'finetune'}",
                     f"train.pretrained_model_path={ckpt}", "trainer.max_epochs=1",
                     "trainer.log_every_n_steps=1"]}
    total = {k.name: 0 for k in kernels}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        run = run_trainer(cli, kernels, argv)
        tokens = 32 * (1023 if name == "pretrain" else 1024)
        # the trainer's own throughput: LM tokens over the epoch's wall time
        # (the classification task logs none, as in the JAX trainer)
        logged = [r["train/tokens_per_sec"] for r in run.records if "train/tokens_per_sec" in r]
        extra = {"loop_tokens_per_s": tokens * len(run.spans)
                 / (run.spans[-1][1] - run.spans[0][0]),
                 "train_tokens_per_sec_logged": logged[-1] if logged else None}
        checks = {}
        if name == "pretrain":  # the hg38 datasets take the fused C++ fetch
            checks["native_fetch"] = run.trainer.datamodule.dataset_train.native is not None
        else:
            checks["test_accuracy_above_half"] = run.final["test/accuracy"] > 0.5
        check_trainer_run(run, f"{name} {argv[0]}", TRAINER_LAUNCHES, checks, extra, t0)
        for n, c in run.launches.items():
            total[n] += c
    for n, c in loss_parity(cli, kernels, runs["finetune"][:3] + [
            f"train.pretrained_model_path={ckpt}"], tmp, "finetune").items():
        total[n] += c
    return total


def check_trainer_run(run, label: str, per_step_launches: dict, checks: dict, extra: dict,
                      t0: float, phase: str = "trainer") -> None:
    """Log a trainer run and raise unless its losses are finite and fall
    (the mean of the last 8 below the first 8), every step launched exactly
    `per_step_launches` (nothing else) and every entry of `checks` holds."""
    import statistics

    losses = train_losses(run.records)
    seconds = [end - start for start, end in run.spans]
    expect = {name: per_step_launches.get(name, 0) for name in run.launches}
    k8 = min(8, len(losses) // 2)
    checks = {"losses_finite": all(math.isfinite(v) for v in losses),
              "loss_falls": sum(losses[-k8:]) / k8 < sum(losses[:k8]) / k8,
              "launches_per_step": all(step == expect for step in run.per_step),
              **checks}
    ok = all(checks.values())
    log({"phase": phase, "run": label, "steps": len(run.per_step),
         "step_ms": statistics.median(seconds[2:]) * 1e3, "step_ms_first": seconds[0] * 1e3,
         **extra, "loss_first": losses[0], "loss_last": losses[-1],
         "loss_mean_first8": sum(losses[:k8]) / k8, "loss_mean_last8": sum(losses[-k8:]) / k8,
         "launches_per_step": run.per_step[-1], "expected_per_step": expect,
         "launches": run.launches, "peak_mem_gib": run.peak,
         "final": {k: v for k, v in run.final.items() if not k.endswith("confusion_matrix")},
         "checks": checks, "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"the trainer's {label} run failed its checks: {checks}")


def loss_parity(cli, kernels, argv, tmp: Path, name: str) -> dict:
    """The run's first PARITY_STEPS steps with dropout off on the card and on
    the CPU (plain kernel versions), each loss within TRAINER_LOSS_RTOL;
    returns the card run's launches."""
    parity = []
    for device in (None, "cpu"):
        run = run_trainer(cli, kernels, argv + [
            f"train.run_dir={tmp / (f'parity_{name}_' + (device or 'cuda'))}",
            f"trainer.limit_train_batches={PARITY_STEPS}", "trainer.max_epochs=1",
            "trainer.log_every_n_steps=1", "trainer.limit_val_batches=1",
            "model.embed_dropout=0.0"], device)
        parity.append(train_losses(run.records))
        if device is None:
            launches = run.launches
    card, cpu = parity
    errs = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    ok = len(card) == len(cpu) == PARITY_STEPS and max(errs) <= TRAINER_LOSS_RTOL
    log({"phase": "trainer_parity", "run": f"{name}, dropout off", "losses_card": card,
         "losses_cpu": cpu, "rel_err": errs, "tol": TRAINER_LOSS_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"the card's {name} losses disagree with the CPU's")
    return launches


# Phase 7, serving and generation at the full width of the hg38 LM (d_model
# 256, 8 layers, d_inner 1024). The generation model's l_max is 2048 and the
# modal fit covers that whole filter (distill's default fit length is 8192;
# the fit is numpy on the host, one Hankel SVD and one least-squares solve
# per channel, 2048 channels, which `distill` splits over the host's cores).
GEN_MAX_LENGTH = 2046  # build_model's l_max = max_length + 2
FIT_LEN = 2048
N_MODES = 64
PROMPT_BASES, NEW_TOKENS, CPU_TOKENS = 4096, 32, 4
DECODE_TOKENS = 256
PREFILL_TOL = 1e-4  # card vs CPU prefill: last logits and each state, of its max
REC_RTOL = 5e-2  # recurrent vs parallel logits, of max|logit| (tests/test_recurrent.py:65)
DRIFT_RTOL = 1e-3  # trained-checkpoint perplexity drift (tests/test_recurrent_drift.py:73)
ICL_STEPS, ICL_BATCH, ICL_LR = 32, 16, 1e-2
GOLDEN = ROOT / "tests" / "golden" / "recurrent_drift.npz"


def zero_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def serve_preset(cli, kernels, tmp: Path, fasta: Path, seed: int) -> dict:
    """7a: `hg38_inference --preset hyena_dna_512ksl` on a LongSafari-layout
    directory written from a seeded preset model, 2 batches of 2 x 32768;
    then `from_pretrained` of that directory on the card, one 1 x 32768
    forward."""
    import torch

    from hyena_dna_tpu_torch.evals.presets import build_model_from_preset, load_eval_preset
    from hyena_dna_tpu_torch.pretrained import from_pretrained

    preset = ROOT / "configs" / "evals" / "hyena_dna_512ksl.yaml"
    cfg = load_eval_preset(str(preset))["model"]
    ckpt = tmp / "hyenadna-512ksl"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps({k: v for k, v in cfg.items() if k != "_name_"}))
    model = build_model_from_preset(cfg, generator=torch.Generator().manual_seed(seed))
    torch.save({"state_dict": {"model." + k: v for k, v in model.state_dict().items()}},
               ckpt / "weights.ckpt")
    del model
    L, B, nb = 32768, 2, 2
    argv = ["--preset", str(preset), "--ckpt", str(ckpt), "--fasta", str(fasta),
            "--max_length", str(L), "--batch_size", str(B), "--limit_batches", str(nb),
            "--chr_ranges", f"chrS:0-{B * nb * L}", "--device", "cuda"]
    zero_counts(kernels)
    t0 = time.perf_counter()
    result = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    ok = (math.isfinite(result["loss"]) and result["tokens"] == B * nb * L
          and launches["fused_front"] == N_LAYER * nb and launches["fftconv"] >= N_LAYER * nb)
    log({"phase": "generation", "part": "7a preset serving", "preset": preset.name,
         "batch": B, "L": L, "batches": nb, "loss": result["loss"], "tokens": result["tokens"],
         "tokens_per_s_eval": result["tokens"] / result["eval_seconds"],
         "request_seconds": wall, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("serving from the 512ksl preset failed its checks")
    total = dict(launches)
    model, _ = from_pretrained(ckpt)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(7, 11, size=(1, L))).cuda()
    zero_counts(kernels)
    with torch.inference_mode():
        hidden = model(ids)
    launches = read_counts(kernels)
    ok = (hidden.shape == (1, L, cfg["d_model"]) and bool(torch.isfinite(hidden).all())
          and launches["fused_front"] == N_LAYER and launches["fftconv"] >= N_LAYER)
    log({"phase": "generation", "part": "7a from_pretrained", "shape": list(hidden.shape),
         "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("from_pretrained on the card failed its checks")
    for name, n in launches.items():
        total[name] += n
    return total


def full_forward_generation(kernels, tmp: Path, seed: int):
    """7b: `generate_cli` at temperature 0, a 4096-base prompt and 32 new
    tokens on the card (kernels A and B once per layer per token); the first
    4 tokens against the CPU's plain run. Returns (launches, the CPU model,
    the card's tokens per second)."""
    import contextlib
    import io

    import torch

    from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer
    from hyena_dna_tpu_torch.evals import generate_cli
    from hyena_dna_tpu_torch.evals import hg38_inference as cli
    from hyena_dna_tpu_torch.generation import generate

    model = cli.build_model(D_MODEL, N_LAYER, GEN_MAX_LENGTH,
                            generator=torch.Generator().manual_seed(seed)).eval()
    pt = tmp / "generation.pt"
    torch.save(model.state_dict(), pt)
    prompt = "".join(np.random.default_rng(seed).choice(list("ACGT"), size=PROMPT_BASES))
    argv = ["--ckpt", str(pt), "--prompt", prompt, "--max_new_tokens", str(NEW_TOKENS),
            "--temperature", "0", "--d_model", str(D_MODEL), "--n_layer", str(N_LAYER),
            "--max_length", str(GEN_MAX_LENGTH), "--device", "cuda"]
    zero_counts(kernels)
    with contextlib.redirect_stdout(io.StringIO()) as text:  # the 4128-base sequence
        result = generate_cli.main(argv)
    launches = read_counts(kernels)
    expect = {k.name: N_LAYER * NEW_TOKENS if k.name in ("fused_front", "fftconv") else 0
              for k in kernels}
    card_new = result["ids"][PROMPT_BASES:]
    ids = torch.as_tensor(CharacterTokenizer().encode(prompt), dtype=torch.long)[None]
    with torch.inference_mode():
        cpu_out = generate(model, ids, CPU_TOKENS, temperature=0.0)
        logits = model(cpu_out)[0, PROMPT_BASES - 1:PROMPT_BASES - 1 + CPU_TOKENS]
    cpu_new = cpu_out[0, PROMPT_BASES:].tolist()
    tol = LOGIT_TOL["float32"] * max(1.0, logits.abs().max().item())
    compared = []
    for j in range(CPU_TOKENS):
        top2 = logits[j].topk(2).values
        margin = (top2[0] - top2[1]).item()
        compared.append({"card": card_new[j], "cpu": cpu_new[j], "cpu_margin": margin})
        if card_new[j] != cpu_new[j]:  # a near tie; the two runs go on from other prefixes
            compared[-1]["near_tie"] = margin <= tol
            break
    ok = (launches == expect and len(result["ids"]) == PROMPT_BASES + NEW_TOKENS
          and all(c.get("near_tie", True) for c in compared)
          and text.getvalue().strip() == result["text"])
    tokens_per_s = NEW_TOKENS / result["seconds"]
    log({"phase": "generation", "part": "7b full forward", "prompt": PROMPT_BASES,
         "new_tokens": NEW_TOKENS, "l_max": GEN_MAX_LENGTH + 2, "seconds": result["seconds"],
         "tokens_per_s": tokens_per_s, "first_tokens": compared, "tol": tol,
         "launches": launches, "expected": expect, "ok": ok})
    if not ok:
        raise AssertionError("full-forward generation failed its checks")
    return launches, model, tokens_per_s


def distilled_forward(model, rec, tokens):
    """The model's own forward (kernels A and B) with each layer's implicit
    filter replaced by the modal filter the recurrence realises, over the
    whole prompt: the parallel model that `prefill_parallel` computes."""
    import torch

    from hyena_dna_tpu_torch.recurrent import _modal_kernel

    T = tokens.shape[1]
    mixers = [layer.mixer for layer in model.backbone.layers]
    saved = [m.l_max for m in mixers]
    for m, lam, c in zip(mixers, rec.lam, rec.c):
        k = _modal_kernel(lam[0], c[0], T).t()[None]  # (1, T, d), order 2
        m.l_max = T
        m.filter_fn.filter = lambda length, out_dtype=torch.float32, k=k: k[:, :length].to(
            out_dtype)
    try:
        with torch.inference_mode():
            return model(tokens)
    finally:
        for m, l_max in zip(mixers, saved):
            m.l_max = l_max
            del m.filter_fn.filter


def rel_err(out, ref) -> float:
    out, ref = out.float().cpu(), ref.float().cpu()
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def recurrent_generation(kernels, cpu_model, seed: int):
    """7c: distil the 7b model (64 modes, the fit on the host); the parallel
    prefill at 2 x 16384 on the card (kernel B once per layer) against the
    CPU; at 1 x 2048 (within the filter) against the model's own forward;
    at 1 x 131072 (fft 2^18) on the card alone, against the model's forward
    with the distilled filter; then 256 greedy steps."""
    import torch

    from hyena_dna_tpu_torch.recurrent import RecurrentLM, distill

    model = copy.deepcopy(cpu_model).cuda().eval()
    t0 = time.perf_counter()
    rec = distill(model, n_modes=N_MODES, fit_len=FIT_LEN)
    distill_s = time.perf_counter() - t0
    cpu_rec = RecurrentLM(cpu_model, [x.cpu().numpy() for x in rec.lam],
                          [x.cpu().numpy() for x in rec.c])
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(7, 11, size=(2, 16384)))
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, lg = rec.prefill_parallel(rec.init_state(2), tokens.cuda())
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    st_cpu, lg_cpu = cpu_rec.prefill_parallel(cpu_rec.init_state(2), tokens)
    errs = {"logits": rel_err(lg, lg_cpu)}
    for i, (a, b) in enumerate(zip(st["layers"], st_cpu["layers"])):
        for key in ("sc", "s"):
            errs[f"{key}{i}"] = rel_err(a[key], b[key])
    expect = {k.name: N_LAYER if k.name == "fftconv" else 0 for k in kernels}
    ok = launches == expect and max(errs.values()) <= PREFILL_TOL
    log({"phase": "generation", "part": "7c prefill 2x16384", "distill_seconds": distill_s,
         "fit_len": FIT_LEN, "n_modes": N_MODES, "fit_rel_err": rec.fit_rel_err,
         "prefill_seconds": prefill_s, "card_vs_cpu": errs, "tol": PREFILL_TOL,
         "launches": launches, "expected": expect, "ok": ok})
    if not ok:
        raise AssertionError("the card's parallel prefill disagrees with the CPU's")
    total = dict(launches)

    short = torch.from_numpy(rng.integers(7, 11, size=(1, GEN_MAX_LENGTH + 2))).cuda()
    _, lg_short = rec.prefill_parallel(rec.init_state(1), short)
    with torch.inference_mode():
        err_short = rel_err(lg_short, model(short)[:, -1])
    long = torch.from_numpy(rng.integers(7, 11, size=(1, 131072))).cuda()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logits = rec.prefill_parallel(rec.init_state(1), long)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    err_long = rel_err(logits, distilled_forward(model, rec, long)[:, -1])
    with torch.inference_mode():
        err_long_model = rel_err(logits, model(long)[:, -1])  # the filter's tail past l_max
    t0 = time.perf_counter()
    for _ in range(DECODE_TOKENS):
        state, logits = rec.step(state, logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    ok = (err_short <= REC_RTOL and err_long <= REC_RTOL and launches == expect
          and bool(torch.isfinite(logits).all()))
    log({"phase": "generation", "part": "7c prefill 1x131072 and decode",
         "rel_err_1x2048_vs_model": err_short, "rel_err_1x131072_vs_distilled_forward": err_long,
         "rel_err_1x131072_vs_model": err_long_model, "tol": REC_RTOL,
         "prefill_seconds_1x131072": long_s, "decode_tokens": DECODE_TOKENS,
         "decode_seconds": decode_s, "decode_tokens_per_s": DECODE_TOKENS / decode_s,
         "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("the recurrence disagrees with the parallel model")
    for name, n in launches.items():
        total[name] += n
    return total, DECODE_TOKENS / decode_s


def golden_model():
    """tests/golden/recurrent_drift.npz (a synthetic-hg38 pretrain, d 128 x
    2, L 1024) as a port model, through `utils/convert.py`; and its tokens."""
    from hyena_dna_tpu_torch.evals.hg38_inference import build_model
    from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

    z = np.load(GOLDEN)
    tree = {}
    for key in z.files:
        if key.startswith("p::"):
            node = tree
            *parents, leaf = key[3:].split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    model = build_model(TRAINER_D, 2, 1024)  # l_max 1026, the checkpoint's
    model.load_state_dict(flax_to_torch_state_dict(tree))
    return model.eval(), z["tokens"].astype(np.int64)


def perplexity(logits, targets) -> float:
    import torch

    nll = torch.nn.functional.cross_entropy(logits.double().flatten(0, 1), targets.flatten())
    return math.exp(nll.item())


def drift_phase(kernels, model, tokens) -> dict:
    """7d: the trained checkpoint on the card, the parallel model's held-out
    perplexity (kernels A and B once per layer) against the distilled
    recurrence's (every position stepped)."""
    import torch

    from hyena_dna_tpu_torch.recurrent import distill

    x, y = torch.from_numpy(tokens[:, :-1]).cuda(), torch.from_numpy(tokens[:, 1:]).cuda()
    zero_counts(kernels)
    with torch.inference_mode():
        ppl_par = perplexity(model(x), y)
    launches = read_counts(kernels)
    expect = {k.name: 2 if k.name in ("fused_front", "fftconv") else 0 for k in kernels}
    t0 = time.perf_counter()
    rec = distill(model, n_modes=N_MODES)
    distill_s = time.perf_counter() - t0
    state, steps = rec.init_state(x.shape[0]), []
    for j in range(x.shape[1]):
        state, lg = rec.step(state, x[:, j])
        steps.append(lg)
    ppl_rec = perplexity(torch.stack(steps, 1), y)
    drift = abs(ppl_rec - ppl_par) / ppl_par
    ok = 2.0 < ppl_par < 4.2 and drift < DRIFT_RTOL and launches == expect
    log({"phase": "generation", "part": "7d trained checkpoint", "ppl_parallel": ppl_par,
         "ppl_recurrent": ppl_rec, "rel_drift": drift, "tol": DRIFT_RTOL,
         "fit_rel_err": rec.fit_rel_err, "distill_seconds": distill_s,
         "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("the distilled recurrence drifts from the trained model")
    return launches


def write_icl_set(root: Path, seed: int) -> None:
    """tests/test_generation_evals.py:72-89's k-shot set (the class is the
    motif of the first 4 characters), with a test split."""
    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        for label, motif in (("neg", "TTTT"), ("pos", "AAAA")):
            d = root / "toy" / split / label
            d.mkdir(parents=True)
            for i in range(24):
                (d / f"{i}.txt").write_text(motif + "".join(rng.choice(list("ACGT"), size=12)))


def icl_phase(kernels, model, tmp: Path, seed: int) -> dict:
    """7e: `icl_cli --mode soft_prompting` from the trained checkpoint at the
    tiny-1k width (d 128 x 2; 1 shot of 256 bases: the model's l_max 1026),
    ICL_STEPS steps: each launches A, B, A', C once per layer, and the
    evaluation A and B; the loss must fall."""
    import torch

    from hyena_dna_tpu_torch.evals import icl_cli

    pt = tmp / "golden.pt"
    torch.save(model.state_dict(), pt)
    write_icl_set(tmp / "icl", seed)
    argv = ["--mode", "soft_prompting", "--ckpt", str(pt), "--dest_path", str(tmp / "icl"),
            "--dataset_name", "toy", "--shots", "1", "--max_length", "256",
            "--d_model", str(TRAINER_D), "--n_layer", "2", "--steps", str(ICL_STEPS),
            "--batch_size", str(ICL_BATCH), "--lr", str(ICL_LR), "--device", "cuda"]
    zero_counts(kernels)
    t0 = time.perf_counter()
    result = icl_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    evals = math.ceil(48 / ICL_BATCH)  # the test split's batches
    expect = {k.name: 0 for k in kernels}
    expect.update(fused_front=2 * (ICL_STEPS + evals), fftconv=2 * (ICL_STEPS + evals),
                  fused_front_bwd=2 * ICL_STEPS, fftconv_bwd=2 * ICL_STEPS)
    losses = result["losses"]
    falls = sum(losses[-8:]) / 8 < sum(losses[:8]) / 8
    ok = launches == expect and falls and all(math.isfinite(v) for v in losses)
    log({"phase": "generation", "part": "7e soft prompting", "steps": ICL_STEPS,
         "loss_mean_first8": sum(losses[:8]) / 8, "loss_mean_last8": sum(losses[-8:]) / 8,
         "loss_first": losses[0], "loss_last": losses[-1], "accuracy": result["accuracy"],
         "seconds": wall, "launches": launches, "expected": expect, "ok": ok})
    if not ok:
        raise AssertionError("soft prompting failed its checks")
    return launches


def generation_phase(cli, kernels, tmp: Path, seed: int) -> dict:
    """Phase 7, parts a-e; returns the launches of every part."""
    fasta = tmp / "synthetic.fa"
    write_fasta(fasta, 1_100_000, seed=13)  # phase 4's FASTA
    t0 = time.perf_counter()
    total = serve_preset(cli, kernels, tmp, fasta, seed)
    launches, cpu_model, ff_tps = full_forward_generation(kernels, tmp, seed + 1)
    rec_launches, rec_tps = recurrent_generation(kernels, cpu_model, seed + 2)
    golden, tokens = golden_model()
    golden = golden.cuda()
    drift = drift_phase(kernels, golden, tokens)
    icl = icl_phase(kernels, golden, tmp, seed + 3)
    for part in (launches, rec_launches, drift, icl):
        for name, n in part.items():
            total[name] += n
    log({"phase": "generation", "part": "summary", "full_forward_tokens_per_s": ff_tps,
         "recurrent_decode_tokens_per_s": rec_tps, "seconds": time.perf_counter() - t0,
         "launches": total})
    return total


# Phase 8, the downstream data layer at the shipped configs' width
# (configs/experiment/hg38/{chromatin_profile,species_*}.yaml: d_model 128,
# 2 layers, d_inner 512, order-2 Hyena, bf16 with a float32 residual), on
# data made from a seed: phase 6's genome, a synthetic chain file and
# coordinate CSVs, five synthetic species.
NATIVE_LENGTHS = (1024, 32768)
NATIVE_SHIFT = (-64, 64)
CHROMATIN_LABELS = 919
# rows written per split: about 72% survive the liftover (36 train steps of
# 64, a few hundred val and test windows)
CHROMATIN_ROWS = {"train": 3200, "val": 400, "test": 400}
CHROMATIN_NOISE_P = 0.05  # labels 1-918: sparse noise, as DeepSEA's positives are sparse
# per-species GC content, so the species can be told apart
SPECIES_GC = {"human": 0.35, "mouse": 0.60, "lemur": 0.45, "pig": 0.52, "hippo": 0.40}
SPECIES_CHROM_BASES = 40_000  # a 32768-base window with room to sample
SPECIES_TOTAL, SPECIES_STEPS = 512, 8  # dataset.total_size, trainer.limit_train_batches
SPECIES_CLS_STEPS = 64  # 8d: steps at batch 32 x 1024 (the warm-up is 60)
SPECIES_LAST_FFT = 1 << 16  # kernels B and C at the last stage's 32768
SPECIES_LAUNCHES = expected_launches("bf16", 1, remat="block", residual="fp32", n=2)


def native_phase(genome: Path) -> None:
    """8a: the hg38 dataset on phase 6's genome at each NATIVE_LENGTHS with
    shift and rc augmentation: the native path taken, its ids equal to the
    Python path's for every window of the valid split, each path's
    windows/s on the host."""
    from hyena_dna_tpu_torch.data import native
    from hyena_dna_tpu_torch.data.hg38 import HG38Dataset

    rates, windows = {}, 0
    for length in NATIVE_LENGTHS:
        kw = dict(split="valid", bed_file=str(genome / "synthetic_hg38.bed"),
                  fasta_file=str(genome / "synthetic_hg38.fa"), max_length=length,
                  add_eos=True, shift_augs=NATIVE_SHIFT, rc_aug=True)
        fused, python = HG38Dataset(**kw), HG38Dataset(**kw)
        if fused.native is None:
            raise AssertionError(f"the native fetch was not taken: {native.build_error}")
        python.native = None
        items = {}
        for name, ds in (("native", fused), ("python", python)):
            t0 = time.perf_counter()
            items[name] = [ds.__getitem__(i, rng=np.random.default_rng((1, i)))
                           for i in range(len(ds))]
            rates[f"{name} {length}"] = len(ds) / (time.perf_counter() - t0)
            ds.close()
        same = all(np.array_equal(a, b) for x, y in zip(items["native"], items["python"])
                   for a, b in zip(x, y))
        windows = len(items["native"])
        if not same:
            raise AssertionError(f"native ids differ from the Python path's at L={length}")
    log({"phase": "downstream", "part": "8a native fetch", "split": "valid",
         "windows": windows, "lengths": list(NATIVE_LENGTHS), "shift_augs": list(NATIVE_SHIFT),
         "windows_per_s": rates, "library": native.library_path(native.compiler()).name,
         "ids_equal": True, "ok": True})


# The synthetic hg19 -> hg38 chains on phase 6's two 2M-base chromosomes:
# chr1 in two blocks with a gap (500 target, 300 query bases), chr2 on the
# '-' strand for its first 600,000 bases and on '+' from 700,000 (the
# 100,000 between unmapped); both unmapped past 1.8M. (t_name, t_start,
# [(size, dt, dq), ...], q_strand, q_start) per chain.
CHAINS = [("chr1", 0, [(900_000, 500, 300), (899_500, 0, 0)], "+", 1000),
          ("chr2", 0, [(600_000, 0, 0)], "-", 100_000),
          ("chr2", 700_000, [(1_100_000, 0, 0)], "+", 650_000)]


def write_chain(path: Path, chrom_len: int) -> list:
    """Write CHAINS as a chain file; return its blocks as (t_name, t0, t1,
    q0, strand, q_size) for the plain lookup `lift`."""
    lines, blocks = [], []
    for i, (name, t0, parts, strand, q0) in enumerate(CHAINS):
        t_end = t0 + sum(size + dt for size, dt, _ in parts)
        q_end = q0 + sum(size + dq for size, _, dq in parts)
        lines.append(f"chain 1000 {name} {chrom_len} + {t0} {t_end} {name} {chrom_len} "
                     f"{strand} {q0} {q_end} {i + 1}")
        t, q = t0, q0
        for j, (size, dt, dq) in enumerate(parts):
            lines.append(f"{size} {dt} {dq}" if j + 1 < len(parts) else f"{size}")
            blocks.append((name, t, t + size, q, strand, chrom_len))
            t, q = t + size + dt, q + size + dq
        lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return blocks


def lift(blocks, chrom: str, pos: int):
    """A position through the chain, by a scan of its blocks; None where
    unmapped."""
    for name, t0, t1, q0, strand, q_size in blocks:
        if name == chrom and t0 <= pos < t1:
            sp = q0 + pos - t0
            return q_size - 1 - sp if strand == "-" else sp
    return None


def write_chromatin(data: Path, fasta: Path, seed: int):
    """The hg19 coordinate CSVs and the chain; returns (chain path, the
    expected lifted (coords, targets) of each split: the rows whose start
    and end both map and stay 1000 bases apart). Label 0 is GC content above
    0.5 of the hg38 window, the rest sparse noise."""
    from hyena_dna_tpu_torch.data.fasta import FastaFile

    rng = np.random.default_rng(seed)
    genome = FastaFile(fasta)
    chrom_len = genome.length("chr1")
    chain = data / "hg19ToHg38.over.chain"
    blocks = write_chain(chain, chrom_len)
    expected = {}
    header = "Chr_No,Start,End," + ",".join(f"y_{j}" for j in range(CHROMATIN_LABELS))
    for split, rows in CHROMATIN_ROWS.items():
        chr_no = rng.integers(0, 2, rows)
        start = rng.integers(20_000, chrom_len - 21_000, rows)
        labels = (rng.random((rows, CHROMATIN_LABELS)) < CHROMATIN_NOISE_P).astype(np.int32)
        kept, lines = [], [header]
        for i in range(rows):
            chrom = f"chr{chr_no[i] + 1}"
            s, e = lift(blocks, chrom, int(start[i])), lift(blocks, chrom, int(start[i]) + 1000)
            keep = s is not None and e is not None and e - s == 1000
            at = s if keep else int(start[i])
            seq = genome.fetch(chrom, at, at + 1000).upper()
            labels[i, 0] = int((seq.count("G") + seq.count("C")) / 1000 > 0.5)
            if keep:
                kept.append((i, chr_no[i], s, e))
            lines.append(f"{chr_no[i]},{start[i]},{start[i] + 1000},"
                         + ",".join(map(str, labels[i])))
        (data / f"{split}_hg19_coords_targets.csv").write_text("\n".join(lines) + "\n")
        rows_kept = [r[0] for r in kept]
        expected[split] = (np.asarray([r[1:] for r in kept], np.int64), labels[rows_kept])
    genome.close()
    return chain, expected


def chromatin_phase(cli, kernels, tmp: Path, seed: int) -> dict:
    """8b: `experiment=hg38/chromatin_profile` from phase 6's checkpoint on
    hg19 CSVs lifted through a synthetic chain; returns the card runs'
    launches."""
    from hyena_dna_tpu_torch.data.chromatin_profile import ChromatinProfileDataset

    t0 = time.perf_counter()
    fasta = tmp / "genome" / "synthetic_hg38.fa"
    data = tmp / "chromatin"
    data.mkdir()
    chain, expected = write_chromatin(data, fasta, seed)
    t1 = time.perf_counter()
    lifted = ChromatinProfileDataset(max_length=1000, ref_genome_path=str(fasta),
                                     coords_target_path=str(data / "train_hg19_coords_targets.csv"),
                                     liftover_chain_path=str(chain), save_liftover=False)
    with_liftover_s = time.perf_counter() - t1
    checks = {"liftover_rows": np.array_equal(lifted.coords, expected["train"][0])
              and np.array_equal(lifted.targets, expected["train"][1])}
    lifted.close()
    argv = ["experiment=hg38/chromatin_profile", f"dataset.ref_genome_path={fasta}",
            f"dataset.data_path={data}", f"dataset.liftover_chain_path={chain}",
            f"train.pretrained_model_path={tmp / 'pretrain' / 'checkpoints' / 'last'}"]
    run = run_trainer(cli, kernels, argv + [f"train.run_dir={tmp / 'chromatin_run'}",
                                            "trainer.max_epochs=1", "trainer.log_every_n_steps=1"])
    # the run lifted every split and wrote its hg38 CSV: read them back
    read_s = {}
    for split in CHROMATIN_ROWS:
        t1 = time.perf_counter()
        saved = ChromatinProfileDataset(
            max_length=1000, ref_genome_path=str(fasta),
            coords_target_path=str(data / f"{split}_hg38_coords_targets.csv"))
        read_s[split] = time.perf_counter() - t1
        checks[f"saved_{split}"] = (np.array_equal(saved.coords, expected[split][0])
                                    and np.array_equal(saved.targets, expected[split][1]))
        saved.close()
    aurocs = {k: v for r in run.records for k, v in r.items() if "auroc" in k}
    aurocs.update({k: v for k, v in run.final.items() if "auroc" in k})
    checks["aurocs"] = (all(f"{s}/auroc_{m}" in aurocs for s in ("val", "test")
                            for m in ("macro", "median"))
                        and all(0.0 <= v <= 1.0 for v in aurocs.values()))
    extra = {"rows": {s: [n, len(expected[s][0])] for s, n in CHROMATIN_ROWS.items()},
             "labels": CHROMATIN_LABELS, "dataset_with_liftover_s": with_liftover_s,
             "dataset_without_liftover_s": read_s["train"], "aurocs": aurocs}
    check_trainer_run(run, "8b chromatin_profile", TRAINER_LAUNCHES, checks, extra, t0,
                      phase="downstream")
    total = dict(run.launches)
    for n, c in loss_parity(cli, kernels, argv, tmp, "chromatin").items():
        total[n] += c
    return total


def write_species(root: Path, seed: int, species=tuple(SPECIES_GC),
                  n_bases: int = SPECIES_CHROM_BASES) -> list:
    """The directories of `species` (by default all five), every chromosome
    of their SPECIES_CHROMOSOME_SPLITS entry as `chr{n}.fa` of `n_bases`
    bases, human's valid ones as `chr{n}.fna.gz`; each species at its
    SPECIES_GC. Returns the paths the datasets must decompress the gzipped
    ones to."""
    from hyena_dna_tpu_torch.data.species import SPECIES_CHROMOSOME_SPLITS

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    unpacked = []
    for spec in species:
        gc = SPECIES_GC[spec]
        d = root / spec
        d.mkdir(parents=True)
        splits = SPECIES_CHROMOSOME_SPLITS[spec]
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        for split in ("train", "valid", "test"):
            for c in splits[split]:
                seq = bases[rng.choice(4, n_bases, p=p)].tobytes()
                text = (f">chr{c}\n".encode()
                        + b"".join(seq[i:i + 80] + b"\n" for i in range(0, len(seq), 80)))
                if spec == "human" and split == "valid":
                    with gzip.open(d / f"chr{c}.fna.gz", "wb") as f:
                        f.write(text)
                    unpacked.append(d / f"chr{c}.fna")
                else:
                    (d / f"chr{c}.fa").write_bytes(text)
    return unpacked


def species_phase(cli, FB, kernels, tmp: Path, seed: int) -> dict:
    """8c: `experiment=hg38/species_seqlen_warmup_reload` through its six
    stages, one epoch each; 8d: `experiment=hg38/species_classification`
    from scratch. Returns the card runs' launches."""
    import statistics

    t0 = time.perf_counter()
    root = tmp / "species"
    unpacked = write_species(root, seed)
    shipped = cli.build_config(["experiment=hg38/species_seqlen_warmup_reload"])
    stages = [(int(p["batch_size"]), int(p["seq_len"]))
              for p in shipped["callbacks"]["seqlen_warmup_reload"]["stage_params"]]
    params = [{"seq_len": L, "epochs": 1, "batch_size": b} for b, L in stages]
    argv = ["experiment=hg38/species_seqlen_warmup_reload", f"dataset.species_dir={root}",
            f"dataset.total_size={SPECIES_TOTAL}", f"trainer.limit_train_batches={SPECIES_STEPS}",
            f"trainer.max_epochs={len(stages)}", "trainer.log_every_n_steps=1",
            "callbacks.seqlen_warmup_reload.stage_params=" + json.dumps(params),
            f"train.run_dir={tmp / 'species_warmup'}"]
    with record_fft(FB):
        run = run_trainer(cli, kernels, argv, step_peaks=True)
    # the stages in the order run: (batch, L) and the steps of each
    runs = []
    for i, shape in enumerate(run.shapes):
        if not runs or runs[-1]["shape"] != shape:
            runs.append({"shape": shape, "steps": []})
        runs[-1]["steps"].append(i)
    per_stage = []
    for (b, L), r in zip(stages, runs):
        idx = r["steps"]
        ms = [(run.spans[i][1] - run.spans[i][0]) * 1e3 for i in idx]
        per_stage.append({"batch": b, "L": L, "steps": len(idx),
                          "step_ms_median": statistics.median(ms), "step_ms_first": ms[0],
                          "tokens_per_step": b * L,
                          "peak_gib": max(run.step_peak[i] for i in idx) if run.step_peak
                          else None,
                          "fft_sizes": sorted({n for i in idx for n in run.ffts[i]})})
    last = runs[-1]["steps"] if runs else []
    val_acc = [r["val/accuracy"] for r in run.records if "val/accuracy" in r]
    checks = {
        "stages": [r["shape"] for r in runs] == stages,
        "steps_per_stage": [len(r["steps"]) for r in runs]
        == [min(SPECIES_STEPS, SPECIES_TOTAL // b) for b, _ in stages],
        "last_stage_fft": bool(last) and all(
            run.ffts[i] and set(run.ffts[i]) == {SPECIES_LAST_FFT} for i in last),
        "val_accuracy": len(val_acc) == len(stages) and all(0 <= v <= 1 for v in val_acc),
        "test_accuracy": 0 <= run.final["test/accuracy"] <= 1,
        "gz_decompressed": all(p.exists() for p in unpacked)}
    losses = train_losses(run.records)
    checks["losses_finite"] = all(math.isfinite(v) for v in losses)
    checks["launches_per_step"] = all(
        step == {k: SPECIES_LAUNCHES.get(k, 0) for k in step} for step in run.per_step)
    ok = all(checks.values())
    log({"phase": "downstream", "part": "8c species seqlen warmup", "stages": per_stage,
         "launches_per_step": run.per_step[-1], "expected_per_step": SPECIES_LAUNCHES,
         "launches": run.launches, "val_accuracy": val_acc,
         "test_accuracy": run.final["test/accuracy"], "loss_first": losses[0],
         "loss_last": losses[-1], "checks": checks,
         "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"the species curriculum failed its checks: {checks}")
    total = dict(run.launches)

    t0 = time.perf_counter()
    argv = ["experiment=hg38/species_classification", f"dataset.species_dir={root}",
            f"dataset.total_size={32 * SPECIES_CLS_STEPS}"]
    run = run_trainer(cli, kernels, argv + [f"train.run_dir={tmp / 'species_cls'}",
                                            "trainer.max_epochs=1", "trainer.log_every_n_steps=1"])
    val_acc = [r["val/accuracy"] for r in run.records if "val/accuracy" in r]
    checks = {"shape": set(run.shapes) == {(32, 1024)},
              "accuracy": bool(val_acc) and all(0 <= v <= 1 for v in val_acc)
              and 0 <= run.final["test/accuracy"] <= 1}
    check_trainer_run(run, "8d species_classification", TRAINER_LAUNCHES, checks,
                      {"val_accuracy": val_acc}, t0, phase="downstream")
    for n, c in run.launches.items():
        total[n] += c
    for n, c in loss_parity(cli, kernels, argv, tmp, "species_classification").items():
        total[n] += c
    return total


def downstream_phase(FB, kernels, tmp: Path, seed: int) -> dict:
    """Phase 8 in phase 6's directory (its genome and checkpoint); returns
    the launches of its card runs."""
    from hyena_dna_tpu_torch.train import __main__ as cli

    t0 = time.perf_counter()
    native_phase(tmp / "genome")
    total = chromatin_phase(cli, kernels, tmp, seed)
    for n, c in species_phase(cli, FB, kernels, tmp, seed + 1).items():
        total[n] += c
    log({"phase": "downstream", "part": "summary", "seconds": time.perf_counter() - t0})
    return total


# Phase 9, the model layer: the attention experiments as shipped, a mixed
# Hyena + MHA stack, the general Hyena path at the hg38 LM width, and the
# generic backbone and adaptive LM at small widths, on phase 6's genome and
# GenomicBenchmarks data.
# phase 6's genome holds 13 batches of 256 x 1023 in its train split: 9a runs
# ATTN_EPOCHS epochs of ATTN_STEPS / ATTN_EPOCHS steps
ATTN_STEPS, ATTN_EPOCHS, MIXED_STEPS, SEQ_STEPS = 48, 4, 16, 16
# the mixed stack's one Hyena layer: A, A', B and C once a step each
MIXED_LAUNCHES = {"fused_front": 1, "fused_front_bwd": 1, "fftconv": 1, "fftconv_bwd": 1}
MIXED_OVERRIDES = ["model.attn_layer_idx=[1]", "model.attn_cfg.num_heads=8",
                   "model.max_position_embeddings=1024"]
# the general operator in bf16, kernels B and C against their plain versions
# on the card: both run the convs in float32 and round the same products and
# gates to bf16, so an element may land a bf16 step (2^-8) apart, of max|.|;
# dfilter is the largest over the filter bank's parameters (its MLP, trained
# through kernel C's float32 dk, and the skip bias) of each one's error: a
# float32 sum over every position, so far tighter (5e-5 on the H100)
GENERAL_TOL = {"y": 1e-2, "du": 2e-2, "dfilter": 1e-3}
GENERAL_SHAPE = (4, 32768)  # fft 2^16 at the hg38 LM width d_model 256
BLOCKS_SHAPE = (4, 8192)
BLOCKS_TOL = 1e-4  # float32 num_blocks = 2 (no kernel), card against CPU, of max|.|
SEQ_LOSS_RTOL = 1e-4  # float32 first loss, card against CPU


def attention_share(trainer) -> dict:
    """One more train step of `trainer` under torch.profiler
    (`utils/profile_forward.py::profile_device`): SDPA's share of the step's
    device time, the step's idle share and the device ms by group."""
    from hyena_dna_tpu_torch.train.trainer import _to_device
    from hyena_dna_tpu_torch.utils.profile_forward import profile_device

    batch = _to_device(next(iter(trainer.datamodule.train_dataloader())), trainer.device)
    wall, groups, kernels = profile_device(
        lambda: trainer.train_step(trainer.state, batch, trainer.generator))
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_step_ms": wall, "device_busy_ms": busy,
            "sdpa_share_of_busy": groups.get("attention", 0.0) / busy if busy else None,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_group": groups, "top_kernels_ms": [[n[:60], ms] for n, ms in top]}


@contextlib.contextmanager
def plain_on_card():
    """Every kernel wrapper takes its plain version, CUDA tensors included."""
    from hyena_dna_tpu_torch import _cuda

    saved = _cuda.on_card
    _cuda.on_card = lambda tensor: False
    try:
        yield
    finally:
        _cuda.on_card = saved


def general_hyena(kernels, seed: int) -> dict:
    """9d: `HyenaOperator(order=3)` at the hg38 LM width in bf16 at 4 x 32768
    (fft 2^16), one head (`_tail_3d`) then two (`_tail_generic`): forward and
    backward through kernels B and C (order - 1 launches each, A and A'
    none), output, input gradient and the filter bank's parameter gradients
    against the same operator with plain convs on the card; then
    `num_blocks=2` (`fftconv_aliased`, no launch) in float32 at 4 x 8192
    against the CPU. Returns the launches of the kernel runs."""
    import torch
    from hyena_dna_tpu_torch.models.hyena import HyenaOperator

    total = {k.name: 0 for k in kernels}
    filt = dict(emb_dim=5, w=10)

    def fwd_bwd(op, u, dy):
        def run():
            x = u.detach().clone().requires_grad_(True)
            for p in op.parameters():
                p.grad = None
            y = op(x)
            y.backward(dy)
            return y.detach(), x.grad
        return run

    def filter_grads(op):
        """The filter bank's parameter gradients (kernel C's dk through the
        filter MLP, and dD), by name."""
        return {n: p.grad.detach().clone() for n, p in op.filter_fn.named_parameters()
                if p.grad is not None}

    for heads in (1, 2):
        b, length = GENERAL_SHAPE
        op = HyenaOperator(D_MODEL, l_max=length, order=3, num_heads=heads, filter_order=64,
                           filter_cfg=filt, dtype=torch.bfloat16)
        op.init_weights(torch.Generator().manual_seed(seed + heads))
        op = op.cuda().train()
        gen = torch.Generator().manual_seed(seed)
        u = torch.randn(b, length, D_MODEL, generator=gen).to("cuda", torch.bfloat16)
        dy = torch.randn(b, length, D_MODEL, generator=gen).to("cuda", torch.bfloat16)
        run = fwd_bwd(op, u, dy)
        zero_counts(kernels)
        y, du = run()
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        dfilter = filter_grads(op)
        ms = time_ms(run)
        with plain_on_card():
            y_ref, du_ref = run()
            dfilter_ref = filter_grads(op)
            plain_ms = time_ms(run)
        err = {"y": rel_err(y, y_ref), "du": rel_err(du, du_ref),
               "dfilter": max(rel_err(dfilter[n], dfilter_ref[n]) for n in dfilter_ref)}
        expect = {k.name: {"fftconv": 2, "fftconv_bwd": 2}.get(k.name, 0) for k in kernels}
        checks = {"launches": launches == expect, "finite": bool(torch.isfinite(y).all()),
                  "same_filter_grads": sorted(dfilter) == sorted(dfilter_ref),
                  **{f"{k}_within_tol": err[k] <= GENERAL_TOL[k] for k in err}}
        ok = all(checks.values())
        log({"phase": "models", "part": f"9d general Hyena order 3, heads {heads}",
             "route": "_tail_3d" if heads == 1 else "_tail_generic", "B": b, "L": length,
             "d": D_MODEL, "precision": "bf16", "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms,
             "rel_err": err, "tol": GENERAL_TOL, "launches": launches, "checks": checks,
             "ok": ok})
        if not ok:
            raise AssertionError(f"the general Hyena path (heads {heads}) failed: {checks}")
        for n, c in launches.items():
            total[n] += c

    b, length = BLOCKS_SHAPE
    cpu_op = HyenaOperator(D_MODEL, l_max=length, order=2, num_blocks=2, filter_order=64,
                           filter_cfg=filt)
    cpu_op.init_weights(torch.Generator().manual_seed(seed + 3))
    card_op = copy.deepcopy(cpu_op).cuda()
    gen = torch.Generator().manual_seed(seed + 4)
    u, dy = (torch.randn(b, length, D_MODEL, generator=gen) for _ in range(2))
    zero_counts(kernels)
    y, du = fwd_bwd(card_op, u.cuda(), dy.cuda())()
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    y_ref, du_ref = fwd_bwd(cpu_op, u, dy)()
    err = {"y": rel_err(y.cpu(), y_ref), "du": rel_err(du.cpu(), du_ref)}
    checks = {"no_launch": not any(launches.values()),
              **{f"{k}_within_tol": v <= BLOCKS_TOL for k, v in err.items()}}
    ok = all(checks.values())
    log({"phase": "models", "part": "9d num_blocks 2 (fftconv_aliased), card vs CPU", "B": b,
         "L": length, "d": D_MODEL, "precision": "fp32", "rel_err": err, "tol": BLOCKS_TOL,
         "launches": launches, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"the multi-block Hyena path failed: {checks}")
    return total


def sequence_models(kernels, tmp: Path, seed: int) -> None:
    """9e: `SequenceModel` with long-conv, ff and mha layers (between a token
    embedding and a Linear head, `LMTask`) and an `AdaptiveLMModel` with
    `AdaptiveLMTask`, each SEQ_STEPS AdamW steps in float32 on 16 x 1024
    windows of phase 6's genome: the loss falls, no kernel launches, and the
    first loss matches the same model's on the CPU."""
    import statistics

    import torch
    from torch import nn
    from hyena_dna_tpu_torch.data.datamodules import DATASET_REGISTRY
    from hyena_dna_tpu_torch.models.adaptive_softmax import AdaptiveLMModel
    from hyena_dna_tpu_torch.models.sequence_model import SequenceModel
    from hyena_dna_tpu_torch.tasks.encoders import EmbeddingEncoder
    from hyena_dna_tpu_torch.tasks.tasks import AdaptiveLMTask, LMTask
    from hyena_dna_tpu_torch.train import build_optimizer, create_train_state, make_train_step
    from hyena_dna_tpu_torch.train.trainer import _to_device

    genome = tmp / "genome"
    dm = DATASET_REGISTRY["hg38"](bed_file=str(genome / "synthetic_hg38.bed"),
                                  fasta_file=str(genome / "synthetic_hg38.fa"), max_length=1024,
                                  batch_size=16, add_eos=True, seed=seed)
    dm.setup()
    batches = []
    for batch in dm.train_dataloader():
        batches.append(batch)
        if len(batches) == SEQ_STEPS:
            break
    vocab = dm.vocab_size
    d = 128

    class SequenceLM(nn.Module):
        def __init__(self, generator):
            super().__init__()
            self.encoder = EmbeddingEncoder(vocab, d, generator=generator)
            self.backbone = SequenceModel(
                d, n_layers=1, residual="R", norm="layer", generator=generator,
                layer=[{"_name_": "long-conv", "l_max": 1024}, {"_name_": "ff", "expand": 4},
                       {"_name_": "mha", "num_heads": 8}])
            self.decoder = nn.Linear(d, vocab)

        def forward(self, x, generator=None):
            return self.decoder(self.backbone(self.encoder(x), generator=generator)[0])

    builds = {
        "SequenceModel (long-conv, ff, mha)": (SequenceLM, LMTask),
        "AdaptiveLMModel": (lambda g: AdaptiveLMModel(
            vocab, d, cutoffs=[4, 8], div_val=2, generator=g,
            backbone=dict(n_layers=2, layer=[{"_name_": "mha", "num_heads": 8},
                                             {"_name_": "ff"}], residual="R", norm="layer")),
            AdaptiveLMTask)}
    for label, (build, task_cls) in builds.items():
        cpu_model = build(torch.Generator().manual_seed(seed))
        task = task_cls()
        x0, y0 = (torch.from_numpy(a).long() for a in batches[0][:2])
        with torch.no_grad():
            out = cpu_model.train()(x0)
            cpu_loss = float(task.compute_loss(out[0] if isinstance(out, tuple) else out, y0))
        model = copy.deepcopy(cpu_model).cuda()
        state = create_train_state(model, build_optimizer(model, lr=1e-3, weight_decay=0.1)[0])
        step = make_train_step(task)
        generator = torch.Generator(device="cuda").manual_seed(seed)
        zero_counts(kernels)
        losses, seconds = [], []
        for batch in batches:
            batch = _to_device(batch, torch.device("cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(state, batch, generator)["loss"]))
            seconds.append(time.perf_counter() - t0)
        launches = read_counts(kernels)
        k8 = len(losses) // 2
        checks = {"losses_finite": all(math.isfinite(v) for v in losses),
                  "loss_falls": sum(losses[-k8:]) < sum(losses[:k8]),
                  "first_loss_vs_cpu": abs(losses[0] - cpu_loss) <= SEQ_LOSS_RTOL * abs(cpu_loss),
                  "no_launch": not any(launches.values())}
        ok = all(checks.values())
        log({"phase": "models", "part": f"9e {label}", "steps": len(losses), "B": 16, "L": 1024,
             "d": d, "precision": "fp32", "step_ms": statistics.median(seconds[2:]) * 1e3,
             "loss_first": losses[0], "loss_first_cpu": cpu_loss, "loss_last": losses[-1],
             "loss_mean_first_half": sum(losses[:k8]) / k8,
             "loss_mean_last_half": sum(losses[-k8:]) / k8, "launches": launches,
             "checks": checks, "ok": ok})
        if not ok:
            raise AssertionError(f"9e {label} failed its checks: {checks}")


def models_phase(kernels, tmp: Path, seed: int) -> dict:
    """Phase 9 in phase 6's directory (its genome and GenomicBenchmarks
    data); returns the launches of its card runs."""
    import torch
    from hyena_dna_tpu_torch.train import __main__ as cli

    t_phase = time.perf_counter()
    genome, gb = tmp / "genome", tmp / "gb"
    data = [f"dataset.bed_file={genome / 'synthetic_hg38.bed'}",
            f"dataset.fasta_file={genome / 'synthetic_hg38.fa'}"]
    total = {k.name: 0 for k in kernels}

    def add(launches):
        for n, c in launches.items():
            total[n] += c

    def mixers(trainer):
        return [type(m.mixer).__name__ for m in trainer.model.modules() if hasattr(m, "mixer")]

    # 9a: the pure-attention LM as shipped, then its first losses card vs CPU
    t0 = time.perf_counter()
    argv = ["experiment=hg38/hg38_attention", *data, f"train.run_dir={tmp / 'attention'}",
            f"trainer.limit_train_batches={ATTN_STEPS // ATTN_EPOCHS}",
            f"trainer.max_epochs={ATTN_EPOCHS}", "trainer.log_every_n_steps=1"]
    run = run_trainer(cli, kernels, argv)
    shape = run.shapes[0]
    check_trainer_run(run, f"9a {argv[0]}", {},
                      {"every_layer_attention": mixers(run.trainer) == ["MHA", "MHA"],
                       "batch_256": shape[0] == 256, "steps": len(run.per_step) == ATTN_STEPS},
                      {"batch_shape": list(shape)}, t0,
                      phase="models")
    add(run.launches)
    log({"phase": "models", "part": "9a profiled step", **attention_share(run.trainer)})
    add(loss_parity(cli, kernels, argv[:3] + ["model.attn_cfg.dropout=0.0",
                                              "dataset.batch_size=32"], tmp, "hg38_attention"))
    del run
    torch.cuda.empty_cache()

    # 9b: GenomicBenchmarks with the attention backbone as shipped, one epoch
    t0 = time.perf_counter()
    run = run_trainer(cli, kernels, [
        "experiment=hg38/genomic_benchmark_attention", f"dataset.dest_path={gb}",
        "dataset.dataset_name=synthetic_promoters", f"train.run_dir={tmp / 'gb_attention'}",
        "trainer.max_epochs=1", "trainer.log_every_n_steps=1"])
    check_trainer_run(run, "9b experiment=hg38/genomic_benchmark_attention", {},
                      {"test_accuracy_above_half": run.final["test/accuracy"] > 0.5,
                       "every_layer_attention": mixers(run.trainer) == ["MHA", "MHA"]},
                      {}, t0, phase="models")
    add(run.launches)
    del run

    # 9c: a mixed stack, Hyena at layer 0 and 8-head MHA at layer 1
    t0 = time.perf_counter()
    argv = ["experiment=hg38/hg38_hyena", *data, *MIXED_OVERRIDES,
            f"train.run_dir={tmp / 'mixed'}", f"trainer.limit_train_batches={MIXED_STEPS}",
            "trainer.max_epochs=1", "trainer.log_every_n_steps=1"]
    run = run_trainer(cli, kernels, argv)
    check_trainer_run(run, "9c experiment=hg38/hg38_hyena + attn_layer_idx [1]",
                      MIXED_LAUNCHES, {"mixers": mixers(run.trainer) == ["HyenaOperator", "MHA"]},
                      {}, t0, phase="models")
    add(run.launches)
    add(loss_parity(cli, kernels, argv[:6], tmp, "mixed"))
    del run

    add(general_hyena(kernels, seed + 1))
    sequence_models(kernels, tmp, seed + 2)
    log({"phase": "models", "part": "summary", "seconds": time.perf_counter() - t_phase,
         "launches": total})
    return total


# Phase 10, data and sequence parallelism on the one card: PAR_WORLD ranks,
# spawned processes that each take the card (NCCL does not support two ranks on one
# device, so the backend rule of `parallel/launch.py` gives gloo), after the
# parent built every kernel. One world runs 10a, 10b, 10c's ranks and 10d in
# turn; each rank writes what it measured to a JSON file the parent reads.
PAR_WORLD = 4
PAR_L = 450_000  # hg38_medium_450k's L - 1: the 450k layer's conv operand
PAR_STEPS = 3
PAR_ACCUM = 2  # hg38_medium_450k ships 8: cut for the time limit
PAR_1M_LENGTH = 131_073  # 10d: hg38_large_1m's 1,000,001 cut to fit four ranks' contexts
A2A_REPS = 5
PAR_LAUNCHES = {"fftconv": N_LAYER, "fftconv_bwd": N_LAYER}  # a micro-step of the seq route
STAGED = []  # collectives the port stages through host memory under gloo: none (10a)


def parallel_data(genome: Path, run_dir: Path, steps: int = PAR_STEPS) -> list:
    return [f"dataset.bed_file={genome / 'synthetic_hg38.bed'}",
            f"dataset.fasta_file={genome / 'synthetic_hg38.fa'}", f"train.run_dir={run_dir}",
            f"trainer.limit_train_batches={steps}", "trainer.max_epochs=1",
            "trainer.log_every_n_steps=1", "trainer.limit_val_batches=1",
            # the shipped warmups (600, 1000 steps) hold the lr near 1e-6 for
            # three steps; at the shipped peak lr from step 0 the loss falls
            "scheduler.warmup_t=0"]


def parallel_ops(kernels, mesh, seed: int) -> dict:
    """10a on one rank: `seq_fftconv` forward and backward on the rank's
    columns of a 1 x 256 x 450,000 bf16 operand against kernels B and C on
    the whole tensor in this process (y, du; dk and dD on the rank's channel
    rows, zero elsewhere), `seq_short_conv` on 1 x 768 x 450,000 bf16 against
    `short_conv_1d`, then each all-to-all timed alone."""
    import torch
    import torch.distributed as dist

    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops.distributed import all_to_all, seq_fftconv, seq_short_conv
    from hyena_dna_tpu_torch.parallel.launch import COLLECTIVES
    from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, L = D_MODEL, PAR_L
    u = torch.randn(1, C, L, device="cuda", generator=g).bfloat16()
    dy = torch.randn(1, C, L, device="cuda", generator=g).bfloat16()
    decay = torch.exp(-torch.arange(L, device="cuda") / (L / 8))
    k = (torch.randn(C, L, device="cuda", generator=g) * 0.05 * decay).bfloat16()
    D = torch.randn(C, device="cuda", generator=g)
    cols = mesh.seq_columns(L)
    rows = slice(mesh.seq_index * C // mesh.seq, (mesh.seq_index + 1) * C // mesh.seq)
    y_ref = FB.fftconv_fused(u, k, D)
    du_ref, dk_ref, dD_ref = FB.fftconv_bwd_retransform(u, dy, k, D)
    zero_counts(kernels)
    COLLECTIVES.reset()
    ul = u[..., cols].contiguous().requires_grad_(True)
    kk, DD = k.clone().requires_grad_(True), D.clone().requires_grad_(True)
    y = seq_fftconv(ul, kk, DD, mesh)
    y.backward(dy[..., cols].contiguous())
    torch.cuda.synchronize()
    launches, calls = read_counts(kernels), dict(COLLECTIVES.calls)
    outside = torch.ones(C, dtype=torch.bool, device="cuda")
    outside[rows] = False
    pairs = {"y": (y, y_ref[..., cols]), "du": (ul.grad, du_ref[..., cols]),
             "dk": (kk.grad[rows], dk_ref[rows]), "dD": (DD.grad[rows], dD_ref[rows])}
    errs = {n: compare(a, b, "float32" if b.dtype == torch.float32 else "bfloat16")[0]
            for n, (a, b) in pairs.items()}
    bit_equal = {n: bool(torch.equal(a, b)) for n, (a, b) in pairs.items()}
    zero_outside = bool((kk.grad[outside] == 0).all() and (DD.grad[outside] == 0).all())
    x = torch.randn(1, 3 * C, L, device="cuda", generator=g).bfloat16()
    w = ((torch.rand(3 * C, 3, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)).bfloat16()
    b = ((torch.rand(3 * C, device="cuda", generator=g) * 2 - 1) / math.sqrt(3)).bfloat16()
    conv_equal = bool(torch.equal(seq_short_conv(x[..., cols].contiguous(), w, b, mesh),
                                  short_conv_1d(x, w, b)[..., cols]))
    del x
    pencil = all_to_all(ul.detach(), mesh.seq_group, True)
    a2a = {}
    for label, t, to_pencil in (("columns_to_pencil", ul.detach(), True),
                                ("pencil_to_columns", pencil, False)):
        all_to_all(t, mesh.seq_group, to_pencil)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(A2A_REPS):
            all_to_all(t, mesh.seq_group, to_pencil)
        torch.cuda.synchronize()
        a2a[label] = {"ms": (time.perf_counter() - t0) / A2A_REPS * 1e3,
                      "shape": list(t.shape), "bytes_sent": t.numel() * t.element_size(),
                      "bytes_leaving_rank": t.numel() * t.element_size()
                      * (mesh.seq - 1) // mesh.seq}
    return {"launches": launches, "collectives": calls, "max_abs_err": errs,
            "bit_equal": bit_equal, "dk_dD_zero_outside_rows": zero_outside,
            "short_conv_bit_equal": conv_equal, "all_to_all": a2a,
            "pencil": [1, C // mesh.seq, L]}


def parallel_trainer(kernels, cfg: dict) -> dict:
    """A trainer run on one rank, its train step wrapped to read each
    step's launches, collectives (calls, bytes, host seconds in each call
    and, as `COLLECTIVES.synchronize` is set for the run, host seconds
    waiting for the card's queued work before each), host time
    (synchronised before and after), peak GiB and global loss."""
    import torch

    from hyena_dna_tpu_torch.parallel.launch import COLLECTIVES
    from hyena_dna_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    step, steps = trainer.train_step, []

    def counted(state, batch, generator=None):
        before = read_counts(kernels)
        COLLECTIVES.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(state, batch, generator)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t0, "loss": loss,
                      "shape": list(batch[0].shape),
                      "launches": {n: c - before[n] for n, c in read_counts(kernels).items()},
                      "collectives": COLLECTIVES.summary(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        return out

    trainer.train_step = counted
    zero_counts(kernels)
    COLLECTIVES.synchronize = True
    try:
        final = trainer.fit()
    finally:
        COLLECTIVES.synchronize = False
        trainer.close()
    mesh = trainer.mesh
    return {"steps": steps, "launches": read_counts(kernels), "mesh": mesh.shape,
            "coords": ([mesh.data_index, mesh.seq_index] if mesh.model == 1
                       else [mesh.data_index, mesh.seq_index, mesh.model_index]),
            "final": {k: v for k, v in final.items() if isinstance(v, float)}}


def parallel_grads(cfg: dict, seed: int, length: int = PAR_L, label: int | None = None):
    """10c (and 11c, 11d, 12b-12d) on one rank: one micro-step of the model
    with dropout off on the rank's columns of a seeded 1 x (length + 1)
    token row (with `label`, a classification row: the first `length`
    tokens and that label, whole on every rank), its loss weighted by the
    rank's share (of the tokens, or 1 / replicas of a per-sequence loss),
    the gradients and loss reduced by the train step's own reduction
    (`train/step.py::reduce_gradients`) and, under a model axis, the sharded
    gradients gathered whole. Returns (loss, {name: gradient})."""
    from hyena_dna_tpu_torch.parallel.sharding import gather_state_dict, tp_layout
    from hyena_dna_tpu_torch.train.step import reduce_gradients
    from hyena_dna_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    mesh = trainer.mesh
    x, y = parity_tokens(seed, trainer.device, length, label)
    cols = mesh.seq_columns(x.shape[1])
    model = trainer.model.train()
    logits = model(x[:, cols].contiguous(), trainer.generator)
    y = y[:, cols] if y.dim() == 2 else y
    loss = trainer.task.compute_loss(logits, y, train=True) / mesh.replicas
    loss.backward()
    (total,) = reduce_gradients(model, [loss.detach()], mesh)
    grads = gather_state_dict({n: p.grad.detach() for n, p in model.named_parameters()}, mesh,
                              tp_layout(model))
    grads = {n: g.float().cpu() for n, g in grads.items()}
    trainer.close()
    return float(total), grads


def parity_tokens(seed: int, device, length: int = PAR_L, label: int | None = None):
    """A seeded 1 x (length + 1) row of base tokens (ids 7-10) as (x, y); with
    `label`, (its first `length` tokens, the (1,) label)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(7, 11, (1, length + 1), generator=g)
    if label is not None:
        return ids[:, :-1].to(device), torch.tensor([label], device=device)
    return ids[:, :-1].to(device), ids[:, 1:].to(device)


def parallel_configs(tmp: Path) -> dict:
    """10b, 10c and 10d's configs (`train/__main__.py::build_config`)."""
    from hyena_dna_tpu_torch.train.__main__ import build_config

    genome = tmp / "genome"
    medium = ["experiment=hg38/hg38_medium_450k",
              f"trainer.accumulate_grad_batches={PAR_ACCUM}"]
    large = ["experiment=hg38/hg38_large_1m", "mesh.data=2", "mesh.seq=2",
             f"dataset.max_length={PAR_1M_LENGTH}", "trainer.accumulate_grad_batches=1"]
    parity = ["experiment=hg38/hg38_medium_450k", "model.embed_dropout=0.0"]
    cfgs = {"10b": build_config(medium + parallel_data(genome, tmp / "par_450k")),
            "10d": build_config(large + parallel_data(genome, tmp / "par_1m")),
            "10c": build_config(parity + parallel_data(genome, tmp / "par_parity")),
            "10c_single": build_config(parity + ["mesh.seq=1"] + parallel_data(
                genome, tmp / "par_parity_single"))}
    cfgs["10d"]["callbacks"].pop("seqlen_warmup_reload")  # the curriculum is cut
    return cfgs


def parallel_ranks(tmp: str, seed: int) -> None:
    """Each rank of the phase 10 world: join through torchrun's variables
    (`initialize_distributed`: the card, gloo), then 10a, 10b, 10c, 10d."""
    import torch

    from hyena_dna_tpu_torch.parallel import launch
    from hyena_dna_tpu_torch.parallel.sharding import make_mesh
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    kernels = port_kernels()
    launch.initialize_distributed(torch.device("cuda"))
    tmp = Path(tmp)
    cfgs = parallel_configs(tmp)
    res = {"backend": torch.distributed.get_backend(), "device": str(torch.cuda.current_device()),
           "10a": parallel_ops(kernels, make_mesh(data=1, seq=PAR_WORLD), seed)}
    torch.cuda.empty_cache()
    res["10b"] = parallel_trainer(kernels, cfgs["10b"])
    gc.collect()
    torch.cuda.empty_cache()
    loss, grads = parallel_grads(cfgs["10c"], seed + 1)
    res["10c"] = {"loss": loss}
    if launch.is_main_process():
        torch.save(grads, tmp / "par_grads.pt")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    res["10d"] = parallel_trainer(kernels, cfgs["10d"])
    (tmp / f"par_rank{launch.rank()}.json").write_text(json.dumps(res))


def check_parallel_run(ranks: list, part: str, label: str, accum: int, t0: float,
                       expected: dict | None = None, phase: str = "parallel",
                       steps: int = PAR_STEPS, falls: bool = True) -> dict:
    """Log a phase 10 (11, 12) trainer run from every rank's record and raise
    unless its losses are finite and (with `falls`) the last below the
    first, every rank saw the same losses, and every step launched
    `expected` (by default B and C PAR_LAUNCHES times a micro-step) and
    nothing else. Returns the launches summed over ranks."""
    import statistics

    runs = [r[part] for r in ranks]
    losses = [s["loss"] for s in runs[0]["steps"]]
    expected = expected or {n: c * accum for n, c in PAR_LAUNCHES.items()}
    expect = {n: expected.get(n, 0) for n in runs[0]["launches"]}
    step_s = [max(r["steps"][i]["seconds"] for r in runs) for i in range(len(losses))]
    # a rank's mean host seconds a step: inside the collectives after the card
    # was synchronised (the data's trip plus the wait for the slowest rank), and
    # in those synchronisations (the card's work queued before each collective)
    mean_host_s = lambda key: [statistics.mean(
        sum(c[key] for c in r["steps"][i]["collectives"].values()) for r in runs)
        for i in range(len(losses))]
    coll_s, wait_s = mean_host_s("seconds"), mean_host_s("wait_seconds")
    # each model group runs the same tokens: count the data x seq ranks' own
    tokens = (runs[0]["steps"][0]["shape"][0] * runs[0]["steps"][0]["shape"][1] * len(runs)
              // runs[0]["mesh"]["model"])
    # gloo returns when the data has moved; NCCL once enqueued, so its host seconds are no share
    gloo = ranks[0]["backend"] == "gloo"
    checks = {"steps": len(losses) == steps,
              "losses_finite": all(math.isfinite(v) for v in losses),
              "loss_falls": losses[-1] < losses[0] or not falls,
              "ranks_agree": all([s["loss"] for s in r["steps"]] == losses for r in runs),
              "launches_per_step": all(s["launches"] == expect for r in runs
                                       for s in r["steps"])}
    ok = all(checks.values())
    log({"phase": phase, "part": label, "mesh": runs[0]["mesh"],
         "coords": [r["coords"] for r in runs], "backend": ranks[0]["backend"],
         "staged_collectives": STAGED, "steps": len(losses),
         "step_ms": [t * 1e3 for t in step_s], "step_ms_median": statistics.median(step_s) * 1e3,
         "micro_step_ms": statistics.median(step_s) * 1e3 / accum,
         "tokens_per_s": tokens / statistics.median(step_s),
         "collective_s_per_step": coll_s,
         "collective_share": (statistics.median(c / t for c, t in zip(coll_s, step_s))
                              if gloo else None),
         "card_wait_s_per_step": wait_s,
         "card_wait_share": (statistics.median(w / t for w, t in zip(wait_s, step_s))
                             if gloo else None),
         "collectives_per_step": runs[0]["steps"][-1]["collectives"],
         "peak_gib_per_rank": [max(s["peak_gib"] for s in r["steps"]) for r in runs],
         "losses": losses, "launches_per_step_per_rank": runs[0]["steps"][-1]["launches"],
         "expected_per_step": expect, "final": runs[0]["final"], "checks": checks,
         "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"phase {phase} {label} failed its checks: {checks}")
    total = {}
    for r in runs:
        for n, c in r["launches"].items():
            total[n] = total.get(n, 0) + c
    return total


def one_process_parity(cfg: dict, seed: int, length: int, ranks: list, part: str,
                       grads_file: Path, label: str, phase: str, cls: int | None = None) -> None:
    """The micro-step of `parallel_grads` in this process on the card (mesh
    1, the fused route) against the ranks' (their loss and rank 0's whole
    gradients in `grads_file`): loss within MODEL_BF16["loss"] relative,
    every gradient within MODEL_BF16["grads"] of its max |g|, and the same
    loss on every rank."""
    import torch

    from hyena_dna_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    x, y = parity_tokens(seed, trainer.device, length, cls)
    model = trainer.model.train()
    loss = trainer.task.compute_loss(model(x, trainer.generator), y, train=True)
    loss.backward()
    loss = loss.item()
    ours = torch.load(grads_file, weights_only=True)
    rank_loss = ranks[0][part]["loss"]
    loss_err = abs(rank_loss - loss) / abs(loss)
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        ref = p.grad.detach().float().cpu()
        err = (ours[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    trainer.close()
    ok = (loss_err <= MODEL_BF16["loss"] and worst <= MODEL_BF16["grads"]
          and set(ours) == {n for n, _ in model.named_parameters()}
          and all(r[part]["loss"] == rank_loss for r in ranks))
    log({"phase": phase, "part": label, "loss_ranks": rank_loss, "loss_single": loss,
         "loss_rel_err": loss_err, "worst_grad_err_of_max": worst, "worst_param": worst_name,
         "tol": {"loss": MODEL_BF16["loss"], "grads": MODEL_BF16["grads"]}, "ok": ok})
    del trainer, model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"phase {part}: the ranks' loss or gradients disagree with one "
                             "process")


def parallel_phase(FB, kernels, tmp: Path, seed: int) -> dict:
    """Phase 10 in phase 6's directory (its genome): the world of ranks,
    then 10c's single-process side, the checks and the lines; returns the
    launches of 10b and 10d summed over the ranks."""
    import torch

    from hyena_dna_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    spawn(parallel_ranks, PAR_WORLD, args=(str(tmp), seed), timeout=900)
    ranks = [json.loads((tmp / f"par_rank{r}.json").read_text()) for r in range(PAR_WORLD)]
    ops = [r["10a"] for r in ranks]
    checks = {"errors_within_tol": True,  # compare() raised on a rank otherwise
              "dk_dD_zero_outside_rows": all(o["dk_dD_zero_outside_rows"] for o in ops),
              "short_conv_bit_equal": all(o["short_conv_bit_equal"] for o in ops),
              "launches": all(o["launches"]["fftconv"] == 1 and o["launches"]["fftconv_bwd"] == 1
                              for o in ops),
              "collectives": all(o["collectives"] == {"all_to_all_single": 4} for o in ops)}
    log({"phase": "parallel", "part": "10a seq_fftconv and seq_short_conv, 4 ranks",
         "backend": ranks[0]["backend"], "staged_collectives": STAGED,
         "signal": [1, D_MODEL, PAR_L], "pencil": ops[0]["pencil"], "dtype": "bfloat16",
         "bit_equal_per_rank": [o["bit_equal"] for o in ops],
         "max_abs_err_per_rank": [o["max_abs_err"] for o in ops],
         "tol": TOL["bfloat16"], "all_to_all_per_rank": [o["all_to_all"] for o in ops],
         "launches_per_rank": [o["launches"] for o in ops], "checks": checks,
         "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"phase 10a failed its checks: {checks}")
    total = {}
    for part, label, accum in (("10b", "10b experiment=hg38/hg38_medium_450k, seq 4", PAR_ACCUM),
                               ("10d", "10d experiment=hg38/hg38_large_1m, data 2 x seq 2", 1)):
        for n, c in check_parallel_run(ranks, part, label, accum, t_phase).items():
            total[n] = total.get(n, 0) + c
    # 10c: the same micro-step in this process on the card (mesh 1, the fused route)
    one_process_parity(parallel_configs(tmp)["10c_single"], seed + 1, PAR_L, ranks, "10c",
                       tmp / "par_grads.pt",
                       "10c 4 ranks vs one process, 1 x 450,000 bf16, dropout off", "parallel")
    torch.cuda.empty_cache()
    log({"phase": "parallel", "part": "summary", "seconds": time.perf_counter() - t_phase,
         "launches": total})
    return total


# Phase 11, tensor parallelism: 4 ranks on a model axis (gloo when they
# share one card), the 1M single-chip config at full width cut to 131,072
# tokens a row, kernels A and A' on each rank's 64-channel slice
TP_WORLD = 4
TP_LENGTH = 131_073  # dataset.max_length: 131,072 tokens a row (fft 2^18), 1M's 1,000,446 cut
TP_TOKENS = TP_LENGTH - 1
TP_SLICES = (128, 64)  # d_c of a model axis of 2 and of 4 at d_model 256
# 11b's steps: each moves 49 float32 partial sums of 128 MiB through gloo's
# host ring (about 0.3 s each on one card), so two, not phase 10's three
TP_STEPS = 2


def tp_configs(tmp: Path) -> dict:
    """11b-11d's configs and the one-process configs 11c and 11d are held
    to (`train/__main__.py::build_config`)."""
    from hyena_dna_tpu_torch.train.__main__ import build_config

    genome = tmp / "genome"
    cut = [f"dataset.max_length={TP_LENGTH}", "dataset.batch_size=1",
           "trainer.accumulate_grad_batches=1"]
    single = ["experiment=hg38/hg38_large_1m_singlechip"] + cut
    large = ["experiment=hg38/hg38_large_1m", "mesh.data=1"] + cut
    off = ["model.embed_dropout=0.0"]
    data = lambda name: parallel_data(genome, tmp / name)
    cfgs = {"11b": build_config(single + ["mesh.model=4"]
                                + parallel_data(genome, tmp / "tp_1m", TP_STEPS)),
            "11c": build_config(single + off + ["mesh.model=4"] + data("tp_parity")),
            "11c_single": build_config(single + off + data("tp_parity_single")),
            "11d": build_config(large + off + ["mesh.seq=2", "mesh.model=2"] + data("tp_seq")),
            "11d_single": build_config(large + off + ["mesh.seq=1", "mesh.model=1"]
                                       + data("tp_seq_single"))}
    for name in ("11d", "11d_single"):
        cfgs[name]["callbacks"].pop("seqlen_warmup_reload")  # the curriculum is cut
    return cfgs


def tp_ranks(tmp: str, seed: int) -> None:
    """Each rank of the phase 11 world: join (`initialize_distributed`: the
    card, gloo when the ranks share it), then 11b's trainer run and the
    micro-steps of 11c and 11d, each with its launches."""
    import torch

    from hyena_dna_tpu_torch.parallel import launch
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    kernels = port_kernels()
    launch.initialize_distributed(torch.device("cuda"))
    tmp = Path(tmp)
    cfgs = tp_configs(tmp)
    res = {"backend": torch.distributed.get_backend(),
           "11b": parallel_trainer(kernels, cfgs["11b"])}
    for i, part in enumerate(("11c", "11d")):
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(kernels)
        loss, grads = parallel_grads(cfgs[part], seed + 1 + i, TP_TOKENS)
        res[part] = {"loss": loss, "launches": read_counts(kernels)}
        if launch.is_main_process():
            torch.save(grads, tmp / f"{part}_grads.pt")
        del grads
    (tmp / f"tp_rank{launch.rank()}.json").write_text(json.dumps(res))


def tp_phase(FF, FB, kernels, tmp: Path, seed: int):
    """Phase 11 in phase 6's directory (its genome). 11a: kernels A and A'
    on a rank's channel slice (d_in 256, d_c 128 and 64, float32 and bf16,
    4 x 32768) and B and C on 11b's 1 x 64 x 131072 slice, each against
    its plain version; then the world of ranks (11b-11d) and the one-process
    sides of 11c and 11d. Returns (11a's rows, the launches of 11b-11d
    summed over the ranks)."""
    import torch

    from hyena_dna_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    rows = []
    for i, (dtype, d_c) in enumerate((dt, c) for dt in ("float32", "bfloat16")
                                     for c in TP_SLICES):
        rows += [check_front(FF, 4, 32768, 120 + 2 * i, dtype, d_c=d_c),
                 check_front_bwd(FF, 4, 32768, 121 + 2 * i, dtype, d_c=d_c)]
    rows += [check_conv(FB, 1, TP_TOKENS, "bfloat16", "pallas_fftconv_n3.py:413 TP slice", 130,
                        C=D_MODEL // TP_WORLD),
             check_conv_bwd(FB, FB.fftconv_bwd_retransform, 1, TP_TOKENS, "bfloat16",
                            "pallas_fftconv_n3.py:629 TP slice", 131, C=D_MODEL // TP_WORLD)]
    for row in rows:
        log({"phase": "tensor_parallel", "part": "11a slice kernels", **row})
    torch.cuda.empty_cache()
    spawn(tp_ranks, TP_WORLD, args=(str(tmp), seed), timeout=900)
    ranks = [json.loads((tmp / f"tp_rank{r}.json").read_text()) for r in range(TP_WORLD)]
    fronts = expected_launches("bf16", 1, remat="residual", group=2, residual="fp32")
    total = check_parallel_run(ranks, "11b", "11b experiment=hg38/hg38_large_1m_singlechip, "
                               "model 4", 1, t_phase, fronts, "tensor_parallel", TP_STEPS)
    seq_route = {n: N_LAYER if n in ("fftconv", "fftconv_bwd") else 0 for n in fronts}
    checks = {"11c_launches": all(r["11c"]["launches"] == fronts for r in ranks),
              "11d_launches": all(r["11d"]["launches"] == seq_route for r in ranks)}
    log({"phase": "tensor_parallel", "part": "11c/11d launches a micro-step",
         "11c": ranks[0]["11c"]["launches"], "11d": ranks[0]["11d"]["launches"],
         "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"phase 11 launches: {checks}")
    for r in ranks:
        for part in ("11c", "11d"):
            for n, c in r[part]["launches"].items():
                total[n] = total.get(n, 0) + c
    cfgs = tp_configs(tmp)
    one_process_parity(cfgs["11c_single"], seed + 1, TP_TOKENS, ranks, "11c",
                       tmp / "11c_grads.pt", "11c model 4 vs one process, 1 x 131,072 bf16, "
                       "dropout off", "tensor_parallel")
    one_process_parity(cfgs["11d_single"], seed + 2, TP_TOKENS, ranks, "11d",
                       tmp / "11d_grads.pt", "11d experiment=hg38/hg38_large_1m, seq 2 x "
                       "model 2 vs one process, 1 x 131,072 bf16, dropout off",
                       "tensor_parallel")
    log({"phase": "tensor_parallel", "part": "summary", "seconds": time.perf_counter() - t_phase,
         "launches": total})
    return rows, total


# Phase 12, the mesh's remaining combinations: kernels A4 and A4' on a
# rank's channel slice (12a, this process), then one world of MR_WORLD
# ranks on the one card (gloo) for 12b-12e, each rank writing its record
MR_WORLD = 4
MR_STEPS = 2
MR_SPECIES_LENGTH = 131_072  # 12c: species_classification's window, the seq-4 cut
MR_SPECIES_BATCH = 4  # shipped 32: four ranks' activations on one card
MR_SPECIES_BASES = 140_000  # human and mouse chromosomes that hold a 131,072 window
MR_ATTN_LENGTH = 8193  # 12d: hg38_attention's max_length (8192 tokens a row)
MR_ATTN_BATCH = 4  # shipped 256, cut for the time limit
MR_LAST_K = 1024
MR_OP_SHAPE = (1, 32768)  # 12e: phase 9d's operator, one row (outer mixing's 4-D products)
MR_OP_TOL = {"y": 1e-2, "du": 2e-2, "grads": 5e-2}  # the bf16 operator, as 9d and MODEL_BF16
MR_F4_PLAN = (16, 128, 128)  # fft 2^18: the 4-D plan at 131,072 tokens, odd B


def mesh_rest_configs(tmp: Path) -> dict:
    """12b-12d's configs and the one-process configs their micro-steps are
    held to (`train/__main__.py::build_config`)."""
    from hyena_dna_tpu_torch.train.__main__ import build_config

    genome = tmp / "genome"
    data = lambda name, steps=MR_STEPS: parallel_data(genome, tmp / name, steps)
    front4 = ["experiment=hg38/hg38_large_1m_singlechip", "model.layer.front4=true",
              f"dataset.max_length={TP_LENGTH}", "dataset.batch_size=1",
              "trainer.accumulate_grad_batches=1"]
    species = ["experiment=hg38/species_classification",
               f"dataset.species_dir={tmp / 'species_131k'}",
               f"dataset.max_length={MR_SPECIES_LENGTH}",
               f"dataset.batch_size={MR_SPECIES_BATCH}",
               f"dataset.total_size={MR_SPECIES_BATCH * MR_STEPS}"]
    attention = ["experiment=hg38/hg38_attention", f"dataset.max_length={MR_ATTN_LENGTH}",
                 f"dataset.batch_size={MR_ATTN_BATCH}", f"task.last_k_ppl={MR_LAST_K}",
                 f"task.seq_len={MR_ATTN_LENGTH - 1}"]
    off = ["model.embed_dropout=0.0"]
    attn_off = off + ["model.attn_cfg.dropout=0.0"]
    cfgs = {"12b": build_config(front4 + ["mesh.model=4"] + data("mr_front4")),
            "12b_parity": build_config(front4 + off + ["mesh.model=4"] + data("mr_f4_parity")),
            "12b_single": build_config(front4 + off + data("mr_f4_single")),
            "12c": build_config(species + ["mesh.seq=4"] + data("mr_species")),
            "12c_parity": build_config(species + off + ["mesh.seq=4"] + data("mr_sp_parity")),
            "12c_single": build_config(species + off + data("mr_sp_single")),
            "12d": build_config(attention + attn_off + ["mesh.data=2", "mesh.seq=2"]
                                + data("mr_attention")),
            "12d_parity": build_config(attention + attn_off + ["mesh.data=2", "mesh.seq=2"]
                                       + data("mr_at_parity")),
            "12d_single": build_config(attention + attn_off + data("mr_at_single"))}
    return cfgs


def general_hyena_tp(kernels, mesh, seed: int) -> dict:
    """12e on one rank of a model pair: phase 9d's order-3 operator (d 256,
    bf16) with two heads, `post_order_ffn` and `outer_mixing` split over the
    model axis of 2 (each rank one head: kernels B and C on its head's
    (B, head_dim) convs), forward and backward at MR_OP_SHAPE, against the
    same operator whole on the card (the same weights, input and cotangent):
    y, du and every gathered gradient."""
    import torch

    from hyena_dna_tpu_torch.models.hyena import HyenaOperator
    from hyena_dna_tpu_torch.parallel.sharding import (PARTIAL, SHARDED, gather_tensor,
                                                       shard_state_dict, tp_layout)

    b, length = MR_OP_SHAPE
    kw = dict(d_model=D_MODEL, l_max=length, order=3, num_heads=2, filter_order=64,
              post_order_ffn=True, outer_mixing=True, filter_cfg=dict(emb_dim=5, w=10),
              dtype=torch.bfloat16)
    whole = HyenaOperator(**kw)
    whole.init_weights(torch.Generator().manual_seed(seed))
    split = HyenaOperator(**kw, mesh=mesh)
    layout = tp_layout(split)
    split.load_state_dict(shard_state_dict(whole.state_dict(), mesh, layout))
    whole, split = whole.cuda().train(), split.cuda().train()
    gen = torch.Generator().manual_seed(seed + 1)
    u = torch.randn(b, length, D_MODEL, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(b, length, D_MODEL, generator=gen).to("cuda", torch.bfloat16)

    def run(op):
        x = u.clone().requires_grad_(True)
        y = op(x)
        y.backward(dy)
        return y.detach(), x.grad

    zero_counts(kernels)
    y, du = run(split)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    grads = {}
    for name, prm in split.named_parameters():
        g = prm.grad.detach().float()
        kind = layout.get(name, ("",))
        if kind[0] == SHARDED:
            g = gather_tensor(g, *kind[1:], mesh)
        elif kind[0] == PARTIAL:
            torch.distributed.all_reduce(g, group=mesh.model_group)
        grads[name] = g
    y_ref, du_ref = run(whole)
    ref = {n: p.grad.detach().float() for n, p in whole.named_parameters()}
    err = {"y": rel_err(y, y_ref), "du": rel_err(du, du_ref),
           "grads": max(rel_err(grads[n], ref[n]) for n in ref)}
    worst = max(ref, key=lambda n: rel_err(grads[n], ref[n]))
    return {"launches": launches, "rel_err": err, "worst_param": worst,
            "same_params": sorted(grads) == sorted(ref), "split": split.split,
            "finite": bool(torch.isfinite(y).all()), "coords": [mesh.model_index]}


def mesh_rest_ranks(tmp: str, seed: int) -> None:
    """Each rank of the phase 12 world: join (`initialize_distributed`: the
    card, gloo when the ranks share it), then 12b's trainer run (model 4,
    front4) and micro-step, 12c's (species, seq 4) and 12d's (attention,
    data 2 x seq 2), then 12e's operator on the model pairs of a data 2 x
    model 2 mesh (data index 0 runs it, index 1 waits)."""
    import torch

    from hyena_dna_tpu_torch.parallel import launch
    from hyena_dna_tpu_torch.parallel.sharding import make_mesh
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    kernels = port_kernels()
    launch.initialize_distributed(torch.device("cuda"))
    tmp = Path(tmp)
    cfgs = mesh_rest_configs(tmp)
    res = {"backend": torch.distributed.get_backend()}
    label = {"12b": None, "12c": 1, "12d": None}
    length = {"12b": TP_TOKENS, "12c": MR_SPECIES_LENGTH, "12d": MR_ATTN_LENGTH - 1}
    for i, part in enumerate(("12b", "12c", "12d")):
        gc.collect()
        torch.cuda.empty_cache()
        res[part] = parallel_trainer(kernels, cfgs[part])
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(kernels)
        loss, grads = parallel_grads(cfgs[f"{part}_parity"], seed + 1 + i, length[part],
                                     label[part])
        res[f"{part}_parity"] = {"loss": loss, "launches": read_counts(kernels)}
        if launch.is_main_process():
            torch.save(grads, tmp / f"{part}_grads.pt")
        del grads
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(data=2, seq=1, model=2)
    if mesh.data_index == 0:
        res["12e"] = general_hyena_tp(kernels, mesh, seed + 5)
    launch.barrier()
    (tmp / f"mr_rank{launch.rank()}.json").write_text(json.dumps(res))


def mesh_rest_phase(FF, kernels, tmp: Path, seed: int):
    """Phase 12 in phase 6's directory (its genome). 12a: kernels A4 and A4'
    on a rank's channel slice (1 x 131,072 x 256 onto d_c 128 and 64,
    float32 and bf16, plan (16, 128, 128)) against their plain versions;
    then the world of ranks (12b-12e) and the one-process sides of 12b-12d.
    Returns (12a's rows, the launches of 12b-12e summed over the ranks)."""
    import torch

    from hyena_dna_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    rows = []
    for i, (dtype, d_c) in enumerate((dt, c) for dt in ("float32", "bfloat16")
                                     for c in TP_SLICES):
        rows += [check_front4(FF, 1, TP_TOKENS, MR_F4_PLAN, dtype, 140 + 2 * i, d_c),
                 check_front4_bwd(FF, 1, TP_TOKENS, MR_F4_PLAN, dtype, 141 + 2 * i, d_c)]
    for row in rows:
        log({"phase": "mesh_rest", "part": "12a A4 and A4' on a channel slice", **row})
    torch.cuda.empty_cache()
    write_species(tmp / "species_131k", seed, ("human", "mouse"), MR_SPECIES_BASES)
    spawn(mesh_rest_ranks, MR_WORLD, args=(str(tmp), seed), timeout=900)
    ranks = [json.loads((tmp / f"mr_rank{r}.json").read_text()) for r in range(MR_WORLD)]
    front4 = expected_launches("bf16", 1, remat="residual", group=2, front4=True,
                               residual="fp32")
    seq_route = lambda n_layer: {n: n_layer if n in ("fftconv", "fftconv_bwd") else 0
                                 for n in front4}
    species_layers = 2
    expected = {"12b": front4, "12c": seq_route(species_layers), "12d": seq_route(0)}
    labels = {"12b": "12b experiment=hg38/hg38_large_1m_singlechip front4, model 4",
              "12c": "12c experiment=hg38/species_classification, seq 4",
              "12d": "12d experiment=hg38/hg38_attention, data 2 x seq 2, last_k_ppl"}
    total = {}
    for part in ("12b", "12c", "12d"):
        # 12c's two steps need not lower the loss: the shipped species run
        # warms up from lr 1e-6 over 60 steps (step 2 at 2.6e-6) with embed
        # dropout 0.1, on two batches of other random windows; its check of
        # the math is the micro-step against one process below
        for n, c in check_parallel_run(ranks, part, labels[part], 1, t_phase, expected[part],
                                       "mesh_rest", MR_STEPS, falls=part != "12c").items():
            total[n] = total.get(n, 0) + c
    finals = {part: ranks[0][part]["final"] for part in ("12c", "12d")}
    checks = {f"{p}_launches": all(r[f"{p}_parity"]["launches"] == expected[p] for r in ranks)
              for p in expected}
    # the evaluations: finite, and the same on every rank (the seq ranks'
    # pooled logits and per-position NLL joined by the collectives)
    agree = lambda a, b: all(abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1.0) for k in b
                             if isinstance(b[k], float)) and a.keys() == b.keys()
    for part, keys in (("12c", ("test/loss", "test/accuracy")),
                       ("12d", ("test/loss", "test/last_k_ppl"))):
        checks[f"{part}_eval_finite"] = all(math.isfinite(finals[part].get(k, math.nan))
                                            for k in keys)
        checks[f"{part}_eval_ranks_agree"] = all(agree(r[part]["final"], finals[part])
                                                 for r in ranks)
    log({"phase": "mesh_rest", "part": "12b-12d micro-step launches and evaluations",
         "launches": {p: ranks[0][f"{p}_parity"]["launches"] for p in expected},
         "final": finals, "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"phase 12 launches or evaluations: {checks}")
    for r in ranks:
        for part in expected:
            for n, c in r[f"{part}_parity"]["launches"].items():
                total[n] = total.get(n, 0) + c
    cfgs = mesh_rest_configs(tmp)
    cls = {"12c": 1}
    length = {"12b": TP_TOKENS, "12c": MR_SPECIES_LENGTH, "12d": MR_ATTN_LENGTH - 1}
    for i, part in enumerate(("12b", "12c", "12d")):
        one_process_parity(cfgs[f"{part}_single"], seed + 1 + i, length[part], ranks,
                           f"{part}_parity", tmp / f"{part}_grads.pt",
                           f"{labels[part]} vs one process, dropout off", "mesh_rest",
                           cls.get(part))
    ops = [r["12e"] for r in ranks if "12e" in r]
    conv = {n: 2 if n in ("fftconv", "fftconv_bwd") else 0 for n in front4}
    checks = {"ranks": len(ops) == 2, "launches": all(o["launches"] == conv for o in ops),
              "split": all(o["split"] == "heads" for o in ops),
              "finite": all(o["finite"] for o in ops),
              "same_params": all(o["same_params"] for o in ops),
              **{f"{k}_within_tol": all(o["rel_err"][k] <= tol for o in ops)
                 for k, tol in MR_OP_TOL.items()}}
    log({"phase": "mesh_rest", "part": "12e order-3 Hyena, 2 heads, post-order FFN and outer "
         "mixing, model 2 vs whole", "B": MR_OP_SHAPE[0], "L": MR_OP_SHAPE[1], "d": D_MODEL,
         "precision": "bf16", "rel_err": [o["rel_err"] for o in ops],
         "worst_param": [o["worst_param"] for o in ops], "tol": MR_OP_TOL,
         "launches_per_rank": [o["launches"] for o in ops], "checks": checks,
         "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"phase 12e failed its checks: {checks}")
    for o in ops:
        for n, c in o["launches"].items():
            total[n] = total.get(n, 0) + c
    log({"phase": "mesh_rest", "part": "summary", "seconds": time.perf_counter() - t_phase,
         "launches": total})
    return rows, total


COLD_BUILD_CHILD = """
import json, os, sys, time
from pathlib import Path
import torch
from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops import add_ln as AL
_cuda.BUILD_DIR = Path(sys.argv[1])
hand = Path(sys.argv[2])
(hand / f"ready.{os.getpid()}").touch()
deadline = time.monotonic() + 120
while len(list(hand.glob("ready.*"))) < 2:  # the other process is there too
    if time.monotonic() > deadline:
        sys.exit("the other build process never started")
    time.sleep(0.01)
g = torch.Generator(device="cuda").manual_seed(int(sys.argv[3]))
h, res = (torch.randn(64, 256, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2))
w, b = torch.randn(256, device="cuda", generator=g), torch.randn(256, device="cuda", generator=g)
t0 = time.perf_counter()
y, res_out = AL.add_ln_fwd(h, res, w, b, 1e-5)  # the first launch builds the library
torch.cuda.synchronize()
build_s = time.perf_counter() - t0
errs = []
for out, ref in zip((y, res_out), AL.add_ln_ref(h, res, w, b, 1e-5)):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert bool((err <= 2e-3 * ref.abs().max() + 2 ** -7 * ref.abs()).all()), err.max()
    errs.append(err.max().item())
print(json.dumps({"build_s": build_s, "launches": AL.KERNEL.launches,
                  "library": AL.KERNEL.library_path.name, "max_abs_err": max(errs)}))
"""


def cold_build_phase(seed: int) -> None:
    """Two processes build kernel D into one fresh build directory at once
    (each process's own temporary name, renamed into place); both run it
    against its plain version, and one library, one log and no temporary
    file are left."""
    with tempfile.TemporaryDirectory() as tmp:
        build, hand = Path(tmp) / "build", Path(tmp) / "handshake"
        hand.mkdir()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", COLD_BUILD_CHILD, str(build), str(hand),
                                   str(seed + i)], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for i in range(2)]
        outs = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    raise AssertionError(f"cold build process failed ({proc.returncode}):\n{err}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        left = sorted(p.name for p in build.iterdir())
        libraries = [name for name in left if name.endswith(".so")]
        temporaries = [name for name in left if name.endswith(".tmp")]
        if len(libraries) != 1 or temporaries or len(left) != 2:
            raise AssertionError(f"a cold build left {left}")
        if {o["library"] for o in outs} != set(libraries) or any(o["launches"] != 1 for o in outs):
            raise AssertionError(f"the cold build processes disagree: {outs}")
        log({"phase": "cold_build", "processes": 2, "kernel": "add_ln",
             "build_s": [o["build_s"] for o in outs], "wall_s": time.perf_counter() - t0,
             "max_abs_err": max(o["max_abs_err"] for o in outs), "left": left,
             "tmp_left": len(temporaries)})


def device_guard_phase(FF, FB, seed: int) -> None:
    """Kernels A, A', B and C on cuda:1 while the current device is 0,
    against their plain versions (computed on cuda:1 too); needs two cards."""
    import torch

    # the guard's host cost a launch (`Kernel.launch`'s), on the current card (no switch)
    here, reps = torch.device("cuda", torch.cuda.current_device()), 100_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with torch.cuda.device(here):
            pass
    guard_us = (time.perf_counter() - t0) / reps * 1e6
    cards = torch.cuda.device_count()
    if cards < 2:
        log({"phase": "device_guard", "cards": cards, "guard_us": guard_us,
             "skipped": "needs two cards: kernels on cuda:1 while the current device is 0"})
        return
    from hyena_dna_tpu_torch.ops.fftconv import fftconv_ref

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    kernels = (FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD)
    rows = []
    for i, (B, L, d, dtype) in enumerate(((32, 1024, TRAINER_D, "float32"),
                                          (4, 32768, D_MODEL, "bfloat16"))):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        dt = getattr(torch, dtype)
        rnd = lambda *shape, scale=1.0: torch.randn(*shape, device=dev, generator=g) * scale
        uniform = lambda *shape: (torch.rand(*shape, device=dev, generator=g) * 2 - 1) / 3 ** 0.5
        u = rnd(B, L, d).to(dt)  # the parameters at `front_inputs`' scales
        params = (rnd(d, 3 * d, scale=0.02), rnd(3 * d, scale=0.02), uniform(3, 3 * d),
                  uniform(3 * d))
        cot = (rnd(B, d, L).to(dt), rnd(B, d, L).to(dt))
        x, dy = rnd(B, d, L).to(dt), rnd(B, d, L).to(dt)
        k = (rnd(d, L, scale=0.05) * torch.exp(-torch.arange(L, device=dev) / (L / 8))).to(dt)
        D = rnd(d)
        before = [kern.launches for kern in kernels]
        outs = {"fused_front": FF.front_fwd(u, *params),
                "fused_front_bwd": FF.front_bwd(u, *params, *cot),
                "fftconv": (FB.fftconv_fused(x, k, D),),
                "fftconv_bwd": FB.fftconv_bwd_retransform(x, dy, k, D)}
        torch.cuda.synchronize(dev)
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"the current device moved to {torch.cuda.current_device()}")
        if [kern.launches - b for kern, b in zip(kernels, before)] != [1, 1, 1, 1]:
            raise AssertionError("a kernel of the device-guard check did not launch once")
        refs = {"fused_front": FF.reference_fwd(u, *params),
                "fused_front_bwd": FF.reference_bwd(u, *params, *cot),
                "fftconv": (fftconv_ref(x, k, D),),
                "fftconv_bwd": FB.fftconv_bwd_ref(x, dy, k, D)}
        for name, out in outs.items():
            errs = []
            for o, r in zip(out, refs[name]):
                if o.device != dev:
                    raise AssertionError(f"{name} wrote to {o.device}, not {dev}")
                errs.append(compare(o, r, "float32" if o.dtype == torch.float32 else dtype)[0])
            rows.append({"name": name, "shape": f"B={B} L={L} d={d} {dtype}",
                         "max_abs_err": max(errs)})
    log({"phase": "device_guard", "cards": cards, "guard_us": guard_us, "device": str(dev),
         "current_device": 0, "rows": rows})


def port_kernels() -> list:
    """Every hand-written kernel of the port, in the build's order."""
    from hyena_dna_tpu_torch.ops import add_ln as AL
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE
    from hyena_dna_tpu_torch.ops import mlp_fused as MF

    return [FF.KERNEL, FF.KERNEL_BWD, FB.KERNEL, FB.KERNEL_BWD, AL.KERNEL, AL.KERNEL_BWD,
            GE.KERNEL, GE.KERNEL_BWD, FF.KERNEL4, FF.KERNEL4_BWD, MF.KERNEL, MF.KERNEL_BWD]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "hyena_dna_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from hyena_dna_tpu_torch import _cuda, bench
    from hyena_dna_tpu_torch.evals import hg38_inference as cli
    from hyena_dna_tpu_torch.ops import add_ln as AL
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF
    from hyena_dna_tpu_torch.ops import gated_fftconv as GE
    from hyena_dna_tpu_torch.ops import mlp_fused as MF
    from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    start = time.perf_counter()
    set_card_numerics()
    kernels = port_kernels()
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    _cuda.build_all(kernels)
    build_seconds = time.perf_counter() - t0
    ptxas = kernel_ptxas(kernels)
    log({"phase": "build", "seconds": build_seconds,
         "libraries": [k.library_path.name for k in kernels], "ptxas": ptxas})
    # the four-step passes' third class (csrc/fft_common.cuh, kSchedLogN1 /
    # kSchedLogN2: 2^19's 128-point columns, the 4-point passes of 2^4 and 2^5)
    log({"phase": "build_sched_class", "build_seconds": build_seconds,
         "ptxas": {lib: {key: r for key, r in readings.items()
                         if not key.startswith("short_") and re.search(r"[<,]0(,sum)?>$", key)}
                   for lib, readings in ptxas.items() if lib.startswith("fftconv")}})
    cold_build_phase(130)
    device_guard_phase(FF, FB, 132)
    log(check_wgmma(FF, 64, "wgmma_probe", 90))
    log(check_wgmma(MF, 256, "mlp_wgmma_probe", 91))

    rows = [check_front(FF, 4, 32768, 1), check_front(FF, 1, 1000448, 2),
            check_front_bwd(FF, 4, 32768, 8)]
    rows += check_add_ln(AL, 4, 32768, 9)
    bf16_rows = [check_front(FF, 4, 32768, 10, "bfloat16"),
                 check_front_bwd(FF, 4, 32768, 18, "bfloat16")]
    # kernel B through each forward TPU row's named entry, with its plan on
    # padded operands (the generic call at 2 x 8192 and at the 1M model shape)
    p16, p18 = (256, 256, 8), (512, 512, 8)
    rows += [check_conv(FB, 2, 8192, "float32", "XLA FFT on the TPU", 3),
             check_conv(FB, 4, 32768, "bfloat16", "pallas_fftconv.py:1119 packed", 4,
                        FB.fftconv_fused_fwd_packed, p16),
             check_conv(FB, 1, 32768, "bfloat16", "pallas_fftconv.py:296 unpacked", 5,
                        FB.fftconv_fused_fwd, p16),
             check_conv(FB, 1, 131072, "bfloat16", "pallas_fftconv_n3.py:413 outer", 6,
                        FB.fftconv_outer_fwd, (16, 128, 128)),
             check_conv(FB, 1, 1000448, "bfloat16", "pallas_fftconv_n3.py:413 outer", 7),
             # the 450k training step's own call (fft 2^20, 256 x 4096)
             check_conv(FB, 1, 450048, "bfloat16", "pallas_fftconv_n3.py:413 450k step", 19),
             # stage 3 of hg38_large_1m's curriculum (fft 2^19, 128 x 4096)
             check_conv(FB, 1, 1 << 18, "bfloat16", "pallas_fftconv_n3.py:413 outer", 140,
                        FB.fftconv_outer_fwd, (16, 128, 256))]
    for entry, B, L, dtype, route, seed, plan in (
            (None, 2, 8192, "float32", "XLA FFT on the TPU", 20, ()),
            (FB.fftconv_fused_bwd_spec_packed, 4, 32768, "bfloat16", "pallas_fftconv.py:1344", 21,
             p16),
            (FB.fftconv_fused_bwd_packed, 4, 32768, "bfloat16", "pallas_fftconv.py:1222", 22, p16),
            (FB.fftconv_fused_bwd_spec, 1, 32768, "bfloat16", "pallas_fftconv.py:519", 23, p16),
            (FB.fftconv_fused_bwd, 1, 32768, "bfloat16", "pallas_fftconv.py:398", 24, p16),
            (FB.fftconv_fused_bwd_split, 2, 131072, "bfloat16",
             "pallas_fftconv.py:687 + :775", 25, p18),
            (FB.fftconv_outer_bwd, 1, 131072, "bfloat16", "pallas_fftconv_n3.py:629", 26,
             (16, 128, 128)),
            (FB.fftconv_outer_bwd, 1, 1 << 20, "bfloat16", "pallas_fftconv_n3.py:629", 27,
             (16, 512, 256)),
            (FB.fftconv_outer_bwd, 1, 1 << 18, "bfloat16", "pallas_fftconv_n3.py:629", 141,
             (16, 128, 256)),
            # the flat 1M and the 450k training steps' own calls: unpadded, L < n / 2
            (None, 1, 1000448, "bfloat16", "pallas_fftconv_n3.py:629 flat 1M step", 28, ()),
            (None, 1, 450048, "bfloat16", "pallas_fftconv_n3.py:629 450k step", 29, ())):
        rows.append(check_conv_bwd(FB, entry or FB.fftconv_bwd_retransform, B, L, dtype,
                                   route, seed, plan))
    # the routes no default path takes: the narrow plan at fft 2^19 (B 1,
    # C 256, scripts/bench_conv_narrow.py's shape), the 3-factor plans at
    # every size of their table, the dk spectrum
    # at scripts/conv_micro.py's shape
    narrow = FB.plan(1 << 19, D_MODEL, 1 << 18, FB.nat_chain(1 << 19))
    rows += [check_conv(FB, 1, 1 << 18, "bfloat16", "pallas_fftconv.py:890 narrow", 70,
                        FB.fftconv_fused_fwd_narrow, narrow),
             check_conv_bwd(FB, FB.fftconv_fused_bwd_narrow, 1, 1 << 18, "bfloat16",
                            "pallas_fftconv.py:987 narrow", 71, narrow)]
    for i, (n, (factors, cb)) in enumerate(FB.PLAN3_BY_N.items()):
        plan3 = (*factors, cb)
        rows += [check_conv(FB, 1, n // 2, "bfloat16", "pallas_fftconv3.py:293", 72 + 2 * i,
                            FB.fftconv3_fwd, plan3),
                 check_conv_bwd(FB, FB.fftconv3_bwd, 1, n // 2, "bfloat16",
                                "pallas_fftconv3.py:390", 73 + 2 * i, plan3)]
    rows.append(check_dk_spec(FB, 4, 32768, "float32", p16, 79))
    rows += check_mlp(MF, 4, 32768, "bfloat16", 80)
    rows += check_mlp(MF, 1, 32768, "float32", 81)
    rows += check_mlp(MF, 4, 32768, "bfloat16", 83, d=512)  # a width F/F' once refused
    rows += [check_gated(GE, 4, 32768, "bfloat16", variant, 40 + i)
             for i, variant in enumerate(("specv", "spec", "y"))]
    rows.append(check_gated(GE, 2, 65536, "bfloat16", "specv", 43))
    rows += [check_gated_bwd(GE, route, 4, 32768, "bfloat16", 44 + i)
             for i, route in enumerate(("specv", "spec", "retransform"))]
    rows.append(check_gated_bwd(GE, "specv", 2, 65536, "bfloat16", 47))
    # E' through its generic wrappers at B = 1 (K's rows on chip in the row
    # pass) and at fft 2^20 (1 x 450,048: the row pair over a 2-CTA cluster)
    rows += [check_gated_bwd(GE, route, 1, L, "bfloat16", 92 + i, generic=True)
             for i, (route, L) in enumerate((("specv", 32768), ("spec", 32768),
                                             ("specv", 450048), ("spec", 450048)))]
    # kernels A4 and A4' at the 1M step's plan and at fft 2^18 (odd B)
    for i, (L, plan) in enumerate(((1000448, (16, 512, 256)), (131072, (16, 128, 128)))):
        for j, dtype in enumerate(("float32", "bfloat16")):
            rows.append(check_front4(FF, 1, L, plan, dtype, 50 + 4 * i + 2 * j))
            rows.append(check_front4_bwd(FF, 1, L, plan, dtype, 51 + 4 * i + 2 * j))
    # the trainer's shapes (phase 6): A, A' in bf16 at d = 128 (two 64-column
    # panels), B and C at fft 2^11 with float32 conv I/O (L < 2^15)
    trainer_rows = [
        check_front(FF, 32, 1024, 100, "bfloat16", d=TRAINER_D),
        check_front_bwd(FF, 32, 1024, 101, "bfloat16", d=TRAINER_D),
        check_conv(FB, 32, 1024, "float32", "XLA FFT on the TPU (trainer)", 102, C=TRAINER_D),
        check_conv_bwd(FB, FB.fftconv_bwd_retransform, 32, 1024, "float32",
                       "XLA FFT on the TPU (trainer)", 103, C=TRAINER_D)]
    rows += trainer_rows
    # kernels B and C's short path (fft 2^4 to the cut, csrc/fft_short.cuh):
    # the sweep against the plain versions, then the species curriculum's
    # first three stages (phase 8c, d = 128, float32 conv I/O): 128 x 1024
    # (fft 2^11), 64 x 2048 (fft 2^12) and 32 x 4096 (fft 2^13, the cut)
    log(check_short_path(FB, 118))
    short_rows = []
    for i, (B, L) in enumerate(((128, 1024), (64, 2048), (32, 4096))):
        stage = f"XLA FFT on the TPU (species stage {i + 1})"
        short_rows += [check_conv(FB, B, L, "float32", stage, 120 + 2 * i, C=TRAINER_D),
                       check_conv_bwd(FB, FB.fftconv_bwd_retransform, B, L, "float32", stage,
                                      121 + 2 * i, C=TRAINER_D)]
    rows += short_rows
    # the species curriculum's last stage (phase 8c): A, A' in bf16 at d = 128,
    # B and C at fft 2^16 with bf16 conv I/O, C on the retransform route the
    # checkpointed cells take
    species_rows = [
        check_front(FF, 4, 32768, 104, "bfloat16", d=TRAINER_D),
        check_front_bwd(FF, 4, 32768, 105, "bfloat16", d=TRAINER_D),
        check_conv(FB, 4, 32768, "bfloat16", "pallas_fftconv.py:1119 (species stage 6)", 106,
                   C=TRAINER_D),
        check_conv_bwd(FB, FB.fftconv_bwd_retransform, 4, 32768, "bfloat16",
                       "pallas_fftconv.py:1222 (species stage 6)", 107, C=TRAINER_D)]
    rows += species_rows
    # phase 10's channel pencils: 1 x 64 x 450,000 (10b, fft 2^20) and
    # 1 x 128 x 131,072 (10d, fft 2^18), each rank's conv in the seq route;
    # and hg38_large_1m's stage 3 on its seq 8: 1 x 32 x 262,144 (fft 2^19)
    parallel_rows = []
    for i, (C, L) in enumerate(((D_MODEL // PAR_WORLD, PAR_L), (D_MODEL // 2, 1 << 17),
                                (D_MODEL // 8, 1 << 18))):
        parallel_rows += [
            check_conv(FB, 1, L, "bfloat16", "pallas_fftconv_n3.py:413 seq pencil", 110 + 2 * i,
                       C=C),
            check_conv_bwd(FB, FB.fftconv_bwd_retransform, 1, L, "bfloat16",
                           "pallas_fftconv_n3.py:629 seq pencil", 111 + 2 * i, C=C)]
    rows += parallel_rows
    for row in rows + bf16_rows:
        log({"phase": "kernel", **row})
    log(check_outer4(FB, 1, 1000448, (16, 512, 256), "bfloat16", 60))
    log(check_outer4(FB, 1, 131072, (16, 128, 128), "bfloat16", 61))
    # this slice's own path, its counts read on their own
    total = {k.name: 0 for k in kernels}
    for name, n in mlp_module(kernels, 4, 32768, 82).items():
        total[name] += n

    slice_parity(cli.build_model, 2, 8192, "float32", 11)
    slice_parity(cli.build_model, 1, 32768, "bfloat16", 12)
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 8192, "float32", 15)
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 32768, "bfloat16", 16)
    slice_parity(cli.build_model, 2, 8192, "float32", 30, "bf16")
    slice_parity(cli.build_model, 1, 32768, "bfloat16", 31, "bf16")
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 8192, "float32", 32, "bf16")
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 32768, "bfloat16", 33, "bf16")
    # the gate-fused conv (kernels E, E'): the gated route takes even B at fft 2^16
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 24576, "float32", 34, "bf16", "specv")
    grad_parity(cli.build_model, cross_entropy, kernels, 2, 32768, "bfloat16", 35, "bf16", "specv")
    for seed, gated in ((36, "spec"), (37, "retransform")):
        grad_parity(cli.build_model, cross_entropy, kernels, 2, 24576, "float32", seed,
                    gated=gated)
    # checkpointing and the 4-D route on the card, against the plain step;
    # then card against CPU with both (fft 2^17, odd B: plan (4, 256, 128))
    plain = ("off", 1, False)
    card_pair(cli.build_model, cross_entropy, kernels, 1, 131072, 62, plain, ("residual", 2, False),
              "remat_vs_plain")
    card_pair(cli.build_model, cross_entropy, kernels, 1, 131072, 63, plain, ("off", 1, True),
              "front4_vs_flat")
    grad_parity(cli.build_model, cross_entropy, kernels, 1, 65536, "bfloat16", 64,
                remat=("residual", 2, True))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta = tmp / "synthetic.fa"
        write_fasta(fasta, 1_100_000, seed=13)
        for max_length, batch_size, n_windows in ((32768, 4, 8), (1000448, 1, 1)):
            for name, n in serve(cli, kernels, tmp, fasta, max_length, batch_size,
                                 n_windows, seed=14).items():
                total[name] += n
    step_ms = {}
    for batch, length, precision, gated in ((4, 32768, "fp32", None), (1, 131072, "fp32", None),
                                            (4, 32768, "bf16", None), (4, 32768, "bf16", "specv"),
                                            (4, 32768, "bf16", "spec"),
                                            (4, 32768, "bf16", "retransform")):
        launches, ms = train(bench, kernels, batch, length, 17, precision, gated)
        for name, n in launches.items():
            total[name] += n
        step_ms[f"{precision} {batch}x{length} gated_conv={gated or 'off'}"] = ms
    composite = step_ms["bf16 4x32768 gated_conv=off"]
    log({"phase": "gated_step", "step_ms": step_ms,
         "vs_composite_bf16": {k: v / composite for k, v in step_ms.items()
                               if k.startswith("bf16 4x32768")}})
    # single-card long context: hg38_large_1m_singlechip.yaml (residual cells,
    # group 2, float32 residual), group 1, the 4-D route, the 450k mode, and
    # the singlechip cells at stage 3 of hg38_large_1m's curriculum (262,144
    # tokens, fft 2^19)
    long_ms = {}
    for length, residual, remat, group, front4, save_filter in (
            (1000448, "fp32", "residual", 2, False, False),
            (1000448, "fp32", "residual", 1, False, False),
            (1000448, "fp32", "residual", 2, True, False),
            (450048, None, "block", 1, False, True),
            (262144, "fp32", "residual", 2, False, False)):
        launches, ms = train(bench, kernels, 1, length, 17, "bf16", None, residual, remat,
                             group, front4, save_filter, steps=2)
        for name, n in launches.items():
            total[name] += n
        long_ms[f"{length} {remat} g{group}{' front4' * front4}"] = ms
    log({"phase": "long_context_step", "step_ms": long_ms,
         "front4_vs_flat_1m": long_ms["1000448 residual g2 front4"]
         / long_ms["1000448 residual g2"]})

    with tempfile.TemporaryDirectory() as trainer_tmp:
        for name, n in trainer_phase(kernels, Path(trainer_tmp), seed=18).items():
            total[name] += n
        with tempfile.TemporaryDirectory() as tmp:
            for name, n in generation_phase(cli, kernels, Path(tmp), seed=19).items():
                total[name] += n
        # phase 8 on phase 6's genome and checkpoint
        for name, n in downstream_phase(FB, kernels, Path(trainer_tmp), seed=20).items():
            total[name] += n
        # phase 9 on phase 6's genome and GenomicBenchmarks data
        models_launches = models_phase(kernels, Path(trainer_tmp), seed=21)
        for name, n in models_launches.items():
            total[name] += n
        # phase 10 on phase 6's genome, ranks spawned after every kernel was built
        parallel_launches = parallel_phase(FB, kernels, Path(trainer_tmp), seed=22)
        for name, n in parallel_launches.items():
            total[name] += n
        # phase 11 on the same genome
        tp_rows, tp_launches = tp_phase(FF, FB, kernels, Path(trainer_tmp), seed=23)
        for name, n in tp_launches.items():
            total[name] += n
        # phase 12 on the same genome
        mr_rows, mr_launches = mesh_rest_phase(FF, kernels, Path(trainer_tmp), seed=24)
        for name, n in mr_launches.items():
            total[name] += n

    log({"phase": "done", "seconds": time.perf_counter() - start})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    csrc = "hyena_dna_tpu_torch/csrc/"
    sources = {"fused_front": csrc + "fused_front.cu", "fused_front_bwd": csrc + "fused_front_bwd.cu",
               "fftconv": csrc + "fftconv.cu", "fftconv_bwd": csrc + "fftconv_bwd.cu",
               "add_ln": csrc + "add_ln.cu", "add_ln_bwd": csrc + "add_ln_bwd.cu",
               "fftconv_gated": csrc + "fftconv_gated.cu",
               "fftconv_gated_bwd": csrc + "fftconv_gated_bwd.cu",
               "fused_front4": csrc + "fused_front4.cu",
               "fused_front4_bwd": csrc + "fused_front4_bwd.cu",
               "mlp_fused": csrc + "mlp_fused.cu", "mlp_fused_bwd": csrc + "mlp_fused_bwd.cu"}
    replaces = {"add_ln": "hyena_dna_tpu/ops/pallas_ln.py:102",
                "add_ln_bwd": "hyena_dna_tpu/ops/pallas_ln.py:130",
                "fused_front": "hyena_dna_tpu/ops/pallas_hyena.py:85",
                "fused_front_bwd": "hyena_dna_tpu/ops/pallas_hyena.py:395",
                "fftconv": "hyena_dna_tpu/ops/pallas_fftconv.py:1119; "
                           "hyena_dna_tpu/ops/pallas_fftconv.py:296; "
                           "hyena_dna_tpu/ops/pallas_fftconv_n3.py:413; "
                           "hyena_dna_tpu/ops/pallas_fftconv.py:890; "
                           "hyena_dna_tpu/ops/pallas_fftconv3.py:293",
                "fftconv_bwd": "hyena_dna_tpu/ops/pallas_fftconv.py:1344; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:1222; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:519; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:398; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:687; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:775; "
                               "hyena_dna_tpu/ops/pallas_fftconv_n3.py:629; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:987; "
                               "hyena_dna_tpu/ops/pallas_fftconv3.py:390; "
                               "hyena_dna_tpu/ops/pallas_fftconv.py:599",
                "fftconv_gated": "hyena_dna_tpu/ops/pallas_fftconv.py:1534",
                "fftconv_gated_bwd": "hyena_dna_tpu/ops/pallas_fftconv.py:1796; "
                                     "hyena_dna_tpu/ops/pallas_fftconv.py:1662; "
                                     "hyena_dna_tpu/ops/pallas_fftconv.py:1932",
                "fused_front4": "hyena_dna_tpu/ops/pallas_hyena.py:197",
                "fused_front4_bwd": "hyena_dna_tpu/ops/pallas_hyena.py:448",
                "mlp_fused": "hyena_dna_tpu/ops/pallas_mlp.py:104",
                "mlp_fused_bwd": "hyena_dna_tpu/ops/pallas_mlp.py:129"}
    # each kernel's row at the main paths' 4 x 32768 shape (the conv's
    # backward on the spectrum route the training step takes there; kernels
    # A and A' in float32, their bf16 rows under "bf16"; E and E' on the
    # gated step's specv route; F and F' in bf16), and every row of B, C, E,
    # E', F and F' under "routes"
    # (kernels A4 and A4' at the 1M step's shape in bf16, every row under "routes")
    gated = ("fftconv_gated", "fftconv_gated_bwd")
    front4 = ("fused_front4", "fused_front4_bwd")
    routed = gated + front4 + ("fftconv", "fftconv_bwd", "mlp_fused", "mlp_fused_bwd")
    main_shape = lambda name, r: (r["shape"] == f"B=1 L=1000448 d={D_MODEL} bfloat16"
                                  if name in front4 else r["shape"].startswith("B=4 "))
    headline = {name: next(r for r in rows if r["name"] == name and main_shape(name, r)
                           and (name not in gated or r["route"] == "specv"))
                for name in sources}
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bf16 = {r["name"]: {"max_abs_err": r["max_abs_err"], **{k: r[k] for k in timing}}
            for r in bf16_rows}

    def route_row(r):  # a "routes" entry
        return (f"{r['route']} {r['shape']}",
                {"max_abs_err": r["max_abs_err"], **{k: r[k] for k in timing}})
    # the rows at the trainer's shapes (phase 6), with their own numbers
    trainer = {r["name"]: {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
                           **{k: r[k] for k in timing}} for r in trainer_rows}
    species = {r["name"]: {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
                           **{k: r[k] for k in timing}} for r in species_rows}
    # the short path's rows (fft 2^11 to 2^13): the trainer's and the
    # species curriculum's first three stages
    short = {name: {r["shape"]: {"max_abs_err": r["max_abs_err"], **{k: r[k] for k in timing}}
                    for r in trainer_rows + short_rows if r["name"] == name}
             for name in ("fftconv", "fftconv_bwd")}
    # the seq route's pencil rows (phase 10) with the ranks' launches
    parallel = {name: {"launches": parallel_launches.get(name, 0),
                       "pencils": {r["shape"]: {"max_abs_err": r["max_abs_err"],
                                                **{k: r[k] for k in timing}}
                                   for r in parallel_rows if r["name"] == name}}
                for name in ("fftconv", "fftconv_bwd")}
    # the tensor-parallel rows (phase 11a: A and A' on a rank's channel slice,
    # B and C on 11b's slice) with the ranks' launches in 11b-11d
    tensor_parallel = {name: {"launches": tp_launches.get(name, 0),
                              "slices": {r["shape"]: {"max_abs_err": r["max_abs_err"],
                                                      **{k: r[k] for k in timing}}
                                         for r in tp_rows if r["name"] == name}}
                       for name in ("fused_front", "fused_front_bwd", "fftconv", "fftconv_bwd")}
    # phase 12: A4 and A4' on a rank's channel slice (12a) with the ranks'
    # launches of every kernel in 12b-12e
    mesh_rest = {name: {"launches": mr_launches.get(name, 0),
                        **({"slices": {r["shape"]: {"max_abs_err": r["max_abs_err"],
                                                    **{k: r[k] for k in timing}}
                                       for r in mr_rows if r["name"] == name}}
                           if name in front4 else {})}
                 for name in sources if mr_launches.get(name, 0) or name in front4}
    # errors: the worst over every shape checked in phase 2 (bf16 dk sums
    # B * L products, so one bf16 step of it is large in absolute terms)
    log({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         "launches": total[name],
         "max_abs_err": max(r["max_abs_err"] for r in rows if r["name"] == name),
         "max_rel_err": max(r["max_rel_err"] for r in rows if r["name"] == name),
         **{k: row[k] for k in timing}, **({"bf16": bf16[name]} if name in bf16 else {}),
         **({"routes": dict(route_row(r) for r in rows if r["name"] == name)}
            if name in routed else {}),
         **({"ptxas": ptxas.get(name, {})} if name in PTXAS_KERNELS else {}),
         **({"trainer": trainer[name]} if name in trainer else {}),
         **({"models_launches": models_launches[name]} if models_launches.get(name) else {}),
         **({"short": short[name]} if name in short else {}),
         **({"species": species[name]} if name in species else {}),
         **({"parallel": parallel[name]} if name in parallel else {}),
         **({"tensor_parallel": tensor_parallel[name]} if name in tensor_parallel else {}),
         **({"mesh_rest": mesh_rest[name]} if name in mesh_rest else {})}
        for name, row in headline.items()]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
