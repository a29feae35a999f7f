"""PyTorch / CUDA port of `hyena_dna_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module layout
and imports only torch and numpy. Its slices so far: hg38 inference
(`evals/hg38_inference.py`) and the hg38 train step (`bench.py` through
`train/step.py`) in float32 and bf16, with the gate-fused conv, and at long
context with activation checkpointing (`ops/remat.py`) and the 4-D conv
layout, all through `models/lm.py::ConvLMHeadModel`; and the
config-driven trainer (`train/trainer.py`, `python -m
hyena_dna_tpu_torch.train experiment=...` on the shared `configs/` tree):
hg38 pretraining and GenomicBenchmarks fine-tuning with its data layer,
heads, metrics, checkpoints and callbacks; and serving and generation:
published checkpoints (`pretrained.py`, eval presets), full-forward
(`generation.py`) and modal-recurrent (`recurrent.py`) generation and the
in-context-learning evals (`evals/`); and data and sequence parallelism
(`parallel/`, `ops/distributed.py`: one process per rank under torchrun,
the channel-pencil conv and the halo short conv over `torch.distributed`).
Hand-written CUDA
kernels (`csrc/`) carry the path: the fused front end forward and backward
(`ops/fused_front.py`: A, A', and A4, A4' on the 4-D layout), the FFT long
conv (`ops/fused_fftconv.py`: B, C), the fused residual-add + LN
(`ops/add_ln.py`: D, D') and the gate-fused conv (`ops/gated_fftconv.py`:
E, E'). On a CPU tensor every kernel wrapper runs its plain PyTorch version
instead.
"""
