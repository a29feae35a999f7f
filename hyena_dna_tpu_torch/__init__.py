"""PyTorch / CUDA port of `hyena_dna_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module layout
and imports only torch and numpy. Its first slice is hg38 inference:
`evals/hg38_inference.py` through `models/lm.py::ConvLMHeadModel`, with two
hand-written CUDA kernels on the path (`ops/fused_front.py`,
`ops/fused_fftconv.py`). On a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.
"""
