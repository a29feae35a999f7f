"""PyTorch / CUDA port of `hyena_dna_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module layout
and imports only torch and numpy. Its slices so far: hg38 inference
(`evals/hg38_inference.py`) and the hg38 train step (`bench.py` through
`train/step.py`), both through `models/lm.py::ConvLMHeadModel`, with four
hand-written CUDA kernels on the path: the fused front end forward and
backward (`ops/fused_front.py`) and the FFT long conv forward and backward
(`ops/fused_fftconv.py`). On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead.
"""
