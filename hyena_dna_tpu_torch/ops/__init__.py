"""Ops of the port: plain PyTorch plus the CUDA kernel wrappers."""
