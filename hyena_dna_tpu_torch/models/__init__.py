"""Model stack of the port (forward pass)."""

from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel, LMBackbone

__all__ = ["ConvLMHeadModel", "LMBackbone"]
