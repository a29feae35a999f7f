"""Model stack of the port."""

from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel, DNAEmbeddingModel, LMBackbone

__all__ = ["ConvLMHeadModel", "DNAEmbeddingModel", "LMBackbone"]
