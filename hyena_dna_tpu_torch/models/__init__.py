"""Model stack of the port."""

from hyena_dna_tpu_torch.models.adaptive_softmax import AdaptiveLMModel
from hyena_dna_tpu_torch.models.attention import MHA
from hyena_dna_tpu_torch.models.blocks import Block, Mlp
from hyena_dna_tpu_torch.models.embeddings import GPT2Embeddings
from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.hyena import HyenaOperator
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel, DNAEmbeddingModel, LMBackbone
from hyena_dna_tpu_torch.models.long_conv import LongConv, LongConvKernel
from hyena_dna_tpu_torch.models.sequence_model import (FF, SequenceIdentity, SequenceModel,
                                                       SequenceResidualBlock)

__all__ = ["AdaptiveLMModel", "MHA", "Block", "Mlp", "GPT2Embeddings", "HyenaFilter",
           "HyenaOperator", "ConvLMHeadModel", "DNAEmbeddingModel", "LMBackbone", "LongConv",
           "LongConvKernel", "FF", "SequenceIdentity", "SequenceModel", "SequenceResidualBlock"]
