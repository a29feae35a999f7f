"""numpy-only data path of the port (copies of the JAX package's modules)."""

from hyena_dna_tpu_torch.data.chromatin_profile import ChromatinProfileDataset
from hyena_dna_tpu_torch.data.classification import (GenomicBenchmarkDataset,
                                                     NucleotideTransformerDataset)
from hyena_dna_tpu_torch.data.fasta import FastaFile, FastaInterval
from hyena_dna_tpu_torch.data.hg38 import HG38Dataset, HG38FixedDataset, LMDataset
from hyena_dna_tpu_torch.data.liftover import ChainFile, get_lifter
from hyena_dna_tpu_torch.data.loader import DataLoader
from hyena_dna_tpu_torch.data.native import NativeFasta
from hyena_dna_tpu_torch.data.species import SPECIES_CHROMOSOME_SPLITS, SpeciesDataset
from hyena_dna_tpu_torch.data.timeseries import (ETTHourDataset, ETTMinuteDataset,
                                                 InformerDataset, StandardScaler)
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer, string_reverse_complement
from hyena_dna_tpu_torch.data.vocabulary import Vocab

__all__ = [
    "CharacterTokenizer",
    "string_reverse_complement",
    "FastaFile",
    "FastaInterval",
    "HG38Dataset",
    "HG38FixedDataset",
    "LMDataset",
    "GenomicBenchmarkDataset",
    "NucleotideTransformerDataset",
    "ChromatinProfileDataset",
    "ChainFile",
    "get_lifter",
    "SPECIES_CHROMOSOME_SPLITS",
    "SpeciesDataset",
    "StandardScaler",
    "InformerDataset",
    "ETTHourDataset",
    "ETTMinuteDataset",
    "Vocab",
    "NativeFasta",
    "DataLoader",
]
