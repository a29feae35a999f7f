"""Species classification and multi-genome pretraining (a copy of
`hyena_dna_tpu/data/species.py`; upstream
`src/dataloaders/datasets/species_dataset.py:29-333`).

One directory per species of per-chromosome FASTAs, train / valid / test
chromosome splits (`SPECIES_CHROMOSOME_SPLITS`), weighted random (species,
chromosome, position) sampling, N-padding at a chromosome's end, and two
tasks: `species_classification` gives (ids, species_idx) and
`next_token_pred` gives (ids[:-1], ids[1:]); optional tail-end cutoffs.

Sampling draws from the `np.random.Generator` the loader passes (its
(seed, epoch, index) stream), so a resumed run sees the same data. A
gzipped chromosome (`chr{n}.fna.gz`) is decompressed once beside itself.
"""

from __future__ import annotations

import gzip
import os
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from hyena_dna_tpu_torch.data.fasta import FastaFile
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer, string_reverse_complement

SPECIES_CHROMOSOME_SPLITS = {
    "human": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "lemur": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "23", "24", "25", "26", "27", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "goat": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "23", "24", "25", "26", "27", "28", "29", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "sheep": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "23", "24", "25", "26", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "pig": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "mouse": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "18", "19", "X"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "gorilla": {
        "train": ["2A", "2B", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "orangutan": {
        "train": ["2A", "2B", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "chimpanzee": {
        "train": ["2A", "2B", "4", "6", "8", "14", "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
    "hippo": {
        "train": ["2", "4", "6", "8", "14", "15", "16", "17", "X"],
        "valid": ["1", "3", "12", "13"],
        "test": ["5", "7", "9", "10", "11"],
    },
}


class SpeciesDataset:
    def __init__(
        self,
        species: List[str],
        species_dir: str,
        split: str,
        max_length: int,
        total_size: int,
        pad_max_length: Optional[int] = None,
        tokenizer: Optional[CharacterTokenizer] = None,
        tokenizer_name: str = "char",
        add_eos: bool = False,
        rc_aug: bool = False,
        chromosome_weights: Union[str, Dict[str, List[float]]] = "uniform",
        species_weights: Union[str, List[float]] = "uniform",
        task: str = "species_classification",
        remove_tail_ends: bool = False,
        cutoff_train: float = 0.1,
        cutoff_test: float = 0.2,
    ):
        self.species = list(species)
        self.split = split
        self.max_length = max_length
        self.pad_max_length = pad_max_length or max_length
        self.total_size = total_size
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length + 2)
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.task = task
        self.remove_tail_ends = remove_tail_ends
        self.cutoff = cutoff_train if split == "train" else cutoff_test
        self.d_output = len(self.species)

        self.fastas: Dict[str, Dict[str, FastaFile]] = {}
        self.chromosomes: Dict[str, List[str]] = {}
        for spec in self.species:
            spec_path = Path(species_dir) / spec
            assert spec_path.exists(), f"species dir {spec_path} must exist"
            self.chromosomes[spec] = SPECIES_CHROMOSOME_SPLITS[spec][split]
            self.fastas[spec] = {}
            for chrom in self.chromosomes[spec]:
                fa = self._resolve_chromosome_file(spec_path, chrom)
                self.fastas[spec][chrom] = FastaFile(fa)

        # per-species chromosome weights
        self.chromosome_weights: Dict[str, np.ndarray] = {}
        for spec in self.species:
            if isinstance(chromosome_weights, dict):
                w = np.asarray(chromosome_weights[spec], dtype=np.float64)
            elif chromosome_weights == "uniform":
                w = np.ones(len(self.chromosomes[spec]))
            elif chromosome_weights == "weighted_by_bp":
                w = np.asarray(
                    [self._chr_len(spec, c) for c in self.chromosomes[spec]],
                    dtype=np.float64,
                )
            else:
                raise ValueError(f"invalid chromosome_weights {chromosome_weights!r}")
            self.chromosome_weights[spec] = w / w.sum()

        if isinstance(species_weights, (list, tuple, np.ndarray)):
            sw = np.asarray(species_weights, dtype=np.float64)
        elif species_weights == "uniform":
            sw = np.ones(len(self.species))
        elif species_weights == "weighted_by_bp":
            sw = np.asarray(
                [
                    sum(self._chr_len(s, c) for c in self.chromosomes[s])
                    for s in self.species
                ],
                dtype=np.float64,
            )
        else:
            raise ValueError(f"invalid species_weights {species_weights!r}")
        self.species_weights = sw / sw.sum()

    @staticmethod
    def _resolve_chromosome_file(spec_path: Path, chrom: str) -> Path:
        for ext in (".fna", ".fa"):
            p = spec_path / f"chr{chrom}{ext}"
            if p.exists():
                return p
        gz = spec_path / f"chr{chrom}.fna.gz"
        if gz.exists():  # decompress once, as upstream does
            # into a file of this process's own, renamed into place at once: the
            # ranks of a mesh read the same directory, and none may find the
            # .fna half written
            out = spec_path / f"chr{chrom}.fna"
            part = spec_path / f"chr{chrom}.fna.{os.getpid()}.part"
            with gzip.open(gz, "rb") as f_in, open(part, "wb") as f_out:
                f_out.write(f_in.read())
            os.replace(part, out)
            return out
        raise FileNotFoundError(f"no chr{chrom}.fna/.fa under {spec_path}")

    def _chr_len(self, spec: str, chrom: str) -> int:
        fa = self.fastas[spec][chrom]
        return sum(fa.length(k) for k in fa.keys())

    def close(self):
        for per_spec in self.fastas.values():
            for fa in per_spec.values():
                fa.close()

    def __len__(self) -> int:
        return self.total_size

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(idx)
        spec_idx = int(rng.choice(len(self.species), p=self.species_weights))
        spec = self.species[spec_idx]
        chrom = self.chromosomes[spec][
            int(rng.choice(len(self.chromosomes[spec]), p=self.chromosome_weights[spec]))
        ]
        fa = self.fastas[spec][chrom]
        record = next(iter(fa.keys()))
        clen = fa.length(record)

        if self.remove_tail_ends:
            lo = int(self.cutoff * clen)
            hi = int((1 - self.cutoff) * clen) - self.max_length
        else:
            lo, hi = 0, max(1, clen - self.max_length)
        start = int(rng.integers(lo, max(lo + 1, hi)))
        seq = fa.fetch(record, start, start + self.max_length).upper()
        if len(seq) < self.max_length:  # chromosome end: N-pad, as upstream does
            seq = seq + "N" * (self.max_length - len(seq))

        if self.rc_aug and rng.random() > 0.5:
            seq = string_reverse_complement(seq)

        out = self.tokenizer(
            seq,
            add_special_tokens=self.add_eos,
            padding="max_length",
            max_length=self.pad_max_length,
            truncation=True,
        )
        ids = out["input_ids"].astype(np.int32)
        if self.task == "next_token_pred":
            return ids[:-1], ids[1:]
        return ids, np.asarray(spec_idx, dtype=np.int32)
