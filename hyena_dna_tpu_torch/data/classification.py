"""Downstream classification datasets (a copy of
`hyena_dna_tpu/data/classification.py`).

  * `GenomicBenchmarkDataset`: one sequence per `.txt` file under
    `<dest_path>/<dataset_name>/<split>/<class_name>/`, the label the class
    directory's index in sorted order; the val split reads the test split
    (the benchmark publishes none);
  * `NucleotideTransformerDataset`: one FASTA per split under
    `<dest_path>/<dataset_name>/`, the label the last character of each
    record's header line.

Both tokenize with optional reverse-complement augmentation, eos and
padding, and return (input_ids, label), with {"mask": attention_mask} as a
third element under `return_mask`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from hyena_dna_tpu_torch.data.fasta import FastaFile
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer, string_reverse_complement


class _TokenizedClassificationDataset:
    """Shared tokenize/augment/format logic."""

    def __init__(
        self,
        max_length: int,
        tokenizer: Optional[CharacterTokenizer],
        use_padding: bool = True,
        add_eos: bool = False,
        rc_aug: bool = False,
        return_mask: bool = False,
        d_output: int = 2,
    ):
        self.max_length = max_length
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length)
        self.use_padding = use_padding
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.return_mask = return_mask
        self.d_output = d_output

    def _format(self, seq: str, label: int, rng: Optional[np.random.Generator]):
        if self.rc_aug and (rng or np.random.default_rng()).random() > 0.5:
            seq = string_reverse_complement(seq)
        out = self.tokenizer(
            seq,
            add_special_tokens=self.add_eos,
            padding="max_length" if self.use_padding else "do_not_pad",
            max_length=self.max_length,
            truncation=True,
        )
        ids = out["input_ids"].astype(np.int32)
        target = np.asarray(label, dtype=np.int32)
        if self.return_mask:
            return ids, target, {"mask": out["attention_mask"].astype(bool)}
        return ids, target


class GenomicBenchmarkDataset(_TokenizedClassificationDataset):
    """8-task GenomicBenchmarks suite (sequence classification)."""

    def __init__(
        self,
        split: str,
        max_length: int,
        dataset_name: str = "human_nontata_promoters",
        d_output: int = 2,
        dest_path: str | Path = None,
        tokenizer: Optional[CharacterTokenizer] = None,
        tokenizer_name: str = "char",
        use_padding: bool = True,
        add_eos: bool = False,
        rc_aug: bool = False,
        return_mask: bool = False,
    ):
        super().__init__(max_length, tokenizer, use_padding, add_eos, rc_aug, return_mask, d_output)
        if split == "val":
            split = "test"  # no val split published (`genomics.py:296-298`)
        base_path = Path(dest_path) / dataset_name / split
        if not base_path.exists():
            raise FileNotFoundError(f"{base_path} must exist (the benchmark's files)")

        self.all_seqs: list[str] = []
        self.all_labels: list[int] = []
        label_mapper = {x.stem: i for i, x in enumerate(sorted(base_path.iterdir()))}
        for label_type, label in label_mapper.items():
            for path in sorted((base_path / label_type).iterdir()):
                self.all_seqs.append(path.read_text())
                self.all_labels.append(label)

    def __len__(self) -> int:
        return len(self.all_labels)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        return self._format(self.all_seqs[idx], self.all_labels[idx], rng)


class NucleotideTransformerDataset(_TokenizedClassificationDataset):
    """17-task Nucleotide Transformer benchmark (fasta with label-suffixed
    record names)."""

    def __init__(
        self,
        split: str,
        max_length: int,
        dataset_name: Optional[str] = None,
        d_output: int = 2,
        dest_path: str | Path = None,
        tokenizer: Optional[CharacterTokenizer] = None,
        tokenizer_name: str = "char",
        use_padding: bool = True,
        add_eos: bool = False,
        rc_aug: bool = False,
        return_mask: bool = False,
    ):
        super().__init__(max_length, tokenizer, use_padding, add_eos, rc_aug, return_mask, d_output)
        if split == "val":
            split = "test"
        base_path = Path(dest_path) / dataset_name
        if not base_path.exists():
            raise FileNotFoundError(f"{base_path} must exist")
        fasta_path = None
        for file in sorted(base_path.iterdir()):
            if file.name.endswith(".fasta") and split in file.name:
                fasta_path = file
        if fasta_path is None:
            raise FileNotFoundError(f"no {split} fasta under {base_path}")
        self.fasta = FastaFile(fasta_path)
        self.names = list(self.fasta.keys())
        # label = last non-space char of the record name (`:70-77`); our
        # indexer keys on the first whitespace token, so parse from the raw
        # header line instead.
        self.labels = [int(name.rstrip()[-1]) for name in self._long_names(fasta_path)]

    @staticmethod
    def _long_names(fasta_path: Path) -> list[str]:
        names = []
        with open(fasta_path) as f:
            for line in f:
                if line.startswith(">"):
                    names.append(line[1:].rstrip("\n"))
        return names

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        name = self.names[idx]
        seq = self.fasta.fetch(name, 0, self.fasta.length(name))
        return self._format(seq, self.labels[idx], rng)
