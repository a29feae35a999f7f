"""Fixed hg38 eval windows (a copy of `hyena_dna_tpu/data/hg38.py::HG38FixedDataset`).

Non-overlapping `max_length` windows over chromosome ranges, upper-cased,
tokenized, left-padded to `max_length`, with an eos appended when
`add_eos`; each item is the next-token pair (ids[:-1], ids[1:]) as int32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hyena_dna_tpu_torch.data.fasta import FastaFile
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer


class HG38FixedDataset:
    def __init__(self, fasta_file: str, chr_ranges: Dict[str, Tuple[int, int]],
                 max_length: int, add_eos: bool = False):
        self.max_length = max_length
        self.tokenizer = CharacterTokenizer()
        self.add_eos = add_eos
        self.intervals = []
        for chr_name, (start, end) in chr_ranges.items():
            for i in range(start, end, max_length):
                self.intervals.append((chr_name, i, min(i + max_length, end)))
        self.fasta = FastaFile(fasta_file)

    def close(self) -> None:
        self.fasta.close()

    def __len__(self) -> int:
        return len(self.intervals)

    def __getitem__(self, idx: int):
        chr_name, start, end = self.intervals[idx]
        seq = self.fasta.fetch(chr_name, start, end).upper()
        ids = self.tokenizer(seq, padding="max_length", max_length=self.max_length,
                             truncation=True)["input_ids"]
        if self.add_eos:
            ids = np.concatenate([ids, [self.tokenizer.sep_token_id]])
        return ids[:-1].astype(np.int32), ids[1:].astype(np.int32)
