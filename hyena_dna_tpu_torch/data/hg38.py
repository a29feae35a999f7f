"""hg38 pretraining datasets (a copy of `hyena_dna_tpu/data/hg38.py`).

  * `HG38Dataset`: the intervals of one split of a bed file (chr, start,
    end, split), sampled from the FASTA by `FastaInterval` (extension to
    `max_length`, optional shift and reverse-complement augmentation),
    tokenized with an eos when `add_eos` and padded to `max_length` by the
    tokenizer: the char tokenizer pads on the left, the BPE tokenizer of
    `HG38DataModule`'s `bpe` route (a `transformers` snapshot) on its own
    side;
  * `HG38FixedDataset`: non-overlapping `max_length` windows over
    chromosome ranges, upper-cased, for a stable test perplexity;
  * `LMDataset`: a contiguous token array cut into blocks.

Every item is the next-token pair (ids[:-1], ids[1:]) as int32 numpy.
Augmentation draws from the `np.random.Generator` the loader passes, so a
sample is a function of (seed, epoch, index) and a resumed run sees the same
data. `HG38Dataset` takes the fused C++ fetch (`data/native.py`) under the
JAX package's rule: the char tokenizer, left padding, the default
characters and no '.'-padding of the interval. `dataset.native` is its
handle, None on the Python path, which gives the same ids and which the
dataset also takes when the library cannot be built or loaded
(`native.load_library` warns once with the compiler's output).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from hyena_dna_tpu_torch.data.fasta import FastaInterval
from hyena_dna_tpu_torch.data.native import NativeFasta, load_library
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer


def read_bed(bed_file: str, split: Optional[str] = None):
    """(chr_name, start, end) of each row of a 4-column bed file in `split`."""
    rows = []
    with open(bed_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4 or parts[0] == "chr_name":
                continue
            if split is None or parts[3] == split:
                rows.append((parts[0], int(parts[1]), int(parts[2])))
    return rows


class HG38Dataset:
    """Intervals listed in a bed file, sampled from a reference genome."""

    def __init__(self, split: str, bed_file: str, fasta_file: str, max_length: int,
                 pad_max_length: Optional[int] = None,
                 tokenizer: Optional[Any] = None, tokenizer_name: str = "char",
                 add_eos: bool = False, shift_augs: Optional[Tuple[int, int]] = None,
                 rc_aug: bool = False, replace_N_token: bool = False,
                 pad_interval: bool = False):
        self.max_length = max_length
        self.pad_max_length = pad_max_length or max_length
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length + 2)
        self.tokenizer_name = tokenizer_name
        self.add_eos = add_eos
        self.replace_N_token = replace_N_token
        self.shift_augs = shift_augs
        self.rc_aug = rc_aug
        self.pad_interval = pad_interval
        self.intervals = read_bed(bed_file, split)
        self.fasta = FastaInterval(fasta_file=fasta_file, shift_augs=shift_augs,
                                   rc_aug=rc_aug, pad_interval=pad_interval)
        self.native = None
        if (not pad_interval and tokenizer_name == "char"
                and self.tokenizer.padding_side == "left"
                and tuple(self.tokenizer.characters) == ("A", "C", "G", "T", "N")
                and load_library() is not None):
            self.native = NativeFasta(fasta_file)

    def close(self) -> None:
        """Release the FASTA handles (the seqlen curriculum rebuilds the
        datasets at each stage)."""
        self.fasta.close()
        if self.native is not None:
            self.native.close()
            self.native = None

    def __len__(self) -> int:
        return len(self.intervals)

    def _native_item(self, idx: int, rng: Optional[np.random.Generator]) -> np.ndarray:
        """The fused fetch with `FastaInterval`'s interval arithmetic: the
        shift, the symmetric extension, the truncation and the coin flip,
        drawn from `rng` in the same order."""
        chr_name, start, end = self.intervals[idx]
        chromosome_length = self.fasta.chr_lens[chr_name]
        interval_length = end - start
        if self.shift_augs is not None:
            min_shift, max_shift = self.shift_augs
            max_shift += 1
            min_shift = max(start + min_shift, 0) - start
            max_shift = min(end + max_shift, chromosome_length) - end
            shift = int((rng or np.random.default_rng()).integers(min_shift, max_shift))
            start += shift
            end += shift
        if interval_length < self.max_length:
            extra = self.max_length - interval_length
            start -= extra // 2
            end += extra - extra // 2
        if interval_length > self.max_length:
            end = start + self.max_length
        rc = self.rc_aug and (rng or np.random.default_rng()).random() > 0.5
        return self.native.fetch_tokens(chr_name, start, end, self.max_length,
                                        add_eos=self.add_eos, rc=rc, pad_left=True,
                                        uppercase=False)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        if self.native is not None:
            ids = self._native_item(idx, rng)
        else:
            chr_name, start, end = self.intervals[idx]
            seq = self.fasta(chr_name, start, end, max_length=self.max_length, rng=rng)
            ids = np.asarray(self.tokenizer(seq, add_special_tokens=self.add_eos,
                                            padding="max_length", max_length=self.max_length,
                                            truncation=True)["input_ids"])
        if self.replace_N_token:
            n_id = self.tokenizer.get_vocab()["N"]
            ids = np.where(ids == n_id, self.tokenizer.pad_token_id, ids)
        return ids[:-1].astype(np.int32), ids[1:].astype(np.int32)


class HG38FixedDataset:
    """Non-overlapping `max_length` windows over chromosome ranges."""

    def __init__(self, fasta_file: str, chr_ranges: Dict[str, Tuple[int, int]],
                 max_length: int, pad_max_length: Optional[int] = None,
                 tokenizer: Optional[Any] = None, add_eos: bool = False):
        self.max_length = max_length
        self.pad_max_length = pad_max_length or max_length
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length + 2)
        self.add_eos = add_eos
        self.intervals = []
        for chr_name, (start, end) in chr_ranges.items():
            for i in range(start, end, max_length):
                self.intervals.append((chr_name, i, min(i + max_length, end)))
        self.fasta = FastaInterval(fasta_file=fasta_file)

    def close(self) -> None:
        self.fasta.close()

    def __len__(self) -> int:
        return len(self.intervals)

    def __getitem__(self, idx: int, rng=None):
        chr_name, start, end = self.intervals[idx]
        seq = self.fasta.fasta.fetch(chr_name, start, end).upper()
        ids = np.asarray(self.tokenizer(seq, add_special_tokens=False, padding="max_length",
                                        max_length=self.pad_max_length,
                                        truncation=True)["input_ids"])
        if self.add_eos:
            ids = np.concatenate([ids, [self.tokenizer.sep_token_id]]).astype(np.int32)
        return ids[:-1].astype(np.int32), ids[1:].astype(np.int32)


class LMDataset:
    """A contiguous token array cut into (data, target) blocks of `seq_len`,
    the last one short unless `drop_last`."""

    def __init__(self, tokens: np.ndarray, seq_len: int, drop_last: bool = True):
        self.seq_len = seq_len
        ntokens = len(tokens)
        if drop_last:
            ntokens = ((ntokens - 1) // seq_len) * seq_len + 1
        self.ntokens = ntokens
        self.tokens = tokens
        self.total_sequences = math.ceil((self.ntokens - 1) / self.seq_len)

    def __len__(self) -> int:
        return self.total_sequences

    def __getitem__(self, idx: int, rng=None):
        start = idx * self.seq_len
        n = min(self.seq_len, self.ntokens - 1 - start)
        chunk = np.asarray(self.tokens[start:start + n + 1], dtype=np.int32)
        return chunk[:-1], chunk[1:].copy()
