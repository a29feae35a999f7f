"""Word and character vocabulary (a copy of
`hyena_dna_tpu/data/vocabulary.py`; upstream
`src/dataloaders/utils/vocabulary.py`): a `Vocab` that counts files or
sentences, builds a symbol table with min-frequency and max-size cutoffs
and special symbols, and encodes files to flat token-id arrays (the input
`LMDataset` takes).
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np


class Vocab:
    def __init__(
        self,
        special: Iterable[str] = (),
        min_freq: int = 0,
        max_size: Optional[int] = None,
        lower_case: bool = True,
        delimiter: Optional[str] = None,
        add_eos: bool = True,
        add_double_eos: bool = False,
    ):
        self.counter: Counter = Counter()
        self.special = list(special)
        self.min_freq = min_freq
        self.max_size = max_size
        self.lower_case = lower_case
        self.delimiter = delimiter
        self.add_eos = add_eos
        self.add_double_eos = add_double_eos
        self.idx2sym: List[str] = []
        self.sym2idx = {}

    # --- tokenization ------------------------------------------------------
    def tokenize(self, line: str, add_eos: Optional[bool] = None,
                 add_double_eos: Optional[bool] = None) -> List[str]:
        line = line.strip()
        if self.lower_case:
            line = line.lower()
        symbols = line.split(self.delimiter) if line else []
        add_eos = self.add_eos if add_eos is None else add_eos
        add_double_eos = (
            self.add_double_eos if add_double_eos is None else add_double_eos
        )
        if add_double_eos:
            return ["<S>"] + symbols + ["<S>"]
        if add_eos:
            return symbols + ["<eos>"]
        return symbols

    # --- counting ----------------------------------------------------------
    def count_file(self, path: str | Path, add_eos: bool = False) -> List[List[str]]:
        sents = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                symbols = self.tokenize(line, add_eos=add_eos)
                self.counter.update(symbols)
                sents.append(symbols)
        return sents

    def count_sents(self, sents: Iterable[List[str]]) -> None:
        for symbols in sents:
            self.counter.update(symbols)

    # --- building ----------------------------------------------------------
    def build_vocab(self) -> None:
        self.idx2sym = []
        self.sym2idx = {}
        for sym in self.special:
            self.add_special(sym)
        for sym, cnt in self.counter.most_common(self.max_size):
            if cnt < self.min_freq:
                break
            self.add_symbol(sym)

    def add_special(self, sym: str) -> None:
        if sym not in self.sym2idx:
            self.idx2sym.append(sym)
            self.sym2idx[sym] = len(self.idx2sym) - 1
            setattr(self, f"{sym.strip('<>')}_idx", self.sym2idx[sym])

    def add_symbol(self, sym: str) -> None:
        if sym not in self.sym2idx:
            self.idx2sym.append(sym)
            self.sym2idx[sym] = len(self.idx2sym) - 1

    # --- lookup ------------------------------------------------------------
    def get_idx(self, sym: str) -> int:
        if sym in self.sym2idx:
            return self.sym2idx[sym]
        assert "<unk>" in self.sym2idx or "<UNK>" in self.sym2idx, (
            f"unknown token {sym!r} and no <unk>"
        )
        return self.sym2idx.get("<unk>", self.sym2idx.get("<UNK>"))

    def get_sym(self, idx: int) -> str:
        return self.idx2sym[idx]

    def convert_to_ids(self, symbols: Iterable[str]) -> np.ndarray:
        return np.asarray([self.get_idx(s) for s in symbols], dtype=np.int64)

    # --- encoding ----------------------------------------------------------
    def encode_file(self, path: str | Path, ordered: bool = False,
                    add_eos: bool = True, add_double_eos: bool = False):
        encoded = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                symbols = self.tokenize(
                    line, add_eos=add_eos, add_double_eos=add_double_eos
                )
                encoded.append(self.convert_to_ids(symbols))
        if ordered:
            return np.concatenate(encoded) if encoded else np.zeros(0, np.int64)
        return encoded

    def encode_sents(self, sents, ordered: bool = False):
        encoded = [self.convert_to_ids(s) for s in sents]
        if ordered:
            return np.concatenate(encoded) if encoded else np.zeros(0, np.int64)
        return encoded

    def __len__(self) -> int:
        return len(self.idx2sym)
