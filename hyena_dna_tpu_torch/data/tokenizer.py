"""Character tokenizer for DNA (a copy of `hyena_dna_tpu/data/tokenizer.py`).

Special tokens [CLS]=0, [SEP]=1 (also eos), [BOS]=2, [MASK]=3, [PAD]=4,
[RESERVED]=5, [UNK]=6; the characters (A, C, G, T, N for DNA) get ids from
7, so the DNA vocabulary has 12 entries; any other byte is [UNK]. Padding is
on the left by default, as in the reference; `add_special_tokens` appends
one [SEP] (eos). Encoding is a 256-entry lookup table over the raw bytes.
`string_reverse_complement` swaps A/T and C/G (either case) and reverses;
other characters pass through.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

SPECIAL_TOKENS: Dict[str, int] = {
    "[CLS]": 0,
    "[SEP]": 1,
    "[BOS]": 2,
    "[MASK]": 3,
    "[PAD]": 4,
    "[RESERVED]": 5,
    "[UNK]": 6,
}

DNA_CHARACTERS = ("A", "C", "G", "T", "N")


class CharacterTokenizer:
    """Vectorised character tokenizer with HF-compatible call semantics."""

    def __init__(
        self,
        characters: Sequence[str] = DNA_CHARACTERS,
        model_max_length: int = int(1e9),
        padding_side: str = "left",
        **_unused,
    ):
        if padding_side not in ("left", "right"):
            raise ValueError(f"padding_side must be left or right, got {padding_side!r}")
        self.characters = tuple(characters)
        self.model_max_length = model_max_length
        self.padding_side = padding_side

        self._vocab_str_to_int = dict(SPECIAL_TOKENS)
        for i, ch in enumerate(self.characters):
            if len(ch) != 1:
                raise ValueError(f"characters must be single chars, got {ch!r}")
            self._vocab_str_to_int[ch] = i + 7
        self._vocab_int_to_str = {v: k for k, v in self._vocab_str_to_int.items()}

        # byte -> id lookup table; unknown bytes map to [UNK]
        lut = np.full(256, SPECIAL_TOKENS["[UNK]"], dtype=np.int32)
        for ch, idx in self._vocab_str_to_int.items():
            if len(ch) == 1:
                lut[ord(ch)] = idx
        self._lut = lut

        # id -> byte for fast decode (special tokens decode to '' below)
        self._inv = np.zeros(len(self._vocab_str_to_int), dtype=np.uint8)
        for ch, idx in self._vocab_str_to_int.items():
            if len(ch) == 1:
                self._inv[idx] = ord(ch)

    # --- id properties -----------------------------------------------------
    cls_token_id = SPECIAL_TOKENS["[CLS]"]
    sep_token_id = SPECIAL_TOKENS["[SEP]"]
    eos_token_id = SPECIAL_TOKENS["[SEP]"]  # eos == sep in the reference
    bos_token_id = SPECIAL_TOKENS["[BOS]"]
    mask_token_id = SPECIAL_TOKENS["[MASK]"]
    pad_token_id = SPECIAL_TOKENS["[PAD]"]
    unk_token_id = SPECIAL_TOKENS["[UNK]"]

    @property
    def vocab_size(self) -> int:
        return len(self._vocab_str_to_int)

    def __len__(self) -> int:
        return self.vocab_size

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab_str_to_int)

    # --- core --------------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = False) -> np.ndarray:
        """Map a string to an int32 id array (vectorized)."""
        ids = self._lut[np.frombuffer(text.encode("latin-1"), dtype=np.uint8)]
        if add_special_tokens:
            ids = np.concatenate([ids, [self.sep_token_id]]).astype(np.int32)
        return ids.astype(np.int32, copy=False)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = np.asarray(ids).ravel()
        if skip_special_tokens:
            # drop specials AND padded-vocab ids (models pad the vocab to a
            # multiple of 8, so sampling can emit ids >= vocab_size)
            ids = ids[(ids >= 7) & (ids < len(self._inv))]
            return bytes(self._inv[ids]).decode("latin-1")
        return "".join(self._vocab_int_to_str.get(int(i), "[UNK]") for i in ids)

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        add_special_tokens: bool = False,
        padding: str = "do_not_pad",
        max_length: Optional[int] = None,
        truncation: bool = False,
        return_attention_mask: bool = True,
    ) -> Dict[str, np.ndarray]:
        """HF-style call: tokenize (+eos), truncate to max_length, pad.

        Truncation keeps the FIRST (max_length - num_special) characters then
        appends eos, matching HF semantics used by the reference datasets.
        """
        if not isinstance(text, str):
            outs = [
                self(
                    t,
                    add_special_tokens=add_special_tokens,
                    padding=padding,
                    max_length=max_length,
                    truncation=truncation,
                )
                for t in text
            ]
            return {
                "input_ids": [o["input_ids"] for o in outs],
                "attention_mask": [o["attention_mask"] for o in outs],
            }

        num_special = 1 if add_special_tokens else 0
        ids = self._lut[np.frombuffer(text.encode("latin-1"), dtype=np.uint8)]
        if truncation and max_length is not None and len(ids) > max_length - num_special:
            ids = ids[: max_length - num_special]
        if add_special_tokens:
            ids = np.concatenate([ids, [self.sep_token_id]])
        ids = ids.astype(np.int32, copy=False)

        mask = np.ones(len(ids), dtype=np.int32)
        if padding == "max_length" and max_length is not None and len(ids) < max_length:
            pad = np.full(max_length - len(ids), self.pad_token_id, dtype=np.int32)
            zeros = np.zeros(max_length - len(ids), dtype=np.int32)
            if self.padding_side == "left":
                ids = np.concatenate([pad, ids])
                mask = np.concatenate([zeros, mask])
            else:
                ids = np.concatenate([ids, pad])
                mask = np.concatenate([mask, zeros])

        out = {"input_ids": ids}
        if return_attention_mask:
            out["attention_mask"] = mask
        return out

    # --- persistence (`hg38_char_tokenizer.py:124-148`) --------------------
    def get_config(self) -> Dict:
        return {
            "char_ords": [ord(ch) for ch in self.characters],
            "model_max_length": self.model_max_length,
            "padding_side": self.padding_side,
        }

    @classmethod
    def from_config(cls, config: Dict) -> "CharacterTokenizer":
        return cls(
            characters=[chr(i) for i in config["char_ords"]],
            model_max_length=config["model_max_length"],
            padding_side=config.get("padding_side", "left"),
        )

    def save_pretrained(self, save_directory: Union[str, os.PathLike]) -> None:
        path = Path(save_directory)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "tokenizer_config.json", "w") as f:
            json.dump(self.get_config(), f, indent=4)

    @classmethod
    def from_pretrained(cls, save_directory: Union[str, os.PathLike]) -> "CharacterTokenizer":
        with open(Path(save_directory) / "tokenizer_config.json") as f:
            return cls.from_config(json.load(f))


# -- string-level augmentation helpers (vectorized) -------------------------

_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    _COMP_LUT[ord(_a)], _COMP_LUT[ord(_b)] = ord(_b), ord(_a)


def string_reverse_complement(seq: str) -> str:
    """Reverse complement; non-ACGT characters pass through unchanged
    (reference `hg38_dataset.py:29-37`)."""
    b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return bytes(_COMP_LUT[b[::-1]]).decode("latin-1")
