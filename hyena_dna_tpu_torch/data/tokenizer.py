"""Character tokenizer for DNA (a copy of `hyena_dna_tpu/data/tokenizer.py`,
as far as the fixed-window eval set needs it).

Special tokens [CLS]=0, [SEP]=1 (also eos), [BOS]=2, [MASK]=3, [PAD]=4,
[RESERVED]=5, [UNK]=6; the characters A, C, G, T, N get ids 7-11, so the
DNA vocabulary has 12 entries; any other byte is [UNK]. Padding is on the
left, as in the reference. Encoding is a 256-entry lookup table over the
raw bytes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

SPECIAL_TOKENS: Dict[str, int] = {
    "[CLS]": 0, "[SEP]": 1, "[BOS]": 2, "[MASK]": 3, "[PAD]": 4,
    "[RESERVED]": 5, "[UNK]": 6,
}

DNA_CHARACTERS = ("A", "C", "G", "T", "N")


class CharacterTokenizer:
    sep_token_id = SPECIAL_TOKENS["[SEP]"]
    pad_token_id = SPECIAL_TOKENS["[PAD]"]
    vocab_size = len(SPECIAL_TOKENS) + len(DNA_CHARACTERS)

    def __init__(self):
        self._lut = np.full(256, SPECIAL_TOKENS["[UNK]"], dtype=np.int32)
        for i, ch in enumerate(DNA_CHARACTERS):
            self._lut[ord(ch)] = i + 7

    def __call__(self, text: str, add_special_tokens: bool = False,
                 padding: str = "do_not_pad", max_length: Optional[int] = None,
                 truncation: bool = False) -> Dict[str, np.ndarray]:
        """Tokenize one string (+ eos), keep the first characters when
        truncating, left-pad to `max_length` when `padding == "max_length"`."""
        num_special = 1 if add_special_tokens else 0
        ids = self._lut[np.frombuffer(text.encode("latin-1"), dtype=np.uint8)]
        if truncation and max_length is not None and len(ids) > max_length - num_special:
            ids = ids[: max_length - num_special]
        if add_special_tokens:
            ids = np.concatenate([ids, [self.sep_token_id]])
        ids = ids.astype(np.int32, copy=False)
        if padding == "max_length" and max_length is not None and len(ids) < max_length:
            pad = np.full(max_length - len(ids), self.pad_token_id, dtype=np.int32)
            ids = np.concatenate([pad, ids])
        return {"input_ids": ids}
