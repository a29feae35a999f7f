"""In-context-learning genomics dataset (a copy of
`hyena_dna_tpu/data/icl.py`): k-shot prompts built from a GenomicBenchmarks
layout (`<dest_path>/<dataset_name>/<split>/<class_name>/*`).

A prompt is [shot sequence + label token (+ eos)] x (shots x classes), in
an order shuffled per item, followed by the unlabeled test sequence; the
target is the test sequence's label token. Labels map to tokens through
`label_to_token` (default: the class index as a character); a name longer
than one character is looked up as one vocabulary entry, else [UNK]. Item
`idx` draws its shots from `rng`, by default `np.random.default_rng(idx)`,
so the same seed gives the same items as the JAX dataset.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer, string_reverse_complement


class ICLGenomicsDataset:
    def __init__(
        self,
        split: str,
        shots: int,
        max_length: int,
        dataset_name: str = "human_nontata_promoters",
        d_output: int = 2,
        dest_path: str | Path = None,
        tokenizer: Optional[CharacterTokenizer] = None,
        use_padding: bool = True,
        add_eos: bool = True,
        eos_token: Optional[str] = None,
        label_to_token: Optional[Dict[int, str]] = None,
        rc_aug: bool = False,
    ):
        self.shots = shots
        self.max_length = max_length
        self.d_output = d_output
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length)
        self.use_padding = use_padding
        self.add_eos = add_eos
        self.eos_token = eos_token
        self.label_to_token = label_to_token or {i: str(i) for i in range(d_output)}
        self.rc_aug = rc_aug

        if split == "val":
            split = "test"
        base_path = Path(dest_path) / dataset_name / split
        if not base_path.exists():
            raise FileNotFoundError(f"{base_path} must exist")
        self.all_paths = []
        self.all_labels = []
        label_mapper = {x.stem: i for i, x in enumerate(sorted(base_path.iterdir()))}
        for label_type, label in label_mapper.items():
            for p in sorted((base_path / label_type).iterdir()):
                self.all_paths.append(p)
                self.all_labels.append(label)
        self.all_labels_np = np.asarray(self.all_labels)
        self.unique_labels = sorted(set(self.all_labels))

    def __len__(self) -> int:
        return len(self.all_paths)

    def _sample(self, idx: int, rng: Optional[np.random.Generator]):
        x = self.all_paths[idx].read_text()
        y = self.all_labels[idx]
        if self.rc_aug and (rng or np.random.default_rng()).random() > 0.5:
            x = string_reverse_complement(x)
        seq = self.tokenizer(
            x,
            add_special_tokens=False,
            padding="max_length" if self.use_padding else "do_not_pad",
            max_length=self.max_length,
            truncation=True,
        )["input_ids"]
        token = self.label_to_token[y]
        if len(token) > 1:
            target = np.asarray(
                [self.tokenizer.get_vocab().get(token, self.tokenizer.unk_token_id)],
                dtype=np.int32,
            )
        else:
            target = self.tokenizer.encode(token)
        if self.add_eos:
            eos = (
                [self.tokenizer.sep_token_id]
                if self.eos_token is None
                else self.tokenizer.encode(self.eos_token).tolist()
            )
            seq = np.concatenate([seq, eos]).astype(np.int32)
            target = np.concatenate([target, eos]).astype(np.int32)
        return seq.astype(np.int32), target.astype(np.int32)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(idx)
        test_seq, test_target = self._sample(idx, rng)
        test_target = test_target[:1]
        if self.shots == 0:
            return test_seq, test_target

        shots = []
        per_label_shots: Dict[int, np.ndarray] = {}
        for label in self.unique_labels:
            label_idx = np.where(self.all_labels_np == label)[0]
            label_idx = label_idx[label_idx != idx]
            per_label_shots[label] = rng.choice(label_idx, size=self.shots, replace=False)
        for s in range(self.shots):
            for label in per_label_shots:
                seq, target = self._sample(int(per_label_shots[label][s]), rng)
                shots.append(np.concatenate([seq, target]))
        order = rng.permutation(len(shots))
        prompt = np.concatenate([np.concatenate([shots[i] for i in order]), test_seq])
        return prompt.astype(np.int32), test_target
