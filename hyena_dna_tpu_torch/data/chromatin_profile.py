"""Chromatin-profile prediction, DeepSEA's 919-way multilabel task (a copy of
`hyena_dna_tpu/data/chromatin_profile.py`; upstream
`src/dataloaders/datasets/chromatin_profile_dataset.py:113-260`).

Coordinates and boolean targets come from a CSV with columns `Chr_No`
(0-based), `Start`, `End` and `y_*` labels; the 1000-base windows are
widened symmetrically to `max_length`, '.'-padded past the chromosome's
ends, and upper-cased before tokenizing.

When the genome is hg38 and the CSV is labelled hg19, the coordinates are
lifted through `data/liftover.py::ChainFile` (`liftover_chain_path`, a local
`hg19ToHg38.over.chain[.gz]`): rows with an unmapped end and rows whose
lifted window is no longer 1000 bases are dropped, as upstream
(`:227-260`), and `save_liftover=True` writes the converted CSV beside the
input so the conversion runs once.
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np

from hyena_dna_tpu_torch.data.fasta import FastaInterval
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer


class ChromatinProfileDataset:
    def __init__(
        self,
        max_length: int,
        ref_genome_path: str = None,
        ref_genome_version: str = "hg38",
        coords_target_path: str = None,
        tokenizer: Optional[CharacterTokenizer] = None,
        tokenizer_name: str = "char",
        use_padding: bool = True,
        add_eos: bool = False,
        rc_aug: bool = False,
        liftover_chain_path: Optional[str] = None,
        save_liftover: bool = False,
    ):
        assert max_length % 2 == 0, "window must be divisible by 2"
        self.max_length = max_length
        self.use_padding = use_padding
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length + 2)
        self.add_eos = add_eos
        self.rc_aug = rc_aug

        fname = str(coords_target_path).rsplit("/", 1)[-1]
        if ref_genome_version not in ("hg19", "hg38"):
            raise ValueError('ref_genome_version must be "hg19" or "hg38"')

        self.ref_genome = FastaInterval(fasta_file=ref_genome_path, pad_interval=True)
        self._load_csv(coords_target_path)
        if ref_genome_version not in fname:
            if ref_genome_version == "hg38" and "hg19" in fname:
                # translate coordinates once (`chromatin_profile_dataset.py:227-260`)
                if liftover_chain_path is None:
                    raise ValueError(
                        'hg19 coordinates with an hg38 genome need '
                        '`liftover_chain_path` (a local hg19ToHg38.over.chain[.gz])'
                    )
                self._convert_coordinates(liftover_chain_path)
                if save_liftover:
                    self._save_csv(
                        str(coords_target_path).replace("hg19", "hg38"))
            else:
                raise ValueError(
                    f"coordinate file {fname!r} does not match genome version "
                    f"{ref_genome_version!r}"
                )
        # widen the 1000bp windows to max_length (`:176-178`)
        pad = (max_length - 1000) // 2
        self.coords[:, 1] -= pad
        self.coords[:, 2] += pad

    def _load_csv(self, path):
        with open(path) as f:
            reader = csv.reader(f)
            header = next(reader)
            idx = {name: i for i, name in enumerate(header)}
            target_cols = [i for i, col in enumerate(header) if col[:2] == "y_"]
            coord_cols = [idx["Chr_No"], idx["Start"], idx["End"]]
            coords, targets = [], []
            for row in reader:
                coords.append([int(row[c]) for c in coord_cols])
                targets.append([int(row[c] in ("1", "True", "true")) for c in target_cols])
        self.coords = np.asarray(coords, dtype=np.int64)
        self.targets = np.asarray(targets, dtype=np.int32)
        self.d_output = self.targets.shape[1]

    def _convert_coordinates(self, chain_path: str):
        """hg19 -> hg38 via the native ChainFile; drop unmapped rows and
        rows whose lifted window is no longer exactly 1000bp (upstream
        filters, `:241-256`)."""
        from hyena_dna_tpu_torch.data.liftover import ChainFile

        chain = ChainFile(chain_path)
        n = len(self.coords)
        new_start = np.full(n, -1, np.int64)
        new_end = np.full(n, -1, np.int64)
        for chr_no in np.unique(self.coords[:, 0]):
            rows = np.nonzero(self.coords[:, 0] == chr_no)[0]
            chrom = f"chr{chr_no + 1}"  # Chr_No is 0-based (`:209`)
            s, s_ok = chain.convert_batch(chrom, self.coords[rows, 1])
            e, e_ok = chain.convert_batch(chrom, self.coords[rows, 2])
            ok = s_ok & e_ok
            new_start[rows] = np.where(ok, s, -999)
            new_end[rows] = np.where(ok, e, -999)
        keep = (new_start != -999) & (new_end - new_start == 1000)
        n_unmapped = int((new_start == -999).sum())
        self.coords = np.stack(
            [self.coords[keep, 0], new_start[keep], new_end[keep]], axis=1
        )
        self.targets = self.targets[keep]
        print(
            f"liftover: filtered {n_unmapped} unmapped + "
            f"{n - n_unmapped - int(keep.sum())} resized windows; "
            f"{int(keep.sum())} samples remain"
        )

    def _save_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Chr_No", "Start", "End"]
                       + [f"y_{i}" for i in range(self.targets.shape[1])])
            for c, t in zip(self.coords, self.targets):
                w.writerow([int(c[0]), int(c[1]), int(c[2])] + t.tolist())

    def close(self):
        self.ref_genome.close()

    def __len__(self) -> int:
        return len(self.coords)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        chr_no, start, end = self.coords[idx]
        seq = self.ref_genome(
            f"chr{chr_no + 1}", int(start), int(end), max_length=self.max_length, rng=rng
        )
        out = self.tokenizer(
            seq.upper(),
            add_special_tokens=self.add_eos,
            padding="max_length" if self.use_padding else "do_not_pad",
            max_length=self.max_length,
            truncation=True,
        )
        return out["input_ids"].astype(np.int32), self.targets[idx]
