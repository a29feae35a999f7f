"""FASTA access through a samtools-style `.fai` index and mmap (a copy of
`hyena_dna_tpu/data/fasta.py`).

The index has one line per record: name, length, byte offset, bases per
line, bytes per line. It is read from `<fasta>.fai` when present, else
built by one scan and written there when the directory allows.
`FastaInterval` samples an interval with the reference's semantics:
symmetric extension of a short interval to `max_length`, truncation of a
long one, an optional random shift, a reverse complement on a coin flip
(`rc_aug`) and '.' padding past the chromosome's ends (`pad_interval`).
"""

from __future__ import annotations

import mmap
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from hyena_dna_tpu_torch.data.tokenizer import string_reverse_complement


def build_fai(fasta_path: str | os.PathLike) -> List[Tuple[str, int, int, int, int]]:
    """Scan a FASTA file and produce (name, length, offset, linebases,
    linewidth) per record — the samtools faidx layout.

    Validates the faidx precondition (every sequence line except a record's
    last has identical length): coordinate math over an irregularly-wrapped
    file would be silently wrong, so reject it loudly (samtools faidx
    errors on such files too)."""
    records = []
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        pending_short = None  # a shorter line is only legal as the LAST line
        while True:
            line = f.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    records.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode() if line[1:].split() else ""
                length = 0
                offset = f.tell()
                first_line = True
                pending_short = None
            else:
                stripped = len(line.rstrip(b"\r\n"))
                if pending_short is not None and stripped:
                    raise ValueError(
                        f"{fasta_path}: record {name!r} has a short line "
                        f"({pending_short} bases) before its end — faidx "
                        "offsets would be wrong; re-wrap the FASTA uniformly"
                    )
                if first_line and stripped:
                    linebases = stripped
                    linewidth = len(line)
                    first_line = False
                elif stripped and stripped != linebases:
                    if stripped > linebases:
                        raise ValueError(
                            f"{fasta_path}: record {name!r} has a line longer "
                            f"than the first ({stripped} > {linebases})"
                        )
                    pending_short = stripped  # fine iff it's the last line
                length += stripped
        if name is not None:
            records.append((name, length, offset, linebases, linewidth))
    return records


class FastaFile:
    """Random access to FASTA records via a .fai index and mmap."""

    def __init__(self, path: str | os.PathLike, build_index: bool = True):
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFoundError(f"fasta file {path} does not exist")
        fai = self.path.with_name(self.path.name + ".fai")
        if fai.exists():
            self._index = {}
            with open(fai) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 5:
                        self._index[parts[0]] = tuple(int(x) for x in parts[1:5])
        else:
            if not build_index:
                raise FileNotFoundError(f"no index at {fai} and build_index=False")
            recs = build_fai(self.path)
            self._index = {r[0]: r[1:] for r in recs}
            # cache the index for subsequent runs: written to a file of its
            # own and renamed into place, so a process that opens the FASTA
            # at the same moment (the ranks of a mesh) never reads a partly
            # written index
            part = None
            try:
                fd, part = tempfile.mkstemp(suffix=".part", prefix=fai.name + ".",
                                            dir=fai.parent)
                with os.fdopen(fd, "w") as f:
                    for name, (length, offset, lb, lw) in self._index.items():
                        f.write(f"{name}\t{length}\t{offset}\t{lb}\t{lw}\n")
                os.replace(part, fai)
            except OSError:  # read-only dir; keep the in-memory index
                if part is not None:
                    Path(part).unlink(missing_ok=True)
        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self):
        return self._index.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def length(self, name: str) -> int:
        return self._index[name][0]

    def fetch(self, name: str, start: int, end: int) -> str:
        """0-based half-open [start, end) subsequence as an uppercase-preserving
        string. start/end are clipped to [0, record_length]."""
        length, offset, linebases, linewidth = self._index[name]
        start = max(0, min(start, length))
        end = max(start, min(end, length))
        if end == start:
            return ""
        byte_start = offset + (start // linebases) * linewidth + start % linebases
        byte_end = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases + 1
        raw = np.frombuffer(self._mmap[byte_start:byte_end], dtype=np.uint8)
        # strip newline/CR bytes vectorized
        raw = raw[(raw != 0x0A) & (raw != 0x0D)]
        return raw.tobytes().decode("latin-1")

    def close(self):
        if getattr(self, "_mmap", None) is not None:
            self._mmap.close()
            self._mmap = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class FastaInterval:
    """Interval sampler with the reference's padding/augmentation semantics
    (`hg38_dataset.py:40-117`)."""

    def __init__(
        self,
        *,
        fasta_file: str | os.PathLike,
        shift_augs: Optional[Tuple[int, int]] = None,
        rc_aug: bool = False,
        pad_interval: bool = False,
    ):
        self.fasta = FastaFile(fasta_file)
        self.shift_augs = shift_augs
        self.rc_aug = rc_aug
        self.pad_interval = pad_interval
        self.chr_lens: Dict[str, int] = {k: self.fasta.length(k) for k in self.fasta.keys()}

    def close(self):
        self.fasta.close()

    def __call__(
        self,
        chr_name: str,
        start: int,
        end: int,
        max_length: int,
        rng: Optional[np.random.Generator] = None,
    ) -> str:
        interval_length = end - start
        chromosome_length = self.chr_lens[chr_name]

        if self.shift_augs is not None:
            min_shift, max_shift = self.shift_augs
            max_shift += 1
            min_shift = max(start + min_shift, 0) - start
            max_shift = min(end + max_shift, chromosome_length) - end
            rand_shift = int((rng or np.random.default_rng()).integers(min_shift, max_shift))
            start += rand_shift
            end += rand_shift

        left_padding = right_padding = 0
        if interval_length < max_length:
            extra_seq = max_length - interval_length
            extra_left_seq = extra_seq // 2
            extra_right_seq = extra_seq - extra_left_seq
            start -= extra_left_seq
            end += extra_right_seq
        if start < 0:
            left_padding = -start
            start = 0
        if end > chromosome_length:
            right_padding = end - chromosome_length
            end = chromosome_length
        if interval_length > max_length:
            end = start + max_length

        seq = self.fasta.fetch(chr_name, start, end)

        if self.rc_aug and (rng or np.random.default_rng()).random() > 0.5:
            seq = string_reverse_complement(seq)

        if self.pad_interval:
            seq = ("." * left_padding) + seq + ("." * right_padding)
        return seq
