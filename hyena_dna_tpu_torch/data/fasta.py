"""FASTA access through a samtools-style `.fai` index and mmap (a copy of
`hyena_dna_tpu/data/fasta.py`, as far as the fixed-window eval set needs it).

The index has one line per record: name, length, byte offset, bases per
line, bytes per line. It is read from `<fasta>.fai` when present, else
built by one scan and written there when the directory allows.
"""

from __future__ import annotations

import mmap
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np


def build_fai(fasta_path: str | os.PathLike) -> List[Tuple[str, int, int, int, int]]:
    """(name, length, offset, linebases, linewidth) per record. Rejects a
    record whose lines (all but its last) differ in length: faidx offsets
    over such a file would be wrong."""
    records = []
    with open(fasta_path, "rb") as f:
        name = None
        length = offset = linebases = linewidth = 0
        first_line = True
        pending_short = None  # a shorter line is legal only as the last one
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
                continue
            stripped = len(line.rstrip(b"\r\n"))
            if pending_short is not None and stripped:
                raise ValueError(f"{fasta_path}: record {name!r} has a short line "
                                 f"({pending_short} bases) before its end")
            if first_line and stripped:
                linebases, linewidth = stripped, len(line)
                first_line = False
            elif stripped and stripped != linebases:
                if stripped > linebases:
                    raise ValueError(f"{fasta_path}: record {name!r} has a line longer "
                                     f"than the first ({stripped} > {linebases})")
                pending_short = stripped
            length += stripped
        if name is not None:
            records.append((name, length, offset, linebases, linewidth))
    return records


class FastaFile:
    """Random access to FASTA records."""

    def __init__(self, path: str | os.PathLike):
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
            self._index = {r[0]: r[1:] for r in build_fai(self.path)}
            try:
                with open(fai, "w") as f:
                    for name, (length, offset, lb, lw) in self._index.items():
                        f.write(f"{name}\t{length}\t{offset}\t{lb}\t{lw}\n")
            except OSError:
                pass  # read-only directory: keep the index in memory
        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def fetch(self, name: str, start: int, end: int) -> str:
        """0-based half-open [start, end), clipped to the record."""
        length, offset, linebases, linewidth = self._index[name]
        start = max(0, min(start, length))
        end = max(start, min(end, length))
        if end == start:
            return ""
        byte_start = offset + (start // linebases) * linewidth + start % linebases
        byte_end = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases + 1
        raw = np.frombuffer(self._mmap[byte_start:byte_end], dtype=np.uint8)
        raw = raw[(raw != 0x0A) & (raw != 0x0D)]
        return raw.tobytes().decode("latin-1")

    def close(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None
