"""UCSC chain-file coordinate liftover, hg19 -> hg38 and the like (a copy of
`hyena_dna_tpu/data/liftover.py`).

The upstream HyenaDNA code calls the `liftover` pip package
(`src/dataloaders/datasets/chromatin_profile_dataset.py:227-236`); this is
the same operation from the UCSC chain format, with no dependency. A chain
file is supplied like the genome FASTA (for example
`hg19ToHg38.over.chain.gz` from UCSC's goldenPath downloads).

Chain format:
    chain <score> <tName> <tSize> <tStrand> <tStart> <tEnd>
          <qName> <qSize> <qStrand> <qStart> <qEnd> <id>
    <size> <dt> <dq>
    ...
    <size>
Each `size` line is an ungapped block aligning `size` bases of target to
query; `dt`/`dq` advance the target/query cursors past unaligned gaps.
`tStrand` is always '+'; when `qStrand` is '-', query block coordinates are
on the reversed strand and map back as `qSize - 1 - strand_pos`.

Lookup is vectorised: every block of every chain lands in one sorted table
per target chromosome, queried with `np.searchsorted`.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np


class ChainFile:
    """Parsed chain file with O(log n) per-position lookup."""

    def __init__(self, path: str):
        # per tName: list of (t_start, t_end, q_signed_start, q_strand, q_size)
        blocks: Dict[str, List[Tuple[int, int, int, int, int]]] = {}
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            header = None
            t_cur = q_cur = 0
            for raw in f:
                line = raw.strip()
                if not line:
                    header = None
                    continue
                if line.startswith("chain"):
                    p = line.split()
                    header = dict(
                        t_name=p[2], t_size=int(p[3]), t_start=int(p[5]),
                        q_name=p[7], q_size=int(p[8]), q_strand=p[9],
                        q_start=int(p[10]),
                    )
                    t_cur, q_cur = header["t_start"], header["q_start"]
                    blocks.setdefault(header["t_name"], [])
                    continue
                if header is None:
                    continue
                p = line.split()
                size = int(p[0])
                blocks[header["t_name"]].append(
                    (t_cur, t_cur + size, q_cur,
                     -1 if header["q_strand"] == "-" else 1,
                     header["q_size"], header["q_name"])
                )
                if len(p) == 3:
                    t_cur += size + int(p[1])
                    q_cur += size + int(p[2])
                else:
                    header = None  # last block of this chain

        self._tables: Dict[str, dict] = {}
        for name, blist in blocks.items():
            blist.sort(key=lambda b: b[0])
            self._tables[name] = dict(
                t_start=np.asarray([b[0] for b in blist], np.int64),
                t_end=np.asarray([b[1] for b in blist], np.int64),
                q_start=np.asarray([b[2] for b in blist], np.int64),
                strand=np.asarray([b[3] for b in blist], np.int64),
                q_size=np.asarray([b[4] for b in blist], np.int64),
                q_name=[b[5] for b in blist],
            )

    def convert(self, chrom: str, pos: int) -> Optional[Tuple[str, int, str]]:
        """Single position -> (q_chrom, q_pos, strand) or None if unmapped.

        Mirrors `liftover.get_lifter(...)[chrom][pos]` (first hit)."""
        t = self._tables.get(chrom)
        if t is None:
            return None
        i = int(np.searchsorted(t["t_start"], pos, side="right")) - 1
        if i < 0 or pos >= t["t_end"][i]:
            return None
        off = pos - t["t_start"][i]
        sp = t["q_start"][i] + off
        if t["strand"][i] < 0:
            return (t["q_name"][i], int(t["q_size"][i] - 1 - sp), "-")
        return (t["q_name"][i], int(sp), "+")

    def convert_batch(self, chrom: str, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized: (mapped_positions int64, ok bool) for one chromosome;
        unmapped entries hold -1."""
        pos = np.asarray(pos, np.int64)
        t = self._tables.get(chrom)
        if t is None:
            return np.full(pos.shape, -1, np.int64), np.zeros(pos.shape, bool)
        i = np.searchsorted(t["t_start"], pos, side="right") - 1
        ok = i >= 0
        ic = np.where(ok, i, 0)
        ok &= pos < t["t_end"][ic]
        off = pos - t["t_start"][ic]
        sp = t["q_start"][ic] + off
        mapped = np.where(t["strand"][ic] < 0, t["q_size"][ic] - 1 - sp, sp)
        return np.where(ok, mapped, -1), ok


def get_lifter(chain_path: str) -> ChainFile:
    """Load a chain file (API analogous to `liftover.get_lifter`, but from a
    local path — zero-egress environments supply the file like the genome)."""
    return ChainFile(chain_path)
