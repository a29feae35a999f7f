"""ctypes binding to the native data-path library (a copy of
`hyena_dna_tpu/data/native.py`): `native/hyena_data.cpp`'s fused FASTA
fetch, tokenize, reverse complement and padding, in one pass over the
mmap'd genome.

The library is compiled at first use with `g++` and the flags of
`native/Makefile` into `hyena_dna_tpu_torch/_build/` (listed in
`.gitignore`). The file name carries a hash of the source, the flags and
what `-march=native` resolves to on this host (`g++ -Q --help=target`), so
an edited source, a changed flag or another CPU gets its own build. The
compiler writes to a temporary name that is then renamed into place, so
processes that build at once never load a partial file. Nothing here runs
at import time.

The native path is a host-side speed-up of the data layer: when the
library cannot be built or loaded, `load_library` returns None, warns once
with the compiler's output, and callers take the Python path, which gives
the same ids (`data/hg38.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "hyena_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_load_attempted = False
build_error: Optional[str] = None  # the compiler's output when the build failed


def compiler() -> str:
    """`$CXX`, else `g++` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise FileNotFoundError("no C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path(cxx: str) -> Path:
    """The library's path under `_build/`: a hash of the source, the flags
    and the host's resolved `-march=native` target options."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60, check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libhyena_data_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; raise with the compiler's
    output on failure."""
    cxx = compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library():
    """The loaded library (building it if needed), or None when it cannot
    be built or loaded; the first failure warns with the compiler's output
    and is kept in `build_error`."""
    global _lib, _load_attempted, build_error
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        build_error = str(err)
        warnings.warn(f"native data library unavailable, the Python path runs: {err}",
                      RuntimeWarning, stacklevel=2)
        return None
    lib.fasta_open.restype = ctypes.c_void_p
    lib.fasta_open.argtypes = [ctypes.c_char_p]
    lib.fasta_close.restype = None
    lib.fasta_close.argtypes = [ctypes.c_void_p]
    lib.fasta_length.restype = ctypes.c_int64
    lib.fasta_length.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fasta_fetch_tokens.restype = ctypes.c_int64
    lib.fasta_fetch_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tokenize_bytes.restype = ctypes.c_int64
    lib.tokenize_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


class NativeFasta:
    """A native handle over an indexed FASTA; one per (file, process)."""

    def __init__(self, path: str | os.PathLike):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        if not Path(str(path) + ".fai").exists():  # the Python indexer writes one
            from hyena_dna_tpu_torch.data.fasta import FastaFile

            FastaFile(path).close()
        self._lib = lib
        self._handle = lib.fasta_open(str(path).encode())
        if not self._handle:
            raise RuntimeError(f"fasta_open failed for {path}")

    def length(self, name: str) -> int:
        n = self._lib.fasta_length(self._handle, name.encode())
        if n < 0:
            raise KeyError(name)
        return n

    def fetch_tokens(self, name: str, start: int, end: int, out_len: int, *,
                     add_eos: bool = False, rc: bool = False, pad_left: bool = True,
                     uppercase: bool = True) -> np.ndarray:
        """Fused fetch and tokenize of [start, end) into a new (out_len,)
        int32 array."""
        out = np.empty(out_len, dtype=np.int32)
        real = self._lib.fasta_fetch_tokens(
            self._handle, name.encode(), start, end,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out_len,
            int(add_eos), int(rc), int(pad_left), int(uppercase))
        if real < 0:
            raise KeyError(name)
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.fasta_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()


def tokenize(text: str | bytes, out_len: int, *, add_eos: bool = False,
             pad_left: bool = True, uppercase: bool = True) -> Optional[np.ndarray]:
    """Native string tokenization; None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    data = text.encode("latin-1") if isinstance(text, str) else text
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(out_len, dtype=np.int32)
    lib.tokenize_bytes(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out_len,
                       int(add_eos), int(pad_left), int(uppercase))
    return out
