"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. At first
use it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `hyena_dna_tpu_torch/_build/` (listed in `.gitignore`; the file name
carries a hash of the source, the shared `csrc/*.cuh` headers and the nvcc
flags, so an edited source or a changed flag is rebuilt) and loaded
with `ctypes`. Every C entry point returns the `cudaError_t` of its
launches; `Kernel.launch` raises on a non-zero code and counts the launch.
Each build's compiler output, ptxas's register, stack and spill readings
among it (`-Xptxas -v`), is written beside the library (`<library>.log`)
and kept on the kernel (`build_log`), read back from that file when the
library was built before. Each process compiles to a temporary name of its
own and renames the result into place, so several processes (torchrun's
ranks on a cold `_build/`) may build one library at once: libraries of one
hash have the same contents, and the last rename leaves one of them.

A C entry point's launches, its `cudaFuncSetAttribute` calls and its card
queries (SM count, occupancy) act on the calling thread's current CUDA
device. `Kernel.launch` and `Kernel.query` therefore take the card of the
wrapper's tensors and make it the current device for the C call
(`torch.cuda.device`, which switches only when it differs).

Nothing here runs at import time: the CPU tests import every module of the
port on a host with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class Kernel:
    """One CUDA source built into a shared library, with a launch count.

    `functions` maps each exported C function to its ctypes argument types
    (pointers and the stream as c_void_p, sizes as c_int); each returns int.
    """

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = dict(functions)
        self.launches = 0
        self.build_log = None  # nvcc's output for the library (build_all fills it)
        self._lib = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # shared pieces a source may include
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    @property
    def log_path(self) -> Path:
        """nvcc's output for the library, beside it."""
        return self.library_path.with_suffix(".log")

    def build_command(self, out: Path) -> list:
        """The nvcc command line writing the library to `out`."""
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if not self.library_path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args, device) -> None:
        """Call C entry point `fn` on the CUDA `device` (its tensors'
        card); raise on a CUDA error, else count it."""
        import torch

        with torch.cuda.device(device):
            rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        self.launches += 1

    def query(self, fn: str, *args, device) -> int:
        """C helper `fn`'s answer (a size or a count) for the CUDA `device`."""
        import torch

        with torch.cuda.device(device):
            return getattr(self.lib(), fn)(*args)


def build_all(kernels: Sequence[Kernel]) -> None:
    """Compile every kernel whose library is missing, one nvcc each, all
    started together; raise with the compiler's output if any fails. Each
    kernel's `build_log` is its compiler output, read back from the log
    beside a library built before (None if there is none)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [k for k in kernels if not k.library_path.exists()]
    for k in kernels:
        if k not in todo:
            k.build_log = k.log_path.read_text() if k.log_path.exists() else None
    procs = []
    for k in todo:
        tmp = _own_temporary(k.library_path)
        procs.append((k, tmp, subprocess.Popen(k.build_command(tmp), stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, tmp, proc in procs:
        out, _ = proc.communicate()
        k.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{k.source.name}:\n{out}")
        else:  # the log first: a library in place has its log beside it
            log = _own_temporary(k.log_path)
            log.write_text(out)
            os.replace(log, k.log_path)
            os.replace(tmp, k.library_path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _own_temporary(path: Path) -> Path:
    """This process's temporary name for `path`, renamed into place when
    written: no other process writes or renames it."""
    return path.with_name(f"{path.name}.{os.getpid()}.tmp")


def on_card(tensor) -> bool:
    """True for a CUDA tensor (a wrapper launches its kernel), False for a
    CPU tensor (it runs the plain version); raises for any other device."""
    if tensor.device.type == "cpu":
        return False
    if tensor.device.type != "cuda":
        raise ValueError(f"no kernel for device {tensor.device}")
    return True


def stream_handle(tensor) -> ctypes.c_void_p:
    """The current CUDA stream of the tensor's device, for a C launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def ptr_or_null(tensor) -> ctypes.c_void_p:
    """`ptr`, or a null pointer for None (an optional input or output)."""
    return ctypes.c_void_p(None if tensor is None else tensor.data_ptr())
