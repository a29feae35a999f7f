"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. At first
use it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `hyena_dna_tpu_torch/_build/` (listed in `.gitignore`; the file name
carries a hash of the source and the shared `csrc/*.cuh` headers, so an
edited source is rebuilt) and loaded
with `ctypes`. Every C entry point returns the `cudaError_t` of its
launches; `Kernel.launch` raises on a non-zero code and counts the launch.

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
              "-shared", "-Xcompiler", "-fPIC")


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
        self._lib = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # shared pieces a source may include
            h.update(header.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build_command(self) -> list:
        """The nvcc command line, writing to a temporary name first."""
        out = self.library_path
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out) + ".tmp", str(self.source)]

    def _finish_build(self) -> None:
        out = self.library_path
        os.replace(str(out) + ".tmp", out)

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

    def launch(self, fn: str, *args) -> None:
        """Call C entry point `fn`; raise on a CUDA error, else count it."""
        rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        self.launches += 1


def build_all(kernels: Sequence[Kernel]) -> None:
    """Compile every kernel whose library is missing, one nvcc each, all
    started together; raise with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [k for k in kernels if not k.library_path.exists()]
    procs = [(k, subprocess.Popen(k.build_command(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for k in todo]
    failed = []
    for k, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{out}")
        else:
            k._finish_build()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


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
