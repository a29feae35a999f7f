"""The ctypes signature of every kernel wrapper against the C entry point
it calls, read from the kernel's source: the same number of arguments, and
pointers, ints and floats in the same places. ctypes checks only the count
it was given, so a signature that disagrees with the source fails only on
the card; this check runs anywhere."""

import ctypes
import re

import pytest

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops import add_ln, fused_fftconv, fused_front, gated_fftconv, mlp_fused

KERNELS = {k.name: k for mod in (add_ln, fused_fftconv, fused_front, gated_fftconv, mlp_fused)
           for k in vars(mod).values() if isinstance(k, _cuda.Kernel)}


def _c_param_types(source: str, fn: str):
    match = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", source)
    assert match, f"{fn} is not an extern \"C\" int function of its source"
    types = []
    for param in match.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl or decl.startswith("cudaStream_t"):
            types.append(ctypes.c_void_p)
        elif decl.startswith("float "):
            types.append(ctypes.c_float)
        elif decl.startswith("int "):
            types.append(ctypes.c_int)
        else:
            raise AssertionError(f"{fn}: no ctypes rule for the parameter {decl!r}")
    return types


def test_every_csrc_source_has_a_wrapper():
    sources = {p.stem for p in _cuda.CSRC.glob("*.cu")}
    assert sources == set(KERNELS), sources ^ set(KERNELS)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_wrapper_signature_matches_the_c_entry(name):
    kernel = KERNELS[name]
    source = kernel.source.read_text()
    for fn, argtypes in kernel.functions.items():
        assert list(argtypes) == _c_param_types(source, fn), fn
