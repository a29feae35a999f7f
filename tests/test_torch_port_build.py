"""The kernel libraries' build records (`_cuda.py`), with no nvcc: the
library's name moves with the nvcc flags, and the compiler output kept
beside a library comes back as `build_log` when the library is not built
again (the ptxas readings `chip_smoke.py` prints)."""

from hyena_dna_tpu_torch import _cuda


def test_library_hash_moves_with_nvcc_flags(monkeypatch):
    kernel = _cuda.Kernel("fftconv_bwd", {})
    before = kernel.library_path
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-lineinfo",))
    assert kernel.library_path != before
    assert kernel.library_path.name.startswith("libfftconv_bwd_")


def test_cached_library_reads_its_build_log(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    kernel = _cuda.Kernel("fftconv_bwd", {})
    kernel.library_path.write_bytes(b"not a library")  # present: nothing is built
    assert kernel.log_path.parent == tmp_path and kernel.log_path.suffix == ".log"
    reading = "ptxas info    : Used 128 registers, 0 bytes spill stores\n"
    kernel.log_path.write_text(reading)
    _cuda.build_all([kernel])
    assert kernel.build_log == reading
    kernel.log_path.unlink()
    _cuda.build_all([kernel])
    assert kernel.build_log is None
