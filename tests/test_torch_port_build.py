"""The kernel libraries' build records (`_cuda.py`), with no nvcc: the
library's name moves with the nvcc flags, and the compiler output kept
beside a library comes back as `build_log` when the library is not built
again (the ptxas readings `chip_smoke.py` prints); builds by several
processes at once, through a stand-in for nvcc, leave one library and no
temporary file."""

import os
from pathlib import Path

import pytest

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


# A stand-in for nvcc: it writes the library named after -o in two halves
# and, between them, waits until every process of the handshake directory
# has started (a file each), so that the builds overlap; it prints a ptxas
# line as nvcc -Xptxas -v does. FAKE_NVCC_FAIL makes it fail instead.
FAKE_NVCC = '''#!{python}
import os, sys, time
from pathlib import Path
args = sys.argv[1:]
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: fake nvcc refuses " + args[-1])
    sys.exit(1)
out, hand = Path(args[args.index("-o") + 1]), Path(os.environ["FAKE_NVCC_HANDSHAKE"])
with open(out, "w") as f:
    f.write("fake library, first half\\n")
    f.flush()
    (hand / f"started.{{os.getpid()}}").write_text("")
    deadline = time.monotonic() + 60
    while len(list(hand.glob("started.*"))) < int(os.environ["FAKE_NVCC_PEERS"]):
        if time.monotonic() > deadline:
            sys.exit("fake nvcc: the other build never started")
        time.sleep(0.01)
    f.write("second half\\n")
print("ptxas info    : Used 32 registers")
'''

BUILD_ONE = ("import sys; from pathlib import Path; from hyena_dna_tpu_torch import _cuda; "
             "_cuda.BUILD_DIR = Path(sys.argv[1]); kernel = _cuda.Kernel('add_ln', {}); "
             "_cuda.build_all([kernel]); print(kernel.library_path.name)")


def fake_cuda_home(tmp_path, peers: int):
    """A CUDA_HOME whose bin/nvcc is FAKE_NVCC, and the environment for it."""
    import sys

    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    hand = tmp_path / "handshake"
    hand.mkdir()
    root = Path(__file__).resolve().parents[1]
    return {**os.environ, "CUDA_HOME": str(home), "FAKE_NVCC_HANDSHAKE": str(hand),
            "FAKE_NVCC_PEERS": str(peers),
            "PYTHONPATH": os.pathsep.join(filter(None, [str(root),
                                                        os.environ.get("PYTHONPATH")]))}


def test_concurrent_builds_leave_one_library(tmp_path):
    """Two processes build one kernel into one cold BUILD_DIR at once (as
    torchrun's ranks do at their first launch): both return, one library
    and its log stand, whole, and no temporary file is left."""
    import subprocess
    import sys

    env = fake_cuda_home(tmp_path, peers=2)
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    (name,) = {out.strip() for out, _ in outs}
    assert sorted(p.name for p in build.iterdir()) == sorted([name, name[:-3] + ".log"])
    assert (build / name).read_text() == "fake library, first half\nsecond half\n"
    assert "Used 32 registers" in (build / name[:-3]).with_suffix(".log").read_text()
    assert len(list((tmp_path / "handshake").glob("started.*"))) == 2  # both compiled


def test_failed_build_raises_and_leaves_no_temporary(tmp_path, monkeypatch):
    """nvcc's failure raises with its output; the build's temporary file is
    removed and no library or log is written."""
    env = fake_cuda_home(tmp_path, peers=1)
    monkeypatch.setenv("CUDA_HOME", env["CUDA_HOME"])
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    kernel = _cuda.Kernel("add_ln", {})
    tmp = kernel.library_path.with_name(f"{kernel.library_path.name}.{os.getpid()}.tmp")
    (tmp_path / "build").mkdir()
    tmp.write_text("a half-written library")
    with pytest.raises(RuntimeError, match="fake nvcc refuses .*add_ln.cu"):
        _cuda.build_all([kernel])
    assert list((tmp_path / "build").iterdir()) == []
