"""The port's native data path (`data/native.py`, the fused C++ fetch of
`native/hyena_data.cpp`) on the CPU: `tests/test_native.py`'s checks run on
the port, both sides of each the port's (the native fetch and tokenizer
against the port's Python tokenizer and `HG38Dataset` Python path), the
port's `HG38Dataset` held to the JAX one on the same seeds, and the
library's build location (`_build/`, a hash in its name).
"""

import numpy as np
import pytest

from hyena_dna_tpu.data.hg38 import HG38Dataset as JaxHG38Dataset
from hyena_dna_tpu_torch.data import native
from hyena_dna_tpu_torch.data.hg38 import HG38Dataset
from hyena_dna_tpu_torch.data.native import NativeFasta, tokenize
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer, string_reverse_complement


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    assert lib is not None, native.build_error  # g++ is on every host the tests run on
    return lib


@pytest.fixture
def genome(tmp_path):
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGTN"), size=5000, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chr1 desc\n")
        for i in range(0, len(seq), 61):  # an odd line width exercises the wrapping
            f.write(seq[i:i + 61] + "\n")
    return fa, seq


def test_library_lands_in_build_dir_with_its_hash(lib):
    path = native.library_path(native.compiler())
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "hyena_dna_tpu_torch"
    digest = path.stem.rsplit("_", 1)[1]
    assert len(digest) == 16 and int(digest, 16) >= 0
    assert not list(native.BUILD_DIR.glob("libhyena_data_*.tmp"))


def test_tokenize_bytes_matches_python(lib):
    tok = CharacterTokenizer()
    for text in ("ACGTN", "ACGTXacgt", "A" * 100):
        out = tokenize(text, 32, add_eos=True, pad_left=True, uppercase=False)
        ref = tok(text, add_special_tokens=True, padding="max_length",
                  max_length=32, truncation=True)["input_ids"]
        np.testing.assert_array_equal(out, ref, err_msg=text)


def test_native_fetch_matches_python_pipeline(lib, genome):
    fa_path, seq = genome
    nf = NativeFasta(fa_path)
    tok = CharacterTokenizer()
    assert nf.length("chr1") == 5000
    for start, end, L in [(100, 200, 100), (0, 50, 100), (4950, 5100, 200), (100, 1000, 64)]:
        out = nf.fetch_tokens("chr1", start, end, L, add_eos=True, uppercase=False)
        s, e = max(0, start), min(5000, end)
        ref = tok(seq[s:e], add_special_tokens=True, padding="max_length",
                  max_length=L, truncation=True)["input_ids"]
        np.testing.assert_array_equal(out, ref, err_msg=f"{start}:{end}")
    with pytest.raises(KeyError):
        nf.length("chrZ")
    nf.close()


def test_native_rc_matches_python(lib, genome):
    fa_path, seq = genome
    nf = NativeFasta(fa_path)
    out = nf.fetch_tokens("chr1", 100, 164, 64, add_eos=False, rc=True, uppercase=False)
    ref = CharacterTokenizer()(string_reverse_complement(seq[100:164]), padding="max_length",
                               max_length=64, truncation=True)["input_ids"]
    np.testing.assert_array_equal(out, ref)
    nf.close()


def _bed(tmp_path, rows):
    bed = tmp_path / "b.bed"
    bed.write_text("".join(f"chr1\t{s}\t{e}\ttrain\n" for s, e in rows))
    return bed


@pytest.mark.parametrize("kw", [{"add_eos": True, "rc_aug": True},
                                {"add_eos": False, "rc_aug": True, "replace_N_token": True},
                                {"add_eos": True, "max_length": 512, "shift_augs": (-40, 40)}])
def test_hg38_dataset_native_vs_python_and_jax(lib, genome, tmp_path, kw):
    """Native against Python in the port, and the port against the JAX
    dataset, item by item on the same seeds (windows past both ends of the
    chromosome included)."""
    fa_path, _ = genome
    bed = _bed(tmp_path, [(i * 600, i * 600 + 128) for i in range(8)] + [(4900, 5000)])
    kw = {"split": "train", "bed_file": str(bed), "fasta_file": str(fa_path),
          "max_length": 128, **kw}
    ds_native, ds_python, ds_jax = HG38Dataset(**kw), HG38Dataset(**kw), JaxHG38Dataset(**kw)
    assert ds_native.native is not None
    ds_python.native = None  # force the Python path
    for i in range(len(ds_native)):
        for seed in (0, 1):
            a = ds_native.__getitem__(i, rng=np.random.default_rng((seed, i)))
            b = ds_python.__getitem__(i, rng=np.random.default_rng((seed, i)))
            c = ds_jax.__getitem__(i, rng=np.random.default_rng((seed, i)))
            for x, y, z in zip(a, b, c):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y, err_msg=f"idx {i} seed {seed}")
                np.testing.assert_array_equal(x, z, err_msg=f"idx {i} seed {seed}")
    ds_native.close()
    assert ds_native.native is None


def test_hg38_dataset_native_shift_aug_parity(lib, genome, tmp_path):
    fa_path, _ = genome
    bed = _bed(tmp_path, [(1000, 1128)])
    kw = dict(split="train", bed_file=str(bed), fasta_file=str(fa_path),
              max_length=128, add_eos=False, shift_augs=(-3, 3))
    ds_native, ds_python = HG38Dataset(**kw), HG38Dataset(**kw)
    ds_python.native = None
    for seed in range(5):
        a = ds_native.__getitem__(0, rng=np.random.default_rng(seed))
        b = ds_python.__getitem__(0, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"seed {seed}")


def test_python_path_where_the_rule_excludes_native(lib, genome, tmp_path):
    """'.'-padded intervals and right padding stay on the Python path."""
    fa_path, _ = genome
    bed = _bed(tmp_path, [(0, 64)])
    kw = dict(split="train", bed_file=str(bed), fasta_file=str(fa_path), max_length=128)
    assert HG38Dataset(**kw, pad_interval=True).native is None
    right = CharacterTokenizer(model_max_length=130, padding_side="right")
    assert HG38Dataset(**kw, tokenizer=right).native is None


def test_unbuildable_library_falls_back_with_one_warning(monkeypatch, genome, tmp_path):
    """A compiler that fails: one warning with its output, no library, the
    dataset on the Python path."""
    fa_path, _ = genome
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-option",))
    with pytest.warns(RuntimeWarning, match="Python path runs"):
        assert native.load_library() is None
    assert native.build_error and "failed" in native.build_error
    ds = HG38Dataset(split="train", bed_file=str(_bed(tmp_path, [(0, 64)])),
                     fasta_file=str(fa_path), max_length=64)
    assert ds.native is None
    assert len(ds[0][0]) == 63
