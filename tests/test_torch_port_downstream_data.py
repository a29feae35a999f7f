"""The port's downstream datasets held against the JAX package's on the same
fixtures (those of `tests/test_datasets2.py` and `tests/test_legacy_data.py`):
chromatin profile (windows, labels, widening, version checks), the chain
file and the hg19 -> hg38 liftover (both strands, gaps, unmapped rows, the
saved CSV), species (both tasks, N-padding, gzip, weights), ETT windows and
the vocabulary. Ids, labels, coordinates, kept rows and arrays must be
equal, each side's own checks as the JAX tests make them.
"""

import gzip

import numpy as np
import pytest

from hyena_dna_tpu.data import chromatin_profile as JCP
from hyena_dna_tpu.data import liftover as JLO
from hyena_dna_tpu.data import species as JS
from hyena_dna_tpu.data import timeseries as JTS
from hyena_dna_tpu.data import vocabulary as JV
from hyena_dna_tpu_torch.data import chromatin_profile as CP
from hyena_dna_tpu_torch.data import liftover as LO
from hyena_dna_tpu_torch.data import species as S
from hyena_dna_tpu_torch.data import timeseries as TS
from hyena_dna_tpu_torch.data import vocabulary as V
from test_torch_port_data import assert_same


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")


def _write_chain(path, lines):
    path.write_text("\n".join(lines) + "\n")


def assert_items_equal(ours, ref, n, seeds=(0, 1)):
    assert len(ours) == len(ref) == n
    for i in range(n):
        for seed in seeds:
            assert_same(ours.__getitem__(i, rng=np.random.default_rng((seed, i))),
                        ref.__getitem__(i, rng=np.random.default_rng((seed, i))))


# ---- chromatin profile ---------------------------------------------------------------

@pytest.fixture
def chromatin_fixture(tmp_path):
    rng = np.random.default_rng(0)
    genome = {f"chr{i + 1}": "".join(rng.choice(list("ACGTacgt"), size=3000)) for i in range(2)}
    fa = tmp_path / "genome.fa"
    _write_fasta(fa, genome)
    csv_path = tmp_path / "train_hg38_coords_targets.csv"
    with open(csv_path, "w") as f:
        f.write("Chr_No,Start,End,y_a,y_b,y_c\n")
        for i in range(6):
            start = 500 + i * 300  # the later windows run past chr{n}'s end
            f.write(f"{i % 2},{start},{start + 1000},{i % 2},{(i + 1) % 2},1\n")
    return fa, csv_path, genome


@pytest.mark.parametrize("max_length,kw", [(1000, {}), (1200, {}), (1400, {"add_eos": True}),
                                           (1000, {"use_padding": False})])
def test_chromatin_profile_matches_jax(chromatin_fixture, max_length, kw):
    fa, csv_path, genome = chromatin_fixture
    args = dict(max_length=max_length, ref_genome_path=str(fa), ref_genome_version="hg38",
                coords_target_path=str(csv_path), **kw)
    ours, ref = CP.ChromatinProfileDataset(**args), JCP.ChromatinProfileDataset(**args)
    assert ours.d_output == ref.d_output == 3
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.targets, ref.targets)
    assert_items_equal(ours, ref, 6, seeds=(0,))
    x, y = ours[0]
    np.testing.assert_array_equal(y, [0, 1, 1])
    if max_length == 1000 and not kw:  # the window is the genome's slice, upper-cased
        assert ours.tokenizer.decode(x) == genome["chr1"][500:1500].upper()
    ours.close()


def test_chromatin_profile_version_mismatch(chromatin_fixture):
    fa, csv_path, _ = chromatin_fixture
    for mod in (CP, JCP):
        with pytest.raises(ValueError):
            mod.ChromatinProfileDataset(max_length=1000, ref_genome_path=str(fa),
                                        ref_genome_version="hg19",
                                        coords_target_path=str(csv_path))
        with pytest.raises(AssertionError):
            mod.ChromatinProfileDataset(max_length=1001, ref_genome_path=str(fa),
                                        coords_target_path=str(csv_path))


# ---- liftover -------------------------------------------------------------------------

def _chains(tmp_path):
    """Two chains on chr1 (a gapped '+' one and a '-' one) and one on chr2."""
    chain = tmp_path / "t.chain"
    _write_chain(chain, [
        "chain 1000 chr1 3000 + 100 200 chr1 4000 + 200 295 1",
        "50 10 5",
        "40",
        "",
        "chain 900 chr1 3000 + 300 400 chrX 1000 - 10 110 2",
        "60 5 7",
        "35",
        "",
        "chain 800 chr2 5000 + 0 1000 chr2 5000 + 37 1037 3",
        "1000",
    ])
    return chain


def test_chainfile_matches_jax(tmp_path):
    chain = _chains(tmp_path)
    ours, ref = LO.get_lifter(str(chain)), JLO.get_lifter(str(chain))
    for chrom in ("chr1", "chr2", "chr3"):
        for pos in list(range(0, 1100, 1)) + [2999, 3000, 4999, 5000]:
            assert ours.convert(chrom, pos) == ref.convert(chrom, pos), (chrom, pos)
        pos = np.random.default_rng(0).integers(-5, 1200, size=500)
        for a, b in zip(ours.convert_batch(chrom, pos), ref.convert_batch(chrom, pos)):
            assert_same(a, b)


def test_chainfile_forward_gaps_and_negative_strand(tmp_path):
    """tests/test_datasets2.py's chain checks on the port."""
    cf = LO.ChainFile(str(_chains(tmp_path)))
    assert cf.convert("chr1", 100) == ("chr1", 200, "+")
    assert cf.convert("chr1", 149) == ("chr1", 249, "+")
    assert cf.convert("chr1", 155) is None  # inside the gap
    assert cf.convert("chr1", 160) == ("chr1", 255, "+")
    assert cf.convert("chr1", 199) == ("chr1", 294, "+")
    assert cf.convert("chr1", 200) is None  # past the chain's end
    assert cf.convert("chr3", 100) is None  # an unknown chromosome
    assert cf.convert("chr1", 300) == ("chrX", 989, "-")  # qSize - 1 - 10
    assert cf.convert("chr1", 365) == ("chrX", 1000 - 1 - (10 + 60 + 7), "-")
    pos, ok = cf.convert_batch("chr1", np.asarray([100, 149, 155, 160, 5000]))
    np.testing.assert_array_equal(pos, [200, 249, -1, 255, -1])
    np.testing.assert_array_equal(ok, [True, True, False, True, False])


def test_chromatin_liftover_matches_jax(tmp_path):
    """An hg19 CSV, an hg38 genome and a chain with a gap and a '-' strand:
    lifted rows, dropped rows (unmapped, resized, reversed) and the saved
    hg38 CSV equal the JAX dataset's."""
    rng = np.random.default_rng(1)
    genome = {c: "".join(rng.choice(list("ACGT"), size=6000)) for c in ("chr1", "chr2")}
    fa = tmp_path / "genome.fa"
    _write_fasta(fa, genome)
    chain = tmp_path / "hg19ToHg38.over.chain"
    _write_chain(chain, [
        "chain 1000 chr1 6000 + 0 3500 chr1 6000 + 37 3532 1",
        "2000 20 15",
        "1480",
        "",
        "chain 900 chr2 6000 + 0 4000 chr2 6000 - 100 4100 2",
        "4000",
    ])
    rows = [(0, 500, 1500), (0, 700, 1700), (0, 1000, 2000), (0, 1510, 2510),
            (0, 2600, 3600), (0, 3500, 4500), (1, 100, 1100), (1, 2000, 3000)]
    for split in ("train", "val"):
        path = tmp_path / f"{split}_hg19_coords_targets.csv"
        with open(path, "w") as f:
            f.write("Chr_No,Start,End,y_a,y_b\n")
            for i, (c, s, e) in enumerate(rows):
                f.write(f"{c},{s},{e},{i % 2},{(i // 2) % 2}\n")
    args = dict(max_length=1000, ref_genome_path=str(fa), ref_genome_version="hg38",
                coords_target_path=str(tmp_path / "train_hg19_coords_targets.csv"),
                liftover_chain_path=str(chain))
    ours = CP.ChromatinProfileDataset(**args, save_liftover=True)
    ref = JCP.ChromatinProfileDataset(**{**args, "coords_target_path":
                                         str(tmp_path / "val_hg19_coords_targets.csv")},
                                      save_liftover=True)
    # rows 0 and 1 map whole and keep 1000 bases; 2 and 4-5 end unmapped, 3
    # spans the gap (995 bases), 6-7 lie on the '-' strand (reversed)
    assert len(ours) == 2
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.coords[:, 1], [537, 737])
    np.testing.assert_array_equal(ours.targets, ref.targets)
    assert_items_equal(ours, ref, 2, seeds=(0,))
    assert ours.tokenizer.decode(ours[0][0]) == genome["chr1"][537:1537]
    saved = (tmp_path / "train_hg38_coords_targets.csv").read_text()
    assert saved == (tmp_path / "val_hg38_coords_targets.csv").read_text()
    again = CP.ChromatinProfileDataset(max_length=1000, ref_genome_path=str(fa),
                                       coords_target_path=str(tmp_path
                                                              / "train_hg38_coords_targets.csv"))
    np.testing.assert_array_equal(again.coords, ours.coords)
    with pytest.raises(ValueError, match="liftover_chain_path"):
        CP.ChromatinProfileDataset(**{**args, "liftover_chain_path": None})


# ---- species --------------------------------------------------------------------------

@pytest.fixture
def species_fixture(tmp_path):
    rng = np.random.default_rng(1)
    for spec in ("human", "mouse"):
        d = tmp_path / spec
        d.mkdir()
        for c in ["1", "3", "12", "13", "2", "4", "5", "7", "9", "10", "11", "6", "8", "14",
                  "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"]:
            seq = "".join(rng.choice(list("ACGTacgt"), size=int(rng.integers(400, 800))))
            _write_fasta(d / f"chr{c}.fa", {f"chr{c}": seq})
    return tmp_path


@pytest.mark.parametrize("kw", [
    {"split": "valid", "max_length": 128},
    {"split": "train", "max_length": 64, "rc_aug": True, "task": "next_token_pred"},
    {"split": "test", "max_length": 1024},  # longer than the chromosomes: N-padded
    {"split": "train", "max_length": 96, "remove_tail_ends": True, "add_eos": True,
     "chromosome_weights": "weighted_by_bp", "species_weights": "weighted_by_bp"},
    {"split": "valid", "max_length": 32, "pad_max_length": 40, "species_weights": [0.2, 0.8],
     "chromosome_weights": {"human": [1, 2, 3, 4], "mouse": [4, 3, 2, 1]}}])
def test_species_dataset_matches_jax(species_fixture, kw):
    args = dict(species=["human", "mouse"], species_dir=str(species_fixture), total_size=12,
                **kw)
    ours, ref = S.SpeciesDataset(**args), JS.SpeciesDataset(**args)
    assert ours.d_output == ref.d_output == 2
    np.testing.assert_array_equal(ours.species_weights, ref.species_weights)
    assert_items_equal(ours, ref, 12)
    x, y = ours.__getitem__(0, rng=np.random.default_rng(0))
    if kw.get("task") == "next_token_pred":
        np.testing.assert_array_equal(x[1:], y[:-1])
    else:
        assert y.dtype == np.int32 and int(y) in (0, 1)
    if kw["max_length"] == 1024:
        assert (x == ours.tokenizer.get_vocab()["N"]).sum() >= 1024 - 800
    ours.close()


def test_species_both_sampled(species_fixture):
    ds = S.SpeciesDataset(species=["human", "mouse"], species_dir=str(species_fixture),
                          split="valid", max_length=128, total_size=16)
    labels = {int(ds.__getitem__(i, rng=np.random.default_rng(i))[1]) for i in range(16)}
    assert labels == {0, 1}
    assert S.SPECIES_CHROMOSOME_SPLITS == JS.SPECIES_CHROMOSOME_SPLITS


def test_species_gz_decompression_matches_jax(tmp_path):
    for side in ("ours", "ref"):
        d = tmp_path / side / "human"
        d.mkdir(parents=True)
        for c in ["1", "3", "12", "13"]:
            seq = "".join(np.random.default_rng(int(c)).choice(list("ACGT"), size=200))
            with gzip.open(d / f"chr{c}.fna.gz", "wb") as f:
                f.write(f">chr{c}\n{seq}\n".encode())
    args = dict(species=["human"], split="valid", max_length=64, total_size=4)
    ours = S.SpeciesDataset(species_dir=str(tmp_path / "ours"), **args)
    ref = JS.SpeciesDataset(species_dir=str(tmp_path / "ref"), **args)
    assert (tmp_path / "ours" / "human" / "chr1.fna").exists()
    assert_items_equal(ours, ref, 4)
    with pytest.raises(FileNotFoundError):
        S.SpeciesDataset(species=["human"], species_dir=str(tmp_path / "ours"), split="train",
                         max_length=64, total_size=4)


# ---- ETT and the vocabulary -------------------------------------------------------------

@pytest.fixture
def ett_csv(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "ett.csv"
    with open(path, "w") as f:
        f.write("date,HUFL,HULL,OT\n")
        for i in range(500):
            h, d = i % 24, 1 + (i // 24) % 28
            f.write(f"2016-07-{d:02d} {h:02d}:{(i * 15) % 60:02d}:00,"
                    f"{rng.normal():.4f},{rng.normal():.4f},{rng.normal():.4f}\n")
    return path


@pytest.mark.parametrize("flag", ["train", "val", "test"])
@pytest.mark.parametrize("kw", [
    {"features": "S"}, {"features": "M", "eval_stamp": True},
    {"features": "MS", "eval_mask": True, "scale": False}, {"features": "M", "freq": "t"}])
def test_informer_dataset_matches_jax(ett_csv, flag, kw):
    args = dict(flag=flag, size=(48, 24, 24), **kw)
    ours, ref = TS.InformerDataset(str(ett_csv), **args), JTS.InformerDataset(str(ett_csv), **args)
    for attr in ("data_x", "data_y", "data_stamp"):
        assert_same(getattr(ours, attr), getattr(ref, attr))
    assert (ours.d_input, ours.d_output, ours.n_tokens_time) == (
        ref.d_input, ref.d_output, ref.n_tokens_time)
    assert len(ours) == len(ref) > 0
    for i in (0, len(ours) // 2, len(ours) - 1):
        assert_same(ours[i], ref[i])
    x, y, extra = ours[0]
    assert x.shape == (72, ours.d_input) and y.shape == (24, ours.d_input)
    np.testing.assert_array_equal(x[48:], 0.0)  # the forecast region is zero
    assert extra["mask"].shape == (72, 1)


@pytest.mark.parametrize("cls", ["ETTHourDataset", "ETTMinuteDataset"])
def test_ett_borders_match_jax(tmp_path, cls):
    """The fixed ETT borders need a year of rows: 12 + 8 months of hours
    (or quarter hours)."""
    per_hour = 4 if cls == "ETTMinuteDataset" else 1
    n = 20 * 30 * 24 * per_hour
    rng = np.random.default_rng(3)
    path = tmp_path / "ett.csv"
    with open(path, "w") as f:
        f.write("date,HUFL,OT\n")
        vals = rng.standard_normal((n, 2))
        for i in range(n):
            m = i // per_hour
            f.write(f"2016-{1 + (m // 720) % 12:02d}-{1 + (m // 24) % 28:02d} "
                    f"{m % 24:02d}:{15 * (i % per_hour):02d}:00,{vals[i, 0]:.4f},"
                    f"{vals[i, 1]:.4f}\n")
    for flag in ("train", "val", "test"):
        ours = getattr(TS, cls)(str(path), flag=flag, size=(96, 48, 24))
        ref = getattr(JTS, cls)(str(path), flag=flag, size=(96, 48, 24))
        assert_same(ours.data_x, ref.data_x)
        assert_same(ours.data_stamp, ref.data_stamp)
        assert_same(ours[len(ours) - 1], ref[len(ref) - 1])


def test_standard_scaler_matches_jax():
    data = np.random.default_rng(1).normal(3.0, 2.0, size=(100, 4))
    data[:, 2] = 5.0  # a constant column: std 1
    ours, ref = TS.StandardScaler(), JTS.StandardScaler()
    ours.fit(data)
    ref.fit(data)
    assert_same(ours.transform(data), ref.transform(data))
    np.testing.assert_allclose(ours.inverse_transform(ours.transform(data)), data, rtol=1e-10)


@pytest.mark.parametrize("kw", [{"special": ["<unk>"], "lower_case": True},
                                {"special": ["<unk>"], "min_freq": 2, "add_eos": False},
                                {"special": ["<unk>", "<eos>"], "max_size": 3,
                                 "add_double_eos": True, "lower_case": False}])
def test_vocab_matches_jax(tmp_path, kw):
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat\nThe dog sat on the mat\na a a b b c\n")
    vocabs = []
    for mod in (V, JV):
        v = mod.Vocab(**kw)
        v.count_file(corpus)
        v.build_vocab()
        vocabs.append(v)
    ours, ref = vocabs
    assert ours.idx2sym == ref.idx2sym and ours.sym2idx == ref.sym2idx
    assert ours.get_idx("zebra") == ref.get_idx("zebra") == 0  # the <unk> fallback
    for ordered in (True, False):
        assert_same(ours.encode_file(corpus, ordered=ordered),
                    ref.encode_file(corpus, ordered=ordered))
    sents = [["the", "cat"], ["a", "b"]]
    assert_same(ours.encode_sents(sents, ordered=True), ref.encode_sents(sents, ordered=True))
    assert ours.unk_idx == 0


def test_vocab_build_and_encode(tmp_path):
    """tests/test_legacy_data.py's vocabulary checks on the port."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat\nthe dog sat on the mat\n")
    v = V.Vocab(special=["<unk>"], lower_case=True)
    v.count_file(corpus)
    v.build_vocab()
    assert v.get_idx("<unk>") == 0 and v.get_idx("the") == 1
    ids = v.encode_file(corpus, ordered=True)
    assert ids.dtype == np.int64 and len(ids) == 11 and v.get_sym(int(ids[0])) == "the"
