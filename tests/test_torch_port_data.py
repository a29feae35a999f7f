"""The port's data layer held against the JAX package on the same files and
seeds: the tokenizer, FASTA access and interval sampling, the hg38,
fixed-window, LM-chunk and classification datasets (item by item, with
augmentation), the resumable loader (order, resume, host split, errors) and
the datamodules (every batch of every split equal), the downstream ones
(chromatin profile, species in both tasks, ETT hour and minute) included,
and hg38's BPE tokenizer route on a local snapshot (datamodule batches
against the JAX one, two Trainer steps).
Both hg38 datasets take their native C++ fetch where their library builds
(tests/test_torch_port_native.py holds it to the Python path).
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hyena_dna_tpu.data import classification as JC
from hyena_dna_tpu.data import datamodules as JDM
from hyena_dna_tpu.data import fasta as JF
from hyena_dna_tpu.data import hg38 as JH
from hyena_dna_tpu.data import loader as JL
from hyena_dna_tpu.data import tokenizer as JTok
from hyena_dna_tpu_torch.data import classification as C
from hyena_dna_tpu_torch.data import datamodules as DM
from hyena_dna_tpu_torch.data import fasta as F
from hyena_dna_tpu_torch.data import hg38 as H
from hyena_dna_tpu_torch.data import loader as Ld
from hyena_dna_tpu_torch.data import tokenizer as Tok

ROOT = Path(__file__).resolve().parents[1]


def assert_same(a, b):
    """Equal nested items (tuples, dicts, arrays) with equal dtypes."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def genome(tmp_path):
    """Two records with N runs and lower case, 60-base lines, and a bed file."""
    rng = np.random.default_rng(0)
    seqs = {}
    for name, n in (("chr1", 3000), ("chr2", 1700)):
        s = rng.choice(list("ACGTacgt"), size=n)
        s[100:140] = "N"
        seqs[name] = "".join(s)
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name} description\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    bed = tmp_path / "g.bed"
    with open(bed, "w") as f:
        f.write("chr_name\tstart\tend\tsplit\n")
        for i in range(12):
            f.write(f"chr1\t{i * 200}\t{i * 200 + 150}\ttrain\n")
        f.write("chr2\t0\t40\tvalid\nchr2\t1600\t1700\tvalid\nchr1\t2900\t3000\ttest\n")
    return fa, bed, seqs


@pytest.fixture
def benchmark(tmp_path):
    rng = np.random.default_rng(1)
    root = tmp_path / "bench"
    for split in ("train", "test"):
        for label in ("negative", "positive"):
            d = root / "toy" / split / label
            d.mkdir(parents=True)
            for i in range(6 if split == "train" else 3):
                (d / f"{i}.txt").write_text("".join(rng.choice(list("ACGTN"),
                                                               size=int(rng.integers(5, 40)))))
    nt = root / "nt_toy"
    nt.mkdir()
    for split in ("train", "test"):
        with open(nt / f"{split}.fasta", "w") as f:
            for i in range(7):
                seq = "".join(rng.choice(list("ACGT"), size=int(rng.integers(10, 30))))
                f.write(f">seq{i} chrom|{i}|label {i % 2}\n{seq}\n")
    return root


# ---- tokenizer ---------------------------------------------------------------

TEXTS = ["ACGTNacgtX", "", "A" * 40, "TTGGCC.."]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kw", [
    {}, {"add_special_tokens": True}, {"padding": "max_length", "max_length": 16},
    {"padding": "max_length", "max_length": 16, "truncation": True, "add_special_tokens": True},
    {"truncation": True, "max_length": 8}, {"return_attention_mask": False}])
def test_tokenizer_matches_jax(side, kw):
    ours, ref = Tok.CharacterTokenizer(padding_side=side), JTok.CharacterTokenizer(
        padding_side=side)
    for text in TEXTS:
        assert_same(ours(text, **kw), ref(text, **kw))
    assert_same(ours(TEXTS, **kw), ref(TEXTS, **kw))


def test_tokenizer_vocab_decode_and_config_match_jax(tmp_path):
    ours, ref = Tok.CharacterTokenizer(), JTok.CharacterTokenizer()
    assert ours.get_vocab() == ref.get_vocab() and ours.vocab_size == ref.vocab_size == 12
    ids = np.array([7, 8, 1, 11, 4, 14, 9])
    assert ours.decode(ids) == ref.decode(ids)
    assert ours.decode(ids, skip_special_tokens=False) == ref.decode(ids,
                                                                     skip_special_tokens=False)
    assert_same(ours.encode("ACGTN", add_special_tokens=True),
                ref.encode("ACGTN", add_special_tokens=True))
    ours.save_pretrained(tmp_path)
    assert JTok.CharacterTokenizer.from_pretrained(tmp_path).get_config() == ours.get_config()
    for seq in ("ACGTacgtN.", "", "GATTACA"):
        assert Tok.string_reverse_complement(seq) == JTok.string_reverse_complement(seq)
    with pytest.raises(ValueError):
        Tok.CharacterTokenizer(padding_side="middle")


# ---- FASTA ---------------------------------------------------------------------

def test_fasta_matches_jax(genome):
    fa, _, seqs = genome
    ours, ref = F.FastaFile(fa), JF.FastaFile(fa)
    assert list(ours.keys()) == list(ref.keys()) == ["chr1", "chr2"]
    assert "chr2" in ours and ours.length("chr2") == 1700
    for name, start, end in (("chr1", 0, 3000), ("chr1", 55, 70), ("chr2", 1650, 2000),
                             ("chr2", -5, 10), ("chr1", 100, 100)):
        assert ours.fetch(name, start, end) == ref.fetch(name, start, end) == \
            seqs[name][max(start, 0):min(end, len(seqs[name]))]
    ours.close()
    ref.close()
    with pytest.raises(FileNotFoundError):
        F.FastaFile(fa.with_name("missing.fa"))
    assert F.build_fai(fa) == JF.build_fai(fa)


@pytest.mark.parametrize("kw", [{}, {"pad_interval": True}, {"rc_aug": True},
                                {"shift_augs": (-20, 20), "rc_aug": True, "pad_interval": True}])
def test_fasta_interval_matches_jax(genome, kw):
    fa, _, _ = genome
    ours, ref = F.FastaInterval(fasta_file=fa, **kw), JF.FastaInterval(fasta_file=fa, **kw)
    for seed, (name, start, end, max_len) in enumerate((
            ("chr1", 50, 60, 40), ("chr1", 0, 10, 64), ("chr2", 1690, 1700, 50),
            ("chr1", 0, 3000, 128), ("chr2", 200, 400, 200))):
        try:
            b = ref(name, start, end, max_length=max_len, rng=np.random.default_rng(seed))
        except ValueError:  # no room to shift at a record's end: both refuse
            with pytest.raises(ValueError):
                ours(name, start, end, max_length=max_len, rng=np.random.default_rng(seed))
            continue
        assert ours(name, start, end, max_length=max_len, rng=np.random.default_rng(seed)) == b


# ---- datasets --------------------------------------------------------------------

def _items(ds, n=None, epoch_seed=5):
    n = len(ds) if n is None else n
    return [ds.__getitem__(i, rng=np.random.default_rng((epoch_seed, i))) for i in range(n)]


@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("kw", [{"add_eos": True}, {"rc_aug": True, "replace_N_token": True},
                                {"shift_augs": (-30, 30), "pad_interval": True},
                                {"max_length": 100}])
def test_hg38_dataset_matches_jax(genome, split, kw):
    fa, bed, _ = genome
    kw = {"max_length": 128, **kw}
    ours = H.HG38Dataset(split=split, bed_file=str(bed), fasta_file=str(fa), **kw)
    ref = JH.HG38Dataset(split=split, bed_file=str(bed), fasta_file=str(fa), **kw)
    assert len(ours) == len(ref) > 0
    for a, b in zip(_items(ours), _items(ref)):
        assert_same(a, b)
    ours.close()
    ref.close()


@pytest.mark.parametrize("kw", [{"add_eos": True}, {"add_eos": False, "pad_max_length": 80}])
def test_hg38_fixed_dataset_matches_jax(genome, kw):
    fa, _, _ = genome
    ranges = {"chr1": (10, 700), "chr2": (1500, 1700)}
    ours = H.HG38FixedDataset(fasta_file=str(fa), chr_ranges=ranges, max_length=64, **kw)
    ref = JH.HG38FixedDataset(fasta_file=str(fa), chr_ranges=ranges, max_length=64, **kw)
    assert ours.intervals == ref.intervals
    for a, b in zip(_items(ours), _items(ref)):
        assert_same(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
def test_lm_dataset_matches_jax(drop_last):
    tokens = np.arange(23, dtype=np.int32)
    ours, ref = H.LMDataset(tokens, 8, drop_last), JH.LMDataset(tokens, 8, drop_last)
    assert len(ours) == len(ref)
    for a, b in zip(_items(ours), _items(ref)):
        assert_same(a, b)


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("kw", [{}, {"rc_aug": True, "add_eos": True},
                                {"return_mask": True, "use_padding": True},
                                {"use_padding": False}])
def test_classification_datasets_match_jax(benchmark, split, kw):
    for ours_cls, ref_cls, name in ((C.GenomicBenchmarkDataset, JC.GenomicBenchmarkDataset,
                                     "toy"),
                                    (C.NucleotideTransformerDataset,
                                     JC.NucleotideTransformerDataset, "nt_toy")):
        args = dict(split=split, max_length=32, dataset_name=name, dest_path=str(benchmark),
                    **kw)
        ours, ref = ours_cls(**args), ref_cls(**args)
        assert len(ours) == len(ref) > 0
        for a, b in zip(_items(ours), _items(ref)):
            assert_same(a, b)


def test_classification_dataset_refuses_a_missing_task(benchmark):
    with pytest.raises(FileNotFoundError):
        C.GenomicBenchmarkDataset("train", 32, dataset_name="absent", dest_path=str(benchmark))


# ---- loader ------------------------------------------------------------------------

class _Arange:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        return (np.full(4, idx, np.int32), np.asarray(rng.integers(0, 1000), np.int64),
                {"mask": np.ones(3, bool)})


@pytest.mark.parametrize("kw", [{"shuffle": True}, {"shuffle": False},
                                {"shuffle": True, "drop_last": False, "batch_size": 5}])
def test_loader_order_matches_jax(kw):
    kw = {"batch_size": 4, "seed": 7, **kw}
    ours, ref = Ld.DataLoader(_Arange(30), **kw), JL.DataLoader(_Arange(30), **kw)
    for _ in range(2):  # two epochs: the permutation moves
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            assert_same(x, y)
    assert ours.epoch == ref.epoch == 2


def test_loader_resume_matches_uninterrupted():
    whole = list(Ld.DataLoader(_Arange(32), batch_size=4, shuffle=True, seed=3))
    cut = Ld.DataLoader(_Arange(32), batch_size=4, shuffle=True, seed=3)
    it = iter(cut)
    head = [next(it) for _ in range(3)]
    state = cut.state_dict()
    assert state == {"epoch": 0, "batches_served": 3, "seed": 3}
    resumed = Ld.DataLoader(_Arange(32), batch_size=4, shuffle=True, seed=0)
    resumed.load_state_dict(state)
    tail = list(resumed)
    assert len(head) + len(tail) == len(whole)
    for x, y in zip(head + tail, whole):
        assert_same(x, y)
    assert resumed.epoch == 1 and resumed.batches_served == 0


def test_loader_propagates_dataset_errors():
    class Boom(_Arange):
        def __getitem__(self, idx, rng=None):
            if idx == 3:
                raise ValueError("bad sample")
            return super().__getitem__(idx, rng)

    with pytest.raises(ValueError, match="bad sample"):
        list(Ld.DataLoader(Boom(8), batch_size=2))


# ---- datamodules --------------------------------------------------------------------

def _all_batches(dm):
    out = []
    for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
        loader = getattr(dm, name)()
        out.append(None if loader is None else list(loader))
    return out


@pytest.fixture(scope="module")
def downstream(tmp_path_factory):
    """Files of the downstream datamodules: a genome with hg38 coordinate
    CSVs (5 labels), two species directories, and ETT CSVs long enough for
    the fixed hour and minute borders."""
    root = tmp_path_factory.mktemp("downstream")
    rng = np.random.default_rng(5)
    genome = {f"chr{i + 1}": "".join(rng.choice(list("ACGTacgt"), size=2500)) for i in range(2)}
    fa = root / "genome.fa"
    with open(fa, "w") as f:
        for name, seq in genome.items():
            f.write(f">{name}\n" + "".join(seq[i:i + 60] + "\n" for i in range(0, len(seq), 60)))
    for split, n in (("train", 10), ("val", 5), ("test", 3)):
        with open(root / f"{split}_hg38_coords_targets.csv", "w") as f:
            f.write("Chr_No,Start,End," + ",".join(f"y_{j}" for j in range(5)) + "\n")
            for i in range(n):
                start = int(rng.integers(0, 2000))
                labels = ",".join(str(int(v)) for v in rng.integers(0, 2, size=5))
                f.write(f"{i % 2},{start},{start + 1000},{labels}\n")
    for spec in ("human", "mouse"):
        d = root / "species" / spec
        d.mkdir(parents=True)
        for c in ("1", "3", "12", "13", "2", "4", "5", "7", "9", "10", "11", "6", "8", "14",
                  "15", "16", "17", "18", "19", "20", "21", "22", "X", "Y"):
            seq = "".join(rng.choice(list("ACGT"), size=300))
            (d / f"chr{c}.fa").write_text(f">chr{c}\n{seq}\n")
    for variant, per_hour in (("hour", 1), ("minute", 4)):
        n = 20 * 30 * 24 * per_hour
        vals = rng.standard_normal((n, 2))
        lines = ["date,HUFL,OT"]
        for i in range(n):
            m = i // per_hour
            lines.append(f"2016-{1 + (m // 720) % 12:02d}-{1 + (m // 24) % 28:02d} "
                         f"{m % 24:02d}:{15 * (i % per_hour):02d}:00,{vals[i, 0]:.4f},"
                         f"{vals[i, 1]:.4f}")
        (root / f"ett_{variant}.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("name,kw", [
    ("hg38", {"max_length": 128, "batch_size": 4, "rc_aug": True}),
    ("hg38", {"max_length": 96, "batch_size": 3, "add_eos": False, "batch_size_eval": 2}),
    ("hg38_fixed", {"chr_ranges": {"chr1": [0, 900]}, "max_length": 128, "batch_size": 2}),
    ("genomic_benchmark", {"dataset_name": "toy", "max_length": 32, "batch_size": 4,
                           "rc_aug": True}),
    ("genomic_benchmark", {"dataset_name": "toy", "max_length": 32, "batch_size": 4,
                           "return_mask": True, "padding_side": "right"}),
    ("nucleotide_transformer", {"dataset_name": "nt_toy", "max_length": 32, "batch_size": 3}),
    ("chromatin_profile", {"d_output": 5, "max_length": 1200, "batch_size": 4}),
    ("species", {"species": ["human", "mouse"], "max_length": 64, "total_size": 20,
                 "batch_size": 4, "rc_aug": True}),
    ("species", {"species": ["human", "mouse"], "max_length": 48, "total_size": 12,
                 "batch_size": 3, "task": "next_token_pred", "total_size_val": 5}),
    ("ett", {"variant": "hour", "size": [96, 48, 24], "batch_size": 64}),
    ("ett", {"variant": "minute", "size": [96, 48, 24], "features": "M", "batch_size": 512})])
def test_datamodule_matches_jax(genome, benchmark, downstream, name, kw):
    fa, bed, _ = genome
    files = ({"bed_file": str(bed), "fasta_file": str(fa)} if name == "hg38"
             else {"fasta_file": str(fa)} if name == "hg38_fixed"
             else {"ref_genome_path": str(downstream / "genome.fa"),
                   "data_path": str(downstream)} if name == "chromatin_profile"
             else {"species_dir": str(downstream / "species")} if name == "species"
             else {"data_path": str(downstream / f"ett_{kw['variant']}.csv")} if name == "ett"
             else {"dest_path": str(benchmark)})
    ours = DM.DATASET_REGISTRY[name](seed=11, **files, **kw)
    ref = JDM.DATASET_REGISTRY[name](seed=11, **files, **kw)
    ours.setup()
    ref.setup()
    for attr in ("vocab_size", "d_output", "l_output", "max_length", "batch_size", "d_input"):
        assert getattr(ours, attr, None) == getattr(ref, attr, None), attr
    for a, b in zip(_all_batches(ours), _all_batches(ref)):
        assert (a is None) == (b is None)
        if a is not None:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert_same(x, y)


# ---- the BPE tokenizer route of hg38 ---------------------------------------------

@pytest.fixture
def bpe_snapshot(tmp_path):
    """tests/test_datasets2.py::test_bpe_tokenizer_path's files: an 8192-base
    genome, a bed file with 8 train, 1 valid and 1 test interval, and a
    64-token BPE trained on random ACGT and saved as a local `transformers`
    snapshot (the stand-in for the reference's gena-lm download)."""
    pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, trainers

    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=8192))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\n")
    bed = tmp_path / "g.bed"
    with open(bed, "w") as f:
        for i in range(8):
            f.write(f"chr1\t{i * 512}\t{i * 512 + 256}\ttrain\n")
        f.write("chr1\t4096\t4352\tvalid\n")
        f.write("chr1\t6000\t6256\ttest\n")
    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    trainer = trainers.BpeTrainer(vocab_size=64, special_tokens=["[PAD]", "[UNK]", "[SEP]"])
    tok.train_from_iterator(["".join(rng.choice(list("ACGT"), size=512)) for _ in range(16)],
                            trainer)
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                                pad_token="[PAD]", sep_token="[SEP]")
    snap = tmp_path / "bpe_tok"
    fast.save_pretrained(str(snap))
    return fa, bed, snap, len(fast)


@pytest.mark.parametrize("kw", [{"add_eos": True, "rc_aug": True},
                                {"add_eos": False, "shuffle": False, "batch_size_eval": 1}])
def test_bpe_datamodule_matches_jax(bpe_snapshot, kw):
    """`tokenizer_name: bpe` from a local snapshot: the same vocab_size
    (len(tokenizer)) and every train, val and test batch equal to the JAX
    datamodule's."""
    fa, bed, snap, n_tokens = bpe_snapshot
    files = {"bed_file": str(bed), "fasta_file": str(fa), "tokenizer_name": "bpe",
             "bpe_tokenizer_path": str(snap), "max_length": 64, "batch_size": 4, "seed": 11}
    ours, ref = DM.HG38DataModule(**files, **kw), JDM.HG38DataModule(**files, **kw)
    ours.setup()
    ref.setup()
    assert ours.vocab_size == ref.vocab_size == n_tokens
    assert ours.dataset_train.native is None  # the fused fetch is the char tokenizer's
    batches = _all_batches(ours)
    for a, b in zip(batches, _all_batches(ref)):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert_same(x, y)
    x, y = batches[0][0]
    assert x.shape == (4, 63) and int(x.max()) < n_tokens
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])


def test_bpe_snapshot_path_from_the_environment(bpe_snapshot, monkeypatch):
    """With no `bpe_tokenizer_path`, `$HYENA_BPE_TOKENIZER_PATH` names the
    snapshot, as in the JAX datamodule."""
    fa, bed, snap, n_tokens = bpe_snapshot
    monkeypatch.setenv("HYENA_BPE_TOKENIZER_PATH", str(snap))
    dm = DM.HG38DataModule(bed_file=str(bed), fasta_file=str(fa), tokenizer_name="bpe",
                           max_length=64)
    dm.setup()
    assert dm.vocab_size == n_tokens and len(dm.dataset_train) == 8


def test_bpe_route_names_transformers_when_it_is_missing(genome, monkeypatch):
    fa, bed, _ = genome
    monkeypatch.setitem(sys.modules, "transformers", None)  # an import of it raises
    dm = DM.HG38DataModule(bed_file=str(bed), fasta_file=str(fa), tokenizer_name="bpe")
    with pytest.raises(ImportError, match="transformers"):
        dm.setup()


def test_hg38_refuses_other_tokenizers(genome):
    fa, bed, _ = genome
    dm = DM.HG38DataModule(bed_file=str(bed), fasta_file=str(fa), tokenizer_name="word")
    with pytest.raises(NotImplementedError, match="'char' or 'bpe'"):
        dm.setup()


def test_port_imports_transformers_only_in_the_bpe_route():
    """Importing the port's data and training modules imports no
    `transformers`; the one import line is inside `HG38DataModule.setup`."""
    code = ("import sys, hyena_dna_tpu_torch.data.datamodules, hyena_dna_tpu_torch.train.trainer;"
            "print('transformers' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip() == "False"
    lines = [(path.name, line) for path in (ROOT / "hyena_dna_tpu_torch").rglob("*.py")
             for line in path.read_text().splitlines()
             if re.match(r"\s*(from|import)\s+transformers\b", line)]
    assert lines == [("datamodules.py", "                from transformers import AutoTokenizer")]


def test_trainer_runs_the_bpe_route(bpe_snapshot, tmp_path):
    """Two steps of the port's Trainer on `dataset.tokenizer_name=bpe` at d
    16: the model's vocabulary is len(tokenizer), from the datamodule, and
    every logged loss is finite."""
    from hyena_dna_tpu_torch.train.trainer import Trainer

    fa, bed, snap, n_tokens = bpe_snapshot
    cfg = {"train": {"seed": 1, "run_dir": str(tmp_path / "run")}, "mesh": {"data": 1},
           "trainer": {"max_epochs": 1, "limit_train_batches": 2, "precision": "32",
                       "log_every_n_steps": 1},
           "dataset": {"_name_": "hg38", "bed_file": str(bed), "fasta_file": str(fa),
                       "tokenizer_name": "bpe", "bpe_tokenizer_path": str(snap),
                       "batch_size": 4, "max_length": 64},
           "task": {"_name_": "hg38", "loss": "cross_entropy"},
           "model": {"_name_": "lm", "d_model": 16, "n_layer": 1, "d_inner": 64,
                     "pad_vocab_size_multiple": 1, "embed_dropout": 0.0,
                     "layer": {"_name_": "hyena", "emb_dim": 5, "filter_order": 8,
                               "l_max": 64}},
           "optimizer": {"lr": 1e-3}, "callbacks": {}}
    trainer = Trainer(cfg, device="cpu")
    assert trainer.datamodule.vocab_size == n_tokens
    assert trainer.model.d_output == n_tokens
    trainer.fit()
    trainer.close()
    records = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert trainer.global_step == 2 and len(losses) == 2
    assert all(np.isfinite(v) for v in losses)
