"""Datamodules (mirrors `hyena_dna_tpu/data/datamodules.py`): named dataset
bundles with `setup()`, loaders and the attributes the trainer wires into
the task and the model (`vocab_size`, `d_output`, `l_output`,
`max_length`).

Registration is by `_name_` through `__init_subclass__`. The loaders are
`data/loader.py::DataLoader`, deterministic and resumable, so the
reference's `fault_tolerant` and `ddp` flags are accepted and change
nothing. Every datamodule of the JAX package is here: `hg38`, `hg38_fixed`,
`genomic_benchmark`, `nucleotide_transformer`, `chromatin_profile` (with
the hg19 -> hg38 liftover, `data/chromatin_profile.py`), `species` (both
tasks, `data/species.py`), `icl_genomics` (k-shot prompts, `data/icl.py`)
and `ett` (`data/timeseries.py`). `hg38` and `species` rebuild their
datasets in `init_datasets`, which the seqlen curriculum
(`train/callbacks.py::SeqlenWarmupReload`) calls at each stage; the JAX
`SpeciesDataModule` has no `init_datasets`, so there the curriculum changes
the batch size and not the length. `hg38` with `tokenizer_name: bpe` loads
a BPE tokenizer with `transformers` (imported only then) from a local
snapshot: `bpe_tokenizer_path`, else `$HYENA_BPE_TOKENIZER_PATH`, else the
reference's hub id, which needs a download.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

from hyena_dna_tpu_torch.data.chromatin_profile import ChromatinProfileDataset
from hyena_dna_tpu_torch.data.classification import (GenomicBenchmarkDataset,
                                                     NucleotideTransformerDataset)
from hyena_dna_tpu_torch.data.hg38 import HG38Dataset, HG38FixedDataset
from hyena_dna_tpu_torch.data.icl import ICLGenomicsDataset
from hyena_dna_tpu_torch.data.loader import DataLoader
from hyena_dna_tpu_torch.data.species import SpeciesDataset
from hyena_dna_tpu_torch.data.timeseries import (ETTHourDataset, ETTMinuteDataset,
                                                 InformerDataset)
from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer

DATASET_REGISTRY: Dict[str, type] = {}

default_data_path = Path(__file__).resolve().parents[2] / "data"


class SequenceDataModule:
    _name_: Optional[str] = None
    l_output: Optional[int] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls._name_:
            DATASET_REGISTRY[cls._name_] = cls

    # common loader knobs
    batch_size: int = 32
    batch_size_eval: Optional[int] = None
    shuffle: bool = True
    num_workers: int = 0  # a config key; the loader builds batches on one thread
    seed: int = 0
    # the rank's data-axis coordinate and size (the trainer sets them under a mesh)
    process_index: int = 0
    process_count: int = 1

    def setup(self):
        raise NotImplementedError

    def _loader(self, dataset, batch_size, shuffle, drop_last=True):
        if dataset is None:
            return None
        return DataLoader(
            dataset,
            batch_size=batch_size,
            shuffle=shuffle,
            seed=self.seed,
            drop_last=drop_last,
            process_index=self.process_index,
            process_count=self.process_count,
        )

    def train_dataloader(self):
        return self._loader(self.dataset_train, self.batch_size, self.shuffle)

    def val_dataloader(self):
        bs = self.batch_size_eval or self.batch_size
        return self._loader(self.dataset_val, bs, False, drop_last=False)

    def test_dataloader(self):
        bs = self.batch_size_eval or self.batch_size
        return self._loader(self.dataset_test, bs, False, drop_last=False)


class HG38DataModule(SequenceDataModule):
    """hg38 pretraining (`genomics.py:29-215`): bed intervals + fasta, char
    tokenizer, next-token pairs, optional fixed-length validation."""

    _name_ = "hg38"

    def __init__(
        self,
        bed_file: Optional[str] = None,
        fasta_file: Optional[str] = None,
        tokenizer_name: str = "char",
        max_length: int = 1024,
        max_length_val: Optional[int] = None,
        max_length_test: Optional[int] = None,
        d_output: int = 2,
        rc_aug: bool = False,
        add_eos: bool = True,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        use_fixed_len_val: bool = False,
        replace_N_token: bool = False,
        pad_interval: bool = False,
        bpe_tokenizer_path: Optional[str] = None,
        seed: int = 0,
        fault_tolerant: bool = False,  # vacuous: loaders always resumable
        ddp: bool = False,
        pin_memory: bool = False,
        drop_last: bool = False,
        **kwargs: Any,
    ):
        self.bed_file = bed_file or str(default_data_path / "hg38" / "human-sequences.bed")
        self.fasta_file = fasta_file or str(default_data_path / "hg38" / "hg38.ml.fa")
        self.tokenizer_name = tokenizer_name
        self.max_length = max_length
        self.max_length_val = max_length_val or max_length
        self.max_length_test = max_length_test or max_length
        self.d_output = d_output
        self.rc_aug = rc_aug
        self.add_eos = add_eos
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.use_fixed_len_val = use_fixed_len_val
        self.replace_N_token = replace_N_token
        self.pad_interval = pad_interval
        self.bpe_tokenizer_path = bpe_tokenizer_path
        self.seed = seed

    def setup(self):
        if self.tokenizer_name == "bpe":
            # the reference's gena-lm BPE (`genomics.py:102-105`), from a local snapshot
            try:
                from transformers import AutoTokenizer
            except ImportError as err:
                raise ImportError("tokenizer_name 'bpe' needs the transformers package") from err
            path = self.bpe_tokenizer_path or os.environ.get(
                "HYENA_BPE_TOKENIZER_PATH", "AIRI-Institute/gena-lm-bert-base")
            self.tokenizer = AutoTokenizer.from_pretrained(path)
            self.vocab_size = len(self.tokenizer)
        elif self.tokenizer_name == "char":
            self.tokenizer = CharacterTokenizer(model_max_length=self.max_length + 2)
            self.vocab_size = self.tokenizer.vocab_size
        else:
            raise NotImplementedError(f"tokenizer {self.tokenizer_name!r}: hg38 takes 'char' "
                                      "or 'bpe'")
        self.init_datasets()

    def init_datasets(self):
        """(Re)build datasets — re-entrant for the seqlen-warmup curriculum
        (`genomics.py:113-164`: closes fasta handles before rebuild)."""
        for attr in ("dataset_train", "dataset_val", "dataset_test"):
            ds = getattr(self, attr, None)
            if ds is not None and hasattr(ds, "close"):
                ds.close()

        def make(split, max_len):
            return HG38Dataset(
                split=split,
                bed_file=self.bed_file,
                fasta_file=self.fasta_file,
                max_length=max_len,
                tokenizer=self.tokenizer,
                tokenizer_name=self.tokenizer_name,
                add_eos=self.add_eos,
                rc_aug=self.rc_aug if split == "train" else False,
                replace_N_token=self.replace_N_token,
                pad_interval=self.pad_interval,
            )

        self.dataset_train = make("train", self.max_length)
        if self.use_fixed_len_val:
            # chr14 + chrX fixed windows (`genomics.py:144-162`)
            self.dataset_val = HG38FixedDataset(
                fasta_file=self.fasta_file,
                chr_ranges={
                    "chr14": (19726402, 106677047),
                    "chrX": (2825622, 144342320),
                },
                max_length=self.max_length_val,
                tokenizer=self.tokenizer,
                add_eos=self.add_eos,
            )
        else:
            self.dataset_val = make("valid", self.max_length_val)
        self.dataset_test = make("test", self.max_length_test)


class HG38FixedDataModule(SequenceDataModule):
    """Fixed-length NON-overlapping hg38 windows for a stable test
    perplexity (`genomics.py:660-700`, registered `hg38_fixed`). Test-only:
    pair with `train.test: true` (reference
    `configs/experiment/hg38/hg38_fixed_test.yaml`). Default chr_ranges are
    the Enformer chr14/chrX spans the reference hardcodes."""

    _name_ = "hg38_fixed"

    def __init__(
        self,
        fasta_file: Optional[str] = None,
        chr_ranges: Optional[Dict[str, Any]] = None,
        max_length: int = 1024,
        pad_max_length: Optional[int] = None,
        add_eos: bool = True,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        **kwargs: Any,
    ):
        self.fasta_file = fasta_file or str(default_data_path / "hg38" / "hg38.ml.fa")
        self.chr_ranges = chr_ranges or {
            "chr14": (19726402, 106677047),
            "chrX": (2825622, 144342320),
        }
        self.max_length = max_length
        self.pad_max_length = pad_max_length
        self.add_eos = add_eos
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed

    def setup(self):
        self.tokenizer = CharacterTokenizer(model_max_length=self.max_length + 2)
        self.vocab_size = self.tokenizer.vocab_size
        ds = HG38FixedDataset(
            fasta_file=self.fasta_file,
            chr_ranges={k: tuple(v) for k, v in self.chr_ranges.items()},
            max_length=self.max_length,
            pad_max_length=self.pad_max_length,
            tokenizer=self.tokenizer,
            add_eos=self.add_eos,
        )
        self.dataset_train = None
        self.dataset_val = ds
        self.dataset_test = ds


class GenomicBenchmarkDataModule(SequenceDataModule):
    """GenomicBenchmarks fine-tuning (`genomics.py:218-298`); val == test."""

    _name_ = "genomic_benchmark"
    l_output = 0  # sequence-level classification => squeeze length

    def __init__(
        self,
        dataset_name: str = "human_nontata_promoters",
        dest_path: Optional[str] = None,
        tokenizer_name: str = "char",
        d_output: int = 2,
        max_length: int = 1024,
        max_length_val: Optional[int] = None,
        use_padding: bool = True,
        padding_side: str = "left",
        add_eos: bool = False,
        rc_aug: bool = False,
        return_mask: bool = False,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        **kwargs: Any,
    ):
        self.dataset_name = dataset_name
        self.dest_path = dest_path or str(default_data_path / self._name_)
        self.tokenizer_name = tokenizer_name
        self.d_output = d_output
        self.max_length = max_length
        self.max_length_val = max_length_val or max_length
        self.use_padding = use_padding
        self.padding_side = padding_side
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.return_mask = return_mask
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed

    def setup(self):
        self.tokenizer = CharacterTokenizer(
            model_max_length=self.max_length + 2, padding_side=self.padding_side
        )
        self.vocab_size = self.tokenizer.vocab_size

        def make(split, max_len, rc):
            return GenomicBenchmarkDataset(
                split=split,
                max_length=max_len,
                dataset_name=self.dataset_name,
                d_output=self.d_output,
                dest_path=self.dest_path,
                tokenizer=self.tokenizer,
                tokenizer_name=self.tokenizer_name,
                use_padding=self.use_padding,
                add_eos=self.add_eos,
                rc_aug=rc,
                return_mask=self.return_mask,
            )

        self.dataset_train = make("train", self.max_length, self.rc_aug)
        self.dataset_val = make("val", self.max_length_val, False)
        self.dataset_test = self.dataset_val  # benchmark has no val split


class NucleotideTransformerDataModule(GenomicBenchmarkDataModule):
    """Nucleotide Transformer 17-task suite (`genomics.py:301-387`)."""

    _name_ = "nucleotide_transformer"

    def setup(self):
        self.tokenizer = CharacterTokenizer(
            model_max_length=self.max_length + 2, padding_side=self.padding_side
        )
        self.vocab_size = self.tokenizer.vocab_size

        def make(split, max_len, rc):
            return NucleotideTransformerDataset(
                split=split,
                max_length=max_len,
                dataset_name=self.dataset_name,
                d_output=self.d_output,
                dest_path=self.dest_path,
                tokenizer=self.tokenizer,
                tokenizer_name=self.tokenizer_name,
                use_padding=self.use_padding,
                add_eos=self.add_eos,
                rc_aug=rc,
                return_mask=self.return_mask,
            )

        self.dataset_train = make("train", self.max_length, self.rc_aug)
        self.dataset_val = make("val", self.max_length_val, False)
        self.dataset_test = self.dataset_val


class ChromatinProfileDataModule(SequenceDataModule):
    """DeepSEA's 919-way multilabel task (`genomics.py:390-461`)."""

    _name_ = "chromatin_profile"
    l_output = 0

    def __init__(
        self,
        ref_genome_path: Optional[str] = None,
        ref_genome_version: str = "hg38",
        data_path: Optional[str] = None,
        liftover_chain_path: Optional[str] = None,
        save_liftover: bool = True,
        d_output: int = 919,
        max_length: int = 1000,
        use_padding: bool = True,
        add_eos: bool = False,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        **kwargs: Any,
    ):
        self.ref_genome_path = ref_genome_path
        self.ref_genome_version = ref_genome_version
        self.data_path = data_path or str(default_data_path / self._name_)
        self.liftover_chain_path = liftover_chain_path
        self.save_liftover = save_liftover
        self.d_output = d_output
        self.max_length = max_length
        self.use_padding = use_padding
        self.add_eos = add_eos
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed

    def setup(self):
        self.tokenizer = CharacterTokenizer(model_max_length=self.max_length + 2)
        self.vocab_size = self.tokenizer.vocab_size

        def make(split):
            return ChromatinProfileDataset(
                max_length=self.max_length,
                ref_genome_path=self.ref_genome_path,
                ref_genome_version=self.ref_genome_version,
                coords_target_path=self._coords_csv(split),
                tokenizer=self.tokenizer,
                use_padding=self.use_padding,
                add_eos=self.add_eos,
                liftover_chain_path=self.liftover_chain_path,
                save_liftover=self.save_liftover,
            )

        self.dataset_train = make("train")
        self.dataset_val = make("val")
        self.dataset_test = make("test")

    def _coords_csv(self, split: str) -> str:
        """The CSV of the genome's version when it exists (a saved liftover
        writes it), else the hg19 original (lifted in memory through
        `liftover_chain_path`)."""
        want = f"{self.data_path}/{split}_{self.ref_genome_version}_coords_targets.csv"
        if os.path.exists(want):
            return want
        alt = f"{self.data_path}/{split}_hg19_coords_targets.csv"
        return alt if os.path.exists(alt) else want


class SpeciesDataModule(SequenceDataModule):
    """Species classification and multi-genome pretraining
    (`genomics.py:464-569`)."""

    _name_ = "species"
    l_output = 0

    def __init__(
        self,
        species: list = None,
        species_dir: str = None,
        max_length: int = 1024,
        total_size: int = 10000,
        pad_max_length: Optional[int] = None,
        add_eos: bool = False,
        rc_aug: bool = False,
        chromosome_weights: str = "uniform",
        species_weights: str = "uniform",
        task: str = "species_classification",
        remove_tail_ends: bool = False,
        cutoff_train: float = 0.1,
        cutoff_test: float = 0.2,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        total_size_val: Optional[int] = None,
        **kwargs: Any,
    ):
        self.species = species or []
        self.species_dir = species_dir or str(default_data_path / self._name_)
        self.max_length = max_length
        self.total_size = total_size
        self.total_size_val = total_size_val or max(1, total_size // 10)
        self.pad_max_length = pad_max_length
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.chromosome_weights = chromosome_weights
        self.species_weights = species_weights
        self.task = task
        self.remove_tail_ends = remove_tail_ends
        self.cutoff_train = cutoff_train
        self.cutoff_test = cutoff_test
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.d_output = len(self.species)

    def setup(self):
        self.tokenizer = CharacterTokenizer(model_max_length=self.max_length + 2)
        self.vocab_size = self.tokenizer.vocab_size
        self.init_datasets()

    def init_datasets(self):
        """(Re)build the datasets at `max_length`, closing the old ones'
        FASTA handles: the seqlen curriculum calls it at each stage."""
        for attr in ("dataset_train", "dataset_val", "dataset_test"):
            ds = getattr(self, attr, None)
            if ds is not None:
                ds.close()

        def make(split, n):
            return SpeciesDataset(
                species=self.species,
                species_dir=self.species_dir,
                split=split,
                max_length=self.max_length,
                total_size=n,
                pad_max_length=self.pad_max_length,
                tokenizer=self.tokenizer,
                add_eos=self.add_eos,
                rc_aug=self.rc_aug if split == "train" else False,
                chromosome_weights=self.chromosome_weights,
                species_weights=self.species_weights,
                task=self.task,
                remove_tail_ends=self.remove_tail_ends,
                cutoff_train=self.cutoff_train,
                cutoff_test=self.cutoff_test,
            )

        self.dataset_train = make("train", self.total_size)
        self.dataset_val = make("valid", self.total_size_val)
        self.dataset_test = make("test", self.total_size_val)


class ICLGenomicsDataModule(SequenceDataModule):
    """k-shot in-context-learning prompts (`genomics.py:572-657`); the val
    and test sets are the benchmark's test split."""

    _name_ = "icl_genomics"
    l_output = 0

    def __init__(
        self,
        dataset_name: str = "human_nontata_promoters",
        dest_path: Optional[str] = None,
        shots: int = 0,
        max_length: int = 1024,
        d_output: int = 2,
        use_padding: bool = True,
        add_eos: bool = True,
        eos_token: Optional[str] = None,
        label_to_token: Optional[dict] = None,
        rc_aug: bool = False,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        **kwargs: Any,
    ):
        self.dataset_name = dataset_name
        self.dest_path = dest_path or str(default_data_path / "genomic_benchmark")
        self.shots = shots
        self.max_length = max_length
        self.d_output = d_output
        self.use_padding = use_padding
        self.add_eos = add_eos
        self.eos_token = eos_token
        self.label_to_token = label_to_token
        self.rc_aug = rc_aug
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed

    def setup(self):
        self.tokenizer = CharacterTokenizer(model_max_length=self.max_length)
        self.vocab_size = self.tokenizer.vocab_size

        def make(split, rc):
            return ICLGenomicsDataset(
                split=split,
                shots=self.shots,
                max_length=self.max_length,
                dataset_name=self.dataset_name,
                d_output=self.d_output,
                dest_path=self.dest_path,
                tokenizer=self.tokenizer,
                use_padding=self.use_padding,
                add_eos=self.add_eos,
                eos_token=self.eos_token,
                label_to_token=self.label_to_token,
                rc_aug=rc,
            )

        self.dataset_train = make("train", self.rc_aug)
        self.dataset_val = make("val", False)
        self.dataset_test = self.dataset_val


class ETTDataModule(SequenceDataModule):
    """Informer ETT time series (`et.py:468-626`): `variant` hour, minute
    or generic borders; `d_input`, `d_output` and `l_output` (the
    forecast horizon) come from the train split."""

    _name_ = "ett"

    def __init__(
        self,
        data_path: str = None,
        variant: str = "hour",
        size=None,
        features: str = "S",
        target: str = "OT",
        scale: bool = True,
        eval_stamp: bool = False,
        eval_mask: bool = False,
        batch_size: int = 32,
        batch_size_eval: Optional[int] = None,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        **kwargs: Any,
    ):
        self.data_path = data_path
        self.variant = variant
        self.size = tuple(size) if size else None
        self.features = features
        self.target = target
        self.scale = scale
        self.eval_stamp = eval_stamp
        self.eval_mask = eval_mask
        self.batch_size = batch_size
        self.batch_size_eval = batch_size_eval
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed

    def setup(self):
        cls = {"hour": ETTHourDataset, "minute": ETTMinuteDataset,
               "generic": InformerDataset}[self.variant]

        def make(flag):
            return cls(self.data_path, flag=flag, size=self.size, features=self.features,
                       target=self.target, scale=self.scale, eval_stamp=self.eval_stamp,
                       eval_mask=self.eval_mask)

        self.dataset_train = make("train")
        self.dataset_val = make("val")
        self.dataset_test = make("test")
        self.d_input = self.dataset_train.d_input
        self.d_output = self.dataset_train.d_output
        self.l_output = self.dataset_train.pred_len
