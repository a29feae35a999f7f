"""Trainer: config-driven orchestration of data, model, task and steps
(mirrors `hyena_dna_tpu/train/trainer.py`).

  * builds the datamodule, the task and the model from their `_name_`
    registries, wiring `vocab_size`, `d_output` and `l_output` from the
    datamodule; classification runs `DNAEmbeddingModel` and a decoder head
    (`models/heads.py`) as one module, `BackboneWithDecoder`;
  * the epoch loop: train steps (`train/step.py`), per-epoch validation,
    the test split at the end, callbacks (`train/callbacks.py`), exact
    epoch perplexity from sufficient statistics, host metrics (mcc, f1,
    ROC-AUC) streamed from the gathered logits;
  * fine-tuning: `train.pretrained_model_path` through the `load_backbone`
    hook, `freeze_backbone` mapping the backbone to the optimizer's frozen
    group; resume from `train.ckpt` (model, optimizer, step, loader state);
    an EMA of the parameters (`train.ema`) evaluated beside them;
  * the metrics stream to stdout and `<run_dir>/metrics.jsonl`.

`trainer.precision` sets the model dtype: "bf16" (or "16", "bfloat16")
-> torch.bfloat16, "32" -> float32, as the JAX trainer maps it.

Device. `Trainer(config, device=None)` runs on the card and raises when
there is none; only an explicit `device="cpu"` runs on the CPU, where every
kernel wrapper takes its plain version (the tests call it so). The card's
numeric policy is set first (`utils/numerics.py::set_card_numerics`).
Weights are drawn on the CPU from `train.seed` and moved to the device;
dropout masks come from a generator on the device seeded the same way.

Mesh (`parallel/`). One process per rank, launched by torchrun
(`python -m torch.distributed.run --nproc_per_node N -m
hyena_dna_tpu_torch.train experiment=...`); `mesh.data` x `mesh.seq` x
`mesh.model` must be the number of ranks (`mesh.data` -1 takes the rest; a
single process is the 1 x 1 x 1 mesh). Each rank's device is `cuda:{LOCAL_RANK % cards}` and the
backend NCCL when each rank has a card of its own, else gloo
(`parallel/launch.py`). The data axis: each data rank reads its strided
share of every epoch's order (`data/loader.py`), `batch_size *
accumulate_grad_batches` must divide by `mesh.data` (the JAX check) and so
must `batch_size` (each rank's microbatch). The seq axis: each rank takes
its contiguous L / S columns of every 2-D array of the batch as wide as
the sequence (`Mesh.local_batch`; per-sequence labels stay whole), and the
sequence length (L - 1 for the LM tasks) must divide by `mesh.seq`. The
`lm`, `dna_embedding` and `lm_simple` models get the mesh (JAX
`trainer.py:222`): the Hyena mixers take the sequence-sharded route,
attention gathers its keys and values, learned positions start at the
rank's first column, and the decoder heads pool over the global sequence
(`models/heads.py`), so every seq rank holds the same per-sequence output.
Another model (`model`, `adaptive_lm`; the JAX package shards its batch too
and lets GSPMD run it) runs whole on every seq rank: its input columns are
gathered over the seq group, and a per-token output is cut back to the
rank's columns (`run_whole_on_seq`). The position metrics gather the
per-position NLL over the seq group (`tasks/metrics.py`), and the host
metrics' per-token predictions are gathered over the seq group before the
data group. The step's gradient and logged loss are those of the global
batch (`train/step.py`); evaluation sums, counts and the host metrics'
predictions are reduced over the ranks, so every rank reports the global
value. Weights are drawn on every rank from `train.seed`; dropout is
seeded per rank from (seed, data index, seq index), with no model index,
so the ranks of a model group draw the same masks (a run whose only axis
is the model axis draws the single process's); a model that runs whole on
every seq rank is seeded with seq index 0, so its seq ranks draw the same
masks. Rank 0 alone writes
`metrics.jsonl` and the checkpoints and prints, with a barrier after each
checkpoint and at `close`; every rank loads.

The model axis (tensor parallelism, `parallel/sharding.py`): the `lm`,
`dna_embedding` and `lm_simple` models get the mesh and split where its
size M divides a module's width (the Hyena mixers' d_model, MHA's heads,
the MLPs' d_inner, the padded vocabulary); a width that does not divide,
another model and a decoder head run whole on each rank. The weights are
drawn whole from `train.seed` and each rank takes its slices
(`build_sharded`), so the run starts from the weights of the run without
a model axis; a pretrained state dict is sliced the same way. Every rank
of a model group reads the same batch; the gradients, the clip norm and
LAMB's norms are reduced as `train/step.py` and `train/optim.py` say, and
the checkpoints hold whole tensors (`train/checkpoint.py`).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from hyena_dna_tpu_torch.data.datamodules import DATASET_REGISTRY
from hyena_dna_tpu_torch.models.blocks import torch_dtype
from hyena_dna_tpu_torch.models.heads import (NDDecoder, PackedDecoder, RetrievalDecoder,
                                              SequenceDecoder, StateDecoder, TokenDecoder)
from hyena_dna_tpu_torch.parallel import launch
from hyena_dna_tpu_torch.ops.distributed import seq_gather
from hyena_dna_tpu_torch.parallel.sharding import (build_sharded, make_mesh, shard_state_dict,
                                                   tp_layout)
from hyena_dna_tpu_torch.tasks import TASK_REGISTRY
from hyena_dna_tpu_torch.tasks.tasks import LMTask
from hyena_dna_tpu_torch.tasks import metrics as M
from hyena_dna_tpu_torch.train.callbacks import CALLBACK_REGISTRY
from hyena_dna_tpu_torch.train.checkpoint import (load_backbone_hook, load_pretrained,
                                                  restore_checkpoint)
from hyena_dna_tpu_torch.train.optim import SCHEDULE_REGISTRY, build_optimizer
from hyena_dna_tpu_torch.train.state import create_train_state
from hyena_dna_tpu_torch.train.step import make_eval_step, make_train_step
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics
from hyena_dna_tpu_torch.utils.registry import MODEL_REGISTRY


class BackboneWithDecoder(nn.Module):
    """DNAEmbeddingModel + head: (B, L) ids -> the decoder's output."""

    def __init__(self, backbone: nn.Module, decoder: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decoder = decoder

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.backbone(x, generator)
        return self.decoder(hidden) if mask is None else self.decoder(hidden, mask=mask)


DECODER_REGISTRY = {
    "sequence": SequenceDecoder,
    "token": TokenDecoder,
    "nd": NDDecoder,
    "retrieval": RetrievalDecoder,
    "state": StateDecoder,
    "pack": PackedDecoder,
    "id": None,
}

PRECISION = {"16": torch.bfloat16, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}
SEQ_MODELS = ("lm", "dna_embedding", "lm_simple")  # the models that take the mesh (JAX :222)
SEQ_DECODERS = ("sequence", "nd", "retrieval")  # the heads that reduce over L


def run_whole_on_seq(model: nn.Module, mesh) -> nn.Module:
    """`model`, run whole on every seq rank of `mesh`: forward hooks gather
    its input's columns (and a keyword tensor as wide, a mask) over the seq
    group, and cut an output (or a tuple's first) of ndim >= 3 as long as
    the whole sequence back to the rank's columns. A per-sequence output
    stays whole."""
    def gather(module, args, kwargs):
        x, *rest = args
        width = x.shape[1]
        kwargs = {k: seq_gather(v, mesh) if torch.is_tensor(v) and v.dim() == 2
                  and v.shape[1] == width else v for k, v in kwargs.items()}
        return (seq_gather(x, mesh), *rest), kwargs

    def cut(module, args, kwargs, out):
        first = out[0] if isinstance(out, tuple) else out
        length = args[0].shape[1]
        if first.dim() < 3 or first.shape[1] != length:
            return out
        first = first[:, mesh.seq_columns(length)]
        return (first, *out[1:]) if isinstance(out, tuple) else first

    model.register_forward_pre_hook(gather, with_kwargs=True)
    model.register_forward_hook(cut, with_kwargs=True)
    return model


def resolve_device(device=None) -> torch.device:
    """The card unless `device` names another; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on the card; pass "
                               "device='cpu' to run the kernels' plain versions")
        return torch.device("cuda")
    return torch.device(device)


def rank_seed(seed: int, data_index: int, seq_index: int) -> int:
    """The dropout seed of the rank at (data_index, seq_index)."""
    return int(np.random.SeedSequence((seed, data_index, seq_index)).generate_state(1)[0])


def _to_device(batch, device: torch.device):
    """A numpy batch (tuple of arrays, a trailing dict of arrays) as tensors
    on `device`; integer arrays become int64."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        return t.to(device, non_blocking=True)

    return tuple({k: put(v) for k, v in b.items()} if isinstance(b, dict) else put(b)
                 for b in batch)


class Trainer:
    def __init__(self, config: Dict[str, Any], device=None):
        set_card_numerics()
        self.config = config
        self.train_cfg = dict(config.get("train", {}))
        self.trainer_cfg = dict(config.get("trainer", {}))
        self.seed = int(self.train_cfg.get("seed", 0))
        mesh_cfg = {k: int(v) for k, v in dict(config.get("mesh", {})).items()}
        self.device = launch.initialize_distributed(resolve_device(device))
        self.mesh = make_mesh(**mesh_cfg)
        self.accumulate_grad_batches = int(self.trainer_cfg.get("accumulate_grad_batches", 1)
                                           or 1)
        # a model that runs whole on every seq rank draws one set of masks
        self.seq_whole = (self.mesh.seq > 1
                          and config["model"].get("_name_", "lm") not in SEQ_MODELS)
        seed = self.seed if self.mesh.replicas == 1 else rank_seed(
            self.seed, self.mesh.data_index, 0 if self.seq_whole else self.mesh.seq_index)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.run_dir = str(self.train_cfg.get("run_dir", "runs/default"))
        self._metrics_file = None
        if launch.is_main_process():
            Path(self.run_dir).mkdir(parents=True, exist_ok=True)
            self._metrics_file = open(Path(self.run_dir) / "metrics.jsonl", "a")

        ds_cfg = dict(config["dataset"])
        ds_name = ds_cfg.pop("_name_")
        ds_cfg.setdefault("seed", self.seed)
        self.datamodule = DATASET_REGISTRY[ds_name](**ds_cfg)
        self.datamodule.process_index = self.mesh.data_index
        self.datamodule.process_count = self.mesh.data
        self.datamodule.setup()

        task_cfg = dict(config.get("task", {"_name_": "lm"}))
        self.task_name = task_cfg.pop("_name_", "lm")
        task_cfg.pop("torchmetrics", None)
        if self.task_name == "hg38":
            task_cfg.setdefault("seq_len", self.datamodule.max_length)
        self.task = TASK_REGISTRY[self.task_name](**task_cfg)
        self.task.mesh = self.mesh if self.mesh.seq > 1 else None
        self._check_shapes()

        init = torch.Generator().manual_seed(self.seed)
        self.model = self._build_model(dict(config["model"]), config.get("decoder"),
                                       init).to(self.device)

        opt_cfg = dict(config.get("optimizer", {}))
        opt_name = opt_cfg.pop("_name_", "adamw")
        sched_cfg = dict(config.get("scheduler", {"_name_": "constant"}))
        layer_cfg = config["model"].get("layer", {}) or {}
        self.lr = float(opt_cfg.get("lr", 6e-4))
        self.tx_kwargs = dict(
            lr=self.lr, weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
            betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
            filter_lr=layer_cfg.get("lr", 1e-3), filter_wd=float(layer_cfg.get("wd", 0.0)),
            lr_pos_emb=float(layer_cfg.get("lr_pos_emb", 1e-5)), scheduler=sched_cfg,
            gradient_clip_val=self.trainer_cfg.get("gradient_clip_val", 1.0),
            optimizer_name=opt_name, mesh=self.mesh)
        s_cfg = dict(sched_cfg)
        s_name = s_cfg.pop("_name_", "constant")
        s_cfg.pop("t_in_epochs", None)
        self.lr_fn = SCHEDULE_REGISTRY[s_name](self.lr, **s_cfg)

        self.epoch = 0
        self.global_step = 0
        self._train_loader = None
        self.frozen_labels = None
        self.state = create_train_state(self.model, build_optimizer(self.model,
                                                                    **self.tx_kwargs)[0])
        self._maybe_load_pretrained()

        self.ema_decay = float(self.train_cfg.get("ema", 0) or 0)
        self.ema_params = None
        if self.ema_decay:
            self.ema_params = {n: p.detach().clone() for n, p in self.model.named_parameters()}

        self.train_step = make_train_step(self.task, self.accumulate_grad_batches, self.mesh)
        self.eval_step = make_eval_step(self.task,
                                        return_logits=bool(self.task.host_metric_names))
        self.callbacks = [CALLBACK_REGISTRY[name](**(cb_cfg or {}))
                          for name, cb_cfg in (config.get("callbacks") or {}).items()
                          if name in CALLBACK_REGISTRY]

    def _check_shapes(self) -> None:
        """What the mesh splits, at the start and at each loader rebuild (a
        curriculum stage): every microbatch's rows over the data axis (JAX
        `trainer.py:120-127`), the sequence over the seq axis."""
        batch_size, n_data, accum = (self.datamodule.batch_size, self.mesh.data,
                                     self.accumulate_grad_batches)
        if (batch_size * accum) % n_data:
            raise ValueError(
                f"batch_size*accumulate_grad_batches={batch_size * accum} must be divisible "
                f"by the mesh data axis ({n_data}); set mesh.data or batch_size accordingly")
        if batch_size % n_data:
            raise ValueError(f"batch_size={batch_size} must be divisible by the mesh data "
                             f"axis ({n_data}): each data rank runs its share of every "
                             "microbatch")
        s = self.mesh.seq
        if s == 1:
            return
        # an LM task's inputs drop the window's last token
        length = self.datamodule.max_length - isinstance(self.task, LMTask)
        if length % s:
            raise ValueError(f"the sequence length {length} must be divisible by mesh.seq={s} "
                             "(dataset.max_length - 1 for the LM tasks)")

    def _build_model(self, model_cfg: dict, decoder_cfg, generator) -> nn.Module:
        name = model_cfg.pop("_name_", "lm")
        dm = self.datamodule
        mesh = None
        if (self.mesh.seq > 1 or self.mesh.model > 1) and name in SEQ_MODELS:
            mesh = self.mesh  # the sharded routes (JAX trainer.py:222-225)
        model_cfg.setdefault("vocab_size", getattr(dm, "vocab_size", 12))
        precision = str(self.trainer_cfg.get("precision", "32"))
        model_cfg.setdefault("dtype", PRECISION.get(precision, torch.float32))
        model_cfg["dtype"] = torch_dtype(model_cfg["dtype"])
        if isinstance(model_cfg.get("layer"), dict):
            model_cfg["layer"] = dict(model_cfg["layer"])
        def build(mesh, gen):
            return MODEL_REGISTRY[name](generator=gen, **model_cfg,
                                        **({"mesh": mesh} if mesh is not None else {}))

        backbone = build_sharded(build, mesh, generator)
        if name == "lm" or decoder_cfg is None:
            return run_whole_on_seq(backbone, self.mesh) if self.seq_whole else backbone
        dec_cfg = (dict(decoder_cfg) if isinstance(decoder_cfg, dict)
                   else {"_name_": decoder_cfg})
        dec_name = dec_cfg.pop("_name_", "sequence")
        dec_cls = DECODER_REGISTRY[dec_name]
        if dec_cls is None:
            return run_whole_on_seq(backbone, self.mesh) if self.seq_whole else backbone
        # the decoder's size from the model and the dataset
        if dec_name == "retrieval":
            dec_cfg.setdefault("d_input", model_cfg["d_model"])
            dec_cfg.setdefault("n_classes", getattr(dm, "d_output", None))
        elif dec_name != "pack":
            dec_cfg.setdefault("d_model", model_cfg["d_model"])
            dec_cfg.setdefault("d_output", getattr(dm, "d_output", None))
        if dec_name == "sequence":
            dec_cfg.setdefault("l_output", getattr(dm, "l_output", None))
        if mesh is not None and mesh.seq > 1 and dec_name in SEQ_DECODERS:
            dec_cfg["mesh"] = mesh  # pooled over the global sequence
        decoder = dec_cls(**dec_cfg)
        decoder.init_weights(generator)
        model = BackboneWithDecoder(backbone, decoder)
        return run_whole_on_seq(model, self.mesh) if self.seq_whole else model

    def _maybe_load_pretrained(self):
        path = self.train_cfg.get("pretrained_model_path")
        if not path:
            return
        pretrained = load_pretrained(path)
        hook_cfg = self.train_cfg.get("pretrained_model_state_hook") or {}
        hook = hook_cfg.get("_name_") or "load_backbone"
        if hook != "load_backbone":
            raise NotImplementedError(f"model state hook {hook!r}")
        layout = tp_layout(self.model)
        _, info = load_backbone_hook(self.model, pretrained,
                                     freeze_backbone=bool(hook_cfg.get("freeze_backbone",
                                                                       False)),
                                     shard=lambda name, t: shard_state_dict(
                                         {name: t}, self.mesh, layout)[name])
        self.frozen_labels = info["frozen"]
        if self.frozen_labels:
            # the optimizer was built before the hook: rebuild it with the
            # backbone in the frozen group
            self.state = create_train_state(
                self.model, build_optimizer(self.model, frozen=self.frozen_labels,
                                            **self.tx_kwargs)[0])
        self.log({"pretrained/loaded_tensors": info["loaded"]})

    def log(self, metrics: Dict[str, Any]):
        """Rank 0 writes the record to metrics.jsonl and prints it."""
        if self._metrics_file is None:
            return
        record = {"step": int(self.global_step), "epoch": self.epoch, **metrics}
        self._metrics_file.write(json.dumps(record, default=float) + "\n")
        self._metrics_file.flush()
        pretty = " ".join(f"{k}={v:.4g}" if isinstance(v, (int, float)) else f"{k}={v}"
                          for k, v in metrics.items())
        print(f"[step {self.global_step}] {pretty}", flush=True)

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
        launch.barrier()

    def loader_state(self):
        return self._train_loader.state_dict() if self._train_loader else {}

    def reset_dataloaders(self):
        self._train_loader = None

    def _ema_update(self):
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                self.ema_params[name].mul_(self.ema_decay).add_(p, alpha=1.0 - self.ema_decay)

    def fit(self):
        max_epochs = int(self.trainer_cfg.get("max_epochs", 1))
        log_every = int(self.trainer_cfg.get("log_every_n_steps", 50))
        limit_train_batches = self.trainer_cfg.get("limit_train_batches")
        val_loader = self.datamodule.val_dataloader()

        ckpt = self.train_cfg.get("ckpt")
        pending_loader_state = None
        if ckpt:
            _, loader_state, meta = restore_checkpoint(ckpt, self.state)
            self.epoch = int(meta.get("epoch", 0))
            self.global_step = int(self.state.step)
            pending_loader_state = loader_state or None
            self.log({"resumed_from": ckpt})

        for cb in self.callbacks:
            cb.on_fit_start(self)

        # `train.test` (or `test_only`): skip training, run the test split
        test_only = bool(self.train_cfg.get("test") or self.train_cfg.get("test_only"))
        ppl = M.Perplexity()
        while not test_only and self.epoch < max_epochs:
            for cb in self.callbacks:
                cb.on_epoch_start(self)
            if self._train_loader is None:
                # a loader batch holds accum microbatches of this data rank's
                # rows; the step cuts them
                self._check_shapes()
                self._train_loader = self.datamodule.train_dataloader()
                self._train_loader.batch_size = (self.datamodule.batch_size
                                                 * self.accumulate_grad_batches
                                                 // self.mesh.data)
                val_loader = self.datamodule.val_dataloader()
                if pending_loader_state:
                    self._train_loader.load_state_dict(pending_loader_state)
                    pending_loader_state = None
            # the trainer's epoch decides the data order: an epoch cut by
            # limit_train_batches leaves the loader's own count behind
            tl = self._train_loader
            if tl.epoch != self.epoch:
                tl.epoch = self.epoch
                tl.batches_served = 0
                tl._resume_pending = False
            ppl.reset()
            epoch_t0 = time.perf_counter()
            tokens = 0
            for i, batch in enumerate(tl):
                if limit_train_batches and i >= limit_train_batches:
                    break
                metrics = self.train_step(self.state,
                                          _to_device(self.mesh.local_batch(batch), self.device),
                                          self.generator)
                if self.ema_params is not None:
                    self._ema_update()
                self.global_step += 1
                if "token_count" in metrics:
                    ppl.update(metrics["nll_sum"], metrics["token_count"])
                    tokens += int(metrics["token_count"])
                if self.global_step % log_every == 0:
                    out = {"train/loss": float(metrics["loss"]),
                           "train/grad_norm": float(metrics["grad_norm"])}
                    for cb in self.callbacks:
                        cb.on_step_end(self, out)
                    if tokens:
                        out["train/tokens_per_sec"] = tokens / (time.perf_counter() - epoch_t0)
                    self.log(out)
                else:
                    for cb in self.callbacks:
                        cb.on_step_end(self, metrics)
            epoch_metrics = {}
            if ppl.count:
                epoch_metrics["train/ppl"] = ppl.compute()
            if val_loader is not None and len(val_loader) > 0:
                epoch_metrics.update(self.evaluate(val_loader, "val"))
                if self.ema_params is not None:
                    epoch_metrics.update(self.evaluate(val_loader, "val_ema",
                                                       params=self.ema_params))
            if epoch_metrics:
                self.log(epoch_metrics)
            for cb in self.callbacks:
                cb.on_validation_end(self, epoch_metrics)
                cb.on_epoch_end(self)
            self.epoch += 1

        test_loader = self.datamodule.test_dataloader()
        final = {}
        if test_loader is not None and len(test_loader) > 0:
            final = self.evaluate(test_loader, "test")
            self.log(final)
        return final

    def evaluate(self, loader, split: str = "val",
                 params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
        """The split's mean metrics (weighted by batch size), exact
        perplexity and host metrics; with `params` (e.g. the EMA) those
        parameters stand in for the model's during the evaluation."""
        saved = None
        if params is not None:
            saved = {n: p.detach().clone() for n, p in self.model.named_parameters()}
            self._load_params(params)
        try:
            return self._evaluate(loader, split)
        finally:
            if saved is not None:
                self._load_params(saved)

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])

    @staticmethod
    def _gather(obj, group, size: int) -> list:
        """`obj` of every rank of `group` (of `size` ranks), in rank order."""
        if size == 1:
            return [obj]
        parts = [None] * size
        dist.all_gather_object(parts, obj, group=group)
        return parts

    def _evaluate(self, loader, split: str) -> Dict[str, float]:
        sums: Dict[str, Any] = {}
        weights: Dict[str, float] = {}
        nll_sum = token_count = 0.0
        n_batches = 0
        streamer = (M.StreamingHostMetrics(self.task.host_metric_names)
                    if self.task.host_metric_names else None)
        limit = self.trainer_cfg.get("limit_val_batches")
        for batch in loader:
            if limit and n_batches >= int(limit):
                break
            bsz = len(batch[0])
            batch = _to_device(self.mesh.local_batch(batch), self.device)
            out = self.eval_step(self.state, batch)
            metrics, logits = out if isinstance(out, tuple) else (out, None)
            for k, v in metrics.items():
                if k in ("nll_sum", "token_count"):
                    continue
                v = v.detach().float().cpu().numpy()
                val = float(v) if v.ndim == 0 else v
                sums[k] = sums.get(k, 0.0) + val * bsz
                weights[k] = weights.get(k, 0.0) + bsz
            if "nll_sum" in metrics:
                nll_sum += float(metrics["nll_sum"])
                token_count += float(metrics["token_count"])
            if streamer is not None and logits is not None:
                preds, labels = logits.detach().float().cpu().numpy(), batch[1].cpu().numpy()
                if self.mesh.seq > 1 and labels.ndim == 2 and labels.shape[1] == batch[0].shape[1]:
                    # per-token predictions: the whole sequence from the seq ranks
                    parts = self._gather((preds, labels), self.mesh.seq_group, self.mesh.seq)
                    preds, labels = (np.concatenate(a, axis=1) for a in zip(*parts))
                for preds, labels in self._gather((preds, labels), self.mesh.data_group,
                                                  self.mesh.data):
                    streamer.update(preds, labels)
            n_batches += 1
        if self.mesh.replicas > 1:  # every rank reports the global value
            parts = self._gather((sums, weights, nll_sum, token_count, n_batches),
                                 self.mesh.grad_group, self.mesh.replicas)
            sums, weights, nll_sum, token_count, n_batches = {}, {}, 0.0, 0.0, 0
            for rank_sums, rank_weights, nll, count, n in parts:
                for k, v in rank_sums.items():
                    sums[k] = sums.get(k, 0.0) + v
                    weights[k] = weights.get(k, 0.0) + rank_weights[k]
                nll_sum, token_count, n_batches = nll_sum + nll, token_count + count, n_batches + n
        result = {}
        for k in sums:
            v = sums[k] / weights[k]
            if isinstance(v, np.ndarray):
                for i, vi in enumerate(v):
                    result[f"{split}/{k}_{i}"] = float(vi)
            else:
                result[f"{split}/{k}"] = float(v)
        if token_count:
            result[f"{split}/ppl"] = math.exp(nll_sum / token_count)
        if streamer is not None and n_batches:
            for name, v in streamer.compute().items():
                result[f"{split}/{name}"] = v
            cm = streamer.confusion_matrix
            if cm is not None and cm.shape[0] <= 32:
                result[f"{split}/confusion_matrix"] = cm.tolist()
        return result
