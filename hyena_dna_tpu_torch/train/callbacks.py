"""Trainer callbacks (mirrors `hyena_dna_tpu/train/callbacks.py`).

  * `timer`: wall-clock seconds of each step (`timer/step`, host clock
    between step ends; the trainer reads the loss each step, which waits for
    the card) and of each epoch (`timer/epoch`);
  * `params`: total, trainable and fixed parameter counts (a frozen
    backbone's parameters are fixed);
  * `learning_rate_monitor`: the main group's lr at the global step;
  * `model_checkpoint`: after each validation, the best checkpoint on the
    monitored metric (`checkpoints/best`) and the last (`checkpoints/last`),
    recording the next epoch so a resume starts there; under a mesh rank 0
    writes them (every rank holds the same global metric, and the tensors
    are gathered whole first) and every rank waits at a barrier after each;
  * `seqlen_warmup_reload`: a curriculum of {seq_len, epochs, batch_size}
    stages, rebuilding the datasets and loaders at each stage's start;
  * `track_norms`: the global gradient norm every `log_every` steps;
  * `progressive_resizing`: stages over the datamodule's `resolution`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from hyena_dna_tpu_torch.parallel import launch
from hyena_dna_tpu_torch.parallel.sharding import SHARDED, tp_layout
from hyena_dna_tpu_torch.train.checkpoint import save_checkpoint
from hyena_dna_tpu_torch.train.optim import label_params


class Callback:
    def on_fit_start(self, trainer):
        pass

    def on_epoch_start(self, trainer):
        pass

    def on_step_end(self, trainer, metrics: Dict[str, Any]):
        pass

    def on_validation_end(self, trainer, metrics: Dict[str, Any]):
        pass

    def on_epoch_end(self, trainer):
        pass


class Timer(Callback):
    def __init__(self, step: bool = True, epoch: bool = True, val: bool = True,
                 inter_step: bool = False):
        self.log_step, self.log_epoch = step, epoch
        self._epoch_t0 = self._step_t0 = None

    def on_epoch_start(self, trainer):
        self._epoch_t0 = self._step_t0 = time.perf_counter()

    def on_step_end(self, trainer, metrics):
        if self.log_step:
            now = time.perf_counter()
            metrics["timer/step"] = now - self._step_t0
            self._step_t0 = now

    def on_epoch_end(self, trainer):
        if self.log_epoch and self._epoch_t0 is not None:
            trainer.log({"timer/epoch": time.perf_counter() - self._epoch_t0})


class ParamsLog(Callback):
    def __init__(self, total: bool = True, trainable: bool = True, fixed: bool = True):
        pass

    def on_fit_start(self, trainer):
        """The whole model's counts: a tensor-parallel rank's sharded
        parameters count M times."""
        model = trainer.state.model
        labels = label_params(model)
        frozen = trainer.frozen_labels or {}
        layout = tp_layout(model)
        sizes = {name: p.numel() * (trainer.mesh.model if name in layout
                                    and layout[name][0] == SHARDED else 1)
                 for name, p in model.named_parameters()}
        total = sum(sizes.values())
        trainable = sum(n for name, n in sizes.items()
                        if labels.get(name) != "frozen" and frozen.get(name) != "frozen")
        trainer.log({"params/total": total, "params/trainable": trainable,
                     "params/fixed": total - trainable})


class LearningRateMonitor(Callback):
    def __init__(self, logging_interval: str = "step"):
        self.interval = logging_interval

    def on_step_end(self, trainer, metrics):
        if trainer.lr_fn is not None:
            metrics["lr"] = float(trainer.lr_fn(int(trainer.global_step)))


class ModelCheckpoint(Callback):
    def __init__(self, monitor: str = "val/loss", mode: str = "min", save_last: bool = True,
                 save_top_k: int = 1, dirpath: Optional[str] = None, **_: Any):
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.best: Optional[float] = None
        self.dirpath = dirpath

    @staticmethod
    def _save(*args, **kwargs):
        save_checkpoint(*args, **kwargs)  # every rank: rank 0 writes
        launch.barrier()

    def on_validation_end(self, trainer, metrics):
        base = self.dirpath or (trainer.run_dir + "/checkpoints")
        value = metrics.get(self.monitor)
        step = int(trainer.global_step)
        # validation runs before trainer.epoch increments: a resume continues
        # with the next epoch
        next_epoch = trainer.epoch + 1
        if value is not None:
            better = self.best is None or (
                value < self.best if self.mode == "min" else value > self.best)
            if better:
                self.best = float(value)
                self._save(base + "/best", trainer.state, step,
                           loader_state=trainer.loader_state(),
                           metadata={"monitor": self.monitor, "value": float(value),
                                     "epoch": next_epoch}, keep=1)
        if self.save_last:
            self._save(base + "/last", trainer.state, step,
                       loader_state=trainer.loader_state(),
                       metadata={"epoch": next_epoch}, keep=1)


def _stage_boundaries(stage_params) -> List[int]:
    if not stage_params:
        raise ValueError("need at least one stage")
    bounds, total = [], 0
    for s in stage_params:
        bounds.append(total)
        total += int(s["epochs"])
    return bounds


def _stage(bounds: List[int], epoch: int) -> int:
    return max(i for i, b in enumerate(bounds) if epoch >= b)


class SeqlenWarmupReload(Callback):
    """stage_params: [{"seq_len": L, "epochs": E, "batch_size": B}, ...]."""

    def __init__(self, stage_params: List[Dict[str, int]]):
        self.stage_params = stage_params
        self._boundaries = _stage_boundaries(stage_params)

    def on_epoch_start(self, trainer):
        stage = _stage(self._boundaries, trainer.epoch)
        params = self.stage_params[stage]
        dm = trainer.datamodule
        if getattr(dm, "max_length", None) == params["seq_len"] and (
                "batch_size" not in params or dm.batch_size == params["batch_size"]):
            return
        trainer.log({"curriculum/stage": stage, "curriculum/seq_len": params["seq_len"],
                     "curriculum/batch_size": params.get("batch_size", dm.batch_size)})
        dm.max_length = dm.max_length_val = dm.max_length_test = params["seq_len"]
        if "batch_size" in params:
            dm.batch_size = params["batch_size"]
        if hasattr(dm, "init_datasets"):
            dm.init_datasets()
        trainer.reset_dataloaders()


class TrackNorms(Callback):
    def __init__(self, log_every: int = 100):
        self.log_every = log_every

    def on_step_end(self, trainer, metrics):
        if int(trainer.global_step) % self.log_every == 0 and "grad_norm" in metrics:
            metrics["norms/grad_total"] = float(metrics["grad_norm"])


class ProgressiveResizing(Callback):
    """stage_params: [{"resolution": r, "epochs": E}, ...]."""

    def __init__(self, stage_params: List[Dict[str, int]]):
        self.stage_params = stage_params
        self._boundaries = _stage_boundaries(stage_params)

    def on_epoch_start(self, trainer):
        params = self.stage_params[_stage(self._boundaries, trainer.epoch)]
        dm = trainer.datamodule
        res = params.get("resolution")
        if res is not None and getattr(dm, "resolution", None) != res:
            dm.resolution = res
            if hasattr(dm, "init_datasets"):
                dm.init_datasets()
            trainer.reset_dataloaders()
            trainer.log({"curriculum/resolution": res})


CALLBACK_REGISTRY = {
    "timer": Timer,
    "params": ParamsLog,
    "learning_rate_monitor": LearningRateMonitor,
    "model_checkpoint": ModelCheckpoint,
    "seqlen_warmup_reload": SeqlenWarmupReload,
    "track_norms": TrackNorms,
    "progressive_resizing": ProgressiveResizing,
}
