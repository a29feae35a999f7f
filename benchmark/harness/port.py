"""What the benchmark takes from the program: the system under test (the
model through the registry, the train step, the optimizer, the eval's
`run_eval`), its numeric policy and its kernels' launch counters. Nothing
else of the harness imports the program."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "32": torch.float32,
          "float32": torch.float32}


def set_numerics() -> None:
    from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()


def kernels() -> Dict[str, object]:
    """The port's kernels on the Hyena LM's path, by group name."""
    from hyena_dna_tpu_torch.ops import fused_fftconv as FB
    from hyena_dna_tpu_torch.ops import fused_front as FF

    return {"kernel_a": FF.KERNEL, "kernel_a_bwd": FF.KERNEL_BWD,
            "kernel_b": FB.KERNEL, "kernel_c": FB.KERNEL_BWD}


def build_kernels() -> None:
    """Compile the missing libraries of `kernels()` (nvcc, all at once, into
    the package's `_build/` inside the checkout); a built one is reused."""
    from hyena_dna_tpu_torch import _cuda

    _cuda.build_all(list(kernels().values()))


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in kernels().items()}


def state_dict(params: dict, bufs: dict) -> dict:
    """The benchmark's weights under the program's state-dict keys: the
    filter's shared Sin frequency appears at each of its indices."""
    out = {**params, **bufs}
    for name in list(params):
        if name.endswith("implicit_filter.1.freq"):
            base = name[:-len("1.freq")]
            out[base + "3.freq"] = params[name]
            out[base + "5.freq"] = params[name]
    return out


def train_model(recipe: dict, params: dict, bufs: dict, device):
    """The LM built from the recipe's model block through the model
    registry, as the trainer builds it, loaded with the benchmark's weights."""
    from hyena_dna_tpu_torch.utils.registry import MODEL_REGISTRY

    cfg = dict(recipe["model"])
    name = cfg.pop("_name_", "lm")
    cfg["layer"] = dict(cfg["layer"])
    cfg["dtype"] = DTYPES[str(recipe["trainer"]["precision"])]
    model = MODEL_REGISTRY[name](generator=torch.Generator().manual_seed(0), **cfg)
    model.to(device)
    model.load_state_dict(state_dict(params, bufs), strict=True)
    return model


def train_state(recipe: dict, model):
    """(state, train_step) with the recipe's optimizer, scheduler, clip, task
    and accumulation, as `train/trainer.py` makes them."""
    from hyena_dna_tpu_torch.tasks.tasks import TASK_REGISTRY
    from hyena_dna_tpu_torch.train.optim import build_optimizer
    from hyena_dna_tpu_torch.train.state import create_train_state
    from hyena_dna_tpu_torch.train.step import make_train_step

    opt_cfg, lay = dict(recipe["optimizer"]), recipe["model"]["layer"]
    optimizer, _ = build_optimizer(
        model, lr=float(opt_cfg["lr"]), weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))), filter_lr=lay.get("lr", 1e-3),
        filter_wd=float(lay.get("wd", 0.0)), lr_pos_emb=float(lay.get("lr_pos_emb", 1e-5)),
        scheduler=dict(recipe["scheduler"]),
        gradient_clip_val=recipe["trainer"].get("gradient_clip_val", 1.0),
        optimizer_name=opt_cfg.get("_name_", "adamw"))
    task_cfg = dict(recipe["task"])
    task = TASK_REGISTRY[task_cfg.pop("_name_")](**task_cfg)
    step = make_train_step(task, int(recipe["trainer"]["accumulate_grad_batches"]))
    return create_train_state(model, optimizer), step


def first_moments(state) -> Dict[str, torch.Tensor]:
    """{name: Adam's first moment} of every parameter the optimizer steps."""
    inner = state.optimizer.inner
    return {name: inner.state[p]["exp_avg"].detach().clone()
            for name, p in state.model.named_parameters() if p in inner.state}


def betas(state):
    return state.optimizer.inner.param_groups[0]["betas"]


def eval_model(recipe: dict, params: dict, bufs: dict, device):
    """The eval preset's model (`evals/presets.py`), in eval mode, loaded
    with the benchmark's weights; raises if the preset's model block is no
    longer the configuration's."""
    from hyena_dna_tpu_torch.evals.presets import build_model_from_preset, load_eval_preset

    preset = load_eval_preset(recipe["preset"])["model"]
    if preset != recipe["model"]:
        raise RuntimeError(f"the {recipe['preset']} preset's model block is not the "
                           "configuration's: the benchmark's configuration file is stale")
    model = build_model_from_preset(preset, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict(params, bufs), strict=True)
    return model.to(device).eval()


def run_eval(model, loader, device):
    from hyena_dna_tpu_torch.evals.hg38_inference import run_eval as entry

    return entry(model, loader, device)
