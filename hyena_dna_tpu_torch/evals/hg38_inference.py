"""hg38 inference eval on PyTorch: load a checkpoint, report next-token
loss and perplexity on fixed genome windows (mirrors
`hyena_dna_tpu/evals/hg38_inference.py`).

Runs on the CUDA card by default, through the port's kernels; `--device cpu`
runs the same model through their plain versions. Prints one JSON line,
{"loss", "ppl", "tokens", "eval_seconds"}; `eval_seconds` is the wall time
of the forward passes and metric updates, ending in a device sync.

Usage:
  python -m hyena_dna_tpu_torch.evals.hg38_inference \
      --ckpt weights.pt --fasta data/hg38/hg38.ml.fa --max_length 1024 \
      --chr_ranges chr14:19726402-106677047

`--ckpt` takes a `.pt`/`.ckpt` state dict under the reference torch names
(`utils/convert.py::load_reference_state_dict`), a LongSafari-layout
directory (its `weights.ckpt`) or a checkpoint directory of the port's
trainer (`train/checkpoint.py::load_pretrained`); an Orbax directory of the
JAX package raises. `--preset` (a `configs/evals` file or its name, e.g.
`hyena_dna_512ksl`) builds the model from the preset's `model:` block
(`evals/presets.py`) in place of `--d_model` / `--n_layer`.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from itertools import islice

import numpy as np
import torch

from hyena_dna_tpu_torch.data.hg38 import HG38FixedDataset
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.tasks import metrics as M
from hyena_dna_tpu_torch.train.checkpoint import load_pretrained
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics


def build_model(d_model, n_layer, max_length, vocab_size=12,
                generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
                residual_in_fp32: bool = True, gated_conv: str | None = None,
                front4: bool = False, **remat) -> ConvLMHeadModel:
    """The hg38 LM (order-2 Hyena, emb_dim 5, filter_order 64, w 10). The
    eval runs it in float32 with a float32 residual; `bench.py` also builds
    it with bfloat16 activations and a bfloat16 residual, with the
    gate-fused conv (`gated_conv`, a mode of `ops.fftconv.GATED_MODES`;
    None keeps the composite gate), with the 4-D conv-layout route
    (`front4`) and with activation checkpointing (`remat`: the
    `ConvLMHeadModel` knobs `checkpoint_mixer`, `checkpoint_mlp`,
    `remat_residual_only`, `remat_group_size`, `remat_save_conv`,
    `remat_save_filter`)."""
    layer = dict(_name_="hyena", emb_dim=5, filter_order=64, short_filter_order=3,
                 l_max=max_length + 2, modulate=True, w=10)
    if gated_conv is not None:
        layer["gated_conv"] = gated_conv
    if front4:
        layer["front4"] = True
    return ConvLMHeadModel(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model,
                           vocab_size=vocab_size, pad_vocab_size_multiple=8,
                           residual_in_fp32=residual_in_fp32, layer=layer, generator=generator,
                           dtype=dtype, **remat)


def load_params(ckpt: str, model: ConvLMHeadModel) -> ConvLMHeadModel:
    """Load a reference-named `.pt`/`.ckpt` file, a LongSafari directory or
    a checkpoint directory of the port's trainer into `model`."""
    model.load_state_dict(load_pretrained(ckpt))
    return model


def batches(ds, batch_size: int):
    """In-order batches of (x, y), the last one possibly short."""
    for i in range(0, len(ds), batch_size):
        items = [ds[j] for j in range(i, min(i + batch_size, len(ds)))]
        yield np.stack([x for x, _ in items]), np.stack([y for _, y in items])


@torch.inference_mode()
def run_eval(model, loader, device) -> M.Perplexity:
    ppl = M.Perplexity()
    for x, y in loader:
        logits = model(torch.as_tensor(x, dtype=torch.long, device=device))
        nll, cnt = M.cross_entropy_stats(logits, torch.as_tensor(y, device=device))
        ppl.update(nll, cnt)
    return ppl


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions on the CPU")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--preset", default=None,
                    help="configs/evals yaml with a model: block (e.g. hyena_dna_512ksl); "
                         "builds the model from it")
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--chr_ranges", nargs="+", default=["chr14:19726402-106677047"],
                    help="chrN:start-end windows for the fixed eval set")
    ap.add_argument("--limit_batches", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_card_numerics()

    chr_ranges = {}
    for spec in args.chr_ranges:
        name, rng = spec.split(":")
        start, end = rng.split("-")
        chr_ranges[name] = (int(start), int(end))
    ds = HG38FixedDataset(fasta_file=args.fasta, chr_ranges=chr_ranges,
                          max_length=args.max_length, add_eos=True)
    if args.preset:
        from hyena_dna_tpu_torch.evals.presets import build_model_from_preset, load_eval_preset

        model = build_model_from_preset(load_eval_preset(args.preset)["model"])
    else:
        model = build_model(args.d_model, args.n_layer, args.max_length)
    load_params(args.ckpt, model)
    model.to(device).eval()

    loader = batches(ds, args.batch_size)
    if args.limit_batches:
        loader = islice(loader, args.limit_batches)
    t0 = time.perf_counter()
    ppl = run_eval(model, loader, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    ds.close()
    result = {"loss": float(math.log(ppl.compute())), "ppl": ppl.compute(),
              "tokens": ppl.count, "eval_seconds": seconds}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
