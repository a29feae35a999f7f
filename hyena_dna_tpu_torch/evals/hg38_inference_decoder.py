"""Inference with a fine-tuned backbone + classification decoder (mirrors
`hyena_dna_tpu/evals/hg38_inference_decoder.py`).

`HG38Inference` runs a `DNAEmbeddingModel` backbone and a
`SequenceDecoder` head (pool mode) over raw sequences or over a
GenomicBenchmarks / Nucleotide Transformer test loader (`data/
classification.py`). `load_checkpoint` reads a Lightning fine-tune
`.ckpt` / `.pt` (Lightning's `model.` prefix removed, the head under
`decoder.0.`) or a checkpoint directory of the port's trainer (the
`BackboneWithDecoder` names `backbone.backbone.*`, `decoder.*`); an Orbax
directory of the JAX package raises (`train/checkpoint.py`). Runs on the
card unless `--device cpu`; raises when there is no card.

Usage:
  python -m hyena_dna_tpu_torch.evals.hg38_inference_decoder \
      --ckpt outputs/.../accuracy.ckpt --d_output 2 \
      --dataset_name human_nontata_promoters --dest_path data/gb --max_length 500
  # or ad-hoc sequences:
  python -m hyena_dna_tpu_torch.evals.hg38_inference_decoder \
      --ckpt ... --d_output 2 --seqs ACGTACGT... TTGACA...
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer
from hyena_dna_tpu_torch.evals.hg38_inference import resolve_device
from hyena_dna_tpu_torch.models.heads import SequenceDecoder
from hyena_dna_tpu_torch.models.lm import DNAEmbeddingModel
from hyena_dna_tpu_torch.train.checkpoint import restore_params_only
from hyena_dna_tpu_torch.utils.convert import load_reference_state_dict
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics

GENOMIC_BENCHMARK_DATASETS = (
    "dummy_mouse_enhancers_ensembl", "demo_coding_vs_intergenomic_seqs",
    "demo_human_or_worm", "human_enhancers_cohn", "human_enhancers_ensembl",
    "human_ensembl_regulatory", "human_nontata_promoters", "human_ocr_ensembl",
)


def build_model(d_model: int, n_layer: int, max_length: int, d_output: int,
                vocab_size: int = 12, mode: str = "pool",
                generator: Optional[torch.Generator] = None
                ) -> Tuple[DNAEmbeddingModel, SequenceDecoder]:
    """The reference fine-tune stack: backbone + pool decoder."""
    layer = dict(_name_="hyena", emb_dim=5, filter_order=64, short_filter_order=3,
                 l_max=max_length + 2, modulate=True, w=10)
    backbone = DNAEmbeddingModel(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model,
                                 vocab_size=vocab_size, pad_vocab_size_multiple=8,
                                 residual_in_fp32=True, layer=layer, generator=generator)
    decoder = SequenceDecoder(d_model, d_output=d_output, l_output=0, mode=mode)
    decoder.init_weights(generator)
    return backbone, decoder


def split_state_dict(sd: Dict[str, torch.Tensor]):
    """(backbone, decoder) state dicts of a fine-tune checkpoint: Lightning's
    `decoder.0.` or the trainer's `decoder.` head, the backbone under
    `backbone.` (the trainer's `backbone.backbone.` collapsed to one)."""
    backbone, decoder = {}, {}
    for key, val in sd.items():
        if key.startswith("decoder."):
            key = key[len("decoder."):]
            decoder[key[len("0."):] if key.startswith("0.") else key] = val
        else:
            while key.startswith("backbone.backbone."):
                key = key[len("backbone."):]
            backbone[key] = val
    return backbone, decoder


def load_checkpoint(ckpt: str, backbone: DNAEmbeddingModel, decoder: SequenceDecoder):
    """Load a Lightning fine-tune `.ckpt`/`.pt` or a trainer checkpoint
    directory into (backbone, decoder), in place."""
    sd = (load_reference_state_dict(ckpt) if Path(ckpt).suffix in (".ckpt", ".pt")
          else restore_params_only(ckpt))
    bsd, dsd = split_state_dict(sd)
    backbone.load_state_dict(bsd)
    decoder.load_state_dict(dsd)
    return backbone, decoder


class HG38Inference:
    """Backbone + decoder inference on the backbone's device."""

    def __init__(self, backbone: DNAEmbeddingModel, decoder: SequenceDecoder,
                 tokenizer: Optional[CharacterTokenizer] = None, max_length: int = 500):
        self.backbone = backbone.eval()
        self.decoder = decoder.eval()
        self.device = next(backbone.parameters()).device
        self.max_length = max_length
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length + 2)

    @torch.inference_mode()
    def _predict(self, ids) -> np.ndarray:
        x = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.decoder(self.backbone(x)).float().cpu().numpy()

    def predict_on_list(self, seqs: Sequence[str]) -> np.ndarray:
        """Raw sequences -> (N, d_output) logits, each padded to max_length."""
        preds = []
        for seq in seqs:
            out = self.tokenizer(seq, add_special_tokens=False, padding="max_length",
                                 max_length=self.max_length, truncation=True)
            preds.append(self._predict(out["input_ids"][None]))
        return np.concatenate(preds, axis=0)

    def predict_from_loader(self, loader) -> Tuple[np.ndarray, np.ndarray]:
        """A test loader of (x, y, ...) batches -> (argmax preds, labels)."""
        all_preds: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        for batch in loader:
            all_preds.append(np.argmax(self._predict(batch[0]), axis=-1))
            all_labels.append(np.asarray(batch[1]).reshape(-1))
        return np.concatenate(all_preds), np.concatenate(all_labels)


def build_loader(args):
    from hyena_dna_tpu_torch.data.classification import (GenomicBenchmarkDataset,
                                                         NucleotideTransformerDataset)
    from hyena_dna_tpu_torch.data.loader import DataLoader

    common = dict(split="test", max_length=args.max_length, dataset_name=args.dataset_name,
                  d_output=args.d_output, dest_path=args.dest_path, use_padding=True)
    ds = (GenomicBenchmarkDataset(**common) if args.dataset_name in GENOMIC_BENCHMARK_DATASETS
          else NucleotideTransformerDataset(**common))
    return DataLoader(ds, batch_size=args.batch_size, shuffle=False, drop_last=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=2)
    ap.add_argument("--d_output", type=int, required=True)
    ap.add_argument("--max_length", type=int, default=500)
    ap.add_argument("--mode", default="pool")
    ap.add_argument("--dataset_name", default=None)
    ap.add_argument("--dest_path", default=None)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--seqs", nargs="*", default=None,
                    help="ad-hoc raw sequences instead of a dataset")
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_card_numerics()

    backbone, decoder = build_model(args.d_model, args.n_layer, args.max_length,
                                    args.d_output, mode=args.mode)
    load_checkpoint(args.ckpt, backbone, decoder)
    infer = HG38Inference(backbone.to(device), decoder.to(device), max_length=args.max_length)
    if args.seqs:
        logits = infer.predict_on_list(args.seqs)
        result = {"preds": np.argmax(logits, axis=-1).tolist(), "logits": logits.tolist()}
    else:
        if not (args.dataset_name and args.dest_path):
            raise ValueError("--dataset_name and --dest_path are required without --seqs")
        preds, labels = infer.predict_from_loader(build_loader(args))
        result = {"accuracy": float((preds == labels).mean()), "n": int(labels.size)}
    print(json.dumps(result))
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
