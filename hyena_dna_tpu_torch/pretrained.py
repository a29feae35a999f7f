"""Published checkpoints: the `HyenaDNAModel` standalone module and
`from_pretrained` (mirrors `hyena_dna_tpu/pretrained.py`).

`from_pretrained` reads a LongSafari-layout directory (`config.json` +
`weights.ckpt`, e.g. a local clone of `LongSafari/hyenadna-tiny-1k-seqlen`)
or a bare `.ckpt` / `.pt` with an explicit config, builds the model and
loads the weights with `load_state_dict` through
`utils/convert.py::load_reference_state_dict` (Lightning's `model.` prefix,
metric buffers, remat infixes and the tied `lm_head.weight` removed; a
missing `pos_emb.t` derived from `pos_emb.z`). Every checkpoint key must
land on the model. As in the JAX loader, the reference's CUDA switches are
dropped from the config and the filter's modulation `shift` defaults to
0.05, the default of the reference's `standalone_hyenadna.py`, which loads
the published checkpoints. Downloading is out of scope: pass a local path.

The model runs on the card unless `device="cpu"`, and `from_pretrained`
raises when no card is present. With `use_head` the pooled classification
head starts from scratch (N(0, 0.02) from `generator`): the published
checkpoints carry none.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch import nn

from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer
from hyena_dna_tpu_torch.evals.hg38_inference import resolve_device
from hyena_dna_tpu_torch.models.heads import SequenceDecoder
from hyena_dna_tpu_torch.models.lm import DNAEmbeddingModel
from hyena_dna_tpu_torch.utils.convert import load_reference_state_dict

_DROPPED_KEYS = ("fused_mlp", "fused_dropout_add_ln", "device", "dtype", "initializer_cfg",
                 "gradient_checkpointing")
_DROPPED_LAYER_KEYS = ("fused_fft_conv", "fused_bias_fc")


class HyenaDNAModel(nn.Module):
    """The standalone model: the embedding backbone (`model`), returning
    hidden states (B, L, d_model), or with `use_head` pooled class logits
    (B, n_classes) from a `SequenceDecoder` in "pool" mode (`head`)."""

    def __init__(self, use_head: bool = False, n_classes: int = 2,
                 generator: Optional[torch.Generator] = None, **config):
        super().__init__()
        self.model = DNAEmbeddingModel(generator=generator, **config)
        self.head = None
        if use_head:
            self.head = SequenceDecoder(config["d_model"], d_output=n_classes, l_output=0,
                                        mode="pool")
            self.head.init_weights(generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        hidden = self.model(input_ids)
        return hidden if self.head is None else self.head(hidden)


def _pretrained_config(config: dict) -> dict:
    """The model config of a published `config.json`, as the JAX loader
    reads it: CUDA switches dropped, `layer.shift` 0.05 unless given."""
    cfg = {k: v for k, v in config.items() if k not in _DROPPED_KEYS}
    layer = {k: v for k, v in (cfg.get("layer") or {}).items() if k not in _DROPPED_LAYER_KEYS}
    layer.setdefault("shift", 0.05)
    cfg["layer"] = layer
    return cfg


def from_pretrained(path, use_head: bool = False, n_classes: int = 2,
                    config: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                    device: str = "cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[HyenaDNAModel, CharacterTokenizer]:
    """Load a LongSafari-layout directory or a bare checkpoint + `config`.
    Returns (model in eval mode on `device`, tokenizer)."""
    dev = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        if config is None:
            config = json.loads((path / "config.json").read_text())
        ckpt_file = path / "weights.ckpt"
    else:
        if config is None:
            raise ValueError("a bare checkpoint needs an explicit config")
        ckpt_file = path
    cfg = _pretrained_config(config)
    model = HyenaDNAModel(use_head=use_head, n_classes=n_classes, generator=generator,
                          dtype=dtype, **cfg)
    model.model.load_state_dict(load_reference_state_dict(str(ckpt_file)))
    seq_len = int(cfg["layer"].get("l_max", 1024))
    return model.to(dev).eval(), CharacterTokenizer(model_max_length=seq_len + 2)
