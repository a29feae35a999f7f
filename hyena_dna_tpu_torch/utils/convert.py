"""Weights across frameworks and checkpoint files.

`flax_to_torch_state_dict` is the exact inverse of the JAX package's
`utils/torch_import.py::convert_state_dict`: it maps a flax parameter tree
(nested dicts of numpy arrays, as `convert_state_dict` returns it) onto the
reference torch names the port's modules carry:

  * Dense kernels (in, out) are transposed to Linear weights (out, in);
  * `short_filter_weight` (C, K) becomes `short_filter.weight` (C, 1, K);
  * LayerNorm `scale` becomes `weight`;
  * the shared Sin `freq` is repeated at `implicit_filter.1/.3/.5/...`;
  * `mlp_in` maps to `implicit_filter.0`, `mlp_inner_j` to
    `implicit_filter.{2j+2}`, `mlp_out` to the last index;
  * `pos_emb.t`, which flax does not store, is derived from `pos_emb.z`.

The mapping holds for any pytree shaped like the parameters, not only the
weights: with `buffers=False` it maps gradients or updated parameters the
same way, without the derived buffer, so a test can hold the JAX step's
grads and new params against the port's by name.

`load_reference_state_dict` reads a `.pt`/`.ckpt` file the way the JAX
package's importer does: a plain state dict or `{"state_dict": ...}`, with
Lightning's `model.` prefix, metric buffers, remat infixes and the tied
`lm_head.weight` removed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _torch_key(path) -> str:
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path)


def flax_to_torch_state_dict(params, buffers: bool = True) -> Dict[str, torch.Tensor]:
    """A params-shaped flax pytree (weights, gradients, updates) ->
    reference-named torch state dict, with the derived `pos_emb.t` buffer
    unless `buffers` is False."""
    flat = dict(_flatten(params))
    n_inner = {}
    for path in flat:
        m = re.match(r"mlp_inner_(\d+)$", path[-2]) if len(path) > 1 else None
        if m and path[-3] == "filter_fn":
            n_inner[path[:-2]] = max(n_inner.get(path[:-2], 0), int(m.group(1)) + 1)
    sd = {}
    for path, val in flat.items():
        *base, leaf = path
        base = tuple(base)
        parent = base[-1] if base else ""
        if leaf == "embedding":
            sd[_torch_key(base + ("weight",))] = val
        elif parent in ("norm1", "norm2", "ln_f"):
            sd[_torch_key(base + ({"scale": "weight"}.get(leaf, leaf),))] = val
        elif leaf == "short_filter_weight":
            sd[_torch_key(base + ("short_filter", "weight"))] = val[:, None, :]
        elif leaf == "short_filter_bias":
            sd[_torch_key(base + ("short_filter", "bias"))] = val
        elif parent == "filter_fn" and leaf == "pos_emb_z":
            sd[_torch_key(base + ("pos_emb", "z"))] = val
            if buffers:
                t = np.linspace(0.0, 1.0, val.shape[1], dtype=np.float32)[None, :, None]
                sd[_torch_key(base + ("pos_emb", "t"))] = t
        elif parent == "filter_fn" and leaf == "deltas":
            sd[_torch_key(base + ("modulation", "deltas"))] = val
        elif parent == "filter_fn" and leaf == "freq":
            for j in range(n_inner.get(base, 0) + 1):
                sd[_torch_key(base + ("implicit_filter", str(2 * j + 1), "freq"))] = val
        elif len(base) > 1 and base[-2] == "filter_fn":
            fbase = base[:-1]
            if parent == "mlp_in":
                idx = 0
            elif parent == "mlp_out":
                idx = 2 * (n_inner.get(fbase, 0) + 1)
            else:
                idx = 2 * int(parent[len("mlp_inner_"):]) + 2
            name = "weight" if leaf == "kernel" else leaf
            sd[_torch_key(fbase + ("implicit_filter", str(idx), name))] = (
                val.T if leaf == "kernel" else val)
        elif leaf == "kernel":
            sd[_torch_key(base + ("weight",))] = val.T
        else:
            sd[_torch_key(path)] = val
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _normalize_key(key: str):
    if key.startswith("model."):
        key = key[len("model."):]
    if key.startswith(("train_torchmetrics", "val_torchmetrics", "test_torchmetrics")):
        return None
    key = key.replace(".mixer.layer.", ".mixer.").replace(".mlp.layer.", ".mlp.")
    return None if key == "lm_head.weight" else key


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-named state dict from a `.pt`/`.ckpt` file."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {}
    for key, val in sd.items():
        key = _normalize_key(key)
        if key is not None and isinstance(val, torch.Tensor):
            out[key] = val
    return out
