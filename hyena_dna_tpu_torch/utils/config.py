"""Config system (a copy of `hyena_dna_tpu/utils/config.py`): YAML
composition, `${...}` interpolation, CLI dot-overrides and `_name_`-keyed
registry instantiation, composing the shared `configs/` tree exactly as the
JAX package does.

  * an experiment file composes onto a base through its `defaults:` list
    (deep-merged in order, later wins; "_self_" places the file's own keys);
  * `${path.to.key}` interpolation (a leading '.' is relative to the
    enclosing mapping), `${eval:expr}` over arithmetic only (no names but
    min, max, round, int, float, len, math, abs; no dunder, import, open,
    exec or eval) and `${div_up:a,b}`;
  * overrides `a.b.c=value`, the value read as YAML;
  * objects built by `_name_` lookup in an explicit registry, never by an
    import path.

YAML is read by PyYAML's safe loader with one more implicit resolver, so a
bare 1e-3 is a float (YAML 1.1 reads it as a string).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import yaml


class _Loader(yaml.SafeLoader):
    """SafeLoader that also parses bare scientific notation (1e-3) as float —
    a YAML 1.1 spec gap that bites every lr config."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(stream):
    return yaml.load(stream, Loader=_Loader)


# --------------------------------------------------------------------------
# merging / loading
# --------------------------------------------------------------------------


def deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge; overlay wins; None overlay values replace."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    path: str | Path,
    config_dir: Optional[str | Path] = None,
    _seen: Optional[set] = None,
) -> dict:
    """Load a yaml config, recursively composing its `defaults:` list.

    Entries in `defaults` are either relative paths ("pipeline/hg38") or
    mappings ({"pipeline": "hg38"}); "_self_" positions this file's own keys.
    """
    path = Path(path)
    config_dir = Path(config_dir) if config_dir else path.parent
    _seen = _seen or set()
    key = str(path.resolve())
    if key in _seen:
        raise ValueError(f"circular defaults involving {path}")
    _seen.add(key)

    with open(path) as f:
        raw = yaml_load(f) or {}

    defaults = raw.pop("defaults", [])
    merged: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = deep_merge(merged, raw)
            self_merged = True
            continue
        if isinstance(entry, Mapping):
            ((group, name),) = entry.items()
            sub = config_dir / str(group) / f"{name}.yaml"
        else:
            sub = config_dir / f"{entry}.yaml"
        merged = deep_merge(merged, load_config(sub, config_dir, _seen))
    if not self_merged:
        merged = deep_merge(merged, raw)
    return merged


# --------------------------------------------------------------------------
# interpolation
# --------------------------------------------------------------------------

_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root: dict, dotted: str, local: dict):
    """Resolve 'a.b.c'; a leading '.' resolves relative to the local dict."""
    if dotted.startswith("."):
        node: Any = local
        dotted = dotted[1:]
    else:
        node = root
    for part in dotted.split("."):
        node = node[part]
    return node


def _safe_eval(expr: str) -> Any:
    """Arithmetic-only eval (the reference's `eval` resolver executes
    arbitrary python, `train.py:37` — deliberately NOT reproduced)."""
    allowed = {"min": min, "max": max, "round": round, "int": int,
               "float": float, "len": len, "math": math, "abs": abs}
    if re.search(r"__|import|open|exec|eval", expr):
        raise ValueError(f"unsafe expression: {expr!r}")
    return eval(expr, {"__builtins__": {}}, allowed)  # noqa: S307


def resolve_interpolations(cfg: dict, max_passes: int = 10) -> dict:
    """Repeatedly substitute ${...} references until fixpoint."""

    def subst_str(s: str, root: dict, local: dict):
        m = _INTERP.fullmatch(s.strip())
        if m:  # whole-string interpolation keeps the value's type
            return resolve_token(m.group(1), root, local)
        # embedded interpolation -> string splice
        def repl(match):
            return str(resolve_token(match.group(1), root, local))

        return _INTERP.sub(repl, s)

    def resolve_token(token: str, root: dict, local: dict):
        if token.startswith("eval:"):
            return _safe_eval(token[5:])
        if token.startswith("div_up:"):
            a, b = token[7:].split(",")
            return (int(float(a)) + int(float(b)) - 1) // int(float(b))
        return _lookup(root, token, local)

    def walk(node, root, local):
        if isinstance(node, dict):
            return {k: walk(v, root, node) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, root, local) for v in node]
        if isinstance(node, str) and "${" in node:
            try:
                return subst_str(node, root, local)
            except (KeyError, TypeError):
                return node  # unresolved this pass; try again next pass
        return node

    for _ in range(max_passes):
        new = walk(cfg, cfg, cfg)
        if new == cfg:
            break
        cfg = new
    return cfg


# --------------------------------------------------------------------------
# CLI overrides
# --------------------------------------------------------------------------


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """Apply 'a.b.c=value' overrides (values YAML-parsed)."""
    cfg = dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        parsed = yaml_load(val) if val != "" else None
        if isinstance(parsed, str):
            # YAML 1.1 misses bare scientific notation like 1e-3
            try:
                parsed = float(parsed) if re.fullmatch(
                    r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+", parsed
                ) else parsed
            except ValueError:
                pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            else:
                nxt = dict(nxt)
                node[p] = nxt
            node = nxt
        node[parts[-1]] = parsed
    return cfg


# --------------------------------------------------------------------------
# registry instantiation (reference src/utils/config.py:63-104)
# --------------------------------------------------------------------------


def instantiate(registry: Dict[str, Callable], config, *args, partial: bool = False, **kwargs):
    """Build an object from {_name_: key, **kwargs} via the registry.

    config may also be a bare string key. Extra *args/**kwargs are forwarded;
    explicit kwargs win over config keys (reference passes wrap kwargs)."""
    if config is None:
        return None
    if isinstance(config, str):
        name, cfg_kwargs = config, {}
    else:
        cfg = dict(config)
        name = cfg.pop("_name_")
        cfg_kwargs = cfg
    fn = registry[name]
    merged = {**cfg_kwargs, **kwargs}
    if partial:
        from functools import partial as _partial

        return _partial(fn, *args, **merged)
    return fn(*args, **merged)
