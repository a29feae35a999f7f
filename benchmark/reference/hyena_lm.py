"""Plain PyTorch reference of the HyenaDNA language model, its loss, its
gradients and its AdamW step.

Written from the published HyenaDNA architecture (order-2 Hyena operator,
implicit Sin-MLP filter with exponential modulation, pre-norm blocks with
a float32 residual stream, tied LM head) and imports nothing of the
program. Every parameter lives in a dict keyed by the reference torch
names, which are also the names of the program's state dict, so the
benchmark hands one dict of weights to both sides.

Precision. Everything runs in float32 except what the configuration
states: from `conv_io_bf16_from` tokens on, the long conv's I/O (signal,
gate, filter bank and its modulation, conv output and gated output) is
rounded to bfloat16, the conv itself summed in float32. `rnd` is that
rounding; `q` rounds the operands of every matrix product (identity in
the reference; the controls put TF32 or fp8 there: `control.py`).

Dropout. The embedding dropout mask is handed in (`masks`), drawn by the
benchmark's own generator in the order and shape the configuration draws
it: one (rows, L, d) Bernoulli(1 - p) tensor per micro-batch, of the
activation dtype (`benchmark/harness/feed.py::dropout_masks`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def padded_vocab(cfg: dict) -> int:
    v, m = cfg["vocab_size"], cfg.get("pad_vocab_size_multiple", 1)
    return v + (-v) % m


# --------------------------------------------------------------------------
# parameters: names, shapes and the GPT-2 style init of HyenaDNA

def positional_features(emb_dim: int, seq_len: int, device="cpu") -> torch.Tensor:
    """z (1, seq_len, emb_dim) = [t, Re exp(-i f w), Im exp(-i f w)] of the
    Hyena filter, with t in [0, 1], w = 2 pi n / seq_len and emb_dim // 2
    frequencies f from 1e-4 to bands - 1 (computed in float64)."""
    bands = (emb_dim - 1) // 2
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.linspace(0.0, 1.0, seq_len, **f64)[None, :, None]
    w = 2.0 * math.pi * torch.arange(seq_len, **f64)[None, :, None] / seq_len
    f = torch.linspace(1e-4, bands - 1, bands, **f64)[None, None]
    z = torch.cat([t, torch.cos(f * w), -torch.sin(f * w)], dim=-1)
    return z.float()


def modulation_rates(d: int, fast: float = 0.3, slow: float = 1.5,
                     target: float = 1e-2, device="cpu") -> torch.Tensor:
    """deltas (1, 1, d): decay rates log(target)/slow .. log(target)/fast."""
    return torch.linspace(math.log(target) / slow, math.log(target) / fast, d,
                          device=device)[None, None]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """[(name, shape, init)] in order; init is ("normal", std), ("uniform",
    bound), ("zeros",), ("ones",) or ("fixed", maker of the tensor on a
    device)."""
    d, n, di = cfg["d_model"], cfg["n_layer"], cfg["d_inner"]
    lay = cfg["layer"]
    emb, order, l_max = lay["emb_dim"], lay["filter_order"], lay["l_max"]
    k = lay.get("short_filter_order", 3)
    resid = 0.02 / math.sqrt(2 * n)
    specs = [("backbone.embeddings.word_embeddings.weight", (padded_vocab(cfg), d),
              ("normal", 0.02))]
    for i in range(n):
        p = f"backbone.layers.{i}."
        m = p + "mixer."
        f = m + "filter_fn."
        specs += [(p + "norm1.weight", (d,), ("ones",)), (p + "norm1.bias", (d,), ("zeros",)),
                  (m + "in_proj.weight", (3 * d, d), ("normal", 0.02)),
                  (m + "in_proj.bias", (3 * d,), ("zeros",)),
                  (m + "out_proj.weight", (d, d), ("normal", resid)),
                  (m + "out_proj.bias", (d,), ("zeros",)),
                  (m + "short_filter.weight", (3 * d, 1, k), ("uniform", 1 / math.sqrt(k))),
                  (m + "short_filter.bias", (3 * d,), ("uniform", 1 / math.sqrt(k))),
                  (f + "bias", (d,), ("normal", 1.0)),
                  (f + "pos_emb.z", (1, l_max, emb),
                   ("fixed", lambda dev: positional_features(emb, l_max, dev))),
                  (f + "implicit_filter.0.weight", (order, emb), ("normal", 0.02)),
                  (f + "implicit_filter.0.bias", (order,), ("zeros",)),
                  (f + "implicit_filter.1.freq", (1, order),
                   ("fixed", lambda dev: torch.full((1, order), float(lay["w"]), device=dev))),
                  (f + "implicit_filter.2.weight", (order, order), ("normal", 0.02)),
                  (f + "implicit_filter.2.bias", (order,), ("zeros",)),
                  (f + "implicit_filter.4.weight", (order, order), ("normal", 0.02)),
                  (f + "implicit_filter.4.bias", (order,), ("zeros",)),
                  (f + "implicit_filter.6.weight", (d, order), ("normal", 0.02))]
        if lay.get("modulate", True):
            specs.append((f + "modulation.deltas", (1, 1, d),
                          ("fixed", lambda dev: modulation_rates(d, device=dev))))
        specs += [(p + "norm2.weight", (d,), ("ones",)), (p + "norm2.bias", (d,), ("zeros",)),
                  (p + "mlp.fc1.weight", (di, d), ("normal", 0.02)),
                  (p + "mlp.fc1.bias", (di,), ("zeros",)),
                  (p + "mlp.fc2.weight", (d, di), ("normal", resid)),
                  (p + "mlp.fc2.bias", (d,), ("zeros",))]
    specs += [("backbone.ln_f.weight", (d,), ("ones",)), ("backbone.ln_f.bias", (d,), ("zeros",))]
    return specs


def make_params(cfg: dict, seed: int, device) -> Params:
    """Every parameter from `seed`, drawn on `device` in two calls (one
    normal, one uniform draw for all), float32."""
    specs = param_specs(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_normal = sum(math.prod(s) for _, s, i in specs if i[0] == "normal")
    n_unif = sum(math.prod(s) for _, s, i in specs if i[0] == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device) * 2 - 1
    out, a, b, made = {}, 0, 0, {}
    for name, shape, init in specs:
        size = math.prod(shape)
        if init[0] == "normal":
            out[name] = normal[a:a + size].view(shape) * init[1]
            a += size
        elif init[0] == "uniform":
            out[name] = unif[b:b + size].view(shape) * init[1]
            b += size
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:  # the same fixed tensor in every layer: made once, copied
            key = (name.split(".")[-1], shape)
            if key not in made:
                made[key] = init[1](device)
            out[name] = made[key].clone()
    return out


def buffers(cfg: dict, device) -> Params:
    """The non-trainable state of the model (the filter's time grid)."""
    lay = cfg["layer"]
    t = torch.linspace(0.0, 1.0, lay["l_max"], device=device)[None, :, None]
    return {f"backbone.layers.{i}.mixer.filter_fn.pos_emb.t": t for i in range(cfg["n_layer"])}


# --------------------------------------------------------------------------
# forward

def _linear(x, w, b, q: Round):
    y = torch.matmul(q(x), q(w).t())
    return y if b is None else y + b


def causal_fft_conv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_{s <= t} k[s] u[t - s] + D u[t] over the last axis (u (B, C,
    L), k (C, L), D (C,)), through an FFT of size >= 2L, in float32."""
    length = u.shape[-1]
    n = 1 << (2 * length - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(u, n=n) * torch.fft.rfft(k, n=n), n=n)[..., :length]
    return y + u * D[:, None]


def filter_bank(P: Params, pre: str, length: int, lay: dict, rnd: Round, q: Round):
    """The (d, L) implicit filter: Sin MLP over z, then the modulation."""
    f = pre + "filter_fn."
    z = P[f + "pos_emb.z"][0, :length]
    freq = P[f + "implicit_filter.1.freq"]
    h = z
    for j in (0, 2, 4):
        h = torch.sin(freq * _linear(h, P[f"{f}implicit_filter.{j}.weight"],
                                     P[f"{f}implicit_filter.{j}.bias"], q))
    h = rnd(_linear(h, P[f + "implicit_filter.6.weight"], None, q))
    if lay.get("modulate", True):
        t = P[f + "pos_emb.t"][0, :length]
        decay = torch.exp(-t * P[f + "modulation.deltas"][0].abs()) + lay.get("shift", 0.0)
        h = rnd(h * rnd(decay))
    return h.t()


def hyena_mixer(P: Params, pre: str, u: torch.Tensor, cfg: dict, q: Round,
                conv_round: Round) -> torch.Tensor:
    """Order-2 Hyena: in_proj, causal depthwise short conv, v * x1, long conv
    with the filter plus the D skip, gate x0, out_proj."""
    lay = cfg["layer"]
    d = cfg["d_model"]
    length = u.shape[1]
    m = pre + "mixer."
    proj = _linear(u, P[m + "in_proj.weight"], P[m + "in_proj.bias"], q).transpose(1, 2)
    k = lay.get("short_filter_order", 3)
    conv = F.conv1d(proj, P[m + "short_filter.weight"], P[m + "short_filter.bias"],
                    padding=k - 1, groups=3 * d)[..., :length]
    x0, x1, v = conv[:, :d], conv[:, d:2 * d], conv[:, 2 * d:]
    rnd = conv_round if length >= cfg["conv_io_bf16_from"] else identity
    bank = filter_bank(P, m, min(length, lay["l_max"]), lay, rnd, q)
    if bank.shape[-1] < length:
        bank = F.pad(bank, (0, length - bank.shape[-1]))
    y = rnd(causal_fft_conv(rnd(v * x1), bank, P[m + "filter_fn.bias"]))
    y = rnd(y * rnd(x0))
    return _linear(y.transpose(1, 2), P[m + "out_proj.weight"], P[m + "out_proj.bias"], q)


def _norm(x, P, name, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def block(P: Params, i: int, hidden, residual, cfg: dict, q: Round, conv_round: Round):
    """dropout (applied by the caller) -> add -> norm1 -> mixer -> add ->
    norm2 -> MLP; returns (hidden, residual), the residual in float32."""
    p = f"backbone.layers.{i}."
    eps = cfg.get("layer_norm_epsilon", 1e-5)
    residual = hidden if residual is None else hidden + residual
    h = hyena_mixer(P, p, _norm(residual, P, p + "norm1", eps), cfg, q, conv_round)
    residual = h + residual
    h = _norm(residual, P, p + "norm2", eps)
    h = F.gelu(_linear(h, P[p + "mlp.fc1.weight"], P[p + "mlp.fc1.bias"], q), approximate="tanh")
    return _linear(h, P[p + "mlp.fc2.weight"], P[p + "mlp.fc2.bias"], q), residual


def forward(P: Params, ids: torch.Tensor, cfg: dict, mask: torch.Tensor | None = None,
            q: Round = identity, conv_round: Round = bf16_round,
            checkpoint_layers: bool = False) -> torch.Tensor:
    """Logits (B, L, V_padded) in float32 of ids (B, L); `mask` the
    embedding dropout's keep mask (B, L, d) or None (eval)."""
    table = P["backbone.embeddings.word_embeddings.weight"]
    hidden = q(table)[ids]
    if mask is not None:
        hidden = hidden * mask.float() / (1.0 - cfg["embed_dropout"])
    residual = None
    for i in range(cfg["n_layer"]):
        if checkpoint_layers and torch.is_grad_enabled():
            if residual is None:
                hidden, residual = checkpoint(
                    lambda h, i=i: block(P, i, h, None, cfg, q, conv_round),
                    hidden, use_reentrant=False)
            else:
                hidden, residual = checkpoint(
                    lambda h, r, i=i: block(P, i, h, r, cfg, q, conv_round),
                    hidden, residual, use_reentrant=False)
        else:
            hidden, residual = block(P, i, hidden, residual, cfg, q, conv_round)
    h = _norm(hidden + residual, P, "backbone.ln_f", cfg.get("layer_norm_epsilon", 1e-5))
    return _linear(h, table, None, q)


def nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood, float32."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    return torch.logsumexp(logits, -1) - logits.gather(-1, y.reshape(-1, 1).long())[:, 0]


# --------------------------------------------------------------------------
# training: gradient accumulation, global-norm clip, AdamW by groups

def group_of(name: str) -> str:
    """The optimizer group of a parameter, by the HyenaDNA recipe as the
    configuration runs it: the filter's positional features and modulation
    rates have their own learning rates (0 in the shipped configs: frozen),
    the filter's D skip no decay, the rest of the filter MLP the layer's lr
    and wd; biases (not the short conv's), norms and the embedding no
    decay; all else the main group."""
    parts = name.split(".")
    if "filter_fn" in parts:
        if parts[-2:] == ["pos_emb", "z"]:
            return "pos_emb"
        if parts[-2:] == ["modulation", "deltas"]:
            return "modulation"
        if parts[-2:] == ["filter_fn", "bias"]:
            return "no_decay"
        return "filter"
    if parts[-1] == "bias" and parts[-2] != "short_filter":
        return "no_decay"
    if any(s in name for s in ("norm1", "norm2", "ln_f", "word_embeddings")):
        return "no_decay"
    return "main"


def group_hparams(run: dict) -> Dict[str, Tuple[float, float]]:
    """{group: (base lr, weight decay)} of a training recipe."""
    lr, wd = run["optimizer"]["lr"], run["optimizer"]["weight_decay"]
    lay = run["layer_optim"]
    return {"main": (lr, wd), "no_decay": (lr, 0.0), "filter": (lay["lr"], lay["wd"]),
            "pos_emb": (lay["lr_pos_emb"], 0.0), "modulation": (lay.get("modulation_lr", 0.0), 0.0)}


def schedule_lr(base: float, step: int, sched: dict) -> float:
    """timm's cosine schedule with linear warm-up, at step count `step`."""
    if sched["_name_"] == "constant":
        return base
    if sched["_name_"] != "cosine_warmup_timm":
        raise ValueError(f"no reference schedule {sched['_name_']!r}")
    warm, init = int(sched.get("warmup_t", 0)), float(sched.get("warmup_lr_init", 0.0))
    total, lr_min = max(int(sched["t_initial"]), 1), float(sched.get("lr_min", 0.0))
    if step < warm:
        return init + step * (base - init) / max(warm, 1)
    frac = min(max(step - warm, 0), max(total - warm, 1)) / max(total - warm, 1)
    return lr_min + 0.5 * (base - lr_min) * (1 + math.cos(math.pi * frac))


class AdamW:
    """Decoupled-decay Adam with bias correction, per group, after a clip of
    the global gradient norm (over every parameter, frozen ones included)."""

    def __init__(self, params: Params, run: dict):
        self.run = run
        self.hp = group_hparams(run)
        self.b1, self.b2 = run["optimizer"].get("betas", (0.9, 0.999))
        self.eps = run["optimizer"].get("eps", 1e-8)
        self.clip = run["trainer"].get("gradient_clip_val")
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.seen_grads: Dict[str, torch.Tensor] = {}

    def step(self, params: Params, grads: Params) -> float:
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values()))
        factor = self.clip / norm if self.clip and norm > self.clip else 1.0
        self.count += 1
        t = self.count
        for name, p in params.items():
            lr_base, wd = self.hp[group_of(name)]
            if lr_base == 0.0:
                continue
            lr = schedule_lr(lr_base, t - 1, self.run["scheduler"])
            g = grads[name] * float(factor)
            if t == 1:
                self.seen_grads[name] = g.clone()
            p.mul_(1 - lr * wd)
            self.m[name].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[name] / (1 - self.b2 ** t)).sqrt() + self.eps
            p.addcdiv_(self.m[name], denom, value=-lr / (1 - self.b1 ** t))
        return float(norm)


def train_steps(P: Params, bufs: Params, batches: Iterator, cfg: dict, run: dict,
                masks: Iterator, q: Round = identity, conv_round: Round = bf16_round,
                row_block: int = 0, checkpoint_layers: bool = True,
                micro_keep: Callable[[int], bool] | None = None):
    """Run the recipe's train steps from P (updated in place; `bufs` the
    buffers) on `batches`,
    an iterator of (x, y) per step of accum x micro rows, with one dropout
    mask per micro-batch from `masks`. Returns (losses, target tokens a step,
    first-step gradient by leaf as the optimizer received it, the
    optimizer). `row_block` rows
    of a micro-batch at a time (0: the whole micro-batch). `micro_keep`
    (a fault of the harness's tests): which micro-batches count."""
    accum = int(run["trainer"]["accumulate_grad_batches"])
    for p in P.values():
        p.requires_grad_(True)
    opt = AdamW(P, run)
    losses, counts = [], []
    for x, y in batches:
        micro = x.shape[0] // accum
        grads = {k: torch.zeros_like(v) for k, v in P.items()}
        kept = [i for i in range(accum) if micro_keep is None or micro_keep(i)]
        loss_sum = 0.0
        for i in range(accum):
            mask = next(masks)
            if i not in kept:
                continue
            rows = slice(i * micro, (i + 1) * micro)
            xb, yb = x[rows], y[rows]
            blk = row_block or micro
            for r0 in range(0, micro, blk):
                r = slice(r0, min(r0 + blk, micro))
                logits = forward({**P, **bufs}, xb[r], cfg, mask[r], q, conv_round,
                                 checkpoint_layers)
                loss = nll(logits, yb[r]).sum() / yb.numel()
                del logits
                gs = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
                for (k, _), g in zip(P.items(), gs):
                    if g is not None:
                        grads[k] += g
                loss_sum += float(loss.detach())
        for k in grads:
            grads[k] /= len(kept)
        losses.append(loss_sum / len(kept))
        counts.append(len(kept) * micro * y.shape[1])
        with torch.no_grad():
            opt.step(P, grads)
        del grads
    for p in P.values():
        p.requires_grad_(False)
    return losses, counts, opt.seen_grads, opt
