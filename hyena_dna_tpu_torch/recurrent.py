"""O(1)-per-token recurrent generation via modal distillation (mirrors
`hyena_dna_tpu/recurrent.py`).

Full-forward generation (`generation.py`) re-runs the whole model over the
buffer for every new token. `distill` fits each layer's implicit long
filter with P complex modes (`ops/modal.py`, on the host) and
`RecurrentLM` steps the whole `ConvLMHeadModel` (or `DNAEmbeddingModel`)
token by token with a state per layer: the (K-1)-tap short-conv buffer of
the projection before the short conv, and (o-1) banks of P complex modes
per channel. A step is O(d^2 + d P) work, whatever the position.

`RecurrentLM` reads the model's own parameters, so one checkpoint serves
both paths. Everything runs in float32 on the model's device. A step is
plain PyTorch: the JAX step is plain `jnp` with no Pallas kernel behind
it. `prefill_parallel` computes the state after a prompt in closed form:
one parallel pass whose long conv is kernel B on the card
(`ops/fftconv.py::fftconv`, with a zero skip D), one launch per layer per
(o-1) group, over the modal filter the recurrence realises, so its state
and logits are those of the sequential `prefill` to float32 error.

The pole powers keep every phase below about 800 rad (blocks of 256, the
outer block's angle reduced mod 2 pi in float32) on every device, as the
JAX package does, so the card and the CPU compute the same angles.

The fit is one Hankel SVD and one least-squares solve per channel on the
host (2048 channels at d 256 x 8 layers). From 256 channels `distill`
splits them over worker processes (`python -m
hyena_dna_tpu_torch.ops.modal`, banks through pipes), one per 128
channels up to the host's cores, each on one BLAS thread: one thread per
factorisation is faster for these small matrices than all cores on each.
"""

from __future__ import annotations

import io
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hyena_dna_tpu_torch.generation import _sample_logits
from hyena_dna_tpu_torch.ops.fftconv import fftconv
from hyena_dna_tpu_torch.ops.modal import fit_modal_filters, modal_reconstruction

_POLE_BLOCK = 256  # power-block size: every phase product stays < ~800 rad


def _ln(x: torch.Tensor, norm, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * norm.weight.float() + norm.bias.float()


def _mlp(x: torch.Tensor, mlp) -> torch.Tensor:
    h = F.gelu(F.linear(x, mlp.fc1.weight.float(), mlp.fc1.bias.float()), approximate="tanh")
    return F.linear(h, mlp.fc2.weight.float(), mlp.fc2.bias.float())


def _order(mixer, d: int) -> int:
    return mixer.in_proj.out_features // d - 1


class RecurrentLM:
    """Distilled recurrent view of a port `ConvLMHeadModel` /
    `DNAEmbeddingModel` (order >= 2, one head).

    `lam` and `c` hold one (o-1, d, P, 2) float32 array per layer: the
    poles' and amplitudes' (real, imaginary) parts, from `distill` or given
    (the JAX distillation's, in the tests). They are moved to the model's
    device."""

    def __init__(self, model, lam: Sequence, c: Sequence, fit_rel_err: float = 0.0):
        self.model = model
        backbone = model.backbone
        self.device = backbone.embeddings.word_embeddings.weight.device
        self.lam = [torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.device)
                    for x in lam]
        self.c = [torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.device)
                  for x in c]
        self.n_layer = len(backbone.layers)
        self.d_model = model.d_model
        mixer = backbone.layers[0].mixer
        self.order = _order(mixer, self.d_model)
        self.short_k = mixer.short_filter.weight.shape[-1]
        self.fit_rel_err = fit_rel_err
        if len(self.lam) != self.n_layer or len(self.c) != self.n_layer:
            raise ValueError(f"need lam and c for each of {self.n_layer} layers")

    # ---- state ------------------------------------------------------------
    def init_state(self, batch: int) -> Dict:
        d, o, P = self.d_model, self.order, self.lam[0].shape[2]
        f32 = dict(dtype=torch.float32, device=self.device)
        layers = [{"sc": torch.zeros(batch, (o + 1) * d, self.short_k - 1, **f32),
                   "s": torch.zeros(batch, o - 1, d, P, 2, **f32)}
                  for _ in range(self.n_layer)]
        return {"layers": layers, "residual": torch.zeros(batch, d, **f32)}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.backbone.embeddings.word_embeddings.weight.float()[tokens]

    def _logits(self, residual: torch.Tensor) -> torch.Tensor:
        backbone = self.model.backbone
        hf = _ln(residual, backbone.ln_f, backbone.ln_f.eps)
        return hf @ backbone.embeddings.word_embeddings.weight.float().t()

    # ---- one token --------------------------------------------------------
    @torch.no_grad()
    def step(self, state: Dict, token: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
        """token: (B,) ints -> (new_state, logits (B, V))."""
        h = self._embed(token)  # (B, d)
        residual = None
        new_layers = []
        for i, layer in enumerate(self.model.backbone.layers):
            residual = h if residual is None else h + residual
            hn = _ln(residual, layer.norm1, layer.norm1.eps)
            y, st = self._mixer_step(hn, state["layers"][i], layer.mixer, self.lam[i], self.c[i])
            residual = y + residual
            h = _mlp(_ln(residual, layer.norm2, layer.norm2.eps), layer.mlp)
            new_layers.append(st)
        residual = h + residual
        return {"layers": new_layers, "residual": residual}, self._logits(residual)

    def _mixer_step(self, x, st, mixer, lam, c):
        """One Hyena token step: proj -> short conv (buffered) -> gated modal
        recurrences -> out_proj. x: (B, d)."""
        o, d = self.order, self.d_model
        proj = F.linear(x, mixer.in_proj.weight.float(), mixer.in_proj.bias.float())
        wsf = mixer.short_filter.weight[:, 0, :].float()  # ((o+1)d, K)
        hist = torch.cat([st["sc"], proj[:, :, None]], dim=-1)  # p_{t-K+1..t}
        uc = (hist * wsf).sum(-1) + mixer.short_filter.bias.float()
        *xg, v = uc.split(d, dim=-1)
        bias = mixer.filter_fn.bias.float().reshape(d, o - 1).t()
        s = st["s"]  # (B, o-1, d, P, 2)
        new_s = []
        for i, x_i in enumerate(reversed(xg[1:])):
            v = v * x_i
            lr, li = lam[i, ..., 0], lam[i, ..., 1]  # (d, P)
            cr, ci = c[i, ..., 0], c[i, ..., 1]
            sr, si = s[:, i, ..., 0], s[:, i, ..., 1]  # (B, d, P)
            sr, si = lr * sr - li * si + v[..., None], lr * si + li * sr
            new_s.append(torch.stack([sr, si], dim=-1))
            v = (cr * sr - ci * si).sum(-1) + bias[i] * v  # Re(sum c s) + skip
        y = mixer.act(v * xg[0])
        out = F.linear(y, mixer.out_proj.weight.float(), mixer.out_proj.bias.float())
        return out, {"sc": hist[:, :, 1:], "s": torch.stack(new_s, dim=1)}

    # ---- sequence APIs ------------------------------------------------------
    @torch.no_grad()
    def prefill(self, state: Dict, tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
        """tokens (B, T): the step T times; returns (state, last logits)."""
        for t in range(tokens.shape[1]):
            state, logits = self.step(state, tokens[:, t])
        return state, logits

    @torch.no_grad()
    def prefill_parallel(self, state: Dict, tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
        """Closed-form prefill: one parallel pass instead of T steps.

        The modal state after a prompt is a pole-weighted suffix sum,
        s_T = sum_t lam^{T-1-t} v_t, over each stage's gated conv input v,
        which the parallel pass computes wholesale; the conv uses the modal
        filter, not the implicit one, so state and logits match `prefill`.
        Ignores `state` (assumed fresh); returns (state at T, last logits)."""
        h = self._embed(tokens)  # (B, T, d)
        residual = None
        new_layers = []
        for i, layer in enumerate(self.model.backbone.layers):
            residual = h if residual is None else h + residual
            hn = _ln(residual, layer.norm1, layer.norm1.eps)
            y, st = self._mixer_parallel(hn, layer.mixer, self.lam[i], self.c[i])
            residual = y + residual
            h = _mlp(_ln(residual, layer.norm2, layer.norm2.eps), layer.mlp)
            new_layers.append(st)
        residual = h + residual
        last = residual[:, -1]
        return {"layers": new_layers, "residual": last}, self._logits(last)

    def _mixer_parallel(self, x, mixer, lam, c):
        """Batched mirror of `_mixer_step` over a whole prompt: x (B, T, d)
        -> (y (B, T, d), state at T)."""
        o, d, K = self.order, self.d_model, self.short_k
        T = x.shape[1]
        proj = F.linear(x, mixer.in_proj.weight.float(),
                        mixer.in_proj.bias.float()).transpose(1, 2)  # (B, (o+1)d, T)
        wsf = mixer.short_filter.weight[:, 0, :].float()
        uc = mixer.short_filter.bias.float()[None, :, None]
        for kk in range(K):  # causal depthwise short conv: tap kk reads p_{t-(K-1-kk)}
            shift = K - 1 - kk
            pk = proj if shift == 0 else F.pad(proj, (shift, 0))[:, :, :T]
            uc = uc + wsf[None, :, kk:kk + 1] * pk
        buf = proj[:, :, T - (K - 1):] if T >= K - 1 else F.pad(proj, (K - 1 - T, 0))
        *xg, v = uc.split(d, dim=1)  # (o+1) x (B, d, T)
        bias = mixer.filter_fn.bias.float().reshape(d, o - 1).t()
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        new_s = []
        for i, x_i in enumerate(reversed(xg[1:])):
            vx = (v * x_i).contiguous()
            new_s.append(_suffix_state(vx, lam[i]))
            kmod = _modal_kernel(lam[i], c[i], T).contiguous()  # (d, T)
            v = fftconv(vx, kmod, zeros) + bias[i][None, :, None] * vx
        y = mixer.act((v * xg[0]).transpose(1, 2))  # (B, T, d)
        out = F.linear(y, mixer.out_proj.weight.float(), mixer.out_proj.bias.float())
        return out, {"sc": buf.contiguous(), "s": torch.stack(new_s, dim=1)}

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None, temperature: float = 1.0,
                 top_k: Optional[int] = None, parallel_prefill: bool = True) -> torch.Tensor:
        """prompt (B, T) -> (B, T + max_new_tokens), greedy unless a
        `generator` (on the model's device) is given. `parallel_prefill`
        False takes the sequential prefill (the oracle)."""
        prompt = prompt.to(self.device)
        pre = self.prefill_parallel if parallel_prefill else self.prefill
        state, logits = pre(self.init_state(prompt.shape[0]), prompt)
        toks: List[torch.Tensor] = []
        for _ in range(max_new_tokens):
            if generator is None:
                tok = logits.argmax(-1)
            else:
                tok = _sample_logits(generator, logits, max(temperature, 1e-6), top_k, None)
            tok = tok.to(prompt.dtype)
            toks.append(tok)
            state, logits = self.step(state, tok)
        return torch.cat([prompt] + [t[:, None] for t in toks], dim=1)


def _pole_powers(lam: torch.Tensor, exps) -> Tuple[torch.Tensor, torch.Tensor]:
    """lam^e for a vector of integer exponents: (re, im), each lam's shape
    (..., P) x len(exps). Magnitude via exp(e log|lam|) with the |lam| = 0
    and e = 0 corners handled; phase e * theta (callers keep it small by
    blocking)."""
    lr, li = lam[..., 0], lam[..., 1]
    mag = torch.sqrt(lr * lr + li * li)
    th = torch.atan2(li, lr)
    e = torch.as_tensor(np.asarray(exps), dtype=torch.float32, device=lam.device)
    logm = torch.log(torch.clamp_min(mag, 1e-30))
    pm = torch.exp(e * logm[..., None])
    pm = torch.where((mag[..., None] <= 1e-30) & (e != 0.0), 0.0, pm)
    pm = torch.where(e == 0.0, 1.0, pm)
    ang = e * th[..., None]
    return pm * torch.cos(ang), pm * torch.sin(ang)


def _outer_pole(lam: torch.Tensor, bk: int) -> torch.Tensor:
    """lam^bk as an (..., 2) pair, the phase reduced mod 2 pi in float32
    while the product is still small (bk |theta| <= ~800 rad)."""
    lr, li = lam[..., 0], lam[..., 1]
    mag = torch.sqrt(lr * lr + li * li)
    th = torch.atan2(li, lr)
    magb = torch.where(mag <= 1e-30, 0.0, torch.exp(bk * torch.log(torch.clamp_min(mag, 1e-30))))
    angb = torch.remainder(bk * th, 2.0 * math.pi)
    return torch.stack([magb * torch.cos(angb), magb * torch.sin(angb)], dim=-1)


def _suffix_state(vx: torch.Tensor, lam: torch.Tensor, bk: int = _POLE_BLOCK) -> torch.Tensor:
    """s_T = sum_t lam^{T-1-t} vx[..., t] -> (B, d, P, 2).

    vx (B, d, T) real; lam (d, P, 2). Front-pads T to a block multiple
    (zeros add nothing), contracts the inner-block powers, then the outer
    block powers: two levels, so float32 phases stay accurate at any T."""
    B, d, T = vx.shape
    nb = -(-T // bk)
    vb = F.pad(vx, (nb * bk - T, 0)).reshape(B, d, nb, bk)
    wr, wi = _pole_powers(lam, np.arange(bk - 1, -1, -1.0))  # lam^{bk-1-j}
    pr = torch.einsum("bdnj,dpj->bdnp", vb, wr)
    pi = torch.einsum("bdnj,dpj->bdnp", vb, wi)
    owr, owi = _pole_powers(_outer_pole(lam, bk), np.arange(nb - 1, -1, -1.0))
    sr = torch.einsum("bdnp,dpn->bdp", pr, owr) - torch.einsum("bdnp,dpn->bdp", pi, owi)
    si = torch.einsum("bdnp,dpn->bdp", pr, owi) + torch.einsum("bdnp,dpn->bdp", pi, owr)
    return torch.stack([sr, si], dim=-1)


def _modal_kernel(lam: torch.Tensor, c: torch.Tensor, T: int,
                  bk: int = _POLE_BLOCK) -> torch.Tensor:
    """kmod[d, t] = Re sum_p c lam^t for t < T (the filter the recurrence
    realises), from the same two-level blocked powers."""
    nb = -(-T // bk)
    wr, wi = _pole_powers(lam, np.arange(0.0, bk))  # (d, P, bk)
    owr, owi = _pole_powers(_outer_pole(lam, bk), np.arange(0.0, nb))  # (d, P, nb)
    cr, ci = c[..., 0], c[..., 1]
    cor = cr[..., None] * owr - ci[..., None] * owi  # c (lam^bk)^n
    coi = cr[..., None] * owi + ci[..., None] * owr
    k = torch.einsum("dpn,dpj->dnj", cor, wr) - torch.einsum("dpn,dpj->dnj", coi, wi)
    return k.reshape(k.shape[0], nb * bk)[:, :T]


_BLAS_THREAD_VARS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")
_CHANNELS_PER_WORKER = 128


def fit_banks(banks: Sequence[np.ndarray], n_modes: int, fit_len: int, workers: int = 1):
    """`fit_modal_filters` of each (C_i, L) bank: a list of (lam, c). With
    `workers` > 1 the channels of all banks are split over that many worker
    processes; each channel's fit is the same computation."""
    if workers <= 1:
        return [fit_modal_filters(k, n_modes, fit_len=fit_len) for k in banks]
    allk = np.ascontiguousarray(np.concatenate(banks)[:, :fit_len])
    env = {**os.environ, **dict.fromkeys(_BLAS_THREAD_VARS, "1")}
    cmd = [sys.executable, "-m", "hyena_dna_tpu_torch.ops.modal", str(n_modes)]
    procs = [subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env) for _ in range(workers)]
    try:
        for proc, part in zip(procs, np.array_split(allk, workers)):
            buf = io.BytesIO()
            np.save(buf, part)
            proc.stdin.write(buf.getvalue())
            proc.stdin.close()
        fits = []
        for proc in procs:
            out, err = proc.stdout.read(), proc.stderr.read()
            if proc.wait() != 0:
                raise RuntimeError(f"modal fit worker failed: {err.decode()[-2000:]}")
            with np.load(io.BytesIO(out), allow_pickle=False) as z:
                fits.append((z["lam"], z["c"]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lam, c = (np.concatenate([f[i] for f in fits]) for i in (0, 1))
    bounds = np.cumsum([0] + [k.shape[0] for k in banks])
    return [(lam[a:b], c[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


@torch.no_grad()
def distill(model, n_modes: int = 64, fit_len: int = 8192) -> RecurrentLM:
    """Fit modal recurrences for every layer of a port `ConvLMHeadModel` /
    `DNAEmbeddingModel` and return the recurrent view. The filter banks are
    computed on the model's device in float32; the fit runs on the host
    (`ops/modal.py`), once per checkpoint. `fit_len` caps the samples
    fitted (the filter's first `fit_len`)."""
    d = model.d_model
    banks = []  # per layer: (o-1, d, L)
    for layer in model.backbone.layers:
        mixer = layer.mixer
        order = _order(mixer, d)
        # (L, (o-1) d) -> (o-1, d, L): channel c of group g is column c (o-1) + g
        k = mixer.filter_fn.filter(mixer.l_max)[0].float().cpu().numpy().astype(np.float64)
        banks.append(k.reshape(k.shape[0], d, order - 1).transpose(2, 1, 0))
    channels = sum(k.shape[0] * k.shape[1] for k in banks)
    workers = min(os.cpu_count() or 1, channels // _CHANNELS_PER_WORKER)
    fits = iter(fit_banks([k[g] for k in banks for g in range(k.shape[0])], n_modes, fit_len,
                          workers))
    lam_all, c_all, errs = [], [], []
    for k in banks:
        lam_l, c_l = [], []
        for g in range(k.shape[0]):
            lam, c = next(fits)
            rec = modal_reconstruction(lam, c, min(k.shape[-1], fit_len))
            ref = k[g][:, :rec.shape[-1]]
            errs.append(float(np.abs(rec - ref).max() / (np.abs(ref).max() + 1e-12)))
            lam_l.append(np.stack([lam.real, lam.imag], -1))
            c_l.append(np.stack([c.real, c.imag], -1))
        lam_all.append(np.stack(lam_l).astype(np.float32))
        c_all.append(np.stack(c_l).astype(np.float32))
    return RecurrentLM(model, lam_all, c_all, fit_rel_err=max(errs))
