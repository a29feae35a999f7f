"""The port's optimizers held against the JAX `build_optimizer` on the CPU:
adamw, adam (coupled L2) and lamb (the reference JITLamb) over the LM's
parameter groups, with and without frozen overrides, and the port's `Lamb`
against the update written out from its equations (tests/test_train.py:354).

Each case runs three steps of the same seeded gradients through both
optimizers from the same parameters (a clip low enough to engage, a timm
cosine schedule with warmup). Parameters within 1e-2 lr per step of each
element (PERF.md section 2); frozen parameters exactly unchanged.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from hyena_dna_tpu.models.lm import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.train.optim import build_optimizer as jax_build_optimizer
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.train.optim import Lamb, build_optimizer
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from test_torch_port_trainer import one_torch_thread  # noqa: F401  (an autouse fixture)

LAYER = dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=34, w=10)
CFG = dict(d_model=16, n_layer=2, d_inner=64, vocab_size=12, pad_vocab_size_multiple=8)
OPT = dict(lr=1e-3, weight_decay=0.1, filter_lr=5e-4, lr_pos_emb=0.0,
           scheduler={"_name_": "cosine_warmup_timm", "t_initial": 10, "warmup_t": 2,
                      "warmup_lr_init": 1e-4}, gradient_clip_val=0.5)


def _models():
    jm = JaxLM(layer=LAYER, **CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"]
    pm = ConvLMHeadModel(layer=LAYER, **CFG)
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params, pm


def _frozen_layer0(params):
    """Every parameter of layer 0 frozen: JAX paths and port names."""
    flat = traverse_util.flatten_dict(params)
    jax_frozen = {p: ("frozen" if "layers_0" in p else None) for p in flat}
    return jax_frozen, lambda name: ".layers.0." in name


@pytest.mark.parametrize("name", ["adamw", "adam", "lamb"])
@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_matches_jax(name, frozen):
    params, pm = _models()
    jax_frozen, is_frozen = _frozen_layer0(params) if frozen else (None, lambda n: False)
    tx, _ = jax_build_optimizer(params, optimizer_name=name, frozen=jax_frozen, **OPT)
    port_frozen = ({n: ("frozen" if is_frozen(n) else None) for n, _ in pm.named_parameters()}
                   if frozen else None)
    opt, labels = build_optimizer(pm, optimizer_name=name, frozen=port_frozen, **OPT)
    assert all((labels[n] == "frozen") == is_frozen(n) for n in labels)
    start = {n: p.detach().clone() for n, p in pm.named_parameters()}
    state = tx.init(params)
    rng = np.random.default_rng(1)
    lrs = []
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        named = flax_to_torch_state_dict(grads, buffers=False)
        for n, p in pm.named_parameters():
            p.grad = named[n].clone()
        norm = opt.step()
        ref_norm = float(optax.global_norm(grads))
        assert abs(float(norm) - ref_norm) <= 1e-5 * ref_norm
        lrs.append(max(OPT["lr"], OPT["filter_lr"]))
    ref = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params), buffers=False)
    tol = 1e-2 * sum(lrs) + 1e-7
    for n, p in pm.named_parameters():
        err = (p.detach() - ref[n]).abs().max().item()
        assert err <= tol, f"{name} {n}: {err} > {tol}"
        if is_frozen(n) or n.endswith("pos_emb.z") or n.endswith("modulation.deltas"):
            assert torch.equal(p.detach(), start[n]), n
        else:
            assert not torch.equal(p.detach(), start[n]), n


def test_lamb_matches_reference_semantics():
    """`Lamb` against its equations (no bias correction, wd before the trust
    ratio, |p| clamped to 10, trust 1 where a norm is 0)."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (8,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params.append(np.zeros((3,), np.float32))
    lr, b1, b2, eps, wd = 0.02, 0.9, 0.999, 1e-6, 0.01
    ref = [p.copy() for p in params]
    m = [np.zeros_like(p) for p in params]
    v = [np.zeros_like(p) for p in params]
    grads_per_step = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
                      for _ in range(5)]
    for grads in grads_per_step:
        for i, g in enumerate(grads):
            m[i] = b1 * m[i] + (1 - b1) * g
            v[i] = b2 * v[i] + (1 - b2) * g * g
            a = m[i] / (np.sqrt(v[i]) + eps) + wd * ref[i]
            wn = min(np.linalg.norm(ref[i]), 10.0)
            an = np.linalg.norm(a)
            tr = 1.0 if (wn == 0.0 or an == 0.0) else wn / (an + eps)
            ref[i] = ref[i] - lr * tr * a
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Lamb(ours, lr=lr, betas=(b1, b2), eps=eps, weight_decay=wd)
    for grads in grads_per_step:
        for p, g in zip(ours, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=2e-5, atol=2e-6)


def test_unknown_optimizer_raises():
    _, pm = _models()
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(pm, optimizer_name="sgd")


def test_optimizer_state_round_trips():
    """state_dict / load_state_dict carry the step count and the moments:
    a restored optimizer takes the same next step."""
    _, pm = _models()
    opt, _ = build_optimizer(pm, optimizer_name="lamb", **OPT)
    rng = torch.Generator().manual_seed(0)
    grads = lambda: {n: 0.05 * torch.randn(p.shape, generator=rng)
                     for n, p in pm.named_parameters()}
    for n, p in pm.named_parameters():
        p.grad = grads()[n]
    opt.step()
    saved_params = {n: p.detach().clone() for n, p in pm.named_parameters()}
    saved = copy.deepcopy(opt.state_dict())  # the live state is updated in place
    g = grads()
    for n, p in pm.named_parameters():
        p.grad = g[n].clone()
    opt.step()
    after = {n: p.detach().clone() for n, p in pm.named_parameters()}
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(saved_params[n])
    opt2, _ = build_optimizer(pm, optimizer_name="lamb", **OPT)
    opt2.load_state_dict(saved)
    assert opt2.count == 1
    for n, p in pm.named_parameters():
        p.grad = g[n].clone()
    opt2.step()
    for n, p in pm.named_parameters():
        assert torch.equal(p.detach(), after[n]), n
