"""The port's bfloat16 path against the JAX package, on the CPU.

The bf16 model of every hg38 config (`precision: bf16`): bfloat16
activations and a bfloat16 residual stream, float32 parameters. The same
numpy inputs go through the JAX function and the port's counterpart; the
port's wrappers, given CPU tensors, run their kernels' plain versions
(`add_ln_ref` / `add_ln_bwd_ref` for kernels D and D', `reference_fwd` /
`reference_bwd` for kernels A and A'). Where the JAX function is a Pallas
kernel it runs in interpret mode, as the JAX package's own tests run it.
Tolerances are stated beside each check.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.pallas_ln as pln
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.ops.pallas_hyena import fused_proj_conv_gate
from hyena_dna_tpu.tasks import LMTask as JaxLMTask
from hyena_dna_tpu.train import build_optimizer as jax_build_optimizer
from hyena_dna_tpu.train import create_train_state as jax_create_train_state
from hyena_dna_tpu.train.step import make_train_step as jax_make_train_step

from hyena_dna_tpu_torch import _cuda, bench
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.ops import add_ln as AL
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops.layer_norm import LayerNormF32
from hyena_dna_tpu_torch.tasks import LMTask
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

BF16 = torch.bfloat16


def _np32(x):
    return np.asarray(x, np.float32)


def _bf16(x: np.ndarray):
    """(JAX bf16 array, torch bf16 tensor) holding the same values."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(BF16)


# (a) kernels D and D': the fused residual-add + LN

def _ln_inputs(n, d, seed):
    """The inputs of tests/test_pallas_ln.py."""
    rng = np.random.default_rng(seed)
    h = _bf16(rng.normal(size=(n, d)).astype(np.float32))
    r = _bf16(rng.normal(size=(n, d)).astype(np.float32) * 3.0)
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return h, r, scale, bias


def _jax_routes():
    """The JAX add+LN as the interpret kernel and as the XLA twin."""
    return {"pallas": lambda *a: pln.add_ln(*a, use_pallas=True, interpret=True),
            "ref": lambda *a: pln._add_ln_ref(*a, 1e-5, jnp.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("n,d", [(512, 256), (1536, 128)])
def test_add_ln_forward_matches_jax(n, d):
    """res_out is the same single rounding on both sides (equal bits); y
    within tests/test_pallas_ln.py's 2e-2. n = 1536 is three Pallas tiles."""
    (hj, ht), (rj, rt), scale, bias = _ln_inputs(n, d, seed=n)
    y, ro = AL.add_ln(ht, rt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.dtype == ro.dtype == BF16
    for route in _jax_routes().values():
        y_ref, ro_ref = route(hj, rj, jnp.asarray(scale), jnp.asarray(bias))
        np.testing.assert_array_equal(ro.float().numpy(), _np32(ro_ref))
        np.testing.assert_allclose(y.float().numpy(), _np32(y_ref), rtol=0, atol=2e-2)


@pytest.mark.parametrize("n,d", [(512, 256), (1536, 128)])
def test_add_ln_grads_match_jax(n, d):
    """All four gradients through `AddLayerNorm`'s written-out backward, with
    both outputs in the loss so the res_out cotangent is not zero; the
    tolerances of tests/test_pallas_ln.py (dh, dres 6e-2; dscale, dbias
    2e-1, sums over n rows of bf16-rounded cotangents)."""
    (hj, ht), (rj, rt), scale, bias = _ln_inputs(n, d, seed=n + 1)
    cw = np.random.default_rng(n + 2).normal(size=(n, d)).astype(np.float32)

    def jax_loss(fn):
        def inner(h, r, s, b):
            y, ro = fn(h, r, s, b)
            return (jnp.sum(y.astype(jnp.float32) * cw)
                    + jnp.sum(ro.astype(jnp.float32) ** 2) * 1e-2)
        return jax.grad(inner, argnums=(0, 1, 2, 3))

    leaves = [ht.clone().requires_grad_(), rt.clone().requires_grad_(),
              torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    y, ro = AL.add_ln(*leaves)
    assert y.grad_fn.next_functions[0][0].name() == "AddLayerNormBackward"  # under a view
    ((y.float() * torch.from_numpy(cw)).sum() + (ro.float() ** 2).sum() * 1e-2).backward()
    for route in _jax_routes().values():
        ref = jax_loss(route)(hj, rj, jnp.asarray(scale), jnp.asarray(bias))
        for t, want, tol in zip(leaves, ref, (6e-2, 6e-2, 2e-1, 2e-1)):
            assert t.grad.dtype == t.dtype
            np.testing.assert_allclose(t.grad.float().numpy(), _np32(want), rtol=0, atol=tol)


def test_add_ln_bwd_ref_is_the_autograd_of_the_plain_forward():
    """The written-out backward against autograd through the plain LN on a
    float32 residual (float32 sums in other orders: 1e-5)."""
    rng = np.random.default_rng(7)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    ro = f32(rng.normal(size=(64, 128)) * 2.0)
    dy, dup = (f32(rng.normal(size=(64, 128))) for _ in range(2))
    w = f32(1.0 + 0.1 * rng.normal(size=(128,))).requires_grad_()
    b = torch.zeros(128, requires_grad=True)
    x = ro.clone().requires_grad_()
    y = torch.nn.functional.layer_norm(x, (128,), w, b, 1e-5)
    torch.autograd.backward((y, x), (dy, dup))
    d_total, dscale, dbias = AL.add_ln_bwd_ref(ro, dy, dup, w.detach())
    for got, want in ((d_total, x.grad), (dscale, w.grad), (dbias, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_float32_residual_takes_the_plain_unit(monkeypatch):
    """An ineligible call (a float32 residual, as in every hg38 config) is
    routed from dtypes to `add_ln_ref`, never to `AddLayerNorm`; it equals
    the JAX `_add_ln_ref` (res_out exactly, y within one bf16 step, 2^-7
    relative at the bottom of a binade)."""
    monkeypatch.setattr(AL.AddLayerNorm, "apply", None)  # any use would raise
    rng = np.random.default_rng(5)
    hj, ht = _bf16(rng.normal(size=(256, 256)).astype(np.float32))
    r = rng.normal(size=(256, 256)).astype(np.float32)
    s, b = np.ones(256, np.float32), np.zeros(256, np.float32)
    y, ro = AL.add_ln(ht, torch.from_numpy(r), torch.from_numpy(s), torch.from_numpy(b),
                      out_dtype=BF16, res_dtype=torch.float32)
    y_ref, ro_ref = pln.add_ln(hj, jnp.asarray(r), jnp.asarray(s), jnp.asarray(b),
                               res_dtype=jnp.float32, out_dtype=jnp.bfloat16,
                               use_pallas=True, interpret=True)
    assert ro.dtype == torch.float32 and y.dtype == BF16
    np.testing.assert_array_equal(ro.numpy(), _np32(ro_ref))
    np.testing.assert_allclose(y.float().numpy(), _np32(y_ref), rtol=2 ** -7, atol=1e-6)
    norm = LayerNormF32(256, out_dtype=BF16)  # the module routes the same way
    y2, ro2 = norm(ht, torch.from_numpy(r))
    assert torch.equal(ro2, ro) and torch.equal(y2, y)


def test_d_and_d_prime_build_from_their_own_sources():
    """Kernels D and D' are two sources with the shared row code in a
    header; each library's name hashes that header, so editing it rebuilds
    both."""
    for k, src in ((AL.KERNEL, "add_ln.cu"), (AL.KERNEL_BWD, "add_ln_bwd.cu")):
        assert k.source.name == src and k.source.is_file()
        assert '#include "add_ln_common.cuh"' in k.source.read_text()
    assert AL.KERNEL.library_path != AL.KERNEL_BWD.library_path
    assert (_cuda.CSRC / "add_ln_common.cuh").is_file()


# (b) kernels A and A' on bf16 u

def _front_inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    params = [(rng.normal(size=(D, 3 * D)) * 0.1).astype(np.float32),
              (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32),
              rng.normal(size=(3, 3 * D)).astype(np.float32),
              (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)]
    cot = [rng.normal(size=(B, D, L)).astype(np.float32) for _ in range(2)]
    return _bf16(u), params, [_bf16(c) for c in cot]


@pytest.mark.parametrize("L,tile", [(128, 32), (96, 32)])
def test_front_bf16_matches_pallas(L, tile):
    """vx, x0 and du come back in bf16, dW, dbp, dwc, dbc in float32. Both
    sides compute in float32 from the same bf16 values and round each bf16
    output once, so those may land one bf16 step apart (2^-7 relative plus
    2e-3 of the largest entry); the float32 gradients at the 2e-3 / 1e-3 of
    the float32 backward test."""
    (uj, ut), params, ((dvj, dvt), (dxj, dxt)) = _front_inputs(2, L, 16, seed=L)
    (vx_ref, x0_ref), vjp = jax.vjp(lambda u, *p: fused_proj_conv_gate(u, *p, tile, True),
                                    uj, *map(jnp.asarray, params))
    ref_grads = vjp((dvj, dxj))
    leaves = [ut.clone().requires_grad_()] + [torch.from_numpy(p).requires_grad_()
                                              for p in params]
    vx, x0 = FF.fused_proj_conv_gate(*leaves)
    assert vx.dtype == x0.dtype == BF16 and vx_ref.dtype == jnp.bfloat16
    for got, want in ((vx, vx_ref), (x0, x0_ref)):
        want = _np32(want)
        np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=2 ** -7,
                                   atol=2e-3 * np.abs(want).max())
    torch.autograd.backward((vx, x0), (dvt, dxt))
    for t, want, name in zip(leaves, ref_grads, ("du", "dw", "dbp", "dwc", "dbc")):
        want = _np32(want)
        assert t.grad.dtype == t.dtype, name
        if name == "du":
            np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=2 ** -7,
                                       atol=2e-3 * np.abs(want).max(), err_msg=name)
        else:
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-3, atol=2e-3, err_msg=name)


def test_front_check_takes_bf16_activations_and_f32_params():
    """The kernel wrappers' check: (u, dvx, dx0) all float32 or all bf16,
    the parameters float32 (it raises before any launch)."""
    (_, ut), params, ((_, dvt), (_, dxt)) = _front_inputs(1, 8, 4, seed=0)
    p = [torch.from_numpy(a) for a in params]
    assert FF._check(u=ut, w=p[0], bp=p[1], wc=p[2], bc=p[3], dvx=dvt, dx0=dxt) == "_bf16"
    assert FF._check(u=ut.float(), w=p[0], bp=p[1], wc=p[2], bc=p[3], dvx=dvt.float(),
                     dx0=dxt.float()) == ""
    with pytest.raises(TypeError, match="dvx"):
        FF._check(u=ut, w=p[0], bp=p[1], wc=p[2], bc=p[3], dvx=dvt.float(), dx0=dxt)
    with pytest.raises(TypeError, match="w"):
        FF._check(u=ut, w=p[0].to(BF16), bp=p[1], wc=p[2], bc=p[3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FF._check(u=ut.half(), w=p[0], bp=p[1], wc=p[2], bc=p[3])


# (c) the bf16 model; (d) the bf16 train step; (e) the bench

def _layer(l_max, **extra):
    return dict(_name_="hyena", emb_dim=5, filter_order=16, short_filter_order=3,
                l_max=l_max, modulate=True, w=10, **extra)


def _bf16_models(d_model=32, n_layer=2, L=256, B=2, seed=0, pallas=True):
    """The JAX ConvLMHeadModel(dtype=bfloat16, residual_in_fp32=False) and
    the port's, with the JAX parameters (float32 arrays) converted."""
    cfg = dict(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model, vocab_size=12,
               pad_vocab_size_multiple=8, residual_in_fp32=False, embed_dropout=0.0)
    tokens = np.random.default_rng(seed).integers(0, 12, size=(B, L + 1)).astype(np.int32)
    extra = dict(use_pallas_front=True, pallas_interpret=True) if pallas else {}
    jm = JaxLM(layer=_layer(L + 2, **extra), dtype=jnp.bfloat16, **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens[:, :-1]))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = ConvLMHeadModel(layer=_layer(L + 2), dtype=BF16, **cfg)
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params))
    assert all(v.dtype == torch.float32 for v in sd.values())  # float32 masters
    pm.load_state_dict(sd)  # strict: every name of the bf16 model maps
    return jm, params, pm, tokens[:, :-1], tokens[:, 1:]


def _named(tree):
    return flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, tree), buffers=False)


@pytest.fixture
def jax_fused_add_ln(monkeypatch):
    """Force the JAX add+LN onto its Pallas kernel in interpret mode (the
    monkeypatch of tests/test_pallas_ln.py)."""
    orig = pln.add_ln

    def forced(h, res, scale, bias, **kwargs):
        kwargs.update(use_pallas=True, interpret=True)
        return orig(h, res, scale, bias, **kwargs)

    monkeypatch.setattr(pln, "add_ln", forced)


# logits: the JAX package's own bf16 model tolerance (tests/test_pallas_ln.py);
# gradients: each parameter against its largest |g|, bf16 cotangents that may
# round one step (2^-8) apart on either side, summed over 2 layers forward
# and back (measured worst 7.6e-3)
LOGIT_ATOL, GRAD_REL, LOSS_RTOL = 5e-2, 2e-2, 1e-4


@pytest.mark.parametrize("add_ln_route", ["ref", "pallas"])
def test_bf16_model_matches_jax(add_ln_route, request):
    """Logits and every parameter's gradient of the 2-layer bf16 model (d=32,
    L=256, bf16 residual, the JAX front through its Pallas kernels in
    interpret mode), with the JAX add+LN once through `_add_ln_ref` and once
    through its Pallas kernel."""
    if add_ln_route == "pallas":
        request.getfixturevalue("jax_fused_add_ln")
    jm, params, pm, x, y = _bf16_models()

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), deterministic=False)[0]
        return JaxLMTask().compute_loss(logits, jnp.asarray(y)), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    pm.train()
    logits = pm(torch.from_numpy(x).long())
    assert logits.dtype == BF16 and ref_logits.dtype == jnp.bfloat16
    loss = cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().float().numpy(), _np32(ref_logits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = _named(ref_grads)
    for name, p in pm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        want = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * max(np.abs(want).max(), 1e-30), err_msg=name)


def test_bf16_model_runs_the_fused_units(monkeypatch):
    """Every add+LN after block 0's first norm is the fused unit: 2 n_layer
    - 1 block units plus ln_f."""
    _, _, pm, x, _ = _bf16_models(L=64)
    calls = []
    orig = AL.AddLayerNorm.apply

    def counting(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(AL.AddLayerNorm, "apply", counting)
    pm(torch.from_numpy(x).long())
    assert calls == [(2 * 64, 32)] * (2 * 2)


OPT = dict(lr=1e-3, weight_decay=0.1, gradient_clip_val=0.05)
# Adam's first update is -lr * g / (|g| + eps), about -lr * sign(g), plus the
# weight decay, which is the same function of p on both sides. Where the JAX
# gradient stands clear of the bf16 noise (above NOISE_FLOOR of its leaf's
# max |g|, three times the worst gradient error of test_bf16_model_matches_jax)
# both sides take the same sign, so p_after - p_before agrees within
# UPDATE_ATOL * lr (float32 roundings of p and the moments; measured worst
# 2.9e-3 lr). Below it a sign may flip between the two sides' bf16 roundings,
# or |g| may come near eps, and move a parameter up to 2 lr apart; the
# elements anywhere that disagree by more than UPDATE_ATOL * lr must stay
# under DISAGREE_SHARE of all (measured 1.2%). A step that is a no-op, of
# the wrong size or of the wrong sign disagrees almost everywhere.
NOISE_FLOOR, UPDATE_ATOL, DISAGREE_SHARE = 2.5e-2, 1e-2, 2.5e-2


@pytest.fixture(scope="module")
def bf16_step():
    """One AdamW step of the bf16 model on both sides from the same float32
    parameters and batch (a clip low enough to engage): the port's metrics
    and update, the JAX metrics and update, and the JAX gradient, by name."""
    jm, params, pm, x, y = _bf16_models(L=128, seed=3)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    grads = jax.grad(lambda p: JaxLMTask().compute_loss(
        jm.apply({"params": p}, xj, deterministic=False)[0], yj))(params)
    start = _named(params)  # the JAX step donates its state
    tx, _ = jax_build_optimizer(params, **OPT)
    jstate = jax_create_train_state(jm, tx, jax.random.PRNGKey(0), xj, params=params)
    jstate, jmetrics = jax_make_train_step(JaxLMTask())(jstate, (xj, yj), jax.random.PRNGKey(0))
    before = {name: p.detach().clone() for name, p in pm.named_parameters()}
    optimizer, _ = build_optimizer(pm, **OPT)
    state = create_train_state(pm, optimizer)
    metrics = make_train_step(LMTask())(
        state, (torch.from_numpy(x).long(), torch.from_numpy(y).long()),
        torch.Generator().manual_seed(0))
    after = _named(jstate.params)
    assert {p.dtype for p in pm.parameters()} == {torch.float32}
    return {"metrics": {k: metrics[k].item() for k in ("loss", "grad_norm")},
            "jax_metrics": {k: float(jmetrics[k]) for k in ("loss", "grad_norm")},
            "dp": {n: (p.detach() - before[n]).numpy() for n, p in pm.named_parameters()},
            "dp_ref": {n: (after[n] - start[n]).numpy() for n in after},
            "g_ref": {n: g.numpy() for n, g in _named(grads).items()}}


def _check_update(dp, dp_ref, g_ref, lr):
    """Hold a step's update to the JAX one (see NOISE_FLOOR above)."""
    disagree = total = 0
    for name, got in dp.items():  # the port's parameters (a shared Sin freq once)
        g = np.abs(g_ref[name])
        clear = g > NOISE_FLOOR * g.max()
        err = np.abs(got - dp_ref[name])
        np.testing.assert_array_less(err[clear], UPDATE_ATOL * lr, err_msg=name)
        np.testing.assert_array_less(err, 2 * lr + 1e-6, err_msg=name)
        disagree, total = disagree + int((err > UPDATE_ATOL * lr).sum()), total + g.size
    assert disagree <= DISAGREE_SHARE * total, (disagree, total)


def test_bf16_train_step_matches_jax(bf16_step):
    """Loss and grad_norm (taken before the update) at 1e-3 relative (bf16
    roundings in the gradients); the update as `_check_update` states."""
    assert bf16_step["metrics"]["grad_norm"] > OPT["gradient_clip_val"]
    for key, want in bf16_step["jax_metrics"].items():
        np.testing.assert_allclose(bf16_step["metrics"][key], want, rtol=1e-3, err_msg=key)
    _check_update(bf16_step["dp"], bf16_step["dp_ref"], bf16_step["g_ref"], OPT["lr"])


@pytest.mark.parametrize("planted", ["no_op", "signs_reversed", "half_step"])
def test_update_check_refuses_a_wrong_step(bf16_step, planted):
    """The update check fails on a step that leaves the parameters as they
    were, on one with every sign reversed and on one of half the size."""
    make = {"no_op": np.zeros_like, "signs_reversed": np.negative,
            "half_step": lambda a: a / 2}[planted]
    wrong = {n: make(bf16_step["dp_ref"][n]) for n in bf16_step["dp"]}
    with pytest.raises(AssertionError):
        _check_update(wrong, bf16_step["dp_ref"], bf16_step["g_ref"], OPT["lr"])


def test_bench_bf16_on_cpu_at_a_tiny_shape(capsys):
    result = bench.main(["--device", "cpu", "--precision", "bf16", "--batch", "1", "--length",
                         "64", "--d_model", "64", "--n_layer", "2", "--steps", "2",
                         "--windows", "1", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "hg38_trainstep_tokens_per_sec_L64_d64x2_bf16"
    assert line["precision"] == "bf16" and line["residual"] == "bf16" and line["value"] > 0
    assert len(line["window_step_ms"]) == 1 and line["window_step_ms"][0] == line["step_ms"]
    losses = result["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_bf16_model_with_float32_residual_matches_jax(monkeypatch):
    """bfloat16 activations with a float32 residual stream, as every hg38
    config sets (`precision: bf16`, `residual_in_fp32: true`): the add+LN
    takes the plain unit, never kernels D and D', and the logits match the
    JAX model's at the bf16 model tolerance."""
    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
               residual_in_fp32=True, embed_dropout=0.0)
    x = np.random.default_rng(4).integers(0, 12, size=(2, 64)).astype(np.int32)
    jm = JaxLM(layer=_layer(66), dtype=jnp.bfloat16, **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x))[0]
    pm = ConvLMHeadModel(layer=_layer(66), dtype=BF16, **cfg).eval()
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    monkeypatch.setattr(AL.AddLayerNorm, "apply", None)  # any use would raise
    with torch.inference_mode():
        logits = pm(torch.from_numpy(x).long())
    assert logits.dtype == BF16
    np.testing.assert_allclose(logits.float().numpy(), _np32(ref), rtol=0, atol=LOGIT_ATOL)
