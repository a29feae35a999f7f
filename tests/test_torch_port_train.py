"""The port's training path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's
counterpart; the port's wrappers, given CPU tensors, run their kernels'
plain versions (`reference_bwd`, `fftconv_bwd_ref` and the spectrum route's
plain math). Where the JAX function is a Pallas kernel it runs in interpret
mode, as the JAX package's own tests run it, with the tolerances of those
tests. Whole-model gradients and train steps carry the JAX parameters,
gradients and updated parameters to the port's names with
`utils/convert.py::flax_to_torch_state_dict`.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyena_dna_tpu.ops.fftconv  # noqa: F401  (module registration)
import hyena_dna_tpu.ops.pallas_fftconv as PF
import hyena_dna_tpu.ops.pallas_fftconv_n3 as PO
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.ops.pallas_hyena import _reference_fwd, fused_proj_conv_gate
from hyena_dna_tpu.tasks import LMTask as JaxLMTask
from hyena_dna_tpu.train import build_optimizer as jax_build_optimizer
from hyena_dna_tpu.train import create_train_state as jax_create_train_state
from hyena_dna_tpu.train import label_params as jax_label_params
from hyena_dna_tpu.train.step import make_train_step as jax_make_train_step

from hyena_dna_tpu_torch import bench
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops.fftconv import fftconv as port_fftconv
from hyena_dna_tpu_torch.tasks import LMTask
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.train import (build_optimizer, create_train_state, label_params,
                                       make_train_step)
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

JF = sys.modules["hyena_dna_tpu.ops.fftconv"]
GRAD_NAMES = ("du", "dw", "dbp", "dwc", "dbc")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _front_inputs(B, L, D, seed):
    """Inputs and cotangents at the scales of tests/test_pallas_hyena.py."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * 0.1).astype(np.float32)
    bp = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    wc = rng.normal(size=(3, 3 * D)).astype(np.float32)
    bc = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    dvx = rng.normal(size=(B, D, L)).astype(np.float32)
    dx0 = rng.normal(size=(B, D, L)).astype(np.float32)
    return (u, w, bp, wc, bc), (dvx, dx0)


def _assert_front_grads(ours, ref):
    for a, b, name in zip(ours, ref, GRAD_NAMES):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-3, rtol=1e-3,
                                   err_msg=name)


# (a) the front end's backward: kernel A''s plain version and the Function

@pytest.mark.parametrize("L,tile", [(128, 32), (96, 32)])
def test_front_bwd_matches_pallas_vjp(L, tile):
    """Several length tiles (the Pallas backward walks them right to left
    and carries two dconv rows across each boundary)."""
    args, (dvx, dx0) = _front_inputs(2, L, 16, seed=L)
    _, vjp = jax.vjp(lambda *a: fused_proj_conv_gate(*a, tile, True), *map(jnp.asarray, args))
    ref = vjp((jnp.asarray(dvx), jnp.asarray(dx0)))
    _assert_front_grads(FF.reference_bwd(*map(_t, args), _t(dvx), _t(dx0)), ref)
    inputs = [_t(a).requires_grad_() for a in args]
    vx, x0 = FF.fused_proj_conv_gate(*inputs)
    torch.autograd.backward((vx, x0), (_t(dvx), _t(dx0)))
    _assert_front_grads([t.grad for t in inputs], ref)


@pytest.mark.parametrize("L", [77, 2, 1])
def test_front_bwd_ragged_length_matches_jax(L):
    """Kernel A' takes any L; the Pallas kernel needs L % 32 == 0, so a
    ragged L is held against jax.vjp of the JAX `_reference_fwd`."""
    args, (dvx, dx0) = _front_inputs(3, L, 8, seed=L + 1)
    _, vjp = jax.vjp(_reference_fwd, *map(jnp.asarray, args))
    ref = vjp((jnp.asarray(dvx), jnp.asarray(dx0)))
    _assert_front_grads(FF.reference_bwd(*map(_t, args), _t(dvx), _t(dx0)), ref)


# (b) the conv's backward: kernel C's plain versions on both routes

def _conv_data(B, C, L, Lk=None, seed=0):
    rng = np.random.default_rng(seed)
    Lk = Lk or L
    u = rng.normal(size=(B, C, L)).astype(np.float32)
    k = (rng.normal(size=(C, Lk)) * np.exp(-np.arange(Lk) / max(16, Lk // 8))).astype(np.float32)
    D = rng.normal(size=(C,)).astype(np.float32)
    dy = rng.normal(size=(B, C, L)).astype(np.float32)
    return u, k, D, dy


def _port_bwd_both_routes(u, k, D, dy):
    """(du, dk, dD) of the retransform and the spectrum route's plain versions."""
    u, k, D, dy = map(_t, (u, k, D, dy))
    spec = FB.pair_spectrum_ref(u, JF.next_fast_fft_size(2 * u.shape[-1]))
    return {"retransform": FB.fftconv_bwd_retransform(u, dy, k, D),
            "spectrum": FB.fftconv_bwd_spectrum(spec, dy, k, D)}


def _assert_conv_grads(ours, ref, scaled=(), **tol):
    """du, dk, dD; those named in `scaled` relative to their largest entry."""
    for a, b, name in zip(ours, ref, ("du", "dk", "dD")):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        s = float(np.abs(b).max()) if name in scaled else 1.0
        np.testing.assert_allclose(a / s, b / s, err_msg=name, **tol)


@pytest.mark.parametrize("B,C,L,Lk", [(1, 3, 100, 100), (2, 4, 96, 40), (3, 5, 300, 300),
                                      (2, 2, 64, 64)])
def test_conv_bwd_matches_jax_vjp(B, C, L, Lk):
    """Odd and even B and C; Lk < L (a filter cut to `l_max`)."""
    u, k, D, dy = _conv_data(B, C, L, Lk, seed=L + B)
    _, vjp = jax.vjp(lambda *a: JF.fftconv(*a, False), *map(jnp.asarray, (u, k, D)))
    ref = vjp(jnp.asarray(dy))
    for route, ours in _port_bwd_both_routes(u, k, D, dy).items():
        assert ours[1].shape == (C, Lk), route
        _assert_conv_grads(ours, ref, rtol=1e-4, atol=1e-4)
    # through the autograd Function, as the model calls it
    ut, kt, Dt = (_t(a).requires_grad_() for a in (u, k, D))
    port_fftconv(ut, kt, Dt).backward(_t(dy))
    _assert_conv_grads((ut.grad, kt.grad, Dt.grad), ref, rtol=1e-4, atol=1e-4)


def test_conv_bwd_bf16_io_matches_jax():
    """bf16 conv I/O as in the model from L = 2^15: du and dk come back in
    bf16 (dy's and k's dtype), dD in float32, as the JAX VJP casts them."""
    u, k, D, dy = _conv_data(2, 3, 200, 150, seed=7)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (u, k)]
    _, vjp = jax.vjp(lambda u, k: JF.fftconv(u, k, jnp.asarray(D), False), *bf)
    rdu, rdk = vjp(jnp.asarray(dy, jnp.bfloat16))
    ours = FB.fftconv_bwd_ref(*(_t(a).bfloat16() for a in (u, dy, k)), _t(D))
    assert [t.dtype for t in ours] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for a, b in ((ours[0], rdu), (ours[1], rdk)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, atol=2e-2 * np.abs(b).max(), rtol=2e-2)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX conv's Pallas routes in interpret mode at fft 4096, f32 dots
    and spectra (the structure check of tests/test_fftconv.py)."""
    monkeypatch.setattr(JF, "_use_mxu_fft", lambda n, rows=1: n >= 4096)
    monkeypatch.setattr(JF, "MXU_SPECTRUM_DTYPE", None)
    monkeypatch.setattr(JF, "PALLAS_FFTCONV_INTERPRET", True)
    monkeypatch.setattr(JF, "PALLAS_PACK_BATCH", True)
    monkeypatch.setitem(PF._CB_BY_N, 4096, 2)
    monkeypatch.setenv("HYENA_PALLAS_SAVE_SPEC_MAX", str(1 << 29))
    for mod in (PF, PO):
        monkeypatch.setattr(mod, "_STORE_DTYPE", jnp.float32)
        monkeypatch.setattr(mod, "_DOT_DTYPE", jnp.float32)


def test_conv_bwd_matches_pallas_packed_spectrum(pallas_interpret):
    """The TPU's saved-spectrum packed backward (even B at fft 4096 here,
    2^16 on the chip), tolerances of tests/test_fftconv.py."""
    u, k, D, dy = _conv_data(2, 4, 2048, seed=31)
    k *= 0.05
    args = tuple(map(jnp.asarray, (u, k, D)))
    assert JF._pallas_conv_plan(args[0], args[1], 4096, False) == (64, 64, 2)
    _, vjp = jax.vjp(lambda *a: JF.fftconv(*a, False), *args)
    ref = vjp(jnp.asarray(dy))
    for ours in _port_bwd_both_routes(u, k, D, dy).values():
        _assert_conv_grads(ours, ref, atol=5e-2, rtol=5e-3)


@pytest.mark.parametrize("plan,B,C", [((16, 32, 32), 3, 2), ((8, 32, 64), 1, 2)])
def test_conv_bwd_matches_pallas_outer(plan, B, C, pallas_interpret):
    """The TPU's outer-radix backward (fft 2^17-2^21 on the chip), at the
    small plans and tolerances of tests/test_fftconv_outer.py."""
    n1, r, m = plan
    u, k, D, dy = _conv_data(B, C, n1 * r * m // 2, seed=1)
    ref = PO.fftconv_outer_bwd(*map(jnp.asarray, (u, dy, k, D)), n1, r, m, interpret=True)
    ours = _port_bwd_both_routes(u, k, D, dy)["retransform"]
    _assert_conv_grads(ours[:2], ref[:2], scaled=("dk",), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=2e-4, atol=1e-3)


def test_spectrum_routing_mirrors_jax():
    """Which shapes save u's spectrum for the backward."""
    assert FB.saves_spectrum(4, 256, 32768)      # fft 2^16, even B (packed)
    assert FB.saves_spectrum(1, 256, 32768)      # fft 2^16, odd B (unpacked)
    assert FB.saves_spectrum(2, 256, 131072)     # fft 2^18, even B (split backward)
    assert not FB.saves_spectrum(1, 256, 131072)  # fft 2^18, odd B: outer route
    assert not FB.saves_spectrum(3, 256, 65536)   # fft 2^17, odd B: outer route
    assert not FB.saves_spectrum(2, 256, 8192)    # below 2^16: nothing saved
    assert not FB.saves_spectrum(2, 256, 1 << 19)  # fft 2^20: outer route
    assert not FB.saves_spectrum(64, 256, 32768)  # over the byte cap


def test_tpu_row_entries_take_their_routes():
    """Each backward Pallas entry of the JAX package has a torch entry point
    on kernel C's route, taking the shapes the JAX routing gave it. dk and
    dD sum 2 x 32768 products: held at 1e-4 of their largest entry."""
    u, k, D, dy = map(_t, _conv_data(2, 3, 32768, seed=5))  # fft 2^16, even B
    ref = FB.fftconv_bwd_ref(u, dy, k, D)
    spec = FB.pair_spectrum_ref(u, 1 << 16)
    for entry, x in ((FB.fftconv_fused_bwd_spec_packed, spec), (FB.fftconv_fused_bwd_packed, u)):
        assert entry.spectrum == (x is spec)
        _assert_conv_grads(entry(x, dy, k, D), ref, ("dk", "dD"), rtol=1e-4, atol=1e-4)
    for entry, x in ((FB.fftconv_fused_bwd_spec, spec), (FB.fftconv_fused_bwd, u),
                     (FB.fftconv_fused_bwd_split, spec), (FB.fftconv_outer_bwd, u)):
        with pytest.raises(ValueError, match=entry.__name__):
            entry(x, dy, k, D)  # odd B only, or another fft size
    _assert_conv_grads(FB.fftconv_fused_bwd(u[:1], dy[:1], k, D),
                       FB.fftconv_bwd_ref(u[:1], dy[:1], k, D), ("dk", "dD"), rtol=1e-4,
                       atol=1e-4)


# (c) the whole model's gradients; (d) the train step; (e) the labels

def _layer(l_max, **extra):
    return dict(_name_="hyena", emb_dim=5, filter_order=16, short_filter_order=3,
                l_max=l_max, modulate=True, w=10, **extra)


def _models(d_model=32, n_layer=2, L=256, B=2, seed=0, pallas=True):
    cfg = dict(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model, vocab_size=12,
               pad_vocab_size_multiple=8, residual_in_fp32=True, embed_dropout=0.0)
    tokens = np.random.default_rng(seed).integers(0, 12, size=(B, L + 1)).astype(np.int32)
    extra = dict(use_pallas_front=True, pallas_interpret=True) if pallas else {}
    jm = JaxLM(layer=_layer(L + 2, **extra), **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens[:, :-1]))["params"]
    # the JAX init leaves biases at zero; make them nonzero so they are tested
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = ConvLMHeadModel(layer=_layer(L + 2), **cfg)
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm, tokens[:, :-1], tokens[:, 1:]


def _named(tree):
    """A params-shaped JAX tree under the port's parameter names."""
    return flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, tree), buffers=False)


def _assert_named_close(port: dict, jax_tree, rel: float, what: str):
    ref = _named(jax_tree)
    for name, val in port.items():
        want = ref[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(val.detach().numpy(), want, rtol=rel, atol=rel * scale,
                                   err_msg=f"{what} {name}")


def test_model_grads_match_jax():
    """Every parameter's gradient of the LM loss (d=32, 2 layers, L=256,
    dropout 0; the JAX front through its Pallas VJP in interpret mode), at
    2e-4 of each gradient's largest entry."""
    jm, params, pm, x, y = _models()

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), deterministic=False)[0]
        return JaxLMTask().compute_loss(logits, jnp.asarray(y))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    pm.train()
    loss = cross_entropy(pm(torch.from_numpy(x).long()), torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert all(g is not None for g in grads.values())
    _assert_named_close(grads, ref_grads, 2e-4, "grad")


SCHED = {"_name_": "cosine_warmup_timm", "t_initial": 10, "warmup_t": 2,
         "warmup_lr_init": 1e-4}
OPT = dict(lr=1e-3, weight_decay=0.1, scheduler=SCHED, gradient_clip_val=0.05)


@pytest.mark.parametrize("steps,accum", [(1, 1), (3, 1), (3, 2)])
def test_train_steps_match_jax(steps, accum):
    """One and three AdamW steps (timm cosine with warmup; a clip low enough
    to engage), with and without in-step accumulation. Loss and grad_norm
    at 1e-4; parameters within 1e-2 of one step's lr, since Adam's first
    steps move a parameter by about lr whatever its gradient's size."""
    jm, params, pm, x, y = _models(L=128, seed=3, pallas=False)
    tx, _ = jax_build_optimizer(params, **OPT)
    jstate = jax_create_train_state(jm, tx, jax.random.PRNGKey(0), jnp.asarray(x), params=params)
    jstep = jax_make_train_step(JaxLMTask(), accumulate_grad_batches=accum)
    optimizer, _ = build_optimizer(pm, **OPT)
    state = create_train_state(pm, optimizer)
    step = make_train_step(LMTask(), accumulate_grad_batches=accum)
    xb, yb = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    for i in range(steps):
        jstate, jm_metrics = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(i))
        metrics = step(state, (xb, yb), torch.Generator().manual_seed(i))
        assert metrics["grad_norm"].item() > OPT["gradient_clip_val"]  # the clip engaged
        for key in ("loss", "grad_norm", "nll_sum", "token_count"):
            np.testing.assert_allclose(metrics[key].item(), float(jm_metrics[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == steps
    ref = _named(jstate.params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0,
                                   atol=1e-2 * OPT["lr"], err_msg=name)


def test_labels_match_jax():
    _, params, pm, _, _ = _models(L=32, pallas=False)
    names = ("main", "no_decay", "filter", "pos_emb", "modulation")
    jl = jax_label_params(params)
    coded = jax.tree_util.tree_map(lambda lab, p: np.full(p.shape, names.index(lab), np.float32),
                                   jl, jax.tree_util.tree_map(np.asarray, params))
    ref = {n: names[int(t.flatten()[0])] for n, t in _named(coded).items()}
    ours = label_params(pm)
    assert ours == {n: ref[n] for n in ours}
    assert set(ours.values()) == set(names)


def test_dropout_is_seeded_and_off_in_eval():
    """One generator seed gives one loss; eval mode ignores dropout."""
    model = ConvLMHeadModel(d_model=16, n_layer=2, d_inner=64, vocab_size=12,
                            pad_vocab_size_multiple=8, layer=_layer(66, dropout=0.2),
                            resid_dropout=0.1, embed_dropout=0.1,
                            generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 12, size=(2, 64)))
    model.train()
    a, b, c = (model(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(x, torch.Generator().manual_seed(1)),
                       model(x, torch.Generator().manual_seed(2)))


# (f) the bench entry point

def test_bench_runs_on_cpu_at_a_tiny_shape(capsys):
    result = bench.main(["--device", "cpu", "--batch", "1", "--length", "64", "--d_model",
                         "16", "--n_layer", "1", "--steps", "2", "--windows", "1",
                         "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "hg38_trainstep_tokens_per_sec_L64_d16x1_fp32"
    assert line["unit"] == "tokens/s" and line["precision"] == "fp32" and line["value"] > 0
    assert "vs_baseline" not in line
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))


def test_bench_bf16_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.main(["--device", "cpu", "--precision", "bf16"])
