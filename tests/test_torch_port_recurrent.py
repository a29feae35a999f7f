"""The port's modal distillation and recurrent stepper (`ops/modal.py`,
`recurrent.py`) against the JAX package, on the CPU.

The JAX model's parameters go to the port through `utils/convert.py`. The
port's distillation is held to the JAX one by each filter's modal
reconstruction (the poles' order out of `eigvals` is not stable), within
1e-4 of max|k|. Fed the JAX distillation's poles, the port's `step`,
`prefill` and `prefill_parallel` match the JAX ones within 1e-5 of
max|logit| and of each state's max|s|. The JAX package's own recurrent
properties (tests/test_recurrent.py, tests/test_recurrent_drift.py) are
mirrored in the port with their tolerances.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM
from hyena_dna_tpu.ops import modal as jax_modal
from hyena_dna_tpu.recurrent import distill as jax_distill

from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.ops import modal
from hyena_dna_tpu_torch.recurrent import RecurrentLM, distill, fit_banks
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

L = 128
GOLDEN = Path(__file__).parent / "golden" / "recurrent_drift.npz"


def _lm_kwargs(d_model, n_layer, l_max, filter_order=32):
    return dict(d_model=d_model, n_layer=n_layer, d_inner=4 * d_model, vocab_size=12,
                pad_vocab_size_multiple=8, residual_in_fp32=True,
                layer=dict(_name_="hyena", emb_dim=5, filter_order=filter_order,
                           short_filter_order=3, l_max=l_max, w=10, modulate=True))


@pytest.fixture(scope="module")
def models():
    """tests/test_recurrent.py's model (d 24, 2 layers, L 128) on both sides,
    with nonzero biases so that every term is tested."""
    kw = _lm_kwargs(24, 2, L)
    jm = JaxLM(embed_dropout=0.0, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = ConvLMHeadModel(embed_dropout=0.0, **kw).eval()
    pm.load_state_dict(flax_to_torch_state_dict(params))
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm


@pytest.fixture(scope="module")
def distilled(models):
    jm, params, pm = models
    return jax_distill(jm, params, n_modes=48, fit_len=L), distill(pm, n_modes=48, fit_len=L)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(7, 11, size=shape).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_modal_fit_is_the_jax_fit():
    """tests/test_recurrent.py's filter: the same numpy code, the same result."""
    t = np.arange(256)
    k = np.stack([np.exp(-t / 30.0) * np.cos(0.2 * t),
                  np.exp(-t / 80.0) * (np.sin(0.05 * t) + 0.3 * np.cos(0.4 * t))])
    lam, c = modal.fit_modal_filters(k, 16)
    ref_lam, ref_c = jax_modal.fit_modal_filters(k, 16)
    np.testing.assert_array_equal(lam, ref_lam)
    np.testing.assert_array_equal(c, ref_c)
    rec = modal.modal_reconstruction(lam, c, 256)
    np.testing.assert_array_equal(rec, jax_modal.modal_reconstruction(ref_lam, ref_c, 256))
    assert np.abs(rec - k).max() / np.abs(k).max() < 1e-6
    assert np.abs(lam).max() <= 1.0 + 1e-6


def test_distillation_reconstructions_match_jax(models, distilled):
    jrec, prec = distilled
    assert prec.n_layer == 2 and prec.order == 2 and prec.short_k == 3

    def reconstruction(lam, c):
        lam, c = np.asarray(lam), np.asarray(c)
        return modal.modal_reconstruction(lam[..., 0] + 1j * lam[..., 1],
                                          c[..., 0] + 1j * c[..., 1], L)

    for i in range(prec.n_layer):
        for g in range(prec.order - 1):
            ref = reconstruction(jrec.lam_ri[i][g], jrec.c_ri[i][g])
            got = reconstruction(prec.lam[i][g].numpy(), prec.c[i][g].numpy())
            assert _rel(got, ref) < 1e-4, (i, g)
    np.testing.assert_allclose(prec.fit_rel_err, jrec.fit_rel_err, rtol=0.2, atol=1e-4)


def test_fit_in_worker_processes_gives_the_same_fits():
    """`fit_banks` with the channels of two banks split over two spawned
    processes gives the serial fits' reconstructions (1e-6 of max|k|: BLAS
    on one thread may round otherwise)."""
    t = np.arange(L)
    rng = np.random.default_rng(4)
    banks = [np.stack([np.exp(-t / rng.uniform(10, 60)) * np.cos(rng.uniform(0, 0.5) * t)
                       for _ in range(n)]) for n in (5, 3)]
    for (lam_p, c_p), (lam_s, c_s), k in zip(fit_banks(banks, 16, L, workers=2),
                                             fit_banks(banks, 16, L, workers=1), banks):
        got = modal.modal_reconstruction(lam_p, c_p, L)
        assert _rel(got, modal.modal_reconstruction(lam_s, c_s, L)) < 1e-6
        assert _rel(got, k) < 1e-4


def test_recurrent_on_jax_poles_matches_jax(models, distilled):
    """RecurrentLM built from the JAX distillation's lam / c: step logits
    over a short sequence, the sequential prefill and the parallel prefill
    (logits and every state) within 1e-5."""
    jm, params, pm = models
    jrec, _ = distilled
    rec = RecurrentLM(pm, [np.array(x) for x in jrec.lam_ri], [np.array(x) for x in jrec.c_ri])
    toks = _tokens(2, (2, 24))
    t = torch.from_numpy(toks).long()

    st_j, st_p = jrec.init_state(2), rec.init_state(2)
    for j in range(6):
        st_j, lg_j = jrec.step(st_j, jnp.asarray(toks[:, j]))
        st_p, lg_p = rec.step(st_p, t[:, j])
        assert _rel(lg_p.numpy(), lg_j) < 1e-5, j

    for name in ("prefill", "prefill_parallel"):
        st_j, lg_j = getattr(jrec, name)(jrec.init_state(2), jnp.asarray(toks))
        st_p, lg_p = getattr(rec, name)(rec.init_state(2), t)
        assert _rel(lg_p.numpy(), lg_j) < 1e-5, name
        for i in range(rec.n_layer):
            for key in ("sc", "s"):
                assert _rel(st_p["layers"][i][key].numpy(), st_j["layers"][i][key]) < 1e-5, \
                    (name, i, key)
        assert _rel(st_p["residual"].numpy(), st_j["residual"]) < 1e-5, name


def test_recurrent_logits_match_parallel(models, distilled):
    """tests/test_recurrent.py:45 in the port: the stepper's logits within
    5e-2 of the parallel forward's, with the same argmax everywhere."""
    _, _, pm = models
    _, rec = distilled
    assert rec.fit_rel_err < 2e-2, rec.fit_rel_err
    t = torch.from_numpy(_tokens(1, (2, 48))).long()
    with torch.inference_mode():
        ref = pm(t)
    state, logits = rec.init_state(2), []
    for j in range(t.shape[1]):
        state, lg = rec.step(state, t[:, j])
        logits.append(lg)
    logits = torch.stack(logits, dim=1)
    assert _rel(logits.numpy(), ref.numpy()) < 5e-2
    torch.testing.assert_close(logits.argmax(-1), ref.argmax(-1), rtol=0, atol=0)


def test_recurrent_generate_matches_full_forward(models, distilled):
    """tests/test_recurrent.py:71 in the port: greedy tokens of the stepper
    equal greedy tokens of repeated full forwards."""
    _, _, pm = models
    _, rec = distilled
    prompt = torch.tensor([[7, 8, 9, 10, 7, 8]])
    out = rec.generate(prompt, 16)
    assert out.shape == (1, 22)
    buf = prompt
    with torch.inference_mode():
        for _ in range(16):
            buf = torch.cat([buf, pm(buf)[:, -1].argmax(-1, keepdim=True)], dim=1)
    torch.testing.assert_close(out, buf, rtol=0, atol=0)


def test_parallel_prefill_matches_scan(distilled):
    """tests/test_recurrent.py:92 in the port: the closed-form prefill
    state and logits equal the sequential scan's within 1e-4, and greedy
    continuations agree."""
    _, rec = distilled
    t = torch.from_numpy(_tokens(3, (2, 48))).long()
    st_scan, lg_scan = rec.prefill(rec.init_state(2), t)
    st_par, lg_par = rec.prefill_parallel(rec.init_state(2), t)
    for i in range(rec.n_layer):
        for key in ("sc", "s"):
            assert _rel(st_par["layers"][i][key].numpy(), st_scan["layers"][i][key].numpy()) \
                < 1e-4, (i, key)
    assert _rel(lg_par.numpy(), lg_scan.numpy()) < 1e-4
    torch.testing.assert_close(rec.generate(t, 8, parallel_prefill=False),
                               rec.generate(t, 8), rtol=0, atol=0)


def _unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _ppl(logits, targets):
    lg = np.asarray(logits, np.float64)
    lg = lg - lg.max(-1, keepdims=True)
    lp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
    return float(np.exp(-np.take_along_axis(lp, targets[..., None], axis=-1).mean()))


def test_trained_checkpoint_distillation_drift():
    """tests/test_recurrent_drift.py in the port alone: on a trained
    checkpoint (d 128 x 2, L 1024) the distilled stepper's held-out
    perplexity is within 0.1% of the parallel forward's at P = 64 (its 256
    channels fitted in two worker processes)."""
    z = np.load(GOLDEN)
    params = _unflatten({k[3:]: z[k] for k in z.files if k.startswith("p::")})
    tokens = z["tokens"].astype(np.int64)
    x, y = torch.from_numpy(tokens[:, :-1]), tokens[:, 1:]
    pm = ConvLMHeadModel(**_lm_kwargs(128, 2, 1026, filter_order=64)).eval()
    pm.load_state_dict(flax_to_torch_state_dict(params))
    with torch.inference_mode():
        ppl_par = _ppl(pm(x).numpy(), y)
    assert 2.0 < ppl_par < 4.2
    rec = distill(pm, n_modes=64)
    assert rec.fit_rel_err < 0.15
    state, logits = rec.init_state(x.shape[0]), []
    for j in range(x.shape[1]):
        state, lg = rec.step(state, x[:, j])
        logits.append(lg)
    ppl_rec = _ppl(torch.stack(logits, 1).numpy(), y)
    assert abs(ppl_rec - ppl_par) / ppl_par < 1e-3
