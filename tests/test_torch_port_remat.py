"""The port's activation checkpointing (`ops/remat.py`, `models/lm.py`), on the CPU.

Checkpointing only changes what the step stores, so the port's
checkpointed model is held to the port's plain model bit for bit (logits
and every gradient `torch.equal`), in every mode: block cells, residual
cells alone and in groups of 2 and 3 (3 leaves a ragged last group), with
the conv output and the filter bank saved or not, with a float32 or a
model-dtype residual, dropout off and on (one generator seed). Then the
runs per step that each policy implies (a counter on the conv forward, the
front end and the filter bank), the JAX remat model at the tolerance of
`tests/test_lm.py`, and the bench's new flags at a tiny shape.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM

from hyena_dna_tpu_torch import bench
from hyena_dna_tpu_torch.models.filters import HyenaFilter
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops import remat
from hyena_dna_tpu_torch.tasks.metrics import cross_entropy
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

N_LAYER, L = 4, 48
# (checkpoint_mixer, remat_residual_only, remat_group_size) of each mode
MODES = {"block": dict(checkpoint_mixer=True),
         "res_g1": dict(checkpoint_mixer=True, remat_residual_only=True),
         "res_g2": dict(checkpoint_mlp=True, remat_residual_only=True, remat_group_size=2),
         "res_g3": dict(checkpoint_mixer=True, remat_residual_only=True, remat_group_size=3)}
SAVES = {"conv": {}, "none": dict(remat_save_conv=False),
         "conv_filter": dict(remat_save_filter=True),
         "filter": dict(remat_save_conv=False, remat_save_filter=True)}


def _layer(l_max=L + 2):
    return dict(_name_="hyena", emb_dim=5, filter_order=16, short_filter_order=3,
                l_max=l_max, modulate=True, w=10)


def _model(dropout=False, residual_in_fp32=True, dtype=torch.float32, **kw):
    p = 0.1 if dropout else 0.0
    return ConvLMHeadModel(d_model=16, n_layer=N_LAYER, d_inner=64, vocab_size=12,
                           layer=_layer(), pad_vocab_size_multiple=8,
                           residual_in_fp32=residual_in_fp32, embed_dropout=p, resid_dropout=p,
                           generator=torch.Generator().manual_seed(0), dtype=dtype, **kw)


def _tokens(B=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(7, 12, size=(B, L + 1)))


def _step(model, tokens, seed=3):
    """Logits, every gradient and the generator's state after one
    forward and backward in training mode."""
    model.train()
    gen = torch.Generator().manual_seed(seed)
    logits = model(tokens[:, :-1], generator=gen)
    cross_entropy(logits, tokens[:, 1:]).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    return logits.detach(), grads, gen.get_state()


def _assert_equal(a, b):
    assert torch.equal(a[0], b[0]), "logits"
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name
    assert torch.equal(a[2], b[2]), "the caller's generator advanced differently"


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("residual_in_fp32", [True, False])
@pytest.mark.parametrize("save", list(SAVES))
@pytest.mark.parametrize("mode", list(MODES))
def test_remat_equals_plain(mode, save, residual_in_fp32, dropout):
    """Logits and every gradient the same bits as the plain model; the
    caller's generator ends in the same state."""
    tokens = _tokens()
    plain = _step(_model(dropout, residual_in_fp32), tokens)
    ckpt = _step(_model(dropout, residual_in_fp32, **MODES[mode], **SAVES[save]), tokens)
    _assert_equal(ckpt, plain)


def test_block_remat_equals_plain_in_bf16():
    """The bf16 model with a bf16 residual: block cells run `Block.forward`,
    so even the fused add + LN's gradients are the same bits."""
    tokens = _tokens()
    plain = _step(_model(True, False, torch.bfloat16), tokens)
    _assert_equal(_step(_model(True, False, torch.bfloat16, **MODES["block"]), tokens), plain)


@pytest.mark.parametrize("mode", ["block", "res_g2"])
def test_planted_generator_fault_is_caught(monkeypatch, mode):
    """A recompute that draws its dropout masks from a generator not
    restored to the cell's entry state must change the gradients."""
    tokens = _tokens()
    plain = _step(_model(True), tokens)
    monkeypatch.setattr(remat, "restored", lambda gen, state: torch.Generator().manual_seed(99))
    faulty = _step(_model(True, **MODES[mode]), tokens)
    assert torch.equal(faulty[0], plain[0])  # the forward itself is untouched
    assert not all(torch.equal(faulty[1][n], plain[1][n]) for n in plain[1])


def _counted(monkeypatch):
    """Counters on the conv forward (kernel B's wrapper), the front end's
    forward (kernel A's) and the filter bank."""
    counts = {"conv": 0, "front": 0, "filter": 0}

    def wrap(owner, attr, key):
        inner = getattr(owner, attr)

        def counted(*a, **k):
            counts[key] += 1
            return inner(*a, **k)

        monkeypatch.setattr(owner, attr, counted)

    wrap(FB, "fftconv_fused", "conv")
    wrap(FF, "front_fwd", "front")
    wrap(HyenaFilter, "filter", "filter")
    return counts


def _group_extra(group: int) -> int:
    """sum_j (g_j - 1) over the residual groups of an N_LAYER model."""
    if group == 1:
        return 0
    return sum(min(group, N_LAYER - i0) - 1 for i0 in range(0, N_LAYER, group))


@pytest.mark.parametrize("save", list(SAVES))
@pytest.mark.parametrize("mode", list(MODES))
def test_policy_counts(monkeypatch, mode, save):
    """Runs per step (models/lm.py): the front end 2n + sum_j (g_j - 1);
    the conv forward n when saved, else as the front end; the filter bank 2n
    when saved (its forward and its own backward), else as the front end."""
    counts = _counted(monkeypatch)
    kw = {**MODES[mode], **SAVES[save]}
    _step(_model(True, **kw), _tokens())
    fronts = 2 * N_LAYER + _group_extra(kw.get("remat_group_size", 1))
    assert counts == {"front": fronts,
                      "conv": N_LAYER if kw.get("remat_save_conv", True) else fronts,
                      "filter": 2 * N_LAYER if kw.get("remat_save_filter") else fronts}


def test_plain_counts_and_no_grad(monkeypatch):
    """Without checkpointing each runs once per layer; under no_grad a
    checkpointed model is a plain forward with the same logits."""
    counts = _counted(monkeypatch)
    _step(_model(), _tokens())
    assert counts == {"front": N_LAYER, "conv": N_LAYER, "filter": N_LAYER}
    x = _tokens()[:, :-1]
    with torch.no_grad():
        counts.update(dict.fromkeys(counts, 0))
        ckpt = _model(**MODES["res_g2"]).eval()(x)
        assert counts == {"front": N_LAYER, "conv": N_LAYER, "filter": N_LAYER}
        assert torch.equal(ckpt, _model().eval()(x))


def test_conv_under_a_saving_cell_takes_retransform(monkeypatch):
    """Where the conv's spectrum route would run (patched down to this
    size), a cell that saves the conv output takes the retransform route."""
    monkeypatch.setattr(FB, "_SPECTRUM_FFT_SIZES", (128,))
    routes = []
    inner = FB.fftconv_fused
    monkeypatch.setattr(FB, "fftconv_fused",
                        lambda u, k, D, save_spectrum=False: routes.append(save_spectrum)
                        or inner(u, k, D, save_spectrum))
    tokens = _tokens()
    plain = _step(_model(), tokens)
    assert routes == [True] * N_LAYER
    routes.clear()
    ckpt = _step(_model(**MODES["res_g1"]), tokens)
    assert routes == [False] * N_LAYER
    assert torch.equal(ckpt[0], plain[0])
    for name in plain[1]:  # the two backward routes sum in other orders
        torch.testing.assert_close(ckpt[1][name], plain[1][name], rtol=1e-4, atol=1e-6)


def test_second_backward_through_a_saving_cell_raises():
    model = _model(**MODES["res_g1"]).train()
    tokens = _tokens()
    loss = cross_entropy(model(tokens[:, :-1]), tokens[:, 1:])
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="already replayed"):
        loss.backward()


def test_remat_matches_jax():
    """The port's `ConvLMHeadModel(checkpoint_mixer=True,
    remat_residual_only=True, remat_group_size=2)` against the JAX one with
    the same knobs (d 16, 3 layers, float32 residual, dropout off), JAX
    parameters carried by `utils/convert.py`: logits and every gradient at
    2e-4, as tests/test_lm.py holds the JAX remat model to the plain one."""
    kw = dict(checkpoint_mixer=True, remat_residual_only=True, remat_group_size=2)
    cfg = dict(d_model=16, n_layer=3, d_inner=64, vocab_size=12, pad_vocab_size_multiple=8,
               residual_in_fp32=True, embed_dropout=0.0)
    tokens = np.random.default_rng(1).integers(7, 12, size=(2, L + 1)).astype(np.int32)
    jm = JaxLM(layer=_layer(), **cfg, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1]))["params"]
    rng = np.random.default_rng(2)  # nonzero biases, so they are tested
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens[:, :-1]))[0]
        return jnp.mean(logits ** 2), logits

    (_, ref_logits), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    pm = ConvLMHeadModel(layer=_layer(), **cfg, **kw)
    pm.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    logits = pm(torch.from_numpy(tokens[:, :-1]).long())
    logits.float().square().mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=2e-4,
                               atol=2e-4)
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads), buffers=False)
    assert set(dict(pm.named_parameters())) <= set(want)  # the shared Sin freq once
    for name, p in pm.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(ref).max(), 1e-30), err_msg=name)


BENCH_FLAGS = {
    "plain": [],
    "resf32": ["--residual", "fp32"],
    "block": ["--remat", "block"],
    "block_filter": ["--remat", "block", "--save_filter"],
    "res_g2": ["--remat", "residual", "--remat_group_size", "2"],
    "res_g1_noconv": ["--remat", "residual", "--no_save_conv"],
    "front4": ["--front4"],
}


def test_bench_flags_on_cpu(capsys):
    """Each new flag at a tiny shape: a distinct metric name, finite losses,
    and the JSON saying what ran."""
    names = set()
    for key, flags in BENCH_FLAGS.items():
        argv = ["--device", "cpu", "--precision", "bf16", "--batch", "1", "--length", "64",
                "--d_model", "16", "--n_layer", "3", "--steps", "1", "--windows", "1",
                "--warmup", "1"] + flags
        result = bench.main(argv)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metric"] == result["metric"] and line["peak_memory_gib"] is None
        assert all(np.isfinite(result["losses"]))
        assert line["residual"] == ("fp32" if key == "resf32" else "bf16")
        assert line["remat"] == (flags[1] if flags[:1] == ["--remat"] else "off")
        assert line["front4"] == (key == "front4")
        assert line["remat_save_filter"] == (key == "block_filter")
        assert line["remat_save_conv"] == (key != "res_g1_noconv")
        names.add(result["metric"])
    assert len(names) == len(BENCH_FLAGS)
    assert "hg38_trainstep_tokens_per_sec_L64_d16x3_bf16_resf32" in names
    assert "hg38_trainstep_tokens_per_sec_L64_d16x3_bf16_remat_residual_g2" in names
