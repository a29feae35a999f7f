"""The port's adaptive softmax (`models/adaptive_softmax.py`) and
`AdaptiveLMTask` against the JAX package, on the CPU, float32 (the cases
of tests/test_components.py's adaptive-softmax section).

JAX parameters (perturbed off their zero biases) go to the port with
`utils/convert.py`. Tolerances: embeddings and log-probabilities within
1e-5 of their max |value|; every parameter gradient within 1e-4 of its own
max |g|; the task's losses over 30 Adam steps within 1e-4 relative of the
JAX run's from the same initial parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import adaptive_softmax as JA
from hyena_dna_tpu.tasks.tasks import TASK_REGISTRY as JAX_TASKS
from hyena_dna_tpu_torch.models import adaptive_softmax as PA
from hyena_dna_tpu_torch.tasks.tasks import TASK_REGISTRY, AdaptiveLMTask, LMTask
from hyena_dna_tpu_torch.train.trainer import Trainer
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from hyena_dna_tpu_torch.utils.registry import MODEL_REGISTRY
from test_torch_port_attention import assert_close, assert_param_grads, perturbed
from test_torch_port_trainer import lm_config, one_torch_thread, tiny_genome

__all__ = ["one_torch_thread", "tiny_genome"]  # fixtures

OUT_TOL = 1e-5
KEY = jax.random.PRNGKey(0)
TOKENS = np.asarray([[1, 5, 9, 0], [11, 3, 7, 2]], np.int32)


def load(pm, params):
    pm.load_state_dict(flax_to_torch_state_dict(params))
    return pm


@pytest.mark.parametrize("div_val,d_embed", [(1, 16), (1, 8), (2, 16)])
def test_adaptive_embedding_matches_jax(div_val, d_embed):
    kw = dict(n_token=12, d_embed=d_embed, d_proj=8, cutoffs=[4, 8], div_val=div_val)
    jm = JA.AdaptiveEmbedding(**kw)
    params = perturbed(jm.init(KEY, jnp.asarray(TOKENS))["params"], 1)
    pm = load(PA.AdaptiveEmbedding(**kw), params)
    with torch.no_grad():
        out = pm(torch.from_numpy(TOKENS).long())
    assert out.shape == (2, 4, 8)
    assert_close(out, jm.apply({"params": params}, jnp.asarray(TOKENS)), OUT_TOL, "emb")


@pytest.mark.parametrize("cutoffs,div_val,d_embed", [([4, 8], 2, 16), ([4, 8], 1, 8), ([], 1, 8),
                                                     ([6], 2, 16)])
def test_projected_log_softmax_matches_jax(cutoffs, div_val, d_embed):
    """Normalised rows, the per-target NLL, and both against the JAX module."""
    kw = dict(n_token=12, d_embed=d_embed, d_proj=8, cutoffs=cutoffs, div_val=div_val)
    h = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    tgt = np.asarray([0, 3, 5, 7, 9, 11])
    jm = JA.ProjectedAdaptiveLogSoftmax(**kw)
    params = perturbed(jm.init(KEY, jnp.asarray(h), jnp.asarray(tgt))["params"], 2)
    pm = load(PA.ProjectedAdaptiveLogSoftmax(**kw), params)
    with torch.no_grad():
        lp = pm(torch.from_numpy(h))
        nll = pm(torch.from_numpy(h), torch.from_numpy(tgt))
    assert lp.shape == (6, 12)
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(6), rtol=1e-5, atol=1e-5)
    assert_close(lp, jm.apply({"params": params}, jnp.asarray(h)), OUT_TOL, "logprob")
    assert_close(nll, jm.apply({"params": params}, jnp.asarray(h), jnp.asarray(tgt)), OUT_TOL,
                 "nll")


def _models(tie_weights=True, tie_projs=None, div_val=2):
    kw = dict(n_token=12, d_model=16, cutoffs=[4, 8], div_val=div_val, tie_weights=tie_weights,
              tie_projs=tie_projs,
              backbone=dict(n_layers=1, layer={"_name_": "ff", "expand": 2}, residual="R",
                            norm="layer", track_norms=False))
    return JA.AdaptiveLMModel(**kw), PA.AdaptiveLMModel(**kw)


@pytest.mark.parametrize("tie_weights,tie_projs,div_val", [(True, None, 2), (False, None, 2),
                                                           (True, [True, False, True], 2),
                                                           (True, None, 1)])
def test_adaptive_lm_matches_jax(tie_weights, tie_projs, div_val):
    """Log-probs and every parameter gradient; the ties give the JAX
    parameter set (no `out_emb_*` when tied, `out_proj_i` only untied)."""
    jm, pm = _models(tie_weights, tie_projs, div_val)
    params = perturbed(jm.init(KEY, jnp.asarray(TOKENS))["params"], 3)
    assert {k for k in pm.state_dict() if "." not in k} == set(params) - {"core"}
    load(pm, params)
    ref, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(TOKENS))
    w = np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32)
    lp, state = pm(torch.from_numpy(TOKENS).long())
    assert state is None and lp.shape == (2, 4, 12)
    assert_close(lp.detach(), ref, OUT_TOL, "logprob")
    torch.testing.assert_close(lp.detach().exp().sum(-1), torch.ones(2, 4), rtol=1e-5,
                               atol=1e-5)
    (lp * torch.from_numpy(w)).sum().backward()
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(TOKENS))[0] * w)))(params)
    assert_param_grads(pm, grads)


def test_adaptive_lm_task_trains_and_matches_jax():
    """The registry's `adaptive_lm` model and task from the JAX model's
    initial parameters: 30 Adam steps (lr 1e-2) on both sides, every loss
    within 1e-4 relative, and the loss lower by more than 0.5 nats
    (tests/test_components.py::test_adaptive_lm_task_trains)."""
    import optax

    assert TASK_REGISTRY["adaptive_lm"] is AdaptiveLMTask and issubclass(AdaptiveLMTask, LMTask)
    kw = dict(n_token=12, d_model=16, cutoffs=[4, 8], div_val=2,
              backbone=dict(n_layers=1, layer={"_name_": "ff", "expand": 2}, track_norms=False))
    task_kw = dict(div_val=2, cutoffs=[4, 8], tie_weights=True, tie_projs=[False, True, True])
    task, jax_task = TASK_REGISTRY["adaptive_lm"](**task_kw), JAX_TASKS["adaptive_lm"](**task_kw)
    rng = np.random.default_rng(0)
    xn = rng.integers(0, 12, (4, 16)).astype(np.int32)
    yn = np.roll(xn, -1, axis=1)
    jm = JA.AdaptiveLMModel(**kw)
    params = jm.init(KEY, jnp.asarray(xn))["params"]
    model = load(MODEL_REGISTRY["adaptive_lm"](**kw), jax.tree_util.tree_map(np.asarray, params))
    tx = optax.adam(1e-2)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            return jax_task.compute_loss(jm.apply({"params": p}, jnp.asarray(xn))[0],
                                         jnp.asarray(yn))

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), opt, loss

    opt_state, ref = tx.init(params), []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state)
        ref.append(float(loss))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x, y = torch.from_numpy(xn).long(), torch.from_numpy(yn).long()
    losses = []
    for _ in range(30):
        opt.zero_grad()
        loss = task.compute_loss(model(x)[0], y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_adaptive_lm_through_the_trainer(tmp_path, tiny_genome):
    """`model._name_: adaptive_lm` and `task._name_: adaptive_lm` through the
    port's Trainer on the CPU: the dataset's vocabulary becomes `n_token`,
    the step takes the model's (log-probs, state), and two steps run."""
    fa, bed = tiny_genome
    cfg = lm_config(tmp_path / "run", fa, bed)
    cfg["model"] = {"_name_": "adaptive_lm", "d_model": 16, "cutoffs": [4, 8], "div_val": 2,
                    "backbone": {"n_layers": 1, "layer": {"_name_": "ff"}, "residual": "R",
                                 "norm": "layer"}}
    cfg["task"] = {"_name_": "adaptive_lm", "loss": "cross_entropy", "cutoffs": [4, 8]}
    cfg["trainer"].update(max_epochs=1, limit_train_batches=2)
    cfg["callbacks"] = {}
    trainer = Trainer(cfg, device="cpu")
    try:
        final = trainer.fit()
    finally:
        trainer.close()
    assert trainer.model.n_token == trainer.datamodule.vocab_size
    assert trainer.global_step == 2 and np.isfinite(final["test/loss"])


def test_adaptive_lm_takes_vocab_size_for_n_token():
    """The trainer gives every model its vocabulary as `vocab_size`: the
    adaptive LM reads it as `n_token`, an explicit `n_token` wins, and a
    model given neither raises."""
    kw = dict(d_model=16, cutoffs=[4, 8], div_val=2,
              backbone=dict(n_layers=1, layer=[{"_name_": "ff"}]))
    assert PA.AdaptiveLMModel(vocab_size=12, **kw).n_token == 12
    assert PA.AdaptiveLMModel(n_token=10, vocab_size=12, **kw).n_token == 10
    with pytest.raises(TypeError, match="n_token"):
        PA.AdaptiveLMModel(**kw)
