"""The port's metrics and tasks held against the JAX package on seeded numpy
inputs: every device metric (float32 at 1e-5 relative), every host metric
(the JAX functions call scikit-learn here; the port's use none) and the
streaming host metrics, and the tasks' losses, device metrics and
perplexity statistics.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.tasks import metrics as JM
from hyena_dna_tpu.tasks import tasks as JT
from hyena_dna_tpu_torch.tasks import metrics as M
from hyena_dna_tpu_torch.tasks import tasks as T

RNG = np.random.default_rng(0)
N, C, SEQ = 24, 5, 8
LOGITS = RNG.standard_normal((3, SEQ, C)).astype(np.float32)
LABELS = RNG.integers(0, C, size=(3, SEQ)).astype(np.int64)
LABELS_IGN = np.where(RNG.random((3, SEQ)) < 0.25, -100, LABELS)


def _inputs(name):
    """(logits or outputs, targets, kwargs) for a metric of METRIC_FNS."""
    if name in ("binary_cross_entropy", "binary_accuracy"):
        return RNG.standard_normal((N, 1)).astype(np.float32), \
            RNG.integers(0, 2, N).astype(np.float32), {}
    if name in ("mse", "mae"):
        return RNG.standard_normal((N, 1)).astype(np.float32), \
            RNG.standard_normal(N).astype(np.float32), {}
    if name == "forecast_rmse":
        return RNG.standard_normal((4, 6, 2)).astype(np.float32), \
            RNG.standard_normal((4, 6, 2)).astype(np.float32), {}
    if name == "student_t":
        return RNG.standard_normal((N, 3)).astype(np.float32), \
            RNG.standard_normal((N, 1)).astype(np.float32), {}
    if name == "gaussian_ll":
        return RNG.standard_normal((N, 2)).astype(np.float32), \
            RNG.standard_normal((N, 1)).astype(np.float32), {}
    if name == "padded_cross_entropy":
        return LOGITS, LABELS, {"pad_mask": (RNG.random((3, SEQ)) < 0.3)}
    if name in ("last_k_ppl", "per_token_ppl"):
        kw = {"seq_len": SEQ, "k": 3} if name == "last_k_ppl" else {"seq_len": SEQ,
                                                                  "ks": [1, 4, 8]}
        return LOGITS, LABELS, kw
    if name.startswith("accuracy@"):
        return RNG.standard_normal((N, 16)).astype(np.float32), RNG.integers(0, 16, N), {}
    if name == "soft_cross_entropy":
        return LOGITS.reshape(-1, C), LABELS.reshape(-1), {"label_smoothing": 0.1}
    if name in ("cross_entropy", "accuracy_ignore_index"):
        return LOGITS, LABELS_IGN, {}
    return LOGITS, LABELS, {}


@pytest.mark.parametrize("name", sorted(JM.METRIC_FNS))
def test_device_metric_matches_jax(name):
    x, y, kw = _inputs(name)
    ref = np.asarray(JM.METRIC_FNS[name](jnp.asarray(x), jnp.asarray(y),
                                         **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                                else v) for k, v in kw.items()}))
    out = M.METRIC_FNS[name](torch.from_numpy(x), torch.from_numpy(y),
                             **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(JM.LOSS_METRIC_FNS))
def test_loss_metric_matches_jax(name):
    ref = JM.LOSS_METRIC_FNS[name](jnp.asarray(LOGITS), jnp.asarray(LABELS),
                                   loss_fn=JM.cross_entropy)
    out = M.LOSS_METRIC_FNS[name](torch.from_numpy(LOGITS), torch.from_numpy(LABELS),
                                  loss_fn=M.cross_entropy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def test_cross_entropy_stats_match_jax():
    ref = JM.cross_entropy_stats(jnp.asarray(LOGITS), jnp.asarray(LABELS_IGN))
    out = M.cross_entropy_stats(torch.from_numpy(LOGITS), torch.from_numpy(LABELS_IGN))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def _host_case(kind):
    rng = np.random.default_rng({"binary": 1, "ties": 2, "multi": 3, "absent": 4}[kind])
    n = 200
    if kind == "multi":
        return rng.standard_normal((n, 4)).astype(np.float32), rng.integers(0, 4, n)
    if kind == "absent":  # class 2 of 4 never occurs, class 3 never predicted
        logits = rng.standard_normal((n, 4)).astype(np.float32)
        logits[:, 3] = -9.0
        return logits, rng.choice([0, 1, 3], n)
    logits = rng.standard_normal((n, 2)).astype(np.float32)
    if kind == "ties":
        logits = np.round(logits, 1)
    y = (rng.random(n) < 1 / (1 + np.exp(-(logits[:, 1] - logits[:, 0])))).astype(np.int64)
    return logits, y


@pytest.mark.parametrize("name", sorted(JM.HOST_METRIC_FNS))
@pytest.mark.parametrize("kind", ["binary", "ties", "multi", "absent"])
def test_host_metric_matches_jax(name, kind):
    """Against the JAX host metrics, which call scikit-learn here."""
    logits, y = _host_case(kind)
    if name == "f1_binary" and kind in ("multi", "absent"):
        return  # scikit-learn's binary f1 refuses a multiclass target
    if name.startswith("roc_auc") and kind in ("multi", "absent"):
        return  # softmax class 1 against a multiclass target: scikit-learn refuses
    ref = JM.HOST_METRIC_FNS[name](logits, y)
    assert abs(M.HOST_METRIC_FNS[name](logits, y) - ref) <= 1e-9, (name, kind)


@pytest.mark.parametrize("names,kind", [
    (["mcc", "f1_binary", "f1_macro", "f1_micro", "accuracy_host", "roc_auc_macro"], "binary"),
    (["mcc", "f1_macro", "f1_micro", "accuracy_host"], "multi")])
def test_streaming_host_metrics_match_jax(names, kind):
    logits, y = _host_case(kind)
    ours, ref = M.StreamingHostMetrics(names), JM.StreamingHostMetrics(names)
    for i in range(0, len(y), 64):
        ours.update(logits[i:i + 64], y[i:i + 64])
        ref.update(logits[i:i + 64], y[i:i + 64])
    assert ours.compute() == ref.compute()
    np.testing.assert_array_equal(ours.confusion_matrix, ref.confusion_matrix)


def test_streaming_host_metrics_multilabel_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 6)).astype(np.float32)
    y = (rng.random((64, 6)) < 0.3).astype(np.float32)
    names = ["auroc_macro", "auroc_median", "f1_macro", "f1_micro"]
    ours, ref = M.StreamingHostMetrics(names), JM.StreamingHostMetrics(names)
    ours.update(logits, y)
    ref.update(logits, y)
    assert ours.compute() == ref.compute() and ours.confusion_matrix is None


def test_roc_auc_needs_both_classes():
    with pytest.raises(ValueError, match="both classes"):
        M.roc_auc_macro(np.zeros((4, 2), np.float32), np.ones(4, np.int64))


@pytest.mark.parametrize("task,kw,y", [
    ("hg38", {"last_k_ppl": 3, "per_token_ppl": [1, 8], "seq_len": SEQ}, LABELS),
    ("lm", {"metrics": ["accuracy", "ppl", "bpb", "loss"]}, LABELS_IGN),
    ("multiclass", {"metrics": ["accuracy", "accuracy@3"], "host_metrics": ["mcc"]},
     LABELS[:, :1]),
    ("icl", {"metrics": ["accuracy", "ppl"]}, LABELS[:, :1])])
def test_task_matches_jax(task, kw, y):
    logits = LOGITS[:, 0] if task == "multiclass" else LOGITS
    jt, pt = JT.TASK_REGISTRY[task](**kw), T.TASK_REGISTRY[task](**kw)
    assert pt.metric_names == jt.metric_names
    assert pt.host_metric_names == jt.host_metric_names
    xj, yj, xt, yt = jnp.asarray(logits), jnp.asarray(y), torch.from_numpy(logits), \
        torch.from_numpy(y)
    np.testing.assert_allclose(pt.compute_loss(xt, yt).numpy(),
                               np.asarray(jt.compute_loss(xj, yj)), rtol=1e-5)
    ref = jt.compute_metrics(xj, yj)
    for name, val in pt.compute_metrics(xt, yt).items():
        np.testing.assert_allclose(val.numpy(), np.asarray(ref[name]), rtol=1e-5, err_msg=name)
    stats, ref_stats = pt.loss_stats(xt, yt), jt.loss_stats(xj, yj)
    if ref_stats is None:
        assert stats is None
    else:
        for a, b in zip(stats, ref_stats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("name", ["adaptive_lm"])
def test_unported_tasks_raise(name):
    """No task of the JAX registry is left unported: the name that raised
    builds now (tests/test_torch_port_adaptive.py holds it to JAX), and the
    two registries hold the same names."""
    assert isinstance(T.TASK_REGISTRY[name](), T.LMTask)
    assert set(T.TASK_REGISTRY) == set(JT.TASK_REGISTRY)


def test_port_imports_no_sklearn_jax_or_reference():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    hyena_dna_tpu or sklearn (import statements, parsed)."""
    root = Path(__file__).resolve().parents[1]
    files = list((root / "hyena_dna_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    banned = {"jax", "flax", "hyena_dna_tpu", "sklearn", "optax", "orbax"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, f"{path}: imports {mod}"
