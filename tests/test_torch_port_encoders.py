"""The port's input encoders (`tasks/encoders.py`) held against the JAX
package's on the CPU: each encoder built on both sides, the JAX initial
parameters carried into the port by
`utils/convert.py::flax_encoder_to_torch_state_dict`, the same seeded numpy
inputs through both, outputs within 2e-4 of max|y| (float32, PERF.md
section 2); plus the registry names, the auto-wiring tables, and the
behaviours `tests/test_components.py` checks on the JAX encoders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.tasks import encoders as JE
from hyena_dna_tpu_torch.tasks import encoders as E
from hyena_dna_tpu_torch.utils.convert import flax_encoder_to_torch_state_dict

B, L, D = 2, 8, 16
TOL = 2e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def run_pair(jax_module, port_module, x, **extras):
    """Both encoders on x (and the keyword extras, numpy), the JAX initial
    parameters loaded into the port; returns (port output, JAX output)."""
    jx = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in extras.items()}
    variables = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **jx)
    ref = jax_module.apply(variables, jnp.asarray(x), **jx)
    params = jax.tree_util.tree_map(np.asarray, dict(variables.get("params", {})))
    if params:
        missing, unexpected = port_module.load_state_dict(
            flax_encoder_to_torch_state_dict(params), strict=False)
        assert not unexpected, unexpected
        assert all(k.endswith(("pos_emb.t", ".freq")) for k in missing), missing
    tx = {k: (torch.as_tensor(np.asarray(v)) if not isinstance(v, dict)
              else {a: torch.as_tensor(np.asarray(t)) for a, t in v.items()})
          for k, v in extras.items()}
    port_module.eval()
    with torch.no_grad():
        out = port_module(torch.as_tensor(x), **tx)
    return out, ref


def assert_close(out, ref):
    out = [out] if not isinstance(out, tuple) else out
    ref = [ref] if not isinstance(ref, tuple) else ref
    for o, r in zip(out, ref):
        o, r = o.detach().float().numpy(), np.asarray(r, np.float32)
        assert o.shape == r.shape
        scale = max(float(np.abs(r).max()), 1e-12)
        assert float(np.abs(o - r).max()) <= TOL * scale


def _tokens(n, shape=(B, L), seed=0):
    return _rng(seed).integers(0, n, size=shape).astype(np.int32)


def _features(d=D, seed=0):
    return _rng(seed).standard_normal((B, L, d)).astype(np.float32)


@pytest.mark.parametrize("case", [
    "embedding", "linear", "position_id", "position", "position_learned", "class",
    "onehot", "conv1d", "conv1d_stride2", "pack", "patch2d", "patch2d_flat"])
def test_encoder_matches_jax(case):
    g = torch.Generator().manual_seed(0)
    extras = {}
    if case == "embedding":
        jm, pm, x = JE.EmbeddingEncoder(12, D), E.EmbeddingEncoder(12, D, generator=g), _tokens(12)
    elif case == "linear":
        jm, pm, x = JE.LinearEncoder(6, D), E.LinearEncoder(6, D, generator=g), _features(6)
    elif case == "position_id":
        jm, pm, x = JE.PositionalIDEncoder(), E.PositionalIDEncoder(), _tokens(12)
    elif case == "position":
        jm, pm, x = JE.PositionalEncoder(D, dropout=0.0), E.PositionalEncoder(D, 0.0), _features()
    elif case == "position_learned":
        jm = JE.PositionalEncoder(D, dropout=0.0, max_len=64, pe_init=0.02)
        pm, x = E.PositionalEncoder(D, 0.0, max_len=64, pe_init=0.02, generator=g), _features()
    elif case == "class":
        jm, pm, x = JE.ClassEmbedding(4, D), E.ClassEmbedding(4, D, generator=g), _features()
        extras = {"y": np.array([0, 3], np.int32)}
    elif case == "onehot":
        jm, pm, x = JE.OneHotEncoder(4, 8), E.OneHotEncoder(4, 8), _tokens(4)
    elif case.startswith("conv1d"):
        stride = 2 if case.endswith("2") else 1
        jm = JE.Conv1DEncoder(D, 8, kernel_size=5, stride=stride)
        pm, x = E.Conv1DEncoder(D, 8, kernel_size=5, stride=stride, generator=g), _features()
    elif case == "pack":
        jm, pm, x = JE.PackedEncoder(), E.PackedEncoder(), _features()
        extras = {"lengths": np.array([3, L])}
    else:
        flat = case.endswith("flat")
        jm = JE.Conv2DPatchEncoder(3, D, (4, 4), flat=flat)
        pm = E.Conv2DPatchEncoder(3, D, (4, 4), flat=flat, generator=g)
        x = _rng().standard_normal((B, 8, 8, 3)).astype(np.float32)
        x = x.reshape(B, 64, 3) if flat else x
    out, ref = run_pair(jm, pm, x, **extras)
    assert_close(out, ref)


@pytest.mark.parametrize("prenorm,norm,layer", [
    (False, "layer", None), (True, "layer", None), (False, "rms", None),
    (True, "group", None), (False, None, None),
    (False, "layer", {"_name_": "hyena", "l_max": 8, "filter_order": 16,
                      "filter_cfg": {"emb_dim": 5}}),
    (True, "rms", {"_name_": "hyena", "l_max": 8, "filter_order": 16,
                   "filter_cfg": {"emb_dim": 5}})])
def test_layer_encoder_matches_jax(prenorm, norm, layer):
    jm = JE.LayerEncoder(d_model=D, prenorm=prenorm, norm=norm, layer=layer)
    pm = E.LayerEncoder(D, prenorm=prenorm, norm=norm, layer=layer,
                        generator=torch.Generator().manual_seed(0))
    out, ref = run_pair(jm, pm, _features())
    assert_close(out, ref)


def test_layer_encoder_refuses_unported_layers():
    """Every layer of the registry builds now (mha, ff, long-conv: see
    tests/test_torch_port_sequence_model.py); a name no registry has
    raises, as in the JAX package."""
    E.LayerEncoder(D, layer={"_name_": "mha", "num_heads": 2})
    with pytest.raises(KeyError, match="s4"):
        E.LayerEncoder(D, layer={"_name_": "s4"})


@pytest.mark.parametrize("timeenc", [0, 1])
def test_time_encoder_matches_jax(timeenc):
    """TimeEncoder: one embedding per integer feature (or one Linear) plus
    the mask embedding; the mask flips between positions 3 and 4."""
    n_tokens = (13, 32, 7, 24)
    mark = np.stack([_rng(i).integers(0, n, size=(B, L)) for i, n in enumerate(n_tokens)],
                    -1).astype(np.int32)
    mask = np.broadcast_to(np.r_[np.zeros(4), np.ones(4)].astype(np.int32), (B, L)).copy()
    jm = JE.TimeEncoder(n_tokens_time=n_tokens, d_model=D, timeenc=timeenc)
    pm = E.TimeEncoder(n_tokens, D, timeenc=timeenc, generator=torch.Generator().manual_seed(0))
    out, ref = run_pair(jm, pm, np.zeros((B, L, D), np.float32), mark=mark, mask=mask)
    assert_close(out, ref)
    assert float((out[0, 3] - out[0, 4]).abs().max()) > 0
    with pytest.raises(ValueError, match="mark"):
        pm(torch.zeros(B, L, D))


@pytest.mark.parametrize("table", [True, False])
def test_timestamp_encoder_matches_jax(table):
    """Timestamp attributes added per position; in table mode a null (-1)
    stamp adds nothing."""
    ts = {"month": np.array([[1, 12, -1, 6]] * B), "hour": np.array([[0, 23, 5, -1]] * B)}
    x = _rng().standard_normal((B, 4, 8)).astype(np.float32)
    jm = JE.TimestampEmbeddingEncoder(d_model=8, table=table, features=tuple(ts))
    pm = E.TimestampEmbeddingEncoder(8, table=table, features=tuple(ts),
                                     generator=torch.Generator().manual_seed(0))
    out, ref = run_pair(jm, pm, x, timestamps=ts)
    assert_close(out, ref)
    if table:
        null = {k: torch.full((B, 4), -1) for k in ts}
        with torch.no_grad():
            np.testing.assert_array_equal(pm(torch.zeros(B, 4, 8), timestamps=null).numpy(), 0.0)


def test_encoder_behaviours():
    """tests/test_components.py's checks on the port: the sinusoid at
    position 0, the one-hot ids, the packed zeros, the patch shapes."""
    y = E.PositionalEncoder(D, dropout=0.0)(torch.zeros(B, L, D))
    assert float(y[0, 0, 0]) == 0.0 and abs(float(y[0, 0, 1]) - 1.0) < 1e-6
    y = E.OneHotEncoder(4, 8)(torch.tensor([[1, 3]]))
    assert y.shape == (1, 2, 8) and y[0, 0, 1] == 1.0 and y[0, 1, 3] == 1.0
    y = E.PackedEncoder()(torch.ones(2, 6, 4), lengths=torch.tensor([3, 6]))
    assert float(y[0, :3].min()) == 1.0 and float(y[0, 3:].abs().max()) == 0.0
    assert E.Conv2DPatchEncoder(3, D, (4, 4))(torch.randn(2, 8, 8, 3)).shape == (2, 4, D)
    with pytest.raises(ValueError):
        E.OneHotEncoder(9, 8)


def test_registry_and_wiring_tables_match_jax():
    assert set(E.ENCODER_REGISTRY) == set(JE.ENCODER_REGISTRY)
    assert (E.ENCODER_REGISTRY["id"] is None) and (JE.ENCODER_REGISTRY["id"] is None)
    for name, cls in E.ENCODER_REGISTRY.items():
        if cls is not None:
            assert cls.__name__ == JE.ENCODER_REGISTRY[name].__name__
    assert E.DATASET_ATTRS == JE.DATASET_ATTRS
    assert E.MODEL_ATTRS == JE.MODEL_ATTRS
    assert E.TimestampEmbeddingEncoder.CARDINALITIES == JE.TimestampEmbeddingEncoder.CARDINALITIES


def test_init_is_seeded():
    """The same generator seed gives the same parameters."""
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return E.LayerEncoder(D, layer={"_name_": "hyena", "l_max": 8, "filter_order": 16,
                                        "filter_cfg": {"emb_dim": 5}},
                               generator=g).state_dict()
    a, b, c = build(1), build(1), build(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
