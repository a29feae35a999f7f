"""The port's `from_pretrained` (`pretrained.py`) against the JAX one, on
the CPU, on a fake LongSafari-layout directory as tests/test_pretrained.py
writes it: config.json and a Lightning-style weights.ckpt of torch tensors
under the reference names (`model.` prefix, the tied `lm_head.weight`, a
metric buffer; no `pos_emb.t`, which the loaders derive)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.models import DNAEmbeddingModel as JaxEmbedding
from hyena_dna_tpu.pretrained import from_pretrained as jax_from_pretrained

from hyena_dna_tpu_torch.pretrained import from_pretrained
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict
from tests.test_pretrained import CONFIG


def _write_dir(path, config, seed=0):
    model = JaxEmbedding(**{k: v for k, v in config.items() if k != "layer"},
                         layer=dict(config["layer"]))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(seed + 1)  # nonzero biases, so that every term is tested
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.01 * rng.normal(size=p.shape).astype(np.float32), params)
    sd = {"model." + k: v for k, v in flax_to_torch_state_dict(params, buffers=False).items()}
    sd["model.lm_head.weight"] = sd["model.backbone.embeddings.word_embeddings.weight"]
    sd["train_torchmetrics.num-tokens.count"] = torch.zeros(())
    path.mkdir()
    (path / "config.json").write_text(json.dumps(config))
    torch.save({"state_dict": sd}, path / "weights.ckpt")
    return path


@pytest.fixture(scope="module")
def longsafari_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("ls") / "hyenadna-tiny", CONFIG)


def _ids(seed):
    return np.random.default_rng(seed).integers(7, 11, size=(2, 64)).astype(np.int32)


def test_backbone_matches_jax_from_pretrained(longsafari_dir):
    jm, jp, jtok = jax_from_pretrained(longsafari_dir)
    model, tok = from_pretrained(longsafari_dir, device="cpu")
    assert tok.vocab_size == jtok.vocab_size == 12
    assert tok.model_max_length == jtok.model_max_length == 68
    assert not model.training and model.head is None
    x = _ids(1)
    ref = jm.apply({"params": jp}, jnp.asarray(x))
    with torch.inference_mode():
        hidden = model(torch.from_numpy(x).long())
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_head_variant_matches_jax(longsafari_dir):
    """The scratch pooled head, given the JAX head's parameters, gives the
    JAX class logits."""
    jm, jp, _ = jax_from_pretrained(longsafari_dir, use_head=True, n_classes=5)
    model, _ = from_pretrained(longsafari_dir, use_head=True, n_classes=5, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    head = jp["head"]["output_transform"]
    model.head.load_state_dict({"output_transform.weight": torch.tensor(
        np.asarray(head["kernel"]).T), "output_transform.bias": torch.tensor(
        np.asarray(head["bias"]))})
    x = _ids(2)
    ref = jm.apply({"params": jp}, jnp.asarray(x))
    with torch.inference_mode():
        out = model(torch.from_numpy(x).long())
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_shift_defaults_to_the_standalone_loader(tmp_path):
    """Without `shift` in the layer config both loaders take 0.05."""
    config = dict(CONFIG, layer={k: v for k, v in CONFIG["layer"].items() if k != "shift"})
    path = _write_dir(tmp_path / "noshift", config, seed=3)
    jm, jp, _ = jax_from_pretrained(path)
    model, _ = from_pretrained(path, device="cpu")
    assert model.model.backbone.layers[0].mixer.filter_fn.modulation.shift == 0.05
    x = _ids(3)
    with torch.inference_mode():
        hidden = model(torch.from_numpy(x).long())
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jm.apply({"params": jp},
                                                                   jnp.asarray(x))),
                               atol=1e-6, rtol=0)


def test_bare_checkpoint_needs_a_config(longsafari_dir):
    ckpt = longsafari_dir / "weights.ckpt"
    with pytest.raises(ValueError, match="explicit config"):
        from_pretrained(ckpt, device="cpu")
    model, _ = from_pretrained(ckpt, config=CONFIG, device="cpu")
    ref, _ = from_pretrained(longsafari_dir, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_unknown_checkpoint_key_raises(tmp_path, longsafari_dir):
    sd = torch.load(longsafari_dir / "weights.ckpt", weights_only=True)
    sd["state_dict"]["model.backbone.extra.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError, match="extra"):
        from_pretrained(tmp_path / "bad.ckpt", config=CONFIG, device="cpu")


def test_from_pretrained_raises_without_a_card(longsafari_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_pretrained(longsafari_dir)
