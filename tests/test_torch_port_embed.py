"""The port's token lookup and its numeric policy, on the CPU.

`GPT2Embeddings` looks tokens up with the JAX package's one-hot product for
a vocabulary of at most 64 (every hg38 config), whose backward is a matrix
product: held to the JAX embeddings (logits through the tied head and the
table's gradient) and to the plain `nn.Embedding` lookup it replaced. The
one-hot forward picks rows exactly, so values are equal; gradients sum
the same terms in another order.

`utils/numerics.py::set_card_numerics` is the one place the port sets the
card's matrix-product policy; each entry point calls it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hyena_dna_tpu.models.embeddings import GPT2Embeddings as JaxEmbeddings

from hyena_dna_tpu_torch.evals import hg38_inference as port_cli
from hyena_dna_tpu_torch.models.embeddings import ONE_HOT_MAX_VOCAB, GPT2Embeddings
from hyena_dna_tpu_torch.utils import numerics


def _port_and_jax(vocab, dim, ids, dtype=torch.float32):
    jm = JaxEmbeddings(embed_dim=dim, vocab_size=vocab,
                       dtype={torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    pm = GPT2Embeddings(dim, vocab, dtype)
    pm.word_embeddings.weight.data = torch.from_numpy(
        np.array(params["word_embeddings"]["embedding"]))
    return jm, params, pm


@pytest.mark.parametrize("vocab,dtype", [(16, torch.float32), (16, torch.bfloat16),
                                         (64, torch.float32), (100, torch.float32)])
def test_embeddings_match_jax(vocab, dtype):
    """Embedding and tied-head logits, and the table's gradient of a loss on
    both, against the JAX `GPT2Embeddings` (one-hot for vocab <= 64 on both
    sides, a lookup above)."""
    ids = np.random.default_rng(vocab).integers(0, vocab, size=(2, 96)).astype(np.int32)
    jm, params, pm = _port_and_jax(vocab, 32, ids, dtype)
    w = np.random.default_rng(1).normal(size=(2, 96, vocab)).astype(np.float32)

    def jax_loss(p):
        emb = jm.apply({"params": p}, jnp.asarray(ids))
        logits = jm.apply({"params": p}, emb, method=jm.attend)
        return jnp.sum(logits.astype(jnp.float32) * w), (emb, logits)

    (_, (emb_ref, logits_ref)), g_ref = jax.value_and_grad(jax_loss, has_aux=True)(params)
    emb = pm(torch.from_numpy(ids).long())
    logits = pm.attend(emb)
    assert emb.dtype == logits.dtype == dtype
    (logits.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(emb.detach().float().numpy(), np.asarray(emb_ref, np.float32))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(logits.detach().float().numpy(),
                               np.asarray(logits_ref, np.float32), rtol=tol, atol=tol)
    g = pm.word_embeddings.weight.grad
    want = np.asarray(g_ref["word_embeddings"]["embedding"])
    assert np.abs(g.numpy() - want).max() <= (1e-5 if dtype == torch.float32 else 2e-2) * np.abs(
        want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_hot_lookup_matches_the_table_lookup(dtype):
    """The one-hot product against `nn.Embedding`'s lookup it replaced: the
    same values, and the table's gradient within 1e-6 of its max in float32;
    in bf16 the product's gradient is a bf16 matrix product, rounded once
    to bf16 as the JAX one-hot product's is (2^-8 of its max), where the
    lookup summed in float32."""
    torch.manual_seed(0)
    pm = GPT2Embeddings(64, 16, dtype)
    ids = torch.randint(0, 16, (3, 200))
    cot = torch.randn(3, 200, 64).to(dtype)
    emb = pm(ids)
    emb.backward(cot)
    g = pm.word_embeddings.weight.grad
    weight = pm.word_embeddings.weight.detach().clone().requires_grad_()
    lookup = F.embedding(ids, weight).to(dtype)
    lookup.backward(cot)
    assert torch.equal(emb, lookup)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    assert (g - weight.grad).abs().max() <= tol * weight.grad.abs().max()
    assert ONE_HOT_MAX_VOCAB == 64


def test_large_vocab_indexes_the_table(monkeypatch):
    """Above 64 tokens the JAX package looks up by index; so does the port."""
    pm = GPT2Embeddings(8, ONE_HOT_MAX_VOCAB + 1)
    calls = []
    inner = pm.word_embeddings.forward
    monkeypatch.setattr(pm.word_embeddings, "forward", lambda x: calls.append(1) or inner(x))
    pm(torch.zeros(2, 3, dtype=torch.long))
    assert calls == [1]
    small = GPT2Embeddings(8, ONE_HOT_MAX_VOCAB)
    monkeypatch.setattr(small.word_embeddings, "forward", lambda x: calls.append(2) or inner(x))
    small(torch.zeros(2, 3, dtype=torch.long))
    assert calls == [1]


def _numerics():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


@pytest.fixture
def loose_numerics():
    """PyTorch's defaults on the card, restored after the test."""
    flags = _numerics()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags


def test_set_card_numerics_turns_off_tf32_and_bf16_reductions(loose_numerics):
    assert _numerics() == (True, True, True)
    numerics.set_card_numerics()
    assert _numerics() == (False, False, False)


def test_hg38_inference_main_sets_the_card_numerics(tmp_path, loose_numerics, capsys):
    """The serving entry point sets the policy before it runs the model."""
    fasta = tmp_path / "t.fa"
    fasta.write_text(">chrA synthetic\n" + "ACGT" * 80 + "\n")
    ckpt = tmp_path / "w.pt"
    torch.save(port_cli.build_model(16, 1, 128, generator=torch.Generator().manual_seed(0))
               .state_dict(), ckpt)
    result = port_cli.main(["--ckpt", str(ckpt), "--fasta", str(fasta), "--max_length", "128",
                            "--d_model", "16", "--n_layer", "1", "--batch_size", "2",
                            "--chr_ranges", "chrA:0-256", "--device", "cpu"])
    assert _numerics() == (False, False, False)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


@pytest.mark.parametrize("module", ["hyena_dna_tpu_torch.bench",
                                    "hyena_dna_tpu_torch.utils.profile_forward",
                                    "hyena_dna_tpu_torch.evals.hg38_inference"])
def test_entry_points_call_the_one_helper(module):
    """Each entry point sets the policy through `set_card_numerics`, and no
    module of the port sets a flag of its own."""
    import importlib
    import inspect

    src = inspect.getsource(importlib.import_module(module))
    assert "set_card_numerics()" in src
    assert "allow_tf32" not in src and "reduced_precision_reduction" not in src
