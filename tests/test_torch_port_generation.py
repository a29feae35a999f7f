"""The port's full-forward generation (`generation.py`) against the JAX
package, on the CPU: greedy tokens equal the JAX `generate`'s on the same
weights and prompt; sampled tokens stay in the top-k / top-p support
(tests/test_generation_evals.py:61 mirrored), since a `torch.Generator`
cannot reproduce JAX's categorical draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyena_dna_tpu.generation import generate as jax_generate
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM

from hyena_dna_tpu_torch.generation import _sample_logits, generate
from hyena_dna_tpu_torch.models.lm import ConvLMHeadModel
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

KW = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=12, pad_vocab_size_multiple=8,
          embed_dropout=0.0,
          layer=dict(_name_="hyena", emb_dim=5, filter_order=16, l_max=66, w=10))


@pytest.fixture(scope="module")
def models():
    """tests/test_generation_evals.py's toy LM on both sides, every
    parameter perturbed so that the logits are far from ties."""
    jm = JaxLM(**KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    pm = ConvLMHeadModel(**KW).eval()
    pm.load_state_dict(flax_to_torch_state_dict(params))
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm


@pytest.mark.parametrize("prompt", [[[7, 8, 9, 10, 7, 8, 9, 10]], [[7, 8, 9], [10, 7, 8]]])
def test_greedy_tokens_match_jax(models, prompt):
    jm, params, pm = models
    ref = jax_generate(jm, params, jnp.asarray(prompt, jnp.int32), max_new_tokens=12,
                       temperature=0.0)
    out = generate(pm, torch.tensor(prompt), 12, temperature=0.0)
    assert out.shape == (len(prompt), len(prompt[0]) + 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_respects_topk_and_shapes(models):
    """tests/test_generation_evals.py:61 in the port."""
    _, _, pm = models
    prompt = torch.tensor([[7, 8, 9], [10, 7, 8]])
    gen = torch.Generator().manual_seed(1)
    out = generate(pm, prompt, 5, generator=gen, temperature=0.8, top_k=4)
    assert out.shape == (2, 8)
    torch.testing.assert_close(out[:, :3], prompt, rtol=0, atol=0)
    assert (out >= 0).all() and (out < 16).all()
    again = generate(pm, prompt, 5, generator=torch.Generator().manual_seed(1),
                     temperature=0.8, top_k=4)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


def _support(logits, top_k=None, top_p=None):
    """The ids the JAX `_sample_logits` keeps, computed in numpy."""
    keep = np.ones_like(logits, bool)
    if top_k:
        keep &= logits >= np.sort(logits, -1)[:, -top_k][:, None]
    if top_p is not None:
        lg = np.where(keep, logits, -np.inf)
        srt = -np.sort(-lg, -1)
        p = np.exp(srt - srt[:, :1])
        p /= p.sum(-1, keepdims=True)
        before = np.cumsum(p, -1) - p
        cut = srt[np.arange(len(srt)), (before < top_p).sum(-1) - 1]
        keep &= lg >= cut[:, None]
    return keep


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.5), (5, 0.8), (1, None)])
def test_sampling_keeps_the_support(top_k, top_p):
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    keep = _support(logits.numpy() / 0.7, top_k, top_p)
    drawn = _sample_logits(torch.Generator().manual_seed(0), logits.repeat(400, 1), 0.7, top_k,
                           top_p).reshape(400, 4)
    seen = np.zeros_like(keep)
    for row in range(4):
        seen[row, np.unique(drawn[:, row].numpy())] = True
    assert not (seen & ~keep).any()  # nothing outside the support
    assert (seen == keep).all()  # and the whole support reached (400 draws, <= 16 ids)


def test_greedy_is_argmax_and_needs_no_generator():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 2.9]])
    torch.testing.assert_close(_sample_logits(None, logits, 0.0, 2, 0.9), torch.tensor([1, 0]))
