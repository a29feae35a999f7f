"""The port's data and sequence parallelism on the CPU: the launch helpers,
the mesh, the sequence-sharded ops and models against the JAX package on
its virtual CPU mesh, and the loader's process split.

One world of 4 gloo ranks (`parallel.spawn`, joined through torchrun's
variables by `initialize_distributed`) runs every rank-side check at
tests/test_seq_parallel.py's shapes (B 2, C 16, L 128) on a data 2 x seq 2
mesh (`tests/torch_parallel_workers.py`); the JAX side runs in this process
on `make_mesh(data=2, seq=2, devices=jax.devices()[:4])`. Tolerances are
those of tests/test_seq_parallel.py: `seq_fftconv` 1e-4 forward, 2e-3 /
1e-3 (atol / rtol) for its gradients; the short conv 1e-5; the operator
and the LM 1e-5 for the loss, 5e-4 / 5e-3 for every gradient. Against the
port's own single-process ops the sharded ones are held to 1e-6 (the same
transforms of the same channels; only the gathers differ).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as W
from hyena_dna_tpu.models import ConvLMHeadModel as JaxLM, HyenaOperator as JaxOp
from hyena_dna_tpu.ops import fftconv as jax_fftconv
from hyena_dna_tpu.ops import short_conv_1d as jax_short_conv
from hyena_dna_tpu.ops.distributed import seq_fftconv as jax_seq_fftconv
from hyena_dna_tpu.ops.distributed import seq_short_conv as jax_seq_short_conv
from hyena_dna_tpu.ops.short_conv import short_conv_1d_with_halo as jax_halo_conv
from hyena_dna_tpu.parallel import make_mesh as jax_make_mesh
from hyena_dna_tpu_torch.data.loader import DataLoader
from hyena_dna_tpu_torch.models import ConvLMHeadModel, HyenaOperator
from hyena_dna_tpu_torch.ops.fftconv import fftconv
from hyena_dna_tpu_torch.ops.short_conv import short_conv_1d, short_conv_1d_with_halo
from hyena_dna_tpu_torch.parallel import launch, spawn
from hyena_dna_tpu_torch.parallel.sharding import Mesh, make_mesh
from hyena_dna_tpu_torch.utils.convert import flax_to_torch_state_dict

WORLD = 4


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(data=2, seq=2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_params():
    """The JAX operator's and LM's initial parameters (numpy trees)."""
    a = W.ops_inputs()
    op = JaxOp(**W.OP_KW)
    lm = JaxLM(**W.LM_KW)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"op": to_np(op.init(jax.random.PRNGKey(0), jnp.asarray(a["op_u"]))["params"]),
            "lm": to_np(lm.init(jax.random.PRNGKey(3), jnp.asarray(a["tokens"]))["params"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    """Every rank's results from one spawned world of 4 ranks."""
    out = tmp_path_factory.mktemp("parallel_ops")
    torch.save({k: flax_to_torch_state_dict(v) for k, v in jax_params.items()},
               out / "params.pt")
    spawn(W.ops_and_models, WORLD, args=(str(out), str(out / "params.pt")))
    return [torch.load(out / f"ops_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def assemble(ranks, part, key):
    """The global (B, C, L) or (B, L, d) tensor from the ranks' blocks."""
    rows = []
    for d in range(2):
        blocks = [ranks[2 * d + s][part][key] for s in range(2)]
        rows.append(torch.cat(blocks, dim=1 if part == "op" else -1))
    return torch.cat(rows, dim=0).numpy()


def _sharded(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


# --- the launch and the mesh ---------------------------------------------------


def test_launch_and_mesh_in_spawned_ranks(ranks):
    """torchrun's variables, the gloo rule on the CPU, rank order with seq
    innermost, and the mesh's groups: rank 2d + s sums with 2d + 1 - s over
    its seq group and with 2 (1 - d) + s over its data group."""
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["world"] == WORLD and res["main"] == (r == 0)
        assert res["backend"] == "gloo" and res["device"] == "cpu"
        d, s = divmod(r, 2)
        assert res["coords"] == (d, s)
        assert res["seq_group_sum"] == 4 * d + 1 and res["data_group_sum"] == 2 + 2 * s


def test_backend_rule(monkeypatch):
    """NCCL when every rank of the node has a card, gloo when they share one
    or run on the CPU; a rank's card from LOCAL_RANK."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert launch.backend_for(torch.device("cuda", 0)) == "gloo"
    assert launch.backend_for(torch.device("cpu")) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert launch.backend_for(torch.device("cuda", 0)) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert launch.backend_for(torch.device("cuda", 3)) == "nccl"
    assert launch.rank_device(torch.device("cuda")) == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.rank_device(torch.device("cuda")) == torch.device("cuda", 1)


def test_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.rank_device(torch.device("cuda"))


def test_single_process_mesh_and_refusals(monkeypatch):
    """Without torchrun's variables nothing is joined and the mesh is 1 x 1;
    a mesh over more ranks than the run has raises, on any axis."""
    for var in launch.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize_distributed(torch.device("cpu")) == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert (mesh.data, mesh.seq, mesh.size, mesh.grad_group) == (1, 1, 1, None)
    assert launch.is_main_process() and launch.world_size() == 1
    launch.barrier()
    with pytest.raises(ValueError, match="needs 4 ranks, the run has 1"):
        make_mesh(data=2, seq=2)
    with pytest.raises(ValueError, match="needs 2 ranks, the run has 1"):
        make_mesh(model=2)


@pytest.mark.parametrize("seq_sharded", [False, True])
def test_batch_spec(seq_sharded):
    """The Trainer's split of a batch: each data rank's loader serves its
    strided share of the rows and `Mesh.local_batch` cuts its columns of
    every 2-D array (1-D arrays whole). Over the ranks every token of the
    single-process batch appears once."""
    n, b, length, seq = 24, 2, 8, 2 if seq_sharded else 1
    whole = DataLoader(_Tokens(n, length), 2 * b, shuffle=True, seed=4)
    ranks = [(Mesh(2, seq, d, s), DataLoader(_Tokens(n, length), b, shuffle=True, seed=4,
                                             process_index=d, process_count=2))
             for d in range(2) for s in range(seq)]
    for ref, *shares in zip(whole, *(loader for _, loader in ranks)):
        got = []
        for (mesh, _), share in zip(ranks, shares):
            x, y, extra = mesh.local_batch((share, share[:, 0], {"t": share}))
            assert x.shape == (b, length // seq) and np.array_equal(extra["t"], x)
            assert np.array_equal(y, share[:, 0])
            got.append(x.reshape(-1))
        got = np.concatenate(got)
        assert sorted(got) == sorted(ref.reshape(-1)) and len(set(got)) == len(got)
    assert Mesh(2, 2, 1, 1).seq_columns(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        Mesh(2, 2).local_batch((np.zeros((2, 7)),))


class _Tokens:
    """Row i holds the tokens i * length .. (i + 1) * length - 1."""

    def __init__(self, n, length):
        self.n, self.length = n, length

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return np.arange(i * self.length, (i + 1) * self.length)


# --- the sequence-sharded ops --------------------------------------------------


def test_seq_fftconv_matches_jax(ranks, jax_mesh):
    a = W.ops_inputs()
    ref = jax.jit(lambda u, k, D: jax_seq_fftconv(u, k, D, jax_mesh))(
        _sharded(jax_mesh, a["u"], P("data", None, "seq")), jnp.asarray(a["k"]),
        jnp.asarray(a["D"]))
    np.testing.assert_allclose(assemble(ranks, "fftconv", "y"), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(assemble(ranks, "fftconv", "y"),
                               np.asarray(jax_fftconv(a["u"], a["k"], a["D"], False)),
                               atol=1e-4, rtol=1e-4)


def test_seq_fftconv_grads_match_jax(ranks, jax_mesh):
    """du, dk and dD of sum(y * dy) against `jax.grad` through the JAX
    sharded conv; dk and dD summed over the ranks."""
    a = W.ops_inputs()
    loss = lambda u, k, D: jnp.sum(jax_seq_fftconv(u, k, D, jax_mesh) * a["dy"])
    du, dk, dD = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        _sharded(jax_mesh, a["u"], P("data", None, "seq")), jnp.asarray(a["k"]),
        jnp.asarray(a["D"]))
    np.testing.assert_allclose(assemble(ranks, "fftconv", "du"), np.asarray(du),
                               atol=2e-3, rtol=1e-3)
    for r in ranks:
        np.testing.assert_allclose(r["fftconv"]["dk"].numpy(), np.asarray(dk), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(r["fftconv"]["dD"].numpy(), np.asarray(dD), atol=2e-3,
                                   rtol=1e-3)


def test_seq_fftconv_matches_single_process(ranks):
    """The pencils run the same conv as one process on the whole tensor:
    y, du, dk and dD within 1e-6; two all-to-alls forward, two backward,
    each sending the rank's block."""
    a = W.ops_inputs()
    u, k, D = (torch.tensor(a[n], requires_grad=True) for n in ("u", "k", "D"))
    y = fftconv(u, k, D)
    (y * torch.tensor(a["dy"])).sum().backward()
    for name, want in (("y", y.detach()), ("du", u.grad)):
        np.testing.assert_allclose(assemble(ranks, "fftconv", name), want.numpy(), atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["fftconv"]["dk"].numpy(), k.grad.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["fftconv"]["dD"].numpy(), D.grad.numpy(), atol=1e-5)
        assert r["fftconv"]["calls_fwd"] == {"all_to_all_single": 2}
        assert r["fftconv"]["calls"] == {"all_to_all_single": 4}
        assert r["fftconv"]["bytes"] == {"all_to_all_single": 4 * (W.B // 2) * W.C
                                         * (W.L // 2) * 4}


def test_seq_short_conv_matches_jax_and_single_process(ranks, jax_mesh):
    """The halo conv forward against the JAX sharded conv (1e-5) and, with
    its gradients, against the port's `short_conv_1d` on the whole tensor;
    one all-gather forward, one backward."""
    a = W.ops_inputs()
    ref = jax.jit(lambda x, w, b: jax_seq_short_conv(x, w, b, jax_mesh))(
        _sharded(jax_mesh, a["x"], P("data", None, "seq")), jnp.asarray(a["w"]),
        jnp.asarray(a["b"]))
    np.testing.assert_allclose(assemble(ranks, "short_conv", "y"), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    x, w, b = (torch.tensor(a[n], requires_grad=True) for n in ("x", "w", "b"))
    y = short_conv_1d(x, w, b)
    (y * torch.tensor(a["dy"])).sum().backward()
    np.testing.assert_allclose(assemble(ranks, "short_conv", "y"), y.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(assemble(ranks, "short_conv", "dx"), x.grad.numpy(), atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["short_conv"]["dw"].numpy(), w.grad.numpy(), atol=1e-4)
        np.testing.assert_allclose(r["short_conv"]["db"].numpy(), b.grad.numpy(), atol=1e-4)
        assert r["short_conv"]["calls"] == {"all_gather": 2}


def test_short_conv_with_halo_matches_jax():
    """The halo form alone: a zero halo is the causal conv; a halo of the
    preceding columns continues it; both against the JAX function."""
    a = W.ops_inputs()
    x, w, b = a["x"], a["w"], a["b"]
    for halo in (np.zeros((W.B, W.C, 2), np.float32), x[..., 30:32]):
        ours = short_conv_1d_with_halo(*(torch.tensor(v) for v in (x[..., 32:], w, b, halo)))
        ref = jax_halo_conv(*(jnp.asarray(v) for v in (x[..., 32:], w, b, halo)))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    whole = short_conv_1d(*(torch.tensor(v) for v in (x, w, b)))
    cont = short_conv_1d_with_halo(*(torch.tensor(v) for v in (x[..., 32:], w, b, x[..., 30:32])))
    np.testing.assert_allclose(cont.numpy(), whole[..., 32:].numpy(), atol=1e-6)


# --- the models with a seq axis --------------------------------------------------


def test_hyena_operator_seq_matches_jax(ranks, jax_mesh, jax_params):
    """The operator's output (2e-4 / 1e-3, tests/test_seq_parallel.py:59-70),
    the input gradient and every parameter gradient (5e-4 / 5e-3) against
    the JAX operator on the mesh, and the parameter gradients against the
    port's single process (1e-5)."""
    a = W.ops_inputs()
    op = JaxOp(**W.OP_KW, mesh=jax_mesh)
    u = _sharded(jax_mesh, a["op_u"], P("data", "seq", None))
    f = lambda p, u: jnp.sum(op.apply({"params": p}, u) * a["op_dy"])
    y = jax.jit(lambda p, u: op.apply({"params": p}, u))(jax_params["op"], u)
    dp, du = jax.jit(jax.grad(f, argnums=(0, 1)))(jax_params["op"], u)
    np.testing.assert_allclose(assemble(ranks, "op", "y"), np.asarray(y), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(assemble(ranks, "op", "du"), np.asarray(du), atol=5e-4, rtol=5e-3)
    dp = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, dp), buffers=False)
    for name, g in dp.items():
        if name in ranks[0]["op"]["grads"]:  # the shared Sin freq: one parameter, several names
            np.testing.assert_allclose(ranks[0]["op"]["grads"][name].numpy(), g.numpy(),
                                       atol=5e-4, rtol=5e-3, err_msg=name)
    single = HyenaOperator(**W.OP_KW)
    single.load_state_dict(flax_to_torch_state_dict(jax_params["op"]), strict=False)
    ou = torch.tensor(a["op_u"], requires_grad=True)
    (single(ou) * torch.tensor(a["op_dy"])).sum().backward()
    for name, p in single.named_parameters():
        np.testing.assert_allclose(ranks[0]["op"]["grads"][name].numpy(), p.grad.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_lm_seq_loss_and_grads_match_jax(ranks, jax_mesh, jax_params):
    """`ConvLMHeadModel` with the mesh: the loss (1e-5) and every gradient
    (5e-4 / 5e-3) against the JAX model on the mesh
    (tests/test_seq_parallel.py:70-117), and against the port's single
    process."""
    a = W.ops_inputs()
    model = JaxLM(**W.LM_KW, mesh=jax_mesh)
    y = jnp.roll(jnp.asarray(a["tokens"]), -1, axis=1)

    def f(p, x):
        logits, _ = model.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    x = _sharded(jax_mesh, a["tokens"].astype(np.int32), P("data", "seq"))
    loss = float(jax.jit(f)(jax_params["lm"], x))
    grads = flax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(f))(jax_params["lm"], x)), buffers=False)
    single = ConvLMHeadModel(**W.LM_KW)
    single.load_state_dict(flax_to_torch_state_dict(jax_params["lm"]), strict=False)
    tokens = torch.from_numpy(a["tokens"])
    single_loss = W.lm_loss(single(tokens), torch.roll(tokens, -1, dims=1))
    single_loss.backward()
    single_loss = float(single_loss.detach())
    for r in ranks:
        np.testing.assert_allclose(float(r["lm"]["loss"]), loss, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(r["lm"]["loss"]), single_loss, atol=1e-6)
    ours = ranks[0]["lm"]["grads"]
    for name, p in single.named_parameters():
        if name in grads:  # the shared Sin freq: one parameter, several names
            np.testing.assert_allclose(ours[name].numpy(), grads[name].numpy(), atol=5e-4,
                                       rtol=5e-3, err_msg=name)
        np.testing.assert_allclose(ours[name].numpy(), p.grad.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


# --- the loader's process split --------------------------------------------------


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return np.array([i])


@pytest.mark.parametrize("count", [2, 4])
def test_loader_split_covers_the_single_process_batches(count):
    """Batch i of `count` processes of b rows each holds the rows of batch i
    of one process of count * b rows; every process serves as many."""
    n, b = 37, 2
    whole = DataLoader(_Rows(n), count * b, shuffle=True, seed=3)
    parts = [DataLoader(_Rows(n), b, shuffle=True, seed=3, process_index=i,
                        process_count=count) for i in range(count)]
    assert len({len(p) for p in parts}) == 1 and len(parts[0]) == len(whole)
    for ref, *shares in zip(whole, *parts):
        got = np.concatenate([s[:, 0] for s in shares])
        assert sorted(got) == sorted(ref[:, 0]) and len(set(got)) == len(got)


def test_loader_split_resumes():
    """A process's loader resumes mid-epoch from its state dict with the
    batches it had not served."""
    loader = DataLoader(_Rows(40), 2, shuffle=True, seed=5, process_index=1, process_count=2)
    full = [b.copy() for b in loader]
    loader.epoch = 0
    it = iter(loader)
    first = [next(it).copy() for _ in range(3)]
    state = loader.state_dict()
    it.close()
    resumed = DataLoader(_Rows(40), 2, shuffle=True, seed=5, process_index=1, process_count=2)
    resumed.load_state_dict(state)
    rest = [b.copy() for b in resumed]
    assert all(np.array_equal(a, b) for a, b in zip(first + rest, full))
    assert len(first + rest) == len(full) == 10
    with pytest.raises(ValueError, match="process 2 of 2"):
        DataLoader(_Rows(4), 1, process_index=2, process_count=2)
