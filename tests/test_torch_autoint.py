"""The port's AutoInt (`repro_torch.models.autoint`) and row-sharded
lookup (`repro_torch.nn.embedding.sharded_embedding_lookup`) against the
JAX package's on the CPU, at the JAX smoke's reduced vocab (100 rows a
field), from the same parameters (`params_from_numpy` of JAX's
`init_autoint`) and the same numpy ids (the two packages' random streams
differ, so `synth_batch` is held by its law, not its draws).

Tolerances: logits and loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
/ atol 1e-6 (`test_torch_gnn.py`'s).  The sharded lookup is bitwise the
whole-table lookup, over `StackedComm(4)` and over 4 gloo ranks; the
logits through it bitwise the whole-table logits in one process, and
within the forward bound across processes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import autoint as jai
from repro.nn.embedding import sharded_embedding_lookup as jlookup
from repro_torch.configs import get_config
from repro_torch.dist.comm import StackedComm
from repro_torch.dist.world import run_world
from repro_torch.models import autoint, gnn
from repro_torch.nn.embedding import sharded_embedding_lookup

import torch_dist_cases as cases
from torch_parity import JAX_K

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
WORLD_TIMEOUT = 240.0
BATCH = 48


@pytest.fixture(scope="module")
def cfgs():
    vocab = tuple([100] * 39)
    return (dataclasses.replace(get_config("autoint")[0], vocab_sizes=vocab),
            dataclasses.replace(jget_config("autoint")[0], vocab_sizes=vocab))


@pytest.fixture(scope="module")
def params_np(cfgs):
    return jax.tree.map(np.asarray, jai.init_autoint(jax.random.PRNGKey(0),
                                                     cfgs[1]))


@pytest.fixture(scope="module")
def batch(cfgs):
    rng = np.random.default_rng(0)
    ids = (rng.integers(0, 100, (BATCH, 39))
           + autoint.field_offsets(cfgs[0])).astype(np.int32)
    return ids, rng.integers(0, 2, BATCH).astype(np.int32)


def test_field_offsets_and_config(cfgs):
    full_t, full_j = get_config("autoint")[0], jget_config("autoint")[0]
    assert np.array_equal(autoint.field_offsets(full_t),
                          jai.field_offsets(full_j))
    assert autoint.field_offsets(full_t).dtype == np.int64
    assert full_t.total_rows() == full_j.total_rows() == 37_020_000
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)


def test_logits_loss_and_grads_match_jax(cfgs, params_np, batch):
    tcfg, jcfg = cfgs
    ids, labels = batch
    jp = jax.tree.map(jnp.asarray, params_np)
    jb = {"ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
    jl, jg = jax.value_and_grad(jai.autoint_loss)(jp, jb, jcfg)
    params = autoint.params_from_numpy(params_np, tcfg, device="cpu")
    tb = {"ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels)}
    logits = autoint.autoint_logits(params, tb["ids"], tcfg)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jai.autoint_logits(jp, jb["ids"],
                                                             jcfg)), **FWD)
    loss = autoint.autoint_loss(params, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **FWD)
    want = jax.tree.leaves(jg)
    got = gnn.parameters(params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   err_msg=f"leaf {i}", **GRAD)


def test_retrieval_scores_match_jax(cfgs, params_np, batch):
    tcfg, jcfg = cfgs
    rng = np.random.default_rng(4)
    cand = rng.normal(size=(500, tcfg.d_attn)).astype(np.float32)
    proj = rng.normal(size=(39 * tcfg.d_attn, tcfg.d_attn)).astype(
        np.float32) * 0.05
    ids = batch[0][:1]
    want = jai.retrieval_scores(jax.tree.map(jnp.asarray, params_np),
                                jnp.asarray(ids), jnp.asarray(cand),
                                jnp.asarray(proj), jcfg)
    params = autoint.params_from_numpy(params_np, tcfg, device="cpu")
    got = autoint.retrieval_scores(params, torch.from_numpy(ids),
                                   torch.from_numpy(cand),
                                   torch.from_numpy(proj), tcfg)
    assert got.shape == (500,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_lookup_bitwise(cfgs, params_np, batch, k):
    """Over `StackedComm(k)`: the lookup equals the whole-table lookup and
    JAX's `sharded_embedding_lookup` (its psum over a vmapped axis),
    bitwise; its table gradient equals the whole-table gather's."""
    table = torch.from_numpy(params_np["table"].copy())
    ids = torch.from_numpy(batch[0])
    rows = table.shape[0] // k
    shards = table.reshape(k, rows, -1).clone().requires_grad_(True)
    got = sharded_embedding_lookup(shards, ids, StackedComm(k))
    want = table[ids.long()]
    assert got.dtype == want.dtype and torch.equal(got, want)
    jax_sharded = jax.vmap(
        lambda tab, i: jlookup(tab, jnp.asarray(batch[0]), i, rows, "x"),
        axis_name="x")(jnp.asarray(params_np["table"]).reshape(k, rows, -1),
                       jnp.arange(k))
    for i in range(k):          # every shard holds the psum
        assert np.array_equal(got.detach().numpy(),
                              np.asarray(jax_sharded[i]))
    cot = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(got.shape)).astype(np.float32))
    (got * cot).sum().backward()
    whole = table.clone().requires_grad_(True)
    from repro_torch.nn.embedding import embedding_lookup
    (embedding_lookup(whole, ids) * cot).sum().backward()
    assert torch.equal(shards.grad.reshape(whole.shape), whole.grad)


def test_synth_batch_law(cfgs):
    """Ids inside each field's rows with the power law's skew (mean of u³
    is 1/4 of the field), labels about 25% positive."""
    tcfg = dataclasses.replace(cfgs[0], vocab_sizes=tuple([10_000] * 39))
    b = autoint.synth_batch(torch.Generator().manual_seed(0), tcfg, 4096)
    ids, labels = b["ids"].numpy(), b["labels"].numpy()
    assert ids.shape == (4096, 39) and labels.shape == (4096,)
    local = ids - autoint.field_offsets(tcfg)[None, :]
    assert local.min() >= 0 and local.max() < 10_000
    assert abs(local.mean() / 9_999 - 0.25) < 0.01
    assert abs(labels.mean() - 0.25) < 0.03


@pytest.fixture(scope="module")
def world(tmp_path_factory, cfgs, params_np, batch):
    out = tmp_path_factory.mktemp("autoint_ranks")
    table = params_np["table"]
    done = run_world(cases.autoint_rank_main, JAX_K,
                     (table, batch[0], params_np, cfgs[0], str(out)),
                     device="cpu", timeout=WORLD_TIMEOUT)
    assert [r.value for r in done] == list(range(JAX_K))
    ranks = []
    for r in range(JAX_K):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    return ranks


def test_sharded_lookup_over_ranks_bitwise(world, params_np, batch, cfgs):
    want = params_np["table"][batch[0]]
    stacked = cases.autoint_sharded_case(params_np["table"], batch[0],
                                         params_np, cfgs[0],
                                         StackedComm(JAX_K))
    whole = autoint.autoint_logits(
        autoint.params_from_numpy(params_np, cfgs[0], device="cpu"),
        torch.from_numpy(batch[0]), cfgs[0]).detach().numpy()
    for got in world:
        assert np.array_equal(got["lookup"], want)
        # the same rows through the same model, in another process: its
        # matmuls may block differently (thread count), hence FWD
        np.testing.assert_allclose(got["logits"], stacked["logits"], **FWD)
        np.testing.assert_allclose(got["logits"], whole, **FWD)
    assert np.array_equal(stacked["logits"], whole)
