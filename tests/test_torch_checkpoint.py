"""Checkpoint and restart in the port (`repro_torch.checkpoint.manager`):
round trips with bf16, async writes and retention, training-state and
module restores, and the graph engine's §6.3 contract (masters and the
active bitmap only, agent slots rebuilt to the monoid identity) against
the JAX package's `graph_engine_snapshot`/`restore`, then a snapshot taken
at superstep 3 of an SSSP and a BFS run, restored and resumed: bitwise the
uninterrupted run."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint.manager import graph_engine_restore as jrestore
from repro.checkpoint.manager import graph_engine_snapshot as jsnapshot
from repro.core.engine import EngineState as JaxEngineState
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            graph_engine_restore,
                                            graph_engine_snapshot)
from repro_torch.configs import get_config
from repro_torch.core import algorithms
from repro_torch.core.engine import DevicePartition, EngineState, GREEngine
from repro_torch.graph.generators import rmat_edges
from repro_torch.launch.train import reduced_lm_config
from repro_torch.models import transformer as tfm


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32)},
            "c": [torch.ones(3), torch.randn((2, 2), generator=g).to(
                torch.bfloat16)],
            "n": np.arange(4, dtype=np.int64), "step": 5}


def _like(tree):
    return {"a": torch.empty(8, 16),
            "nested": {"b": torch.empty(10, dtype=torch.int32)},
            "c": [torch.empty(3), torch.empty((2, 2), dtype=torch.bfloat16)],
            "n": np.zeros(4, np.int64), "step": 0}


def test_round_trip_with_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    tree = _tree()
    mgr.save(5, tree, metadata={"note": "x"})
    restored, step = mgr.restore(_like(tree))
    assert step == 5
    assert restored["c"][1].dtype == torch.bfloat16
    assert torch.equal(restored["c"][1], tree["c"][1])
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    np.testing.assert_array_equal(restored["n"], tree["n"])
    assert restored["step"] == 5
    with np.load(tmp_path / "step-5" / "state.npz") as blob:
        assert blob["c/1"].dtype == np.float32     # bf16 stored widened
    with pytest.raises(ValueError, match="stored"):
        mgr.restore({**_like(tree), "a": torch.empty(4, 16)})


def test_async_write_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert sorted(mgr.all_steps()) == [3, 4]
    assert mgr.latest_step() == 4
    restored, _ = mgr.restore(_like(_tree()), step=3)
    assert torch.equal(restored["a"], _tree(3)["a"])


def test_save_copies_before_the_caller_updates_in_place(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    t = torch.zeros(1000)
    mgr.save(1, {"t": t})
    t.add_(1.0)                        # the next step's in-place update
    mgr.wait()
    restored, _ = mgr.restore({"t": torch.empty(1000)})
    assert torch.count_nonzero(restored["t"]) == 0


def test_module_state_restores_in_place(tmp_path):
    cfg = reduced_lm_config(get_config("granite-moe-1b-a400m")[0],
                            layers=2, d_model=32, n_heads=2, n_kv=1,
                            d_head=16, d_ff=32, vocab=64)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    a = tfm.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = tfm.init_lm(cfg, torch.Generator().manual_seed(2), device="cpu")
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(7, a)
    back, step = mgr.restore(b)
    assert back is b and step == 7
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert b.layers[0].moe["router"].dtype == torch.float32


def test_graph_engine_snapshot_matches_jax():
    """Paper §6.3 on the same arrays: only the masters and the bitmap are
    kept, and the agent slots come back as the identity, inactive."""
    cap, slots = 4, 10
    arrays = {"vertex_data": np.arange(cap, dtype=np.float32),
              "scatter_data": np.arange(slots, dtype=np.float32) * 0.5,
              "active_scatter": np.arange(slots) % 3 == 0}
    st = EngineState(*(torch.from_numpy(a) for a in arrays.values()), step=7)
    jst = JaxEngineState(*(jnp.asarray(a) for a in arrays.values()),
                         jnp.asarray(7, jnp.int32))
    snap, jsnap = graph_engine_snapshot(st, cap), jsnapshot(jst, cap)
    assert snap["scatter_data"].shape == (cap,)
    np.testing.assert_array_equal(snap["scatter_data"].numpy(),
                                  np.asarray(jsnap["scatter_data"]))
    np.testing.assert_array_equal(snap["active"].numpy(),
                                  np.asarray(jsnap["active"]))
    back = graph_engine_restore(snap, slots, identity=float("inf"))
    jback = jrestore(jsnap, slots, identity=jnp.inf)
    for name in ("vertex_data", "scatter_data", "active_scatter"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jback, name)))
    assert back.step == int(jback.step) == 7
    assert torch.isinf(back.scatter_data[cap:]).all()
    assert not back.active_scatter[cap:].any()


@pytest.fixture(scope="module")
def graph():
    return rmat_edges(scale=9, edge_factor=8, seed=2, weights=True).dedup()


@pytest.mark.parametrize("name", ["sssp", "bfs"])
def test_engine_resumes_bitwise_from_a_snapshot(graph, name, tmp_path):
    """Superstep 3 snapshotted into a synchronous manager, restored onto
    fresh agent slots, run to the end: the uninterrupted run's state, bit
    for bit, and the same superstep count."""
    prog = getattr(algorithms, f"{name}_program")()
    part = DevicePartition.from_graph(graph, device="cpu")
    eng = GREEngine(prog)
    full = eng.run(part, eng.init_state(part, source=0), max_steps=10_000)
    early = eng.run(part, eng.init_state(part, source=0), max_steps=3)
    assert early.step == 3 and full.step > 3
    mgr = CheckpointManager(tmp_path, async_write=False)
    snap = graph_engine_snapshot(early, part.num_masters)
    mgr.save(early.step, snap)
    restored, step = mgr.restore({k: (torch.empty_like(v) if isinstance(
        v, torch.Tensor) else 0) for k, v in snap.items()})
    assert step == 3
    state = graph_engine_restore(restored, part.num_slots,
                                 prog.monoid.identity)
    resumed = eng.run(part, state, max_steps=10_000)
    assert resumed.step == full.step
    for field in ("vertex_data", "scatter_data", "active_scatter"):
        assert torch.equal(getattr(resumed, field), getattr(full, field))
