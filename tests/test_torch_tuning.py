"""The port's plan autotuner (`repro_torch.tuning`) and its engines'
`plan=` / `plan="auto-tuned"`: the counterparts of `tests/test_tuning.py`
on the port, then parity with the JAX package in process.

The measured half is substituted with deterministic fake evaluators, so
the search's control flow (rung culling, default-plan seeding, tie-breaks,
the cache hit that runs no probe) is pinned without trusting clocks.
Parity: candidate lists, plan JSON and cache keys must equal the JAX
package's exactly (strings and JSON), cache files must be readable both
ways, and adopted plans must give results bitwise equal to the default
engine's (BFS and SSSP are min programs).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core.agent_graph import build_agent_graph as jax_build_agent_graph
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import GREEngine as JaxEngine
from repro.core.partition_stream import partition_edges as jax_partition_edges
from repro.core.plan import SuperstepPlan as JaxPlan
from repro.graph.structures import Graph as JaxGraph
from repro.tuning import PlanCache as JaxCache
from repro.tuning import PlanSearchSpace as JaxSpace
from repro.tuning import ProbeEvaluator as JaxProbe
from repro.tuning import plan_cache_key as jax_key
from repro.tuning import tune as jax_tune
from repro_torch.core import algorithms
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import DistGREEngine
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.core.frontier import bucketed_tile_occupancy, default_cap
from repro_torch.core.partition import greedy_partition
from repro_torch.core.partition_stream import partition_edges
from repro_torch.core.plan import KernelPlan, SuperstepPlan
from repro_torch.graph.generators import circulant_graph, rmat_edges
from repro_torch.graph.structures import EdgeDelta
from repro_torch.serving import GraphQueryBatcher
from repro_torch.tuning import (PlanCache, PlanSearchSpace, ProbeEvaluator,
                                SMOKE_SPACE, graph_fingerprint,
                                partition_fingerprint, plan_cache_key,
                                program_fingerprint, successive_halving,
                                tune)

from torch_parity import to_graph


# ------------------------------------------------------------ fake evaluators
def _cost(plan):
    """Distance of the plan's capacity from a sweet spot, dense heavily
    penalized: no clocks, the winner is reproducible."""
    if plan.strategy == "dense":
        return 1e6
    cap = plan.frontier_cap or 10 ** 4
    return 1000.0 + abs(cap - 64)


class CostModelEvaluator(ProbeEvaluator):
    def evaluate(self, plan, probe_steps=2, iters=1):
        self.num_probes += 1
        return _cost(plan)


class JaxCostModelEvaluator(JaxProbe):
    def evaluate(self, plan, probe_steps=2, iters=1):
        self.num_probes += 1
        return _cost(plan)


class ExplodingEvaluator(ProbeEvaluator):
    """Any probe execution is a test failure (the cache-hit contract)."""

    def evaluate(self, plan, probe_steps=2, iters=1):
        raise AssertionError("cache hit must not execute probes")


def _evaluator(cls, prog, g):
    return cls(prog, g, device="cpu")


@pytest.fixture
def scenario():
    return algorithms.bfs_program(), circulant_graph(1 << 9, degree=8)


@pytest.fixture(scope="module")
def rmat7():
    return rmat_edges(scale=7, edge_factor=8, seed=0, weights=True).dedup()


def _tuned(prog, g, path, cls=CostModelEvaluator):
    return tune(prog, g, cache=path, space=SMOKE_SPACE,
                evaluator=_evaluator(cls, prog, g))


# ------------------------------------------------------- space enumeration
def test_space_prunes_dense_duplicates():
    cands = PlanSearchSpace().candidates(num_slots=4096, base_cap=64)
    dense = [p for p in cands if p.strategy == "dense"]
    assert len(dense) == 1
    assert dense[0].frontier_cap is None and dense[0].bucket_bounds is None


def test_space_flat_ignores_bucket_bounds():
    cands = PlanSearchSpace().candidates(num_slots=4096, base_cap=64)
    assert all(p.bucket_bounds is None for p in cands
               if p.strategy == "flat")
    compact_bounds = {p.bucket_bounds for p in cands
                      if p.strategy == "compact"}
    assert len(compact_bounds) == len(PlanSearchSpace().bucket_bounds)


def test_space_caps_clamped_and_deduped():
    cands = PlanSearchSpace(
        cap_multipliers=(1.0, 2.0, 100.0, 200.0),
        bucket_bounds=(None,)).candidates(num_slots=256, base_cap=64)
    flat_caps = sorted(p.frontier_cap for p in cands
                       if p.strategy == "flat")
    assert flat_caps == [64, 128, 256]


def test_space_pipelined_requires_split_tiles():
    space = PlanSearchSpace(phases=("sync", "pipelined"))
    solo = space.candidates(num_slots=4096, base_cap=64)
    assert all(p.phases == "sync" for p in solo)
    dist = space.candidates(num_slots=4096, base_cap=64,
                            has_split_tiles=True)
    assert any(p.phases == "pipelined" for p in dist)


def test_space_dense_frontier_forces_dense_strategy():
    cands = PlanSearchSpace().candidates(num_slots=4096, base_cap=64,
                                         dense_frontier=True)
    assert cands and all(p.strategy == "dense" for p in cands)
    assert all(p.dense_frontier for p in cands)


def test_space_async_axis_requires_split_tiles_and_monotone():
    space = PlanSearchSpace(phases=("sync", "pipelined", "async"),
                            staleness_choices=(2, 4))
    both = space.candidates(num_slots=4096, base_cap=64,
                            has_split_tiles=True, monotone=True)
    assert {p.staleness for p in both if p.phases == "async"} == {2, 4}
    assert all(p.staleness == 0 for p in both if p.phases != "async")
    non_mono = space.candidates(num_slots=4096, base_cap=64,
                                has_split_tiles=True, monotone=False)
    assert any(p.phases == "pipelined" for p in non_mono)
    assert all(p.phases != "async" for p in non_mono)
    solo = space.candidates(num_slots=4096, base_cap=64, monotone=True)
    assert all(p.phases == "sync" for p in solo)


def test_space_prunes_noop_kernel():
    space = PlanSearchSpace(kernels=(KernelPlan(use_pallas=False,
                                                dynamic_table=False),))
    assert space.candidates(num_slots=4096, base_cap=64) == ()


# ------------------------------------------------------- fingerprint keys
def test_fingerprint_quantizes_size():
    a = graph_fingerprint(10_000, 160_000)
    assert a == graph_fingerprint(10_300, 165_000)
    assert a != graph_fingerprint(100_000, 1_600_000)


def test_fingerprint_skew_and_density_facets():
    assert (graph_fingerprint(4096, 65536, max_out_degree=16)
            != graph_fingerprint(4096, 65536, max_out_degree=4096))
    assert (graph_fingerprint(4096, 65536, frontier_hist=[1, 16])
            != graph_fingerprint(4096, 65536, frontier_hist=[1, 2000]))
    assert "fd" not in graph_fingerprint(4096, 65536)


def test_program_and_mesh_facets_split_keys(scenario):
    prog, g = scenario
    part = DevicePartition.from_graph(g, device="cpu")
    assert (program_fingerprint(prog)
            != program_fingerprint(algorithms.pagerank_program()))
    assert (plan_cache_key(part=part, program=prog, mesh_size=1)
            != plan_cache_key(part=part, program=prog, mesh_size=8))


# ------------------------------------------------------------- plan cache
def test_cache_foreign_version_falls_back_clean(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(
        {"version": 99, "entries": {"k": {"plan": {"bogus": 1}}}}))
    cache = PlanCache(path)
    with pytest.warns(UserWarning, match="version"):
        assert cache.lookup("k") is None
    cache.store("k2", SuperstepPlan(strategy="flat", frontier_cap=16))
    reread = json.loads(path.read_text())
    assert reread["version"] == 1
    assert list(reread["entries"]) == ["k2"]


def test_cache_store_merges_concurrent_writers(tmp_path):
    path = tmp_path / "plans.json"
    a, b = PlanCache(path), PlanCache(path)
    a.store("ka", SuperstepPlan(strategy="flat", frontier_cap=32))
    b.store("kb", SuperstepPlan(strategy="compact", frontier_cap=64))
    fresh = PlanCache(path)
    assert sorted(fresh.keys()) == ["ka", "kb"]
    assert fresh.lookup("ka").frontier_cap == 32


def test_default_cache_path_is_the_ports_own(monkeypatch):
    """Unset `$GRE_PLAN_CACHE` names a file apart from the JAX package's
    default, so its CPU-measured plans are not read by default; set, both
    packages use it."""
    from repro.tuning import default_cache_path as jax_default
    from repro_torch.tuning import default_cache_path
    monkeypatch.delenv("GRE_PLAN_CACHE", raising=False)
    assert default_cache_path() != jax_default()
    monkeypatch.setenv("GRE_PLAN_CACHE", "/shared/plans.json")
    assert str(default_cache_path()) == str(jax_default())


def test_plan_json_rejects_unknown_fields():
    good = SuperstepPlan(strategy="flat", frontier_cap=64).to_json()
    with pytest.raises(ValueError, match="unknown"):
        SuperstepPlan.from_json({**good, "exchange_fanout": 4})
    with pytest.raises(ValueError, match="unknown"):
        SuperstepPlan.from_json(
            {**good, "kernel": {**good["kernel"], "vector_width": 8}})
    plan = SuperstepPlan(strategy="compact", frontier_cap=64,
                         bucket_bounds=[4, 16, 64, 256])
    assert plan.bucket_bounds == (4, 16, 64, 256)   # normalised, hashable
    assert SuperstepPlan.from_json(plan.to_json()) == plan


# -------------------------------------------------------- search + tune()
def test_successive_halving_deterministic_tiebreak():
    class Flat:
        num_probes = 0

        def evaluate(self, plan, steps, iters):
            return 100.0
    cands = [SuperstepPlan(strategy="flat", frontier_cap=c)
             for c in (8, 16, 32, 64)]
    for _ in range(3):
        best, _ = successive_halving(cands, Flat(), rungs=((2, 1), (8, 1)))
        assert best == 0


def test_successive_halving_reseeds_must_keep_into_final_rung():
    class CheapRungLies:
        def __init__(self):
            self.rung_calls = []

        def evaluate(self, plan, steps, iters):
            self.rung_calls.append((plan.frontier_cap, steps))
            cap = plan.frontier_cap or 0
            return (1000 - cap) if steps == 2 else cap + 1
    cands = [SuperstepPlan(strategy="flat", frontier_cap=c)
             for c in (8, 16, 32)] + [SuperstepPlan()]
    ev = CheapRungLies()
    best, _ = successive_halving(cands, ev, rungs=((2, 1), (8, 1)),
                                 must_keep=(3,))
    assert best == 3
    assert (None, 8) in ev.rung_calls


def test_tune_fixed_evaluator_stable_winner(scenario, tmp_path):
    prog, g = scenario
    winners = []
    for i in range(2):
        res = _tuned(prog, g, tmp_path / f"c{i}.json")
        assert not res.from_cache and res.num_probes > 0
        winners.append(res.plan)
    assert winners[0] == winners[1]
    assert winners[0].strategy != "dense"


def test_tune_cache_hit_runs_zero_probes(scenario, tmp_path):
    prog, g = scenario
    path = tmp_path / "plans.json"
    first = _tuned(prog, g, path)
    ev = _evaluator(ExplodingEvaluator, prog, g)
    hit = tune(prog, g, cache=path, space=SMOKE_SPACE, evaluator=ev)
    assert hit.from_cache and hit.num_probes == 0 and ev.num_probes == 0
    assert hit.plan == first.plan and hit.key == first.key
    again = tune(prog, g, cache=path, space=SMOKE_SPACE, force=True,
                 evaluator=_evaluator(CostModelEvaluator, prog, g))
    assert not again.from_cache and again.plan == first.plan


def test_tune_stores_default_measurement(scenario, tmp_path):
    prog, g = scenario
    res = _tuned(prog, g, tmp_path / "c.json")
    entry = PlanCache(tmp_path / "c.json").entry(res.key)
    assert entry["probe_us"] <= entry["default_us"]
    assert entry["space_size"] > 1


# ------------------------------------------------------ engine integration
def test_engine_auto_tuned_adopts_cached_plan(scenario, tmp_path):
    prog, g = scenario
    path = tmp_path / "plans.json"
    res = _tuned(prog, g, path)
    eng = GREEngine(prog, plan="auto-tuned", plan_cache=path)
    part = DevicePartition.from_graph(g, device="cpu")
    state = eng.init_state(part, source=0)
    assert eng.frontier == res.plan.strategy
    assert eng.frontier_cap == res.plan.frontier_cap
    assert eng.make_plan() == dataclasses.replace(res.plan,
                                                  bucket_bounds=None)
    ref_eng = GREEngine(prog)
    ref = ref_eng.run(part, ref_eng.init_state(part, source=0), 200)
    got = eng.run(part, state, 200)
    assert torch.equal(got.vertex_data, ref.vertex_data)


def test_engine_auto_tuned_miss_keeps_defaults(scenario, tmp_path):
    prog, g = scenario
    eng = GREEngine(prog, plan="auto-tuned",
                    plan_cache=tmp_path / "empty.json")
    part = DevicePartition.from_graph(g, device="cpu")
    eng.init_state(part, source=0)
    assert eng.frontier == "auto" and eng.frontier_cap is None
    assert not eng._auto_plan_pending
    assert eng.make_plan().kernel == KernelPlan(use_pallas=False)


# ------------------------------------------- mutation: fingerprint refresh
def _removal(g, size, seed):
    pick = np.random.default_rng(seed).choice(g.num_edges, size=size,
                                              replace=False)
    return EdgeDelta(rem_src=g.src[pick], rem_dst=g.dst[pick])


def test_fingerprint_counts_live_edges_not_padded_length():
    g = circulant_graph(1 << 9, degree=8)
    part = DevicePartition.from_graph(g, device="cpu")
    half, rep = part.apply_edge_delta(_removal(g, g.num_edges // 2, 0))
    assert not rep.compacted
    assert half.src.shape == part.src.shape
    assert partition_fingerprint(half) != partition_fingerprint(part)


def test_refresh_plan_absorbs_small_delta(scenario, tmp_path):
    prog, g = scenario
    path = tmp_path / "plans.json"
    _tuned(prog, g, path)
    eng = GREEngine(prog, plan="auto-tuned", plan_cache=path)
    part = DevicePartition.from_graph(g, device="cpu")
    eng.init_state(part, source=0)
    adopted = (eng.frontier, eng.frontier_cap)
    small, _ = part.apply_edge_delta(_removal(g, 5, 1))
    assert eng.refresh_plan(small) is False
    assert (eng.frontier, eng.frontier_cap) == adopted


def test_refresh_plan_rekeys_large_delta_and_adopts(scenario, tmp_path):
    prog, g = scenario
    path = tmp_path / "plans.json"
    _tuned(prog, g, path)
    eng = GREEngine(prog, plan="auto-tuned", plan_cache=path)
    part = DevicePartition.from_graph(g, device="cpu")
    eng.init_state(part, source=0)
    old_key = eng._plan_key
    assert old_key is not None
    big, _ = part.apply_edge_delta(_removal(g, g.num_edges // 2, 2))
    new_key = plan_cache_key(part=big, program=prog, mesh_size=1,
                             frontier_hist=eng._plan_hist)
    assert new_key != old_key
    PlanCache(path).store(new_key, SuperstepPlan(strategy="flat",
                                                 frontier_cap=16))
    assert eng.refresh_plan(big) is True
    assert eng._plan_key == new_key
    assert eng.frontier == "flat" and eng.frontier_cap == 16
    assert GREEngine(prog).refresh_plan(big) is False


def test_rerun_incremental_refreshes_plan(scenario, tmp_path):
    """`rerun_incremental` re-keys the tuned plan against the mutated
    partition and passes the adopted ladder to the delta ingress; the warm
    result equals a cold run on the mutated graph bitwise."""
    prog, g = scenario
    path = tmp_path / "plans.json"
    _tuned(prog, g, path)
    eng = GREEngine(prog, plan="auto-tuned", plan_cache=path)
    part = DevicePartition.from_graph(g, device="cpu")
    prev = eng.run(part, eng.init_state(part, source=0), 200)
    old_key = eng._plan_key
    new_part, out, _ = eng.rerun_incremental(
        part, prev, _removal(g, g.num_edges // 2, 3), source=0,
        max_steps=200)
    assert eng._plan_key != old_key       # re-keyed: the bin moved
    cold = GREEngine(prog)
    want = cold.run(new_part, cold.init_state(new_part, source=0), 200)
    assert torch.equal(out.vertex_data, want.vertex_data)


def test_dist_engine_plan_maps_phase_to_exchange(scenario):
    prog, _ = scenario
    dist = DistGREEngine(prog, 2, exchange="pipelined", device="cpu")
    dist.adopt_plan(SuperstepPlan(strategy="flat", frontier_cap=32,
                                  phases="sync"))
    assert dist.exchange == "agent"
    assert dist.frontier_cap == 32 and dist.local.frontier_cap == 2 * 32
    assert dist.plan.phases == "sync"
    dist.adopt_plan(SuperstepPlan(phases="pipelined"))
    assert dist.exchange == "pipelined" and dist.plan.phases == "pipelined"
    dist.adopt_plan(SuperstepPlan(phases="async", staleness=4))
    assert dist.exchange == "async" and dist.plan.staleness == 4
    overlap = DistGREEngine(prog, 2, exchange="agent", overlap=True,
                            device="cpu")
    overlap.adopt_plan(SuperstepPlan(phases="sync"))
    assert overlap.plan.phases == "sync"
    pr = DistGREEngine(algorithms.pagerank_program(), 2, device="cpu")
    with pytest.raises(ValueError, match="monotone"):
        pr.adopt_plan(SuperstepPlan(phases="async", staleness=2))


def test_dist_engine_auto_tuned_consults_mesh_keyed_cache(scenario,
                                                         tmp_path):
    prog, g = scenario
    ag = build_agent_graph(g, greedy_partition(g, 1), 1)
    path = tmp_path / "plans.json"
    PlanCache(path).store(plan_cache_key(agent_graph=ag, program=prog,
                                         mesh_size=1),
                          SuperstepPlan(strategy="flat", frontier_cap=32))
    dist = DistGREEngine(prog, 1, plan="auto-tuned", plan_cache=path,
                         device="cpu")
    out, _ = dist.run(ag, source=0, max_steps=200)
    assert dist.local.frontier == "flat" and dist.local.frontier_cap == 32
    assert not dist._auto_plan_pending
    ref, _ = DistGREEngine(prog, 1, device="cpu").run(ag, source=0,
                                                      max_steps=200)
    np.testing.assert_array_equal(np.nan_to_num(out, posinf=-1.0),
                                  np.nan_to_num(ref, posinf=-1.0))


# ------------------------------------------------------ parity with JAX
def _jax_graph(g):
    return to_graph(g, JaxGraph)


SPACES = {"default": ({}, {}),
          "smoke": ({"cap_multipliers": (1.0, 2.0),
                     "bucket_bounds": (None,)}, {}),
          "dist": ({"phases": ("sync", "pipelined", "async")},
                   {"has_split_tiles": True, "monotone": True}),
          "iterative": ({}, {"dense_frontier": True})}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_candidates_equal_jax(rmat7, name):
    """`PlanSearchSpace().candidates(...)` of the same scenario (slots and
    the capacity anchored on the probe histogram, which both packages
    measure alike) equals the JAX package's, element by element, through
    `to_json`."""
    kw, flags = SPACES[name]
    prog, jprog = algorithms.bfs_program(), jalg.bfs_program()
    part = DevicePartition.from_graph(rmat7, device="cpu")
    jpart = JaxPartition.from_graph(_jax_graph(rmat7))
    eng, jeng = GREEngine(prog), JaxEngine(jprog)
    hist = eng.probe_frontier_hist(part, eng.init_state(part, source=0))
    assert hist == jeng.probe_frontier_hist(
        jpart, jeng.init_state(jpart, source=0))
    base = default_cap(part.num_slots, hist)
    got = [p.to_json() for p in PlanSearchSpace(**kw).candidates(
        part.num_slots, base, **flags)]
    want = [p.to_json() for p in JaxSpace(**kw).candidates(
        jpart.num_slots, base, **flags)]
    assert got == want and got


@pytest.mark.parametrize("hist", [None, [1, 9]])
def test_partition_key_equals_jax(rmat7, hist):
    for prog, jprog in ((algorithms.sssp_program(), jalg.sssp_program()),
                        (algorithms.pagerank_program(),
                         jalg.pagerank_program()),
                        (algorithms.bfs_program(8), jalg.bfs_program(8))):
        part = DevicePartition.from_graph(rmat7, device="cpu")
        jpart = JaxPartition.from_graph(_jax_graph(rmat7))
        assert (plan_cache_key(part=part, program=prog, frontier_hist=hist)
                == jax_key(part=jpart, program=jprog, frontier_hist=hist))


def test_mutated_partition_key_equals_jax(rmat7):
    """Live-edge counting after a delta (tombstones keep the padded
    length) gives the JAX package's key."""
    from repro.graph.structures import EdgeDelta as JaxDelta
    delta = _removal(rmat7, rmat7.num_edges // 2, 4)
    part, _ = DevicePartition.from_graph(rmat7, device="cpu"
                                         ).apply_edge_delta(delta)
    jpart, _ = JaxPartition.from_graph(_jax_graph(rmat7)).apply_edge_delta(
        JaxDelta(rem_src=delta.rem_src, rem_dst=delta.rem_dst))
    prog, jprog = algorithms.sssp_program(), jalg.sssp_program()
    assert (plan_cache_key(part=part, program=prog)
            == jax_key(part=jpart, program=jprog))


def test_agent_graph_key_equals_jax(rmat7):
    """The same k = 4 HDRF agent graph gives the JAX package's key, with
    `mesh_size` = the shard count."""
    jg = _jax_graph(rmat7)
    ag = build_agent_graph(rmat7, partition_edges(rmat7, 4, method="hdrf"),
                           4, partitioner="hdrf")
    jag = jax_build_agent_graph(jg, jax_partition_edges(jg, 4,
                                                        method="hdrf"),
                                4, partitioner="hdrf")
    got = plan_cache_key(agent_graph=ag, program=algorithms.sssp_program(),
                         mesh_size=4)
    assert got == jax_key(agent_graph=jag, program=jalg.sssp_program(),
                          mesh_size=4)
    assert "p:hdrf" in got and "|mesh4" in got


def test_tune_entry_equals_jax(scenario, tmp_path):
    """`tune` with the same deterministic evaluator stores the JAX
    package's entry: key, winner, default time (the engine's default plan
    seeded into the final rung) and space size."""
    prog, g = scenario
    res = _tuned(prog, g, tmp_path / "port.json")
    jres = jax_tune(jalg.bfs_program(), _jax_graph(g),
                    cache=tmp_path / "jax.json", space=JaxSpace(
                        cap_multipliers=(1.0, 2.0), bucket_bounds=(None,)),
                    evaluator=JaxCostModelEvaluator(jalg.bfs_program(),
                                                    _jax_graph(g)))
    assert res.key == jres.key
    assert res.plan.to_json() == jres.plan.to_json()
    assert (res.probe_us, res.default_us) == (jres.probe_us,
                                              jres.default_us)
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


def test_cache_file_reads_across_packages(tmp_path):
    plans = [SuperstepPlan(strategy="compact", frontier_cap=64,
                           bucket_bounds=(4, 16, 64, 256)),
             SuperstepPlan(phases="async", staleness=3),
             SuperstepPlan(strategy="dense", dense_frontier=True,
                           kernel=KernelPlan(use_pallas=True))]
    port_file, jax_file = tmp_path / "port.json", tmp_path / "jax.json"
    for i, plan in enumerate(plans):
        PlanCache(port_file).store(f"k{i}", plan, probe_us=1.5)
        JaxCache(jax_file).store(f"k{i}", JaxPlan.from_json(plan.to_json()),
                                 probe_us=1.5)
    assert port_file.read_text() == jax_file.read_text()
    for i, plan in enumerate(plans):
        assert JaxCache(port_file).lookup(f"k{i}").to_json() == plan.to_json()
        assert PlanCache(jax_file).lookup(f"k{i}") == plan


def test_probe_evaluator_tunes_on_cpu(rmat7, tmp_path):
    """A measured `tune` (real clocks) over `SMOKE_SPACE` on the CPU: every
    candidate gets a cheap rung, the winner is no slower than the default
    at its final rung, and a second call hits the cache with no probe."""
    prog = algorithms.sssp_program()
    ev = ProbeEvaluator(prog, rmat7, device="cpu")
    res = tune(prog, rmat7, cache=tmp_path / "c.json", space=SMOKE_SPACE,
               evaluator=ev)
    assert not res.from_cache and res.num_probes >= 6
    assert 0.0 < res.probe_us <= res.default_us
    n = ev.num_probes
    hit = tune(prog, rmat7, cache=tmp_path / "c.json", space=SMOKE_SPACE,
               evaluator=ev)
    assert hit.from_cache and hit.num_probes == 0 and ev.num_probes == n
    eng = GREEngine(prog, plan="auto-tuned", plan_cache=tmp_path / "c.json")
    part = ev.partition(res.plan.bucket_bounds)
    got = eng.run(part, eng.init_state(part, source=0), 500)
    ref = GREEngine(prog)
    want = ref.run(part, ref.init_state(part, source=0), 500)
    assert eng.frontier == res.plan.strategy
    assert torch.equal(got.vertex_data, want.vertex_data)


def test_probe_out_of_device_memory_ranks_last(rmat7, tmp_path,
                                               monkeypatch):
    """A candidate whose probe runs out of device memory measures inf, so
    the search goes on and never picks it."""
    prog = algorithms.sssp_program()
    run = GREEngine.run

    def run_or_oom(self, part, state, max_steps=100):
        if self.frontier == "flat":
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return run(self, part, state, max_steps)
    monkeypatch.setattr(GREEngine, "run", run_or_oom)
    ev = ProbeEvaluator(prog, rmat7, device="cpu")
    assert ev.evaluate(SuperstepPlan(strategy="flat", frontier_cap=64)) \
        == float("inf")
    res = tune(prog, rmat7, cache=tmp_path / "c.json", space=SMOKE_SPACE,
               evaluator=ev)
    assert res.plan.strategy != "flat" and res.probe_us < float("inf")


def test_probe_of_a_tile_beyond_the_kernels_lanes_ranks_last(rmat7,
                                                            monkeypatch):
    """A candidate whose widest tile holds more lanes than the kernels
    index measures inf without running; the others run."""
    from repro_torch.tuning import evaluator
    ev = ProbeEvaluator(algorithms.sssp_program(), rmat7, device="cpu")
    part = ev.partition()
    flat = SuperstepPlan(strategy="flat", frontier_cap=64)
    lanes = evaluator.widest_tile(flat, part)
    assert lanes == 64 * part.csr_max_deg
    assert evaluator.widest_tile(SuperstepPlan(strategy="dense"), part) == 0
    monkeypatch.setattr(evaluator, "MAX_LANES", lanes - 1)
    assert ev.evaluate(flat) == float("inf") and ev.num_probes == 1
    assert ev.evaluate(SuperstepPlan(strategy="dense")) < float("inf")


def test_cached_plan_executes_bitwise_identical(rmat7, tmp_path):
    plan = SuperstepPlan(strategy="compact", frontier_cap=64,
                         bucket_bounds=(4, 16, 64, 256))
    cache = PlanCache(tmp_path / "plans.json")
    cache.store("k", plan, probe_us=1.0)
    reloaded = PlanCache(tmp_path / "plans.json").lookup("k")
    assert reloaded == plan
    prog = algorithms.sssp_program()
    finals = []
    for p in (plan, reloaded):
        eng = GREEngine(prog, plan=p)
        part = DevicePartition.from_graph(rmat7, bucket_bounds=p.bucket_bounds,
                                          device="cpu")
        finals.append(eng.run(part, eng.init_state(part, source=0), 64))
    assert torch.equal(finals[0].vertex_data, finals[1].vertex_data)


def test_sum_monoid_serving_clamps_tuned_compact_plan(rmat7, tmp_path):
    """A compacted plan reaching a PPR batcher, by `plan=` or by a
    `plan="auto-tuned"` cache hit, is clamped back to the dense frontier,
    and every answer equals a fresh dense batcher's bitwise."""
    class SparseWins(ProbeEvaluator):
        def evaluate(self, plan, probe_steps=2, iters=1):
            self.num_probes += 1
            if plan.strategy == "dense":
                return 1e6
            return 1000.0 + float(plan.frontier_cap or 10 ** 5)

    scen_prog = algorithms.bfs_program()
    scen = circulant_graph(1 << 9, degree=8)
    res = tune(scen_prog, scen, cache=tmp_path / "plans.json",
               space=SMOKE_SPACE, evaluator=SparseWins(scen_prog, scen,
                                                       device="cpu"))
    assert res.plan.strategy != "dense" and not res.plan.dense_frontier
    prog = algorithms.ppr_push_program(4)
    part = DevicePartition.from_graph(rmat7, device="cpu")
    path = tmp_path / "ppr.json"
    PlanCache(path).store(plan_cache_key(part=part, program=prog,
                                         frontier_hist=[]), res.plan)
    for eng in (GREEngine(prog, plan=res.plan),
                GREEngine(prog, plan="auto-tuned", plan_cache=path)):
        b = GraphQueryBatcher(eng, part)
        assert eng.frontier == "dense" and not eng.dense_frontier
        for s in (0, 3, 17, 42, 99, 8):
            b.submit(s)
        done = b.run()
        assert [q.status for q in done] == ["done"] * 6
        for q in done:
            fresh = GraphQueryBatcher(GREEngine(prog, frontier="dense"),
                                      part)
            fresh.submit(q.source)
            (ref,) = fresh.run()
            assert np.array_equal(ref.result, q.result), q.uid


def test_batcher_swap_refreshes_plan(scenario, tmp_path):
    """After a delta the batcher re-keys its engine's tuned plan
    (`refresh_plan`) before it serves the mutated graph."""
    prog = algorithms.bfs_program(4)
    g = scenario[1]
    part = DevicePartition.from_graph(g, device="cpu")
    eng = GREEngine(prog, plan="auto-tuned",
                    plan_cache=tmp_path / "empty.json")
    b = GraphQueryBatcher(eng, part)
    old_key = eng._plan_key
    assert old_key is not None
    b.apply_delta(_removal(g, g.num_edges // 2, 5), policy="finish")
    assert eng._plan_key != old_key


def test_bucketed_tile_occupancy_counts_valid_lanes(rmat7):
    """Valid lanes over tile lanes of the bucketed gather: every live
    member's out-edges are valid lanes, and the tile holds at least as
    many lanes."""
    part = DevicePartition.from_graph(rmat7, device="cpu")
    eng = GREEngine(algorithms.bfs_program(), frontier="compact")
    state = eng.superstep(part, eng.init_state(part, source=0))
    plan = eng.make_plan().frontier(part)
    assert plan.kind == "bucketed"
    visited, total = bucketed_tile_occupancy(part, state.active_scatter,
                                             plan.caps)
    deg = (part.csr_indptr[1:] - part.csr_indptr[:-1])
    assert visited == int(deg[state.active_scatter].sum()) > 0
    assert total >= visited
