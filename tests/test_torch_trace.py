"""The port's spans (`repro_torch.trace`), the halt test's host-read
counter (`core.plan.HOST_READS`) and the ingress record
(`DevicePartition.ingress_s`), on the CPU."""
import time

import pytest
import torch

from repro_torch import trace
from repro_torch.core import algorithms, plan
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import DistGREEngine
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.graph.generators import rmat_edges

PHASES = ("fill", "sort_dst", "csr", "upload")
# each span and the span it opens inside
PARENT = {"gre.superstep": "gre.run", "gre.halt_test": "gre.run",
          "gre.scatter_combine": "gre.superstep",
          "gre.apply": "gre.superstep",
          "gre.frontier_counts": "gre.scatter_combine",
          "gre.gather": "gre.scatter_combine",
          "gre.message": "gre.scatter_combine",
          "gre.combine": "gre.scatter_combine"}


@pytest.fixture(scope="module")
def graph():
    return rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()


@pytest.fixture(scope="module")
def part(graph):
    return DevicePartition.from_graph(graph, device="cpu")


def _profiled(fn):
    """`fn()` under the CPU profiler: its result and the port's spans as
    `(start, end, name)`, sorted by start, the longer first."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(trace.PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    return out, spans, prof


def _parents(spans):
    """Each span with the name of the innermost span it lies inside."""
    stack, out = [], []
    for s, t, name in spans:
        while stack and stack[-1][1] < s:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, t, name))
    return out


def _count(spans, name):
    return sum(n == name for _, _, n in spans)


def _traversal(part, frontier):
    eng = GREEngine(algorithms.sssp_program(), frontier=frontier)
    return eng.run(part, eng.init_state(part, source=0), max_steps=1000)


def test_no_profiler_opens_no_range(part, monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_record",
                        lambda name: made.append(name) or trace._OFF)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a))
    _traversal(part, "auto")
    eng = GREEngine(algorithms.pagerank_program())
    eng.run(part, eng.init_state(part), max_steps=3)
    DevicePartition.from_graph(rmat_edges(scale=5, edge_factor=4, seed=2),
                               device="cpu")
    assert made == []
    assert trace.span("run") is trace.span("apply")


@pytest.mark.parametrize("frontier", ["dense", "compact"])
def test_sssp_spans_nest(part, frontier):
    out, spans, _ = _profiled(lambda: _traversal(part, frontier))
    assert out.step > 2 and _count(spans, "gre.superstep") == out.step
    assert _count(spans, "gre.run") == _count(spans, "gre.init_state") == 1
    assert _count(spans, "gre.halt_test") == out.step + 1
    nested = _parents(spans)
    for name, parent in nested:
        if name in PARENT:
            assert parent == PARENT[name], (name, parent)
    names = {n for n, _ in nested}
    assert {"gre.gather", "gre.combine", "gre.apply"} <= names
    assert ("gre.frontier_counts" in names) == (frontier == "compact")
    # the dense scan forms its messages inside the gather (the kernel's
    # route); the tile route still has a message stage
    assert ("gre.message" in names) == (frontier == "compact")


def test_pagerank_spans_nest(part):
    eng = GREEngine(algorithms.pagerank_program())
    out, spans, _ = _profiled(
        lambda: eng.run(part, eng.init_state(part), max_steps=7))
    assert out.step == 7 and _count(spans, "gre.superstep") == 7
    assert _count(spans, "gre.halt_test") == 7   # the cut reads nothing
    for name, parent in _parents(spans):
        if name in PARENT:
            assert parent == PARENT[name], (name, parent)


def test_spans_stay_off_the_device_timeline(part):
    """The spans are not user annotations, the ranges a profiler also lays
    over the device timeline."""
    _, spans, prof = _profiled(lambda: _traversal(part, "dense"))
    assert spans
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(trace.PREFIX))


def test_halt_reads_pagerank_reads_max_steps(part):
    eng = GREEngine(algorithms.pagerank_program())
    before = plan.HOST_READS["halt_test"]
    out = eng.run(part, eng.init_state(part), max_steps=12)
    assert out.step == 12
    assert plan.HOST_READS["halt_test"] - before == 12


@pytest.mark.parametrize("frontier", ["dense", "compact"])
def test_halt_reads_sssp_reads_steps_plus_one(part, frontier):
    before = plan.HOST_READS["halt_test"]
    out = _traversal(part, frontier)
    assert 2 < out.step < 1000
    assert plan.HOST_READS["halt_test"] - before == out.step + 1


def test_halt_reads_distributed_any(graph):
    ag = build_agent_graph(graph, "hdrf", 2)
    eng = DistGREEngine(algorithms.sssp_program(), 2, device="cpu")
    before = plan.HOST_READS["halt_test"]
    _, out = eng.run(ag, source=0, max_steps=1000)
    assert 2 < out.step < 1000
    assert plan.HOST_READS["halt_test"] - before == out.step + 1


def test_empty_frontier_reads_once(part):
    eng = GREEngine(algorithms.bfs_program(4))
    before = plan.HOST_READS["halt_test"]
    out, spans, _ = _profiled(lambda: eng.run(
        part, eng.init_state(part, source=[None, -1, None, None]),
        max_steps=10))
    assert out.step == 0 and _count(spans, "gre.superstep") == 0
    assert plan.HOST_READS["halt_test"] - before == 1


@pytest.mark.parametrize("sort_by_dst", [True, False])
def test_ingress_records_its_phases(graph, sort_by_dst):
    t0 = time.perf_counter()
    part = DevicePartition.from_graph(graph, sort_by_dst=sort_by_dst,
                                      device="cpu")
    wall = time.perf_counter() - t0
    assert tuple(part.ingress_s) == PHASES
    assert all(s >= 0 for s in part.ingress_s.values())
    assert sum(part.ingress_s.values()) <= wall
