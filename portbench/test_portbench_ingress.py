"""Each deployment builds its own device state from the host graph
(`deploy/<deployment>.py::ingress`): a sharded Agent-Graph deployment runs
through the unchanged harness in every cell and is checked against the
float64 reference, and a deployment without `ingress` is refused."""
import sys
import time
import types
from collections import Counter, deque

import pytest

from portbench import harness

SPEC = harness.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
KEY = "portbench.deploy.engine"
SHARDS = 2
SEED = 2**31 + 211
WINDOW_S = 1.0


def sharded_ingress(graph, cfg, seed, device):
    """Hash placement into `SHARDS` shards, the agent graph, and the
    stacked shards' topology on `device`.  A sync Agent-Graph topology
    does not depend on the program: any one builds it."""
    del cfg, seed
    t0 = time.perf_counter()
    from repro_torch.core import algorithms
    from repro_torch.core.agent_graph import build_agent_graph
    from repro_torch.core.dist_engine import DistGREEngine
    ag = build_agent_graph(graph, "hash", k=SHARDS)
    topo = DistGREEngine(algorithms.pagerank_program(), SHARDS,
                         exchange="agent", device=device
                         ).device_topology(ag)
    sharded_ingress.seconds = time.perf_counter() - t0
    return {"ag": ag, "topo": topo, "device": device}


class ShardedDeployment:
    """Jobs one at a time, each kind on its own `DistGREEngine` with the
    agent exchange over the shards `sharded_ingress` built; answers in
    original vertex ids."""

    def __init__(self, cfg, state, kinds, tracer):
        from repro_torch.core.dist_engine import DistGREEngine
        self.ag, self.topo = state["ag"], state["topo"]
        self.settings = cfg["kinds"]
        self.engines = {
            kind: DistGREEngine(mod.program(), SHARDS, exchange="agent",
                                frontier=self.settings[kind]["frontier"],
                                device=state["device"])
            for kind, mod in kinds.items()}
        self.tracer = tracer
        self.queue = deque()
        self.finished = Counter()

    def submit(self, req):
        self.queue.append(req)

    def step(self):
        req = self.queue.popleft()
        eng = self.engines[req.kind]
        state = eng.init_state(self.ag, source=req.root)
        run = eng.make_run(self.ag, self.settings[req.kind]["max_steps"])
        out = run(self.topo, state)
        req.result = eng.original_order(self.ag, out.vertex_data)
        req.supersteps = int(out.step)
        self.finished[req.kind] += 1
        return [req]

    def warmed_up(self):
        return all(self.finished[k] >= 1 for k in self.engines)

    def close(self):
        self.engines.clear()
        self.queue.clear()


def deployment_module(**attrs):
    mod = types.ModuleType(KEY)
    for name, value in attrs.items():
        setattr(mod, name, value)
    return mod


@pytest.mark.parametrize("cell", CELLS)
def test_sharded_deployment_runs_through_the_harness(cell, monkeypatch):
    from repro_torch.core.engine import DevicePartition

    def whole_graph(*args, **kwargs):
        raise AssertionError("the whole graph's DevicePartition was built")
    monkeypatch.setattr(DevicePartition, "from_graph",
                        staticmethod(whole_graph))
    monkeypatch.setitem(sys.modules, KEY, deployment_module(
        ingress=sharded_ingress, Deployment=ShardedDeployment))
    res = harness.run_cell(cell, SEED, WINDOW_S, False, device="cpu",
                           overrides={"scale": 8})
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    rec = res["record"]
    # `ingress_s` is the sharded ingress, timed by the harness around it
    inner = sharded_ingress.seconds
    assert inner <= rec.ingress_seconds < inner + 0.5
    assert rec.ingress_seconds < rec.setup_seconds
    assert res["parts"]["metrics"]["ingress_s"].read(rec) == \
        rec.ingress_seconds
    # no whole-graph partition: the CSR phase of its ingress reads nothing
    assert res["parts"]["metrics"]["ingress_csr_s"].read(rec) is None


@pytest.mark.parametrize("cell", CELLS)
def test_deployment_without_ingress_is_refused(cell, monkeypatch):
    monkeypatch.setitem(sys.modules, KEY, deployment_module(
        Deployment=ShardedDeployment))
    with pytest.raises(harness.CellError, match="portbench/deploy/engine.py"):
        harness.resolve(SPEC, cell)


def test_engine_ingress_is_the_whole_graph_partition(monkeypatch):
    """`deploy/engine.py::ingress` hands the graph and the device to
    `DevicePartition.from_graph` and returns its partition."""
    from repro_torch.core.engine import DevicePartition
    calls = []

    def whole_graph(graph, device=None):
        calls.append((graph, device))
        return "partition"
    monkeypatch.setattr(DevicePartition, "from_graph",
                        staticmethod(whole_graph))
    parts = harness.resolve(SPEC, CELLS[0])
    graph = object()
    assert parts["deploy"].ingress(graph, parts["cfg"], 2**33 + 1,
                                   "cpu") == "partition"
    assert calls == [(graph, "cpu")]
