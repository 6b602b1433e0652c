"""The dense scan's messages (`repro_torch.kernels.gather_messages`): the
plain version against the route the engine took before the kernel, the
declared forms against the programs' `scatter_msg`, the engine's dispatch,
the ranking of the source slots, the wrapper's refusals, and the metric
`gather_launches_per_query` on a run.  The kernel itself runs only on a
card (the `cuda` test here, and `chip_smoke.py`)."""
import dataclasses
import math
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.kernels as kernels_pkg
from repro_torch.core import algorithms
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.core.vertex_program import segment_combine
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.structures import EdgeDelta
from repro_torch.kernels import _build
from repro_torch.kernels import gather_messages as gm

METRIC = "gather_launches_per_query"

# the shipped scalar programs that declare a form
SCALAR = {"pagerank": algorithms.pagerank_program,
          "sssp": algorithms.sssp_program, "cc": algorithms.cc_program,
          "bfs": algorithms.bfs_program}


@pytest.fixture(scope="module")
def graph():
    return rmat_edges(scale=8, edge_factor=8, seed=3, weights=True).dedup()


def _padded(graph):
    return DevicePartition.from_graph(graph, pad_to=graph.num_edges + 13,
                                      device="cpu")


def _tombstoned(graph):
    """A partition after a delta: removed edges are tombstones (masked, both
    ends at the sink), added ones take slack slots."""
    part = DevicePartition.from_graph(graph, edge_slack=64, device="cpu")
    pick = np.random.default_rng(4).choice(graph.num_edges, 40,
                                           replace=False)
    delta = EdgeDelta(add_src=[1, 2, 3], add_dst=[7, 8, 9],
                      add_props={"weight": np.float32([5.0, 6.0, 7.0])},
                      rem_src=graph.src[pick], rem_dst=graph.dst[pick])
    new, _ = part.apply_edge_delta(delta)
    assert int((~new.edge_mask).sum()) > 40
    return new


PARTITIONS = {"padded": _padded, "tombstoned": _tombstoned}


def _state(eng, part, seed):
    """Random values (some infinite, the sink's too) and a random activity
    mask over every slot, the sink included."""
    g = torch.Generator().manual_seed(seed)
    n = part.num_slots
    x = torch.rand(n, generator=g) * 50.0
    x[torch.rand(n, generator=g) < 0.2] = math.inf
    active = torch.rand(n, generator=g) < 0.4
    return dataclasses.replace(eng.init_state(part, source=0)
                               if eng.program.halts else eng.init_state(part),
                               scatter_data=x, active_scatter=active)


def _todays_messages(eng, part, state):
    """The dense route's messages before the kernel: `index_select` of the
    values and the activity, `scatter_msg`, the mask and the select."""
    p = eng.program
    eprop = (part.edge_props[p.needs_edge_prop] if p.needs_edge_prop
             else None)
    msgs = p.scatter_msg(state.scatter_data.index_select(0, part.src), eprop)
    if eng.dense_frontier:
        return msgs.to(p.msg_dtype)
    live = state.active_scatter.index_select(0, part.src) & part.edge_mask
    return torch.where(live, msgs.to(p.msg_dtype), p.monoid.identity)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("layout", sorted(PARTITIONS))
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("name", sorted(SCALAR))
def test_plain_equals_todays_route(graph, name, dense, layout):
    """Bitwise, on every edge (padding, the sink and tombstones included),
    with the dense frontier and with random activity; the engine's combine
    too."""
    part = PARTITIONS[layout](graph)
    eng = GREEngine(SCALAR[name](), dense_frontier=dense)
    state = _state(eng, part, seed=len(name) + 2 * dense)
    p = eng.program
    want = _todays_messages(eng, part, state)
    got = gm.gather_messages_plain(
        state.scatter_data, part.src, p.message,
        prop=part.edge_props.get(p.needs_edge_prop),
        active=None if dense else state.active_scatter,
        edge_mask=None if dense else part.edge_mask,
        identity=p.monoid.identity)
    assert torch.equal(_bits(got), _bits(want))
    combined = eng.dense_scatter_combine(part, state)
    ref = segment_combine(want, part.dst, part.num_slots, p.monoid,
                          indices_are_sorted=True, seg_ptr=part.seg_ptr)
    assert torch.equal(_bits(combined), _bits(ref))


DECLARED = {"pagerank": algorithms.pagerank_program,
            "sssp": algorithms.sssp_program,
            "sssp_x4": lambda: algorithms.sssp_program(4),
            "cc": algorithms.cc_program, "bfs": algorithms.bfs_program,
            "bfs_x4": lambda: algorithms.bfs_program(4),
            "ppr_x3": lambda: algorithms.ppr_push_program(3),
            "gnn_aggregate": lambda: algorithms.gnn_aggregate_program(5)}


# each form's message as the paper writes it, the edge property broadcast
# over payload lanes
WRITTEN = {"copy": lambda x, w: x,
           "add_prop": lambda x, w: x + (w if x.dim() == 1 else w[:, None]),
           "add_one": lambda x, w: x + 1.0}


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_declared_form_is_scatter_msg(name):
    """A program's `scatter_msg` is its declared form's, and computes that
    form's message as written out, bitwise, on values with infinities and
    on payload lanes."""
    p = DECLARED[name]()
    assert p.message in gm.FORMS
    g = torch.Generator().manual_seed(11)
    x = torch.rand((300,) + tuple(p.payload_shape), generator=g) * 1e4
    x[torch.rand(x.shape, generator=g) < 0.1] = math.inf
    # the engine hands `scatter_msg` the property the program names, if any
    prop = (torch.rand(300, generator=g) * 65535.0 if p.needs_edge_prop
            else None)
    got = p.scatter_msg(x, prop)
    assert torch.equal(_bits(got), _bits(gm.form_messages(p.message, x,
                                                          prop)))
    assert torch.equal(_bits(got), _bits(WRITTEN[p.message](x, prop)))


def test_undeclared_programs_keep_none():
    assert algorithms.degree_program().message is None
    assert algorithms.gnn_aggregate_program(5, edge_weighted=True).message \
        is None


def _counted(monkeypatch):
    """Count the engine's calls of the kernel's dispatch."""
    calls = []
    real = gm.gather_messages

    def spy(*args, **kwargs):
        calls.append(args[2])
        return real(*args, **kwargs)
    monkeypatch.setattr(gm, "gather_messages", spy)
    return calls


KEPT = {   # the program, its init_state arguments, a gradient wanted
    "sssp_x4": (lambda: algorithms.sssp_program(4), {"source": [0, 1, 2, 3]},
                False),
    "bfs_x4": (lambda: algorithms.bfs_program(4), {"source": [0, 1, 2, 3]},
               False),
    "degree": (algorithms.degree_program, {}, False),
    "pagerank_undeclared": (lambda: dataclasses.replace(
        algorithms.pagerank_program(), message=None), {}, False),
    "pagerank_grad": (algorithms.pagerank_program, {}, True),
    "sssp_float64_weight": (algorithms.sssp_program, {"source": 0}, False),
}


@pytest.mark.parametrize("case", sorted(KEPT))
def test_other_programs_keep_todays_route(graph, case, monkeypatch):
    """Payload lanes, undeclared messages, a gradient wanted and a prop that
    is not float32 keep the tensor operations: the dispatch is not
    called, and `LAUNCHES` does not move."""
    part = _padded(graph)
    if case == "sssp_float64_weight":
        part.edge_props["weight"] = part.edge_props["weight"].double()
    program, kw, grad = KEPT[case]
    eng = GREEngine(program())
    state = eng.init_state(part, **kw)
    if grad:
        state = dataclasses.replace(
            state, scatter_data=state.scatter_data.clone().requires_grad_())
    calls = _counted(monkeypatch)
    before = dict(gm.LAUNCHES)
    eng.dense_scatter_combine(part, state)
    assert calls == [] and gm.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_declared_scalar_programs_take_the_dispatch(graph, name,
                                                    monkeypatch):
    """One dispatch a dense superstep, on the CPU the plain version: no
    launch is counted."""
    part = _padded(graph)
    eng = GREEngine(SCALAR[name](), frontier="dense")
    calls = _counted(monkeypatch)
    before = dict(gm.LAUNCHES)
    out = eng.run(part, eng.init_state(part, **(
        {"source": 0} if eng.program.halts else {})), max_steps=5)
    assert calls == [eng.program.message] * out.step
    assert gm.LAUNCHES == before
    assert part.src_ranking is None     # the CPU route reads no ranking


def test_rank_sources_orders_by_reads(graph):
    """`order` holds every slot some edge reads, most read first and ties
    by slot; the table in that order, gathered by rank, is the values
    gathered by slot, and a row's activity too."""
    part = _padded(graph)
    r = gm.rank_sources(part.src, part.num_slots)
    counts = torch.bincount(part.src.long(), minlength=part.num_slots)
    order = r.order.long()
    assert r.order.dtype == r.rank_of_src.dtype == torch.int32
    assert set(order.tolist()) == set(torch.nonzero(counts).view(-1).tolist())
    c = counts[order]
    assert bool((c[:-1] >= c[1:]).all())
    ties = c[:-1] == c[1:]
    assert bool((order[:-1][ties] < order[1:][ties]).all())
    x = torch.rand(part.num_slots)
    active = torch.rand(part.num_slots) < 0.5
    rank = r.rank_of_src.long()
    assert torch.equal(x[order][rank], x[part.src.long()])
    assert torch.equal(active[order][rank], active[part.src.long()])


def test_partition_ranking_follows_its_src(graph):
    part = _padded(graph)
    first = part.source_ranking()
    assert part.source_ranking() is first and part.src_ranking is first
    other = dataclasses.replace(part, src=part.src.clone())
    assert other.source_ranking() is not first
    assert other.src_ranking.src is other.src


def _valid_args():
    src = torch.tensor([0, 5, 2, 2], dtype=torch.int32)
    return {"x": torch.zeros(6), "src": src, "form": "add_prop",
            "prop": torch.ones(4), "active": torch.ones(6, dtype=torch.bool),
            "edge_mask": torch.ones(4, dtype=torch.bool),
            "ranking": gm.rank_sources(src, 6)}


BAD = {
    "form": (lambda a: dict(a, form="mul"), "form must be one of"),
    "float64_x": (lambda a: dict(a, x=a["x"].double()), "float32"),
    "int64_src": (lambda a: dict(a, src=a["src"].long()), "int32"),
    "no_prop": (lambda a: dict(a, prop=None), "add_prop needs"),
    "short_prop": (lambda a: dict(a, prop=a["prop"][:3]), "add_prop needs"),
    "active_alone": (lambda a: dict(a, edge_mask=None), "go together"),
    "short_active": (lambda a: dict(a, active=a["active"][:5]), "active"),
    "byte_mask": (lambda a: dict(a, edge_mask=a["edge_mask"].to(
        torch.uint8)), "edge_mask"),
    "no_ranking": (lambda a: dict(a, ranking=None), "needs the ranking"),
    "other_ranking": (lambda a: dict(a, ranking=gm.rank_sources(
        a["src"].clone(), 6)), "another src"),
    "cpu_tensors": (lambda a: a, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_cuda_wrapper_refuses_bad_input_before_launch(case, monkeypatch):
    def trap(*a, **k):
        raise AssertionError("the wrapper tried to build or launch")

    monkeypatch.setattr(_build, "load", trap)
    before = dict(gm.LAUNCHES)
    mutate, match = BAD[case]
    with pytest.raises(ValueError, match=match):
        gm.gather_messages_cuda(**mutate(_valid_args()))
    assert gm.LAUNCHES == before


def test_fake_tensors_make_the_output():
    """The dry run's fake tensors take the kernel's shape route."""
    with FakeTensorMode():
        x = torch.empty(10)
        src = torch.empty(7, dtype=torch.int32)
        out = gm.gather_messages(x, src, "copy")
        assert out.shape == (7,) and out.dtype == torch.float32
    assert gm.message_bytes(7, 10, "copy", False) == 7 * 8 + 40
    assert gm.message_bytes(7, 10, "add_prop", True) == 7 * 13 + 50


@pytest.fixture()
def metric(monkeypatch):
    """The metric's reader, with the JAX modules hidden from the harness
    (a test worker may have loaded them; the benchmark never does)."""
    from portbench import harness
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)
    return harness.plugin("metrics", METRIC)


def test_metric_reads_the_launches_of_a_run(metric, monkeypatch):
    """A traced CPU run of a cell with the dispatch counted as a launch
    (the plain CPU route counts none): the metric reads the counter as the
    window opens and closes."""
    from portbench import harness
    real = gm.gather_messages

    def launched(x, src, form, **kwargs):
        gm.LAUNCHES[form] += 1
        return real(x, src, form, **kwargs)
    monkeypatch.setattr(gm, "gather_messages", launched)
    cell = harness.benchmark()["workloads"][0]["name"]
    res = harness.run_cell(cell, 2**31 + 29, 0.5, True, device="cpu",
                           overrides={"scale": 8})
    before, after = res["record"].snapshots[METRIC]
    assert after > before >= 0
    got = res["metrics"][METRIC]["value"]
    steps = sum(r.supersteps for r in res["record"].completed)
    assert got == (after - before) / len(res["record"].completed)
    assert after - before == steps       # one launch a superstep


def test_metric_reads_nothing_without_the_module(metric, monkeypatch):
    monkeypatch.delattr(kernels_pkg, "gather_messages")
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.gather_messages",
                        None)
    assert metric.snapshot(None) is None
    run = type("Run", (), {"snapshots": {METRIC: (None, None)},
                           "completed": [object()]})()
    assert metric.read(run) is None


def test_metric_reads_nothing_where_nothing_launched(metric):
    start = metric.snapshot(None)
    run = type("Run", (), {"snapshots": {METRIC: (start, start)},
                           "completed": [object()]})()
    assert metric.read(run) is None


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: every form, with and without activity, bitwise against
    the plain version, aligned and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(5000, generator=g, device="cuda") * 100.0
    x[::7] = math.inf
    act = torch.rand(5000, generator=g, device="cuda") < 0.3
    for e in (1, 5, 4096, 100_003):
        src = torch.randint(0, 5000, (e + 1,), generator=g, device="cuda",
                            dtype=torch.int32)
        prop = torch.rand(e + 1, generator=g, device="cuda")
        mask = torch.rand(e + 1, generator=g, device="cuda") < 0.9
        for shift in (0, 1):
            s, w, m = (t[shift:shift + e] for t in (src, prop, mask))
            ranking = gm.rank_sources(s, 5000)
            for form in gm.FORMS:
                for activity in (False, True):
                    args = dict(x=x, src=s, form=form, prop=w,
                                active=act if activity else None,
                                edge_mask=m if activity else None,
                                identity=math.inf)
                    got = gm.gather_messages_cuda(**args, ranking=ranking)
                    assert torch.equal(_bits(got), _bits(
                        gm.gather_messages_plain(**args)))
