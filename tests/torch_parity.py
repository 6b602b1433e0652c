"""Shared helpers of the parity tests between the JAX package (`repro`) and
its PyTorch port (`repro_torch`): both get the same numpy inputs, and
results come back as numpy arrays."""
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

PARTITION_ARRAYS = ("src", "dst", "edge_mask", "csr_indptr", "csr_eidx",
                    "bucket_id")
PARTITION_STATICS = ("num_masters", "num_slots", "edges_sorted_by_dst",
                     "csr_max_deg", "bucket_sizes", "bucket_max_deg")
STATE_ARRAYS = ("vertex_data", "scatter_data", "active_scatter", "step",
                "lane_active")


def _np(x):
    if x is None:
        return None
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def partition_arrays(part):
    """`(arrays, statics)` of a partition of either package, in the form
    `repro_torch.core.engine.DevicePartition.from_arrays` takes."""
    arrays = {k: _np(getattr(part, k)) for k in PARTITION_ARRAYS}
    arrays["edge_props"] = {k: _np(v) for k, v in part.edge_props.items()}
    arrays["aux"] = {k: _np(v) for k, v in part.aux.items()}
    statics = {k: getattr(part, k) for k in PARTITION_STATICS}
    return arrays, statics


def state_arrays(state):
    """Host arrays of an engine state of either package."""
    return {k: _np(getattr(state, k)) for k in STATE_ARRAYS}


def to_graph(graph, cls):
    """Re-wrap a `Graph` of one package as the other package's `Graph`."""
    return cls(graph.num_vertices, graph.src.copy(), graph.dst.copy(),
               {k: v.copy() for k, v in graph.edge_props.items()})


# bf16 attention outputs: two bf16 ulps of each element (2**-6 of it) plus
# 3% of the RMS of its row (the head dim), which covers elements that
# cancel to near 0; the same limit as chip_smoke.py's, whose readings of
# sound kernels and of planted faults PERF.md records.
BF16_RTOL, BF16_ROW_ATOL = 2.0 ** -6, 3e-2


def bf16_attention_error_ratio(got, want):
    """Worst |got - want| over its bf16 limit; above 1 fails."""
    got = np.asarray(_np(got), np.float32)
    want = np.asarray(_np(want), np.float32)
    rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
    limit = BF16_RTOL * np.abs(want) + BF16_ROW_ATOL * rms
    return float(np.max(np.abs(got - want) / np.maximum(limit, 1e-30)))


def mutation_delta(g, seed, frac=0.08, undirected=False):
    """A fixed-seed churn batch as a dict of `EdgeDelta` fields: retire
    `frac` of the live edges and add about as many fresh ones (symmetric
    pairs when `undirected`, so CC's both-directions invariant holds), with
    integer weights (exact in f32, so warm-vs-cold comparisons stay
    bitwise).  The batch of `tests/test_conformance.py::_mutation_delta`."""
    rng = np.random.default_rng(seed)
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    n = g.num_vertices
    if undirected:
        fwd = np.flatnonzero(src < dst)
        m = max(1, int(fwd.size * frac))
        pick = rng.choice(fwd, size=m, replace=False)
        rem_s = np.concatenate([src[pick], dst[pick]])
        rem_d = np.concatenate([dst[pick], src[pick]])
        u = rng.integers(0, n, size=m)
        v = (u + 1 + rng.integers(0, n - 1, size=m)) % n   # never u == v
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        _, first = np.unique(lo.astype(np.int64) * n + hi, return_index=True)
        keep = np.sort(first)
        u, v = u[keep], v[keep]
        add_s, add_d = np.concatenate([u, v]), np.concatenate([v, u])
        m_prop = keep.size
    else:
        m = max(1, int(g.num_edges * frac))
        pick = rng.choice(g.num_edges, size=m, replace=False)
        rem_s, rem_d = src[pick], dst[pick]
        add_s = rng.integers(0, n, size=m)
        add_d = rng.integers(0, n, size=m)
        _, first = np.unique(add_s.astype(np.int64) * n + add_d,
                             return_index=True)
        keep = np.sort(first)
        add_s, add_d = add_s[keep], add_d[keep]
        m_prop = keep.size
    props = {}
    for key in g.edge_props:
        w = rng.integers(1, 100, size=m_prop).astype(np.float32)
        props[key] = np.concatenate([w, w]) if undirected else w
    return dict(add_src=add_s, add_dst=add_d, add_props=props,
                rem_src=rem_s, rem_dst=rem_d)


def edge_delta(cls, fields, parts=("add", "rem")):
    """`cls(**fields)` (an `EdgeDelta` of either package), keeping only the
    adds and/or the removals."""
    kw = {k: v for k, v in fields.items()
          if k.split("_")[0] in parts}
    return cls(**kw)


def report_arrays(report):
    """The arrays and flag of a `DeltaReport` of either package."""
    return {k: np.asarray(getattr(report, k))
            for k in ("added_src", "added_dst", "removed_src", "removed_dst",
                      "compacted")}


# ------------------------------------ the JAX DistGREEngine at k = 4, once
# The graph and cases of tests/test_torch_dist_engine.py's comparison with
# JAX's DistGREEngine, which tests/test_torch_dist_ranks.py shares: R-MAT
# scale 8, edge factor 8, seed 1, HDRF onto 4 shards, four simulated CPU
# devices in one subprocess.
SRC = str(Path(__file__).resolve().parent.parent / "src")
JAX_K = 4
SOURCES4 = [0, 5, None, 77]
# the distributed tests' programs, which each package resolves against its
# own `algorithms` module (`make_program`): name -> (factory, its
# arguments, source, whether it runs on the undirected graph)
PROGRAMS = {"sssp": ("sssp_program", (), 0, False),
            "bfs": ("bfs_program", (), 0, False),
            "bfs_x4": ("bfs_program", (4,), SOURCES4, False),
            "cc": ("cc_program", (), None, True),
            "pagerank": ("pagerank_program", (), None, False)}
# backend name -> (exchange, its engine options)
BACKENDS = {"agent": ("agent", {}),
            "agent_overlap": ("agent", {"overlap": True}),
            "dense": ("dense", {}), "pipelined": ("pipelined", {}),
            "async_s1": ("async", {"staleness": 1}),
            "async_s2": ("async", {"staleness": 2}),
            "async_s3": ("async", {"staleness": 3}),
            "null": ("null", {})}
JAX_BACKENDS = ("agent", "agent_overlap", "dense", "pipelined", "async_s2",
                "async_s3")
# the JAX package's own PageRank differs between its backends in the last
# bit (ROADMAP Queue 3): held on the sync backends only
JAX_CASES = [(n, b) for n in PROGRAMS for b in JAX_BACKENDS
             if n != "pagerank" or b in ("agent", "agent_overlap", "dense")]


def make_program(algorithms, name):
    """`PROGRAMS[name]`'s program from a package's `algorithms` module."""
    factory, args, _, _ = PROGRAMS[name]
    return getattr(algorithms, factory)(*args)
PLAN_CAP = 16
PLAN_STRATEGIES = ("dense", "flat", "compact")

JAX_SCRIPT = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
import numpy as np
import jax
from repro.core import algorithms
from repro.core.agent_graph import build_agent_graph
from repro.core.dist_engine import DistGREEngine
from repro.graph.generators import rmat_edges

g = rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()
ags = {False: build_agent_graph(g, "hdrf", 4),
       True: build_agent_graph(g.as_undirected(), "hdrf", 4)}
mesh = jax.make_mesh((4,), ("graph",))
programs = PROGRAMS
backends = BACKENDS
out = {}
for name, backend in CASES:
    factory, args, source, undirected = programs[name]
    exchange, kw = backends[backend]
    eng = DistGREEngine(getattr(algorithms, factory)(*args), mesh,
                        ("graph",), exchange=exchange, **kw)
    res, st = eng.run(ags[undirected], source=source,
                      max_steps=20 if name == "pagerank" else 300)
    out[name + "/" + backend + "/vd"] = res
    out[name + "/" + backend + "/step"] = np.asarray(st.step)
from repro.core.dist_engine import _squeeze0
for ex in ("agent", "pipelined"):
    for strat in PLAN_STRATEGIES:
        eng = DistGREEngine(algorithms.sssp_program(), mesh, ("graph",),
                            exchange=ex, frontier=strat,
                            frontier_cap=PLAN_CAP)
        topo = eng.device_topology(ags[False])
        parts = ([topo.part] if ex == "agent"
                 else [topo.tiles.part_remote, topo.tiles.part_local])
        key = "plan/" + ex + "/" + strat
        out[key + "/cap"] = np.asarray(eng.plan.frontier_cap)
        out[key + "/strategy"] = np.asarray(eng.plan.strategy)
        for t, p in enumerate(parts):
            fp = eng.plan.frontier(_squeeze0(p))
            out[key + "/" + str(t) + "/kind"] = np.asarray(fp.kind)
            out[key + "/" + str(t) + "/caps"] = np.asarray(
                -1 if fp.caps is None else fp.caps)
np.savez(sys.argv[2], **out)
print("JAX_DIST_S", time.perf_counter() - t0)
"""


def jax_dist_results(tmp_path_factory) -> dict:
    """JAX `DistGREEngine`'s results of every `JAX_CASES` case (and the
    frontier plans at `PLAN_CAP`) as a dict of numpy arrays.  The
    subprocess runs once a test session: its `.npz` is kept in the
    session's temporary directory, shared by the xdist workers, under a
    file lock."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                     # shared by the workers
    path = root / "jax_dist_k4.npz"
    with open(root / "jax_dist_k4.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            script = (JAX_SCRIPT.replace("PROGRAMS", repr(PROGRAMS))
                      .replace("PLAN_STRATEGIES", repr(PLAN_STRATEGIES))
                      .replace("PLAN_CAP", repr(PLAN_CAP))
                      .replace("BACKENDS", repr({b: BACKENDS[b]
                                                 for b in JAX_BACKENDS}))
                      .replace("CASES", repr(JAX_CASES)))
            part = root / f"jax_dist_k4.{os.getpid()}.npz"
            proc = subprocess.run([sys.executable, "-c", script, SRC,
                                   str(part)], capture_output=True,
                                  text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(part, path)
    with np.load(path) as z:
        return dict(z)
