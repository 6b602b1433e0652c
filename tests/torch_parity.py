"""Shared helpers of the parity tests between the JAX package (`repro`) and
its PyTorch port (`repro_torch`): both get the same numpy inputs, and
results come back as numpy arrays."""
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
