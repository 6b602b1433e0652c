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
