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
