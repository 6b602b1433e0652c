"""Graph fingerprints: the plan cache's lookup key (a copy of the JAX
package's `repro.tuning.fingerprint`; for the same graph and program the
keys are string-equal, since the port's partitions and agent graphs are
byte-identical to the JAX package's).

A tuned `SuperstepPlan` is only as reusable as the scenario it was
measured on, so cache entries are keyed by the facets that actually move
the frontier/kernel/exchange decisions (the survey result the ROADMAP
cites: no single configuration wins across graphs AND algorithms):

  * **size class** — `num_slots` and `num_edges`, log2-quantized: the
    density crossover and the worth of compaction scale with both, but a
    graph 3% larger must hit the same entry;
  * **degree skew** — max local out-degree over mean, log2-quantized:
    the facet that decides flat vs bucketed tiles (power-law hubs
    poison a flat tile's `max_deg`; `partition_quality.degree_skew` is
    the same statistic measured at partition time);
  * **remote-destination fraction** — share of edges terminating at a
    combiner agent (0.05-quantized; 0 on a single shard): the facet that
    decides whether the pipelined exchange has anything to overlap
    (`partition_quality.remote_dst_edge_fraction`);
  * **frontier density estimate** — the largest live frontier observed
    by the probe harness (`GREEngine.calibrate_frontier_cap` /
    `probe_frontier_hist`) as a fraction of slots, decade-quantized:
    the facet that decides dense vs compacted scanning.  Omitted when no
    histogram is available (iterative dense-frontier programs).

The full cache key (`plan_cache_key`) appends the program's payload
shape, monoid, and halting mode plus the MESH SIZE — the same graph
tuned for an 8-shard agent exchange must not serve its plan to a
single-shard engine.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def _q_log2(x: float) -> int:
    """log2 quantization: values within a factor ~1.4 share a bin."""
    return int(round(math.log2(max(float(x), 1.0))))


def graph_fingerprint(num_slots: int, num_edges: int,
                      max_out_degree: int = 0,
                      remote_dst_fraction: float = 0.0,
                      frontier_hist: Optional[Sequence[int]] = None,
                      partitioner: str = "") -> str:
    """Quantized scenario key for one graph/partition layout.

    `partitioner` names the edge-placement heuristic that built the
    layout (`AgentGraph.partitioner`; "" for raw placements and
    single-shard partitions).  Different partitioners reshape the very
    facets the probes measure — remote fraction, skew, exchange load —
    so a plan tuned on a greedy placement must not answer for an HDRF
    one even when both quantize into the same size/skew bins."""
    mean_deg = num_edges / max(num_slots, 1)
    skew = max_out_degree / max(mean_deg, 1e-9) if max_out_degree else 0.0
    parts = [f"v{_q_log2(num_slots)}",
             f"e{_q_log2(num_edges)}",
             f"skew{_q_log2(skew) if skew >= 1.0 else 0}",
             f"rdf{round(remote_dst_fraction / 0.05) * 5}"]
    if partitioner:
        parts.append(f"p:{partitioner}")
    if frontier_hist:
        density = max(frontier_hist) / max(num_slots, 1)
        # decade quantization: 1e-3 and 8e-3 frontiers tune alike,
        # 1e-3 and 0.2 do not
        parts.append(f"fd{int(round(math.log10(max(density, 1e-9))))}")
    return "-".join(parts)


def partition_fingerprint(part, frontier_hist=None,
                          partitioner: str = "") -> str:
    """Fingerprint of a single-shard `DevicePartition` (uses the LIVE edge
    count — `edge_mask.sum()` — and the CSR max degree as the skew
    numerator).

    Counting live edges rather than the padded column length matters for
    mutated partitions: `apply_edge_delta` retires edges into masked
    tombstones and appends into slack WITHOUT changing the padded length,
    so a padded-length key would keep serving a plan tuned for the
    pre-mutation graph forever.  With the live count, log2 quantization
    absorbs small deltas (same bin → same key, the adopted plan stands)
    while large deltas shift a bin and re-key
    (`GREEngine.refresh_plan`).  `part` is a port `DevicePartition` on any
    device.
    """
    if part.src is None:
        num_edges = 0
    elif part.edge_mask is not None:
        num_edges = int(part.edge_mask.sum())     # one host read
    else:
        num_edges = int(part.src.shape[0])
    return graph_fingerprint(part.num_slots, num_edges,
                             max_out_degree=part.csr_max_deg,
                             frontier_hist=frontier_hist,
                             partitioner=partitioner)


def agent_graph_fingerprint(ag, frontier_hist=None) -> str:
    """Fingerprint of an `AgentGraph` layout: per-shard slot space, total
    real edges, worst-shard CSR degree, and the measured combiner-bound
    (remote-destination) edge fraction."""
    import numpy as np
    num_edges = int(np.sum(ag.num_edges))
    comb_base = ag.cap + ag.s_pad
    if num_edges:
        remote = int(np.sum((ag.dst >= comb_base) & ag.edge_mask))
        rdf = remote / num_edges
    else:
        rdf = 0.0
    return graph_fingerprint(ag.num_slots, num_edges,
                             max_out_degree=ag.csr_max_deg,
                             remote_dst_fraction=rdf,
                             frontier_hist=frontier_hist,
                             partitioner=getattr(ag, "partitioner", ""))


def program_fingerprint(program) -> str:
    """The algorithm facets a plan depends on: payload shape (multi-source
    lanes change tile widths and combine cost), monoid (⊕ identity and
    bitwise-vs-tolerance semantics), halting mode (dense-frontier
    iterative programs never compact)."""
    shape = "x".join(str(d) for d in program.payload_shape) or "scalar"
    return f"{shape}-{program.monoid.name}-{'halt' if program.halts else 'iter'}"


def plan_cache_key(part=None, agent_graph=None, program=None,
                   mesh_size: int = 1, frontier_hist=None) -> str:
    """The persistent plan cache's full key:
    `graph fingerprint | program fingerprint | mesh size`."""
    assert (part is None) != (agent_graph is None), \
        "pass exactly one of part/agent_graph"
    if part is not None:
        gfp = partition_fingerprint(part, frontier_hist=frontier_hist)
    else:
        gfp = agent_graph_fingerprint(agent_graph,
                                      frontier_hist=frontier_hist)
    pfp = program_fingerprint(program)
    return f"{gfp}|{pfp}|mesh{mesh_size}"
