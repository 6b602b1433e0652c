"""Warm-start invalidation for incremental re-convergence.

After a batch of edge mutations, `rerun_incremental` re-converges from the
previous fixed point instead of from scratch.  Added edges are easy: under a
min monoid, re-delivering a fixed-point value is idempotent, so activating
the add endpoints and letting the normal frontier machinery run is both safe
and exact.  Removals are the hard half: a min-monoid fixed point can hold
values that were only attainable THROUGH a removed edge, and min cannot
retract, so this module computes the (vertex, lane) entries whose values the
surviving graph no longer certifies and resets them to the program's
initial values before re-seeding.

Two invalidation policies (`VertexProgram.invalidation`):

* ``"path"`` (BFS/SSSP): support-based worklist invalidation in the
  Ramalingam–Reps tradition: entry ``(x, d)`` keeps its value iff some live
  in-edge ``(w, x)`` from an untainted ``w`` reproduces it BITWISE
  (``scatter_msg(val[w], prop) == val[x]``), or ``x`` is lane ``d``'s
  source.  Uncertified entries taint, and the entries they supported are
  re-examined, wave by wave.  Sound because these programs' messages are
  strictly increasing (``+1`` / positive weights), so stale values cannot
  support each other around a cycle.

* ``"component"`` (CC): label propagation has CYCLIC support (two stale
  labels in a split-off component certify each other), so instead
  everything forward-reachable from the removed edges' destinations over
  the PRE-delta edge set taints: the region whose in-reachable set, and
  hence min label, the removal could have changed.

The port's copy of `repro.core.incremental`: every mask is byte-identical
to the JAX package's.  All passes run on the host in numpy over the master
(original) id space.  The certificate runs the program's own `scatter_msg`
on float32 CPU tensors, the same float32 add the device superstep makes.
The waves visit only the edges that can carry the OR they compute (the
support edges, or the edges leaving the last wave's taint), and set
entries by index where the JAX package runs `np.logical_or.at` over every
edge: the same sets, at a cost that follows the affected region.
"""
from __future__ import annotations

import numpy as np
import torch


def check_supported(program, report) -> None:
    """Raise unless `program` can warm-start over this delta.

    Iterative programs (halts=False, e.g. PageRank) always can: they
    recompute from whatever state they hold.  Halting traversals need the
    min monoid (idempotent re-delivery), and removals additionally need an
    invalidation policy.
    """
    if not program.halts:
        return
    if program.monoid.name != "min":
        raise ValueError(
            f"{program.name}: incremental warm start needs an idempotent "
            f"(min) monoid or an iterative program; a halting "
            f"{program.monoid.name}-monoid traversal cannot reuse a prior "
            "fixed point (already-delivered mass does not re-deliver)")
    if report.num_removed and program.invalidation is None:
        raise ValueError(
            f"{program.name}: edge removals need an invalidation policy "
            "(VertexProgram.invalidation = 'path' or 'component')")


def source_mask(shape, source) -> np.ndarray:
    """Protected entries the invalidation pass must never taint: lane d's
    source vertex holds the seeded 0.0 by definition, not by edge support.
    `source` follows `init_state` conventions (scalar, or a per-lane
    sequence with None/negative = unseeded)."""
    out = np.zeros(shape, dtype=bool)
    if source is None:
        return out
    if np.ndim(source) == 0:
        out[int(source)] = True
        return out
    for d, sv in enumerate(source):
        if sv is not None and int(sv) >= 0:
            out[int(sv), d] = True
    return out


def _or_into(out: np.ndarray, rows: np.ndarray, lanes) -> None:
    """`out[rows(, lanes)] = True`: the OR of `np.logical_or.at` over the
    selected edges."""
    if lanes is None:
        out[rows] = True
    else:
        out[rows, lanes] = True


def support_taint(program, num_vertices, src, dst, eprop, values,
                  suspect, protected) -> np.ndarray:
    """The "path" policy: worklist certification over the NEW live edges.

    `values` is the previous fixed point (`[V]` or `[V, D]` f32, original
    vertex order); `suspect` seeds the worklist (destinations of removed
    edges); `protected` entries (sources) never taint.  Returns the tainted
    mask, same shape as `values`.
    """
    finite = np.isfinite(values)
    eligible = finite & ~protected
    if src.shape[0] == 0:
        return suspect & eligible
    msgs = program.scatter_msg(
        torch.from_numpy(np.ascontiguousarray(values[src])),
        None if eprop is None else torch.from_numpy(
            np.ascontiguousarray(eprop))).numpy()
    # bitwise certificate: edge (w, x) supports val[x] iff re-scattering
    # w's value reproduces it exactly (the device path's f32 ops)
    support_edge = msgs == values[dst]
    if support_edge.ndim == 1:
        (e,), lane = np.nonzero(support_edge), None
    else:
        e, lane = np.nonzero(support_edge)
    s_src, s_dst = src[e], dst[e]

    def at_src(mask):
        return mask[s_src] if lane is None else mask[s_src, lane]

    def pick(sel):
        return s_dst[sel], None if lane is None else lane[sel]

    tainted = np.zeros_like(suspect)
    pending = suspect & eligible
    while True:
        supported = np.zeros_like(tainted)
        _or_into(supported, *pick(~at_src(tainted)))
        newly = pending & ~supported & ~tainted
        if not newly.any():
            return tainted
        tainted |= newly
        # entries whose certificate ran through a newly tainted supporter
        # must be re-examined against the shrunken untainted set
        child = np.zeros_like(tainted)
        _or_into(child, *pick(at_src(newly)))
        pending |= child & eligible


def reach_taint(num_vertices, src, dst, seeds) -> np.ndarray:
    """The "component" policy: forward reachability from `seeds` over the
    given edge set (pre-delta: survivors + removed).  Returns `[V]` bool.
    Each wave follows only the edges leaving the last wave's new taint:
    the edges of earlier waves reached nothing new."""
    tainted = np.zeros(num_vertices, dtype=bool)
    if seeds.shape[0] == 0:
        return tainted
    tainted[seeds] = True
    if src.shape[0] == 0:
        return tainted
    wave = tainted.copy()
    while True:
        reach = np.zeros(num_vertices, dtype=bool)
        reach[dst[wave[src]]] = True
        new = reach & ~tainted
        if not new.any():
            return tainted
        tainted |= new
        wave = new


def compute_taint(program, num_vertices, live_src, live_dst, live_prop,
                  values, report, protected) -> np.ndarray:
    """Dispatch on `program.invalidation`; returns a mask shaped like
    `values` (all-False when the delta removed nothing)."""
    if report.num_removed == 0:
        return np.zeros(values.shape, dtype=bool)
    if program.invalidation == "component":
        old_src = np.concatenate([live_src, report.removed_src])
        old_dst = np.concatenate([live_dst, report.removed_dst])
        t = reach_taint(num_vertices, old_src, old_dst, report.removed_dst)
        t = np.broadcast_to(
            t.reshape((num_vertices,) + (1,) * (values.ndim - 1)),
            values.shape).copy()
        return t & np.isfinite(values) & ~protected
    suspect = np.zeros(values.shape, dtype=bool)
    suspect[report.removed_dst] = True
    return support_taint(program, num_vertices, live_src, live_dst,
                         live_prop, values, suspect, protected)


def warm_seed_active(num_vertices, live_src, live_dst, tainted_any,
                     added_src, init_active) -> np.ndarray:
    """The warm-start activity seeds (`[V]` bool, master space):

    * sources of ADDED edges: their (possibly finite) values must travel
      the new edges;
    * in-neighbors of tainted vertices: they re-deliver the surviving
      certified values into the reset region (min idempotence makes the
      re-delivery a no-op everywhere it is not needed);
    * tainted vertices the program itself seeds active (`init_active`,
      e.g. CC re-scatters its reset self-labels).

    An empty delta yields an empty seed set: the warm run terminates at
    superstep 0 with the previous fixed point intact.
    """
    act = np.zeros(num_vertices, dtype=bool)
    if added_src.shape[0]:
        act[added_src] = True
    if tainted_any.any():
        if live_src.shape[0]:
            into_taint = tainted_any[live_dst]
            act[live_src[into_taint]] = True
        act |= tainted_any & init_active
    return act
