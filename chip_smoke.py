#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

  python3 chip_smoke.py [--scale 22] [--reps 10]

1. Prints the card's name and power limit and builds the CUDA combine
   kernel from `src/repro_torch/kernels/csrc/` with `nvcc` (sm_90a).
2. Builds the Graph500 R-MAT graph (a=0.57, b=c=0.19, edge factor 16,
   seed 0, integer weights in [1, 65535]) at `--scale` and its partitions
   on the card, then holds the kernel against its plain PyTorch version on
   messages gathered from that partition: the dense route at D=1 (sum, min,
   max) and D=32 (min), and one real bucketed frontier tile (min).  Min/max
   must be bitwise equal to the plain version, and two launches bitwise
   equal to each other.  Sums must agree to rtol 1e-5 with the plain
   version evaluated in float64 on the same values: the float32 plain
   version sums with atomics in an arbitrary order, and on hub segments
   (in-degree ~1e5) its own rounding drift (~eps·sqrt(in-degree)) is of
   the order of that tolerance; its distance from the float64 sum is
   printed beside the kernel's.
   Times come from CUDA events (median of `--reps`); `launches` counts
   the kernel launches of the timed loop; `bound_ms` is the bytes the
   kernel must move over 3.35 TB/s: the messages of the edges this input
   routes to a segment (a tile's sentinel lanes lie past the row
   pointer's end and are never read), the row pointer and the output
   (the kernel never reads dst).  The whole tile route (sort, row pointer,
   kernel) also reads every lane's dst; its `route_bound_ms` counts that.
   `library_ms` is one `torch.segment_reduce` call on the same inputs, a
   yardstick only.
3. Drives the main path through the port's entry points
   (`DevicePartition.from_graph`, `GREEngine`, `init_state`, `run`):
   PageRank (30 supersteps), SSSP (frontier "auto"), BFS (frontier
   "compact" and "dense"), CC and 32-lane BFS, each held against a
   numpy/scipy oracle, with the kernel's launch counters read around it.
4. Prints the `kernels` JSON line, the nvidia-smi line, and last
   `{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero; without a card it
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/segment_combine.cu"
REPLACES = {"dense": "src/repro/kernels/segment_combine.py:232",
            "tile": "src/repro/kernels/segment_combine.py:194"}
SUM_RTOL = 1e-5                    # f32 sum vs the plain version in f64


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of `fn()` over `reps` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(e: int, d: int, v: int) -> float:
    """Least time to move the kernel's bytes: `e` routed edges' messages,
    the row pointer and the output, each once."""
    return (e * d * 4 + (v + 1) * 4 + v * d * 4) / HBM_BYTES_PER_S * 1e3


def route_bound_ms(lanes: int, e: int, d: int, v: int) -> float:
    """Least time of the whole tile route: every lane's dst, the `e` routed
    lanes' messages and the output, each once."""
    return (lanes * 4 + e * d * 4 + v * d * 4) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------ kernel phase
def check_case(name, route, op, msgs, dst, seg_ptr, num_segments, reps):
    """Kernel vs plain on one input; returns the case's record."""
    from repro_torch.kernels import segment_combine as sc
    first = sc.segment_combine_cuda(msgs, dst, seg_ptr, num_segments, op,
                                    route=route)
    second = sc.segment_combine_cuda(msgs, dst, seg_ptr, num_segments, op,
                                     route=route)
    plain = sc.segment_combine_plain(msgs, dst, num_segments, op)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: two launches differ")
    extra = {}
    if op == "sum":
        exact = sc.segment_combine_plain(msgs.double(), dst, num_segments,
                                         op)
        err = (first.double() - exact).abs()
        scale = exact.abs().clamp(min=1e-30)
        worst = float((err - SUM_RTOL * exact.abs()).max())
        if not (torch.isfinite(first).all() and worst <= 0.0):
            raise AssertionError(f"{name}: sum off by more than rtol "
                                 f"{SUM_RTOL} (excess {worst})")
        max_abs_err = float(err.max())
        max_rel_err = float((err / scale).max())
        extra["plain_f32_max_rel_err"] = float(
            ((plain.double() - exact).abs() / scale).max())
        del exact, err, scale
    else:
        if not torch.equal(first, plain):
            raise AssertionError(f"{name}: {op} is not bitwise equal")
        max_abs_err = max_rel_err = 0.0
    del first, second, plain
    n_used = int(seg_ptr[-1])           # edges routed to some segment
    offsets = seg_ptr.to(torch.int64)
    lib_data = msgs[:n_used]
    ident = sc.IDENTITY[op]
    launches_before = sc.LAUNCHES[route]
    kernel_ms = cuda_ms(lambda: sc.segment_combine_cuda(
        msgs, dst, seg_ptr, num_segments, op, route=route), reps)
    rec = {
        "case": name, "route": route, "op": op, "E": int(msgs.shape[0]),
        "E_routed": n_used, "D": int(msgs.shape[1]),
        "segments": num_segments,
        "max_abs_err": max_abs_err, "max_rel_err": max_rel_err, **extra,
        "kernel_ms": kernel_ms,
        "launches": sc.LAUNCHES[route] - launches_before,
        "plain_ms": cuda_ms(lambda: sc.segment_combine_plain(
            msgs, dst, num_segments, op), reps),
        "library_ms": cuda_ms(lambda: torch.segment_reduce(
            lib_data, op, offsets=offsets, axis=0, unsafe=True,
            initial=ident), reps),
        "bound_ms": bound_ms(n_used, msgs.shape[1], num_segments),
    }
    log("kernel_case", json.dumps(rec))
    return rec


def pick_frontier_tile(part, source, max_supersteps=8):
    """The largest real bucketed tile of a compact BFS from `source`: run
    supersteps until the frontier leaves the compacted range, keeping the
    (msgs, dst) of the widest bucket tile the route gathered."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.core.frontier import frontier_counts, frontier_tile
    eng = GREEngine(algorithms.bfs_program(), frontier="compact")
    plan = eng.make_plan().frontier(part)
    assert plan.kind == "bucketed", plan
    state = eng.init_state(part, source=source)
    best = None
    for step in range(max_supersteps):
        counts = frontier_counts(part, state.active_scatter)
        if counts[0] == 0 or counts[0] > sum(plan.caps):
            break
        for b, (cap_b, deg_b) in enumerate(zip(plan.caps,
                                               part.bucket_max_deg)):
            n_b = counts[b + 1]
            if 0 < n_b <= cap_b and (best is None
                                     or cap_b * deg_b > best[0]):
                mask_b = state.active_scatter & (part.bucket_id == b)
                msgs, dst = frontier_tile(eng.program, part, state,
                                          part.num_slots, cap_b, deg_b,
                                          mask_b)
                best = (cap_b * deg_b, step, b, n_b, msgs, dst)
        state = eng.superstep(part, state)
    assert best is not None, "no bucketed tile on this BFS"
    lanes, step, b, n_b, msgs, dst = best
    log(f"frontier_tile superstep={step} bucket={b} live={n_b} "
        f"lanes={lanes} valid={int((dst < part.num_slots).sum())}")
    return msgs, dst


def kernel_phase(part, source, reps):
    from repro_torch.kernels import segment_combine as sc
    nseg = part.num_slots
    gen = torch.Generator(device=part.device).manual_seed(0)
    records = []
    # D = 1: PageRank's first-superstep messages, pr0 / outdeg per source
    x = 1.0 / torch.clamp(part.aux["out_degree"], min=1.0)
    x = torch.cat([x, torch.zeros(1, device=x.device)])
    msgs = x.index_select(0, part.src).unsqueeze(1).contiguous()
    for op in ("sum", "min", "max"):
        records.append(check_case(f"dense_D1_{op}", "dense", op, msgs,
                                  part.dst, part.seg_ptr, nseg, reps))
    del msgs
    # D = 32: 32-lane traversal values gathered along src
    x32 = torch.rand((nseg, 32), generator=gen, device=part.device)
    msgs = x32.index_select(0, part.src)
    records.append(check_case("dense_D32_min", "dense", "min", msgs,
                              part.dst, part.seg_ptr, nseg, reps))
    del msgs, x32
    # one real bucketed frontier tile of a BFS, after the route's sort
    tmsgs, tdst = pick_frontier_tile(part, source)
    tmsgs, tdst = sc.sort_tile(tmsgs.reshape(-1, 1).contiguous(), tdst)
    tptr = sc.segment_row_pointer(tdst, nseg)
    rec = check_case("tile_D1_min", "tile", "min", tmsgs, tdst, tptr, nseg,
                     reps)
    # the whole tile route: stable sort + row pointer + kernel
    rec["route_ms"] = cuda_ms(lambda: sc.tile_segment_combine_cuda(
        tmsgs, tdst, nseg, "min"), reps)
    rec["route_bound_ms"] = route_bound_ms(
        tdst.shape[0], rec["E_routed"], rec["D"], nseg)
    log(f"tile_route_ms={rec['route_ms']} "
        f"route_bound_ms={rec['route_bound_ms']}")
    records.append(rec)
    torch.cuda.synchronize()
    return records


# ------------------------------------------------------------- main path
class Inputs(NamedTuple):
    graph: object          # repro_torch.graph.structures.Graph
    ugraph: object         # graph.as_undirected(), for CC
    part: object           # DevicePartition of graph, on the card
    upart: object          # DevicePartition of ugraph, on the card
    source: int            # the highest-out-degree vertex
    sources: list          # source + 31 sampled with seed 0 (32-lane BFS)


def build_inputs(scale: int) -> Inputs:
    """The main path's graph, partitions and traversal sources; the one
    set-up of this script and `tools/profile_torch_main_path.py`.  Needs
    `src/` on `sys.path`."""
    from repro_torch.core.engine import DevicePartition
    from repro_torch.graph.generators import rmat_edges
    t0 = time.perf_counter()
    graph = rmat_edges(scale, 16, seed=0, weights=True).dedup()
    ugraph = graph.as_undirected()
    log(f"ingress_graph_s={time.perf_counter() - t0:.3f} "
        f"V={graph.num_vertices} E={graph.num_edges}")
    t0 = time.perf_counter()
    part = DevicePartition.from_graph(graph, device="cuda")
    upart = DevicePartition.from_graph(ugraph, device="cuda")
    torch.cuda.synchronize()
    log(f"ingress_partition_s={time.perf_counter() - t0:.3f} "
        f"bucket_sizes={part.bucket_sizes} "
        f"bucket_max_deg={part.bucket_max_deg}")
    outdeg = graph.out_degree()
    source = int(np.argmax(outdeg))
    cands = np.flatnonzero(outdeg > 0)
    cands = cands[cands != source]
    rng = np.random.default_rng(0)
    sources = [source] + [int(s) for s in
                          rng.choice(cands, size=31, replace=False)]
    return Inputs(graph, ugraph, part, upart, source, sources)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def report(name, eng, part, out, wall_ms, num_edges):
    plan = eng.make_plan().frontier(part)
    rate = num_edges * out.step / (wall_ms / 1e3) if out.step else 0.0
    log(f"program={name} plan={plan.kind} caps={plan.caps} "
        f"supersteps={out.step} wall_ms={wall_ms:.3f} "
        f"edges_per_s={rate:.6e}")
    return {"program": name, "plan": plan.kind, "supersteps": out.step,
            "wall_ms": wall_ms, "edges_per_s": rate}


def host_oracles(graph, ugraph, source):
    """numpy/scipy references of every program of the main path."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = graph.num_vertices
    t0 = time.perf_counter()
    adj = sp.csr_matrix((graph.edge_props["weight"].astype(np.float64),
                         (graph.src, graph.dst)), shape=(n, n))
    pr = np.ones(n)
    outdeg = np.maximum(graph.out_degree(), 1).astype(np.float64)
    for _ in range(30):
        pr = 0.15 + 0.85 * np.bincount(graph.dst, weights=(pr / outdeg)[
            graph.src], minlength=n)
    ref = {"pagerank": pr,
           "sssp": csgraph.dijkstra(adj, indices=source),
           "bfs": csgraph.shortest_path(adj, unweighted=True, indices=source)}
    uadj = sp.csr_matrix((np.ones(ugraph.num_edges), (ugraph.src,
                                                       ugraph.dst)),
                         shape=(n, n))
    _, comp = csgraph.connected_components(uadj, directed=False)
    first = np.full(comp.max() + 1, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n))
    ref["cc"] = first[comp].astype(np.float64)
    log(f"host_oracles_s={time.perf_counter() - t0:.3f}")
    return ref


def assert_exact(name, got: torch.Tensor, want: np.ndarray):
    got = got.double().cpu().numpy()
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"{name}: {bad.size} vertices differ from the "
                             f"oracle, e.g. {bad[:5]} {got[bad[:5]]} "
                             f"{want[bad[:5]]}")


def main_path(graph, part, upart, source, sources, ref):
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.kernels.segment_combine import LAUNCHES
    e = graph.num_edges
    runs = []

    eng = GREEngine(algorithms.pagerank_program())
    st = eng.init_state(part)
    out, ms = timed(lambda: eng.run(part, st, 30))
    runs.append(report("pagerank", eng, part, out, ms, e))
    assert out.step == 30 and LAUNCHES["dense"] > 0, LAUNCHES
    np.testing.assert_allclose(out.vertex_data.cpu().numpy(),
                               ref["pagerank"], rtol=1e-4, atol=1e-4)

    eng = GREEngine(algorithms.sssp_program(), frontier="auto")
    st = eng.init_state(part, source=source)
    out, ms = timed(lambda: eng.run(part, st, 10_000))
    runs.append(report("sssp", eng, part, out, ms, e))
    assert_exact("sssp", out.vertex_data, ref["sssp"])

    bfs = {}
    for frontier in ("compact", "dense"):
        tile_before = LAUNCHES["tile"]
        eng = GREEngine(algorithms.bfs_program(), frontier=frontier)
        st = eng.init_state(part, source=source)
        out, ms = timed(lambda: eng.run(part, st, 10_000))
        runs.append(report(f"bfs_{frontier}", eng, part, out, ms, e))
        assert_exact(f"bfs_{frontier}", out.vertex_data, ref["bfs"])
        bfs[frontier] = out
        if frontier == "compact":
            assert LAUNCHES["tile"] > tile_before, LAUNCHES
    assert torch.equal(bfs["compact"].vertex_data, bfs["dense"].vertex_data)
    assert bfs["compact"].step == bfs["dense"].step

    eng = GREEngine(algorithms.cc_program())
    st = eng.init_state(upart)
    out, ms = timed(lambda: eng.run(upart, st, 10_000))
    runs.append(report("cc", eng, upart, out, ms, 2 * e))
    assert_exact("cc", out.vertex_data, ref["cc"])

    eng = GREEngine(algorithms.bfs_program(len(sources)))
    st = eng.init_state(part, source=sources)
    out, ms = timed(lambda: eng.run(part, st, 10_000))
    runs.append(report(f"bfs_x{len(sources)}", eng, part, out, ms, e))
    multi = out.vertex_data
    return runs, multi, bfs["dense"].vertex_data


def check_lanes(part, sources, multi, single0):
    """Sampled lanes of the multi-source BFS vs single-source runs."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    assert torch.equal(multi[:, 0], single0), "lane 0"
    eng = GREEngine(algorithms.bfs_program(), frontier="dense")
    lanes = (7, 19, len(sources) - 1)
    for lane in lanes:
        out = eng.run(part, eng.init_state(part, source=sources[lane]),
                      10_000)
        assert torch.equal(multi[:, lane], out.vertex_data), f"lane {lane}"
    log(f"multi_source lanes {(0,) + lanes} bitwise equal to single-source "
        "runs")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="log2 |V| of the R-MAT graph (<= 24: CC labels and "
                         "SSSP sums are exact in f32 below 2**24)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if args.scale > 24:
        raise SystemExit("--scale must be <= 24")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_combine as sc

    smi = nvidia_smi_line()
    log("device:", torch.cuda.get_device_name(0), "|", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.perf_counter()
    _build.load("segment_combine")
    log(f"build_s={time.perf_counter() - t0:.3f}")

    graph, ugraph, part, upart, source, sources = build_inputs(args.scale)
    ref = host_oracles(graph, ugraph, source)

    records = kernel_phase(part, source, args.reps)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    t0 = time.perf_counter()
    runs, multi, single0 = main_path(graph, part, upart, source, sources,
                                     ref)
    launches = dict(sc.LAUNCHES)
    log(f"main_path_s={time.perf_counter() - t0:.3f} launches={launches} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    for route, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the {route} route launched no kernel")
    check_lanes(part, sources, multi, single0)
    log("main_path", json.dumps(runs))

    kernels = []
    for route, case in (("dense", "dense_D1_sum"), ("tile", "tile_D1_min")):
        rec = next(r for r in records if r["case"] == case)
        kernels.append({
            "name": f"segment_combine_{route}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[route],
            "launches": launches[route],
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["route"] == route),
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
