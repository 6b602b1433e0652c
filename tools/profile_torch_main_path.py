#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's main paths on one NVIDIA card.

  python3 tools/profile_torch_main_path.py [--scale 22] [--src DIR]
                                          [--lm-only | --dist]

Graph path: builds the inputs of `chip_smoke.py` with its own `build_inputs`
(Graph500 R-MAT a=0.57, b=c=0.19, edge factor 16, seed 0, weights; both
partitions on the card; the same traversal sources) and profiles each
program of the graph path.
LM path: full-width smollm-135m (bf16, random weights from a CUDA generator
seeded 0) as `chip_smoke.py` serves it: one prefill of B=4 x 2048 tokens,
8 decode steps of B=4 after it, and the continuous batcher serving 16
requests (prompt lengths uniform in 128-2048, numpy seed 0, 32 new tokens
each, 8 slots, max_len 2112).
Distributed path (`--dist`, alone): the directed graph of `chip_smoke.py`
on its k = 8 HDRF shards stacked on the card, through `chip_smoke`'s own
ingress, and PageRank (30 supersteps) and SSSP ("auto") under the agent,
dense and pipelined exchanges.  Device time is grouped by layer as well:
kernels launched inside the exchanges' gathers, scatters, flush routes
and shard-axis reductions (`repro_torch.core.exchange`,
`repro_torch.dist.comm`) are "exchange", inside `GREEngine.apply`
"apply"; the combine kernel keeps its own group wherever it runs.

Each program runs once to warm up, then once under `torch.profiler`.  For
each it prints one JSON line: the wall time of the traced run, the
device-busy time (the union of its kernels' intervals), the idle share
`1 - busy / wall`, and device time grouped by kind of kernel (the combine
and attention kernels, matmuls, gathers and index writes, sorts and the
tile route's lane compaction, other).  Tracing
adds host time, so the wall times here are not the end-to-end numbers;
those come from `chip_smoke.py`, run without the profiler.  `--src`
profiles the port of another tree (an unpacked `git archive`) with this
script, so two commits are measured alike in one call.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

# kernel-name fragment -> group; the first match wins.  The combine
# kernel's passes (partition, combine, carry fold) are "combine_kernel"; the
# tile route's lane compaction, which took the place of its whole-tile sort,
# is "sort" with the sort of the compacted lanes.
GROUPS = (("merge_path_partition", "combine_kernel"),
          ("combine_d1_kernel", "combine_kernel"),
          ("combine_cols_kernel", "combine_kernel"),
          ("fold_carries", "combine_kernel"),
          ("compact_count", "sort"), ("compact_scan", "sort"),
          ("compact_write", "sort"),
          ("flash_attention_", "attention_kernel"),   # f32 and bf16
          ("gemm", "matmul"), ("nvjet", "matmul"), ("gemv", "matmul"),
          ("index", "gather"), ("gather", "gather"),
          ("sort", "sort"), ("radix", "sort"), ("Radix", "sort"),
          ("nonzero", "compact"), ("scan", "compact"))


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


LAYER = "layer:"


def labelled(label, fn):
    """`fn` inside a profiler range named for its layer."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(LAYER + label):
            return fn(*args, **kwargs)
    return wrapper


def label_dist_layers():
    """Wrap the exchange and apply layers of the port in labelled ranges
    (module globals, looked up at call time by their callers)."""
    from repro_torch.core import exchange
    from repro_torch.core.engine import GREEngine
    from repro_torch.dist.comm import StackedComm
    for name in ("refresh_scatter_agents", "flush_combiners", "_gather"):
        setattr(exchange, name, labelled("exchange",
                                         getattr(exchange, name)))
    exchange.CombineRoute.combine = labelled("exchange",
                                             exchange.CombineRoute.combine)
    for name in ("all_to_all", "psum", "pmin", "pmax"):
        setattr(StackedComm, name, labelled("exchange",
                                            getattr(StackedComm, name)))
    GREEngine.apply = labelled("apply", GREEngine.apply)


def layer_of(evt):
    """The label of the innermost layer range around a CPU op, or None."""
    while evt is not None:
        if evt.name.startswith(LAYER):
            return evt.name[len(LAYER):]
        evt = evt.cpu_parent
    return None


def by_layer(prof, by_group_ms: dict) -> dict:
    """Device ms by layer: a kernel an op launched goes to the layer range
    the op ran in; the combine kernel, wherever it runs, and the kernels no
    op owns (those launched through ctypes) keep their name group
    (`by_group_ms`, the name groups of every device kernel)."""
    from torch.autograd import DeviceType
    out, owned = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        layer = None
        for kern in e.kernels:
            g = group_of(kern.name)
            if g == "combine_kernel":
                continue
            layer = layer or layer_of(e) or ""
            ms = kern.duration / 1e3
            owned[g] = owned.get(g, 0.0) + ms
            out[layer or g] = out.get(layer or g, 0.0) + ms
    for g, ms in by_group_ms.items():
        rest = ms - owned.get(g, 0.0)
        if rest > 0.0:
            out[g] = out.get(g, 0.0) + rest
    return dict(sorted(out.items()))


def profile(name, fn, layers=False):
    from torch.profiler import ProfilerActivity
    from torch.autograd import DeviceType
    fn()                                  # warm-up: allocator, build, caches
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a layer range also shows on the device timeline, spanning its
    # kernels; it is no kernel of its own
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(LAYER)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_group, intervals = {}, []
    for e in kernels:
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us()
        intervals.append((e.time_range.start, e.time_range.end))
    busy = busy_us(intervals)
    rec = {"program": name, "traced_wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us,
           "kernels": len(kernels),
           "device_ms_by_group": {g: v / 1e3 for g, v in
                                  sorted(by_group.items())}}
    if layers:
        rec["device_ms_by_layer"] = by_layer(prof,
                                             rec["device_ms_by_group"])
    print(json.dumps(rec), flush=True)


def profile_lm():
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ContinuousBatcher, Request
    cfg, _ = get_config("smollm-135m")
    params = tfm.init_lm(cfg, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2048))).cuda()
    profile("lm_prefill", lambda: tfm.prefill(params, prompts, cfg,
                                              max_len=2048 + 33))
    _, cache = tfm.prefill(params, prompts, cfg, max_len=2048 + 33)
    tok = torch.zeros(4, dtype=torch.int32, device="cuda")

    def decode8():
        cache["len"].fill_(2048)
        for _ in range(8):
            tfm.decode_step(params, cache, tok, cfg)
    profile("lm_decode_x8", decode8)

    lens = rng.integers(128, 2049, 16)
    prompts16 = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                 for n in lens]

    def serve16():
        sched = ContinuousBatcher(params, cfg, batch_slots=8, max_len=2112)
        for i, p in enumerate(prompts16):
            sched.submit(Request(uid=i, prompt=p, max_new=32))
        sched.run()
    profile("lm_batcher_16", serve16)


def profile_graph(scale: int) -> None:
    from chip_smoke import build_inputs
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine

    _, _, part, upart, source, sources = build_inputs(scale)

    def run(program, p, src=None, frontier="auto", steps=10_000):
        eng = GREEngine(program, frontier=frontier)
        return lambda: eng.run(p, eng.init_state(p, source=src), steps)

    profile("pagerank", run(algorithms.pagerank_program(), part, steps=30))
    profile("sssp", run(algorithms.sssp_program(), part, source))
    profile("bfs_compact", run(algorithms.bfs_program(), part, source,
                               "compact"))
    profile("bfs_dense", run(algorithms.bfs_program(), part, source,
                             "dense"))
    profile("cc", run(algorithms.cc_program(), upart))
    profile("bfs_x32", run(algorithms.bfs_program(32), part, sources))


def profile_dist(scale: int) -> None:
    from chip_smoke import (DIST_K, dist_inputs, start_dist_ingress,
                            stop_dist_ingress)
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine

    ingress = start_dist_ingress(scale, DIST_K, ("directed",))
    try:
        ag, topos, _ = dist_inputs(ingress)["directed"]
    finally:
        stop_dist_ingress(ingress)
    # chip_smoke's source: the highest out-degree, lowest original id
    outdeg = np.zeros(ag.num_vertices)
    real = ag.new2old >= 0
    outdeg[ag.new2old[real]] = ag.out_degree.reshape(-1)[real]
    source = int(outdeg.argmax())
    label_dist_layers()
    for exchange in ("agent", "dense", "pipelined"):
        topo = topos["tiles" if exchange == "pipelined" else "sync"]
        for name, program, src, steps in (
                ("pagerank", algorithms.pagerank_program(), None, 30),
                ("sssp", algorithms.sssp_program(), source, 10_000)):
            eng = DistGREEngine(program, DIST_K, exchange=exchange)
            st = eng.init_state(ag, source=src)
            run = eng.make_run(ag, steps)
            profile(f"dist_{name}_{exchange}", lambda: run(topo, st),
                    layers=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is profiled, "
                         "e.g. an unpacked git archive of another commit")
    ap.add_argument("--lm-only", action="store_true",
                    help="profile the LM path alone")
    ap.add_argument("--dist", action="store_true",
                    help="profile the distributed path alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import repro_torch
    print(json.dumps({"repro_torch": repro_torch.__file__}), flush=True)
    if args.dist:
        profile_dist(args.scale)
    else:
        profile_lm()
        if not args.lm_only:
            profile_graph(args.scale)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
