#!/usr/bin/env python3
"""Traced runs of benchmark cells, read by the port's own spans, on one
NVIDIA card.

  python3 tools/trace_port_spans.py --cells NAME[,NAME] --seeds N[,N]
      [--seconds S] [--root DIR] [--scale S] [--out FILE]

Each run is `portbench.harness.run_cell` with tracing on (the window's first
`harness.TRACE_SLICE_S` seconds under the profiler), as `portbench/run.py
--trace 1` makes it.  For each run it prints one JSON line: the cell's
per-layer metrics, the benchmark's trace summary (busy and window seconds,
device time by kernel group, idle time by the benchmark's spans, the queries
finished in the traced window), the reduction of the port's spans
(`portbench.port_spans`: spans opened, idle time inside each span and by
the innermost span, device time by the port span open at each launch) and
the host seconds of each ingress phase (`DevicePartition.ingress_s`, as the
`ingress_csr_s` metric's snapshot reads it off the partition).  The window
lasts `run_seconds` of `BENCHMARK.json` unless `--seconds` says otherwise.

`--root DIR` runs the port and the benchmark of another tree (an unpacked
`git archive` of a commit, with this tree's `portbench/` laid over it to
read the same spans); a port without spans or ingress phases reads zero
counts and no phases.  `--scale` overrides the configuration's scale (a
short first check).  `--out` also appends the lines to FILE.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--scale", type=int)
    p.add_argument("--out")
    return p.parse_args(argv)


def by_size(d: dict) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1]))


def one_run(harness, cell: str, seed: int, seconds, scale) -> dict:
    t0 = time.perf_counter()
    res = harness.run_cell(cell, seed, seconds, True, device="cuda",
                           overrides=None if scale is None
                           else {"scale": scale})
    rec = res["record"]
    t = rec.trace
    # the reduction every reader of the port's spans shares
    spans = rec.snapshots.get("loop_idle_ms_per_superstep", (None, None))[1]
    line = {"cell": cell, "seed": seed, "wall_s": time.perf_counter() - t0,
            "correct": res["correct"],
            "metrics": {k: m["value"] for k, m in res["metrics"].items()},
            "trace": {"window_s": t.window_s, "busy_s": t.busy_s,
                      "queries": t.queries,
                      "by_group_s": by_size(t.by_group_s),
                      "idle_by_span_s": by_size(t.idle_by_span_s)},
            "ingress_s": rec.ingress_seconds,
            # every phase the partition recorded, as the window opened
            "ingress_phases_s": rec.snapshots["ingress_csr_s"][0]}
    if spans is not None:
        line["port_spans"] = {
            "busy_s": spans.busy_s, "counts": spans.counts,
            "idle_in_s": by_size(spans.idle_in_s),
            "idle_by_span_s": by_size(spans.idle_by_span_s),
            "device_by_span_s": by_size(spans.device_by_span_s),
            "device_annotations": spans.device_annotations}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(args.root).resolve()
    for path in (root / "src", root):
        sys.path.insert(0, str(path))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("trace_port_spans: needs an NVIDIA card", file=sys.stderr)
        return 2
    seconds = args.seconds or harness.benchmark()["run_seconds"]
    for cell in args.cells.split(","):
        for seed in args.seeds.split(","):
            line = json.dumps(one_run(harness, cell, int(seed), seconds,
                                      args.scale))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
