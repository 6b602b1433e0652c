#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

  python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up (the inputs from the seed, ingress,
the deployment, warm-up of the cell's own shapes), then `--seconds` of
closed-loop load, then the check of sampled answers against the plain
reference.  The last line of standard output is the result as one JSON
object: with `--trace 0` the cell's end-to-end metrics, with `--trace 1`
(the window under the profiler) its per-layer metrics, the device trace's
busy and window seconds and a breakdown.  The numbers compared, each with
its limit, come last in that line (`checks`) and as the last lines of
standard error.  Without a CUDA device, with fewer than the cell's chips,
or with JAX or the JAX package loaded in the process, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches the run may fill, at fixed paths inside the checkout
CACHE = ROOT / ".portbench_cache"
TOP_ENTRIES = 10


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit_w():
    """The card's power limit as `nvidia-smi` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def top(items: dict) -> list:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            ][:TOP_ENTRIES]


def result_line(res: dict, cell: dict, trace: bool) -> dict:
    import torch
    rec = res["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(rec.peak_mem_bytes),
              "power_limit_w": power_limit_w()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": top(rec.trace.by_group_s),
                             "idle_gaps": top(rec.trace.idle_by_span_s)}
    conf = res["parts"]["conf"]
    line["config"] = {"name": conf["name"], "source": conf["source"],
                      "reduced": conf["reduced"], "graph": res["graph"]}
    line["checks"] = res["checks"]
    return line


def main(argv=None, t_start: float = T_START) -> int:
    args = parse(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    from portbench import harness
    try:
        spec = harness.benchmark()
        cell = harness.workload(spec, args.workload)
        harness.require_devices(cell["chips"])
        harness.require_no_jax("at start")
        res = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_start=t_start)
    except harness.CellError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    line = result_line(res, cell, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
