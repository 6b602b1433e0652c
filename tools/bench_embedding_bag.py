#!/usr/bin/env python3
"""Times of the EmbeddingBag kernels' variants, and of the host path around
them, on one NVIDIA card.

  python3 tools/bench_embedding_bag.py [--ahead 2,4,8] [--src DIR]

1. Builds `src/repro_torch/kernels/csrc/embedding_bag.cu` once for each
   value of `kAhead` (the table rows a unit loads ahead of its fold) into
   a temporary directory, with `nvcc -Xptxas -v` (registers a thread
   printed), and times each variant through the port's wrappers, in turn
   over two rounds (CUDA events, median of 5): the forward at a synthetic
   GCN-like shape (4,194,304 bags with Pareto(1.2) in-degrees, 65,241,642
   ids, uniform or skewed towards low ids, d = 16 and 100) and the
   backward at d = 16.
2. The host path at autoint's shape (`[10_000_000, 16]` f32, 134,093 ids
   in 4,096 bags, numpy seed 0, as `chip_smoke.py`): host µs a call (a
   loop of 300 without a sync) and CUDA-event ms of a bare `autograd.grad`
   of a multiply (the autograd floor), of the wrappers, `ops.embedding_bag`
   and `F.embedding_bag`, forward and backward.
Prints one JSON line a measurement, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def ev_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us(fn, k=300):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    us = (time.perf_counter() - t0) / k * 1e6
    torch.cuda.synchronize()
    return us


def build_variants(aheads, tmp):
    """{kAhead: loaded library} of the source with kAhead replaced."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb
    text = (_build.CSRC / "embedding_bag.cu").read_text()
    pattern = r"constexpr int kAhead = \d+;"
    if len(re.findall(pattern, text)) != 1:
        raise RuntimeError("embedding_bag.cu: no single kAhead constant")
    libs = {}
    for ahead in aheads:
        src = Path(tmp) / f"embedding_bag_a{ahead}.cu"
        src.write_text(re.sub(pattern, f"constexpr int kAhead = {ahead};",
                              text))
        out = Path(tmp) / f"libembedding_bag_a{ahead}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               "-Xptxas", "-v", "-o", str(out), str(src)],
                              capture_output=True, text=True, check=True)
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in proc.stderr.splitlines()
                       if "registers" in line})
        print(json.dumps({"ahead": ahead, "registers": regs}), flush=True)
        libs[ahead] = eb._typed(ctypes.CDLL(str(out)))
    return libs


def variants(aheads):
    from repro_torch.kernels import embedding_bag as eb
    gen = torch.Generator(device="cuda").manual_seed(0)
    v, e = 1 << 22, 65_241_642
    deg = torch.distributions.Pareto(torch.tensor(1.0), torch.tensor(1.2)
                                     ).sample((v,)).cuda()
    deg = (deg / deg.sum() * e).floor().long()
    deg[0] += e - int(deg.sum())
    bags = torch.repeat_interleave(
        torch.arange(v, device="cuda", dtype=torch.int32), deg)
    ids = {"uniform": torch.randint(0, v, (e,), device="cuda",
                                    dtype=torch.int32, generator=gen),
           "skewed": (torch.rand(e, device="cuda", generator=gen) ** 3
                      * v).to(torch.int32)}
    w = torch.rand(e, device="cuda", generator=gen)
    tables = {d: torch.rand((v, d), device="cuda", generator=gen)
              for d in (16, 100)}
    cot = torch.rand((v, 16), device="cuda", generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(aheads, tmp)
        for rnd in range(2):
            for ahead in aheads:
                eb._LIB = libs[ahead]
                rec = {"round": rnd, "ahead": ahead}
                for d, t in tables.items():
                    for kind, i in ids.items():
                        rec[f"forward_{kind}_d{d}_ms"] = ev_ms(
                            lambda: eb.embedding_bag_forward_cuda(
                                t, i, bags, v, w))
                rec["backward_uniform_d16_ms"] = ev_ms(
                    lambda: eb.embedding_bag_backward_cuda(
                        cot, tables[16], ids["uniform"], bags, v, w), 3)
                print(json.dumps(rec), flush=True)
    eb._LIB = None


def host_path():
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.rand((10_000_000, 16), generator=gen, device="cuda")
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 65, 4096)
    n = int(sizes.sum())
    ids = torch.from_numpy(rng.integers(0, 10_000_000, n).astype(np.int32)
                           ).cuda()
    w = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
    bags = torch.from_numpy(np.repeat(np.arange(4096), sizes).astype(
        np.int32)).cuda()
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(sizes)[:-1]]).astype(np.int32)).cuda()
    cot = torch.rand((4096, 16), generator=gen, device="cuda")
    x = torch.rand((4096, 16), device="cuda", requires_grad=True)
    y = x * 2
    tab = table.detach().requires_grad_(True)
    wt = w.detach().requires_grad_(True)
    out_both = ops.embedding_bag(tab, ids, bags, 4096, weights=wt)
    out_w = ops.embedding_bag(table, ids, bags, 4096, weights=wt)
    lib_out = F.embedding_bag(ids, tab, offsets, mode="sum",
                              per_sample_weights=wt)
    cases = {
        "autograd_floor": lambda: torch.autograd.grad(
            y, (x,), cot, retain_graph=True),
        "forward_wrapper": lambda: eb.embedding_bag_forward_cuda(
            table, ids, bags, 4096, w),
        "forward_ops": lambda: ops.embedding_bag(table, ids, bags, 4096,
                                                 weights=w),
        "forward_library": lambda: F.embedding_bag(
            ids, table, offsets, mode="sum", per_sample_weights=w),
        "backward_wrapper": lambda: eb.embedding_bag_backward_cuda(
            cot, table, ids, bags, 4096, w),
        "backward_autograd": lambda: torch.autograd.grad(
            out_both, (tab, wt), cot, retain_graph=True),
        "backward_weights_only_autograd": lambda: torch.autograd.grad(
            out_w, (wt,), cot, retain_graph=True),
        "backward_library_autograd": lambda: torch.autograd.grad(
            lib_out, (tab, wt), cot, retain_graph=True),
        "sort_ids": lambda: torch.sort(ids, stable=True)}
    for name, fn in cases.items():
        print(json.dumps({"host": name, "host_us": host_us(fn),
                          "event_ms": ev_ms(fn, 20)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ahead", default="2,4,8")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the tree to measure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_embedding_bag: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants([int(a) for a in args.ahead.split(",")])
    host_path()
    return 0


if __name__ == "__main__":
    sys.exit(main())
