#!/usr/bin/env python3
"""The host side of the port's kernel calls and of its MoE serving and
training paths, for one tree of the port, on one NVIDIA card.

  python3 tools/bench_host_paths.py [--src DIR] [--reps 50] [--out FILE]

`--src` names the `src` directory whose `repro_torch` is measured (default:
this tree's), e.g. that of an unpacked `git archive` of another commit, so
that two trees run the same cases in one call (parent, tree, tree, parent).
Only entry points that both trees have are called:

- K3's forward through `ops.flash_attention` at smollm-135m's prefill
  shape (B=4, S=2048, 3 kv heads x 3, H=64, causal, bf16), and its forward
  and backward through `torch.autograd.grad` at smollm's training shape
  (B=4, S=4096);
- `ops.embedding_bag` on a `[10M, 16]` float32 table, 4,096 bags of 1-64
  ids, and its table gradient;
- granite-moe-1b-a400m at full size through `launch.serve.greedy_generate`
  (B=4, 2,048-token prompts, 33 tokens: the prefill's ms and the decode's
  ms a step; 3 runs after a warm-up);
- granite's training step through `launch.train.main` (B=2, S=4096, 4
  steps, seed 0, as `chip_smoke.py`'s 1x1 run): ms a step over steps 1-3,
  two runs.

A call's host ms is the wall time of `reps` calls enqueued without a
synchronisation, over `reps`; its event ms is CUDA events around `reps`
calls, over `reps`.  Prints one `host_paths` JSON line (also written to
`--out`) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
GRANITE_ARGV = ["--arch", "granite-moe-1b-a400m", "--full-size", "--seq",
                "4096", "--batch", "2", "--steps", "4", "--seed", "0"]


def host_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention(ops, reps):
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for name, s, grad in (("prefill", 2048, False), ("training", 4096, True)):
        q = torch.randn((4, s, 3, 3, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(grad)
        k, v = (torch.randn((4, s, 3, 64), generator=gen, device="cuda",
                            dtype=torch.bfloat16).requires_grad_(grad)
                for _ in range(2))
        if grad:
            do = torch.randn_like(q)

            def fn():
                o = ops.flash_attention(q, k, v, True)
                torch.autograd.grad(o, (q, k, v), do)
        else:
            def fn():
                ops.flash_attention(q, k, v, True)
        out[name] = {"host_ms": host_ms(fn, reps),
                     "event_ms": event_ms(fn, reps)}
    return out


def embedding(ops, reps):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 65, 4096)
    ids = torch.from_numpy(rng.integers(0, 10_000_000, int(lens.sum()))
                           ).to(torch.int32).cuda()
    bags = torch.from_numpy(np.repeat(np.arange(4096), lens)).to(
        torch.int32).cuda()
    table = torch.randn((10_000_000, 16), device="cuda").requires_grad_()
    gout = torch.randn((4096, 16), device="cuda")

    def fwd():
        with torch.no_grad():
            ops.embedding_bag(table, ids, bags, 4096)

    def bwd():
        torch.autograd.grad(ops.embedding_bag(table, ids, bags, 4096),
                            table, gout)
    return {"forward": {"host_ms": host_ms(fwd, reps),
                        "event_ms": event_ms(fwd, reps)},
            "backward": {"host_ms": host_ms(bwd, reps),
                         "event_ms": event_ms(bwd, reps)}}


def moe_serving():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as tfm
    cfg = get_config("granite-moe-1b-a400m")[0]
    params = tfm.init_lm(cfg, generator=torch.Generator("cuda").manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 2048))).cuda()
    greedy_generate(params, cfg, prompts, 3)
    runs = []
    for _ in range(3):
        _, times = greedy_generate(params, cfg, prompts, 33)
        runs.append({"prefill_ms": 1e3 * times["prefill_s"],
                     "decode_ms_per_step": 1e3 * times["decode_s"] / 32})
    del params
    torch.cuda.empty_cache()
    return runs


def training():
    from repro_torch.launch import train
    runs = []
    for _ in range(2):
        steps = []
        train.main(GRANITE_ARGV,
                   on_step=lambda s, loss, sec: steps.append(sec))
        runs.append(1e3 * float(np.mean(steps[1:])))
        torch.cuda.empty_cache()
    return runs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_host_paths: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rec = {"src": args.src, "reps": args.reps,
           "attention": attention(ops, args.reps),
           "embedding_bag": embedding(ops, args.reps),
           "moe_serving": moe_serving(), "granite_step_ms": training()}
    line = json.dumps(rec)
    print("host_paths", line)
    print(smi)
    if args.out:
        Path(args.out).write_text(line + "\n" + smi + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
