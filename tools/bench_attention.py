#!/usr/bin/env python3
"""The flash-attention kernel (K3) alone, at the attention cases of
`chip_smoke.py`, for one tree of the port, on one NVIDIA card.

  python3 tools/bench_attention.py [--src DIR] [--reps 10] [--cases a,b]
                                   [--backward]

`--src` names the `src` directory whose `repro_torch` is measured (default:
this tree's), e.g. that of an unpacked `git archive` of another commit, so
that two kernels are held to one set of cases, checks and timings in one
call.  Runs `chip_smoke.attention_kernel_phase` (each case against the
plain version, two launches bitwise equal, the planted faults at smollm's
shape above the limit; kernel, plain and `scaled_dot_product_attention`
times from CUDA events) and prints its `attention_case` lines, the build
time and the card's name and power limit.  Then, for each case, the
device time of one kernel launch and of one SDPA call from the profiler,
which leaves out the host time that the CUDA-event times include, and the
host time of each call (`attention_device` lines).

`--backward` runs the backward's cases instead
(`chip_smoke.attention_backward_phase` at `ATTN_BWD_CASES`: the forward's
row statistic against the plain one, the backward kernel against its plain
version and two launches bitwise equal; kernel, device, plain and SDPA
backward times, and at the LM training shapes the profiler's device times
of the kernel and of SDPA's backward; `attention_backward_case` lines).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def device_ms(fn, reps, name=""):
    """Device time of one `fn()` from the profiler: the kernels whose name
    holds `name` over `reps` calls, after a warm-up call.  Host time
    between launches is left out, unlike the CUDA-event times of
    `chip_smoke.cuda_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / reps / 1e3


def host_ms(fn, reps):
    """Host time of one `fn()`: the wall time of `reps` calls enqueued
    without a synchronisation, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / reps * 1e3


def device_times(chip_smoke, fa, case, reps):
    """The kernel's and `scaled_dot_product_attention`'s device times at
    one case."""
    import torch.nn.functional as F
    name, b, sq, sk, kv, g, h, causal, dt = case
    q, k, v = chip_smoke.attention_inputs(b, sq, sk, kv, g, h, dt)
    lq = q.reshape(b, sq, kv * g, h).transpose(1, 2).contiguous()
    lk = k.transpose(1, 2).contiguous()
    lv = v.transpose(1, 2).contiguous()
    def kernel():
        return fa.flash_attention_cuda(q, k, v, causal)

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                              enable_gqa=True)
    return {"case": name,
            "kernel_device_ms": device_ms(kernel, reps, "flash_attention_"),
            "library_device_ms": device_ms(library, reps),
            "kernel_host_ms": host_ms(kernel, reps),
            "library_host_ms": host_ms(library, reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--backward", action="store_true",
                    help="the backward kernel's cases instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention: needs an NVIDIA card", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {fa.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    print("device:", torch.cuda.get_device_name(0), "|", smi, "| src:", src,
          flush=True)
    t0 = time.perf_counter()
    _build.load("flash_attention")
    if args.backward:
        _build.load("flash_attention_bwd")
    print(f"build_s={time.perf_counter() - t0:.3f}", flush=True)
    cases = (chip_smoke.ATTN_BWD_CASES if args.backward
             else chip_smoke.ATTN_CASES)
    if args.cases:
        wanted = args.cases.split(",")
        cases = tuple(c for c in cases if c[0] in wanted)
        if len(cases) < len(wanted):
            raise SystemExit(f"unknown case in {wanted}")
    if args.backward:
        chip_smoke.attention_backward_phase(args.reps, cases, profile=True)
        print(smi, flush=True)
        return 0
    chip_smoke.attention_kernel_phase(args.reps, cases)
    for case in cases:
        print("attention_device", json.dumps(device_times(chip_smoke, fa,
                                                          case, args.reps)),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
