#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel's time goes, phase by phase, on
one NVIDIA card.

  python3 tools/attention_phase_profile.py [--case smollm_prefill]

No instruction-level profiler runs on the card's machine, so this script
builds an instrumented copy of `csrc/flash_attention.cu` (git-ignored,
under `kernels/_build/phase/`): each consumer warpgroup reads the SM's
cycle counter (`clock()`) around the phases of its kv-tile loop and sums
them, and warp 0 of each warpgroup of three CTAs (the heaviest query
tile, the middle one and the lightest, batch and kv head 0) prints the
sums once the loop ends:

  qwait    from the warpgroup's start to its query tile's arrival
  loop     the whole kv-tile loop
  waitK    waiting on the K tile's "full" barrier
  S        S = Q·Kᵀ, issue to completion
  softmax  mask, maxima, exp2, sums, bf16 packing and O's rescale
  waitV    waiting on the V tile's "full" barrier
  PV       O += P·V, issue to completion, and the "empty" arrival

It then launches that copy once through `flash_attention_cuda` at an
attention case of `chip_smoke.py` and checks its output against the
committed kernel's, bit for bit.  The counters cost registers, so the
times are those of a near relative of the kernel, not of the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# (anchor in the kernel's consumer loop, text that replaces it)
PROBES = (
    ("  mbar_wait(q_full, 0);\n  for (int it = 0; it < n_tiles; ++it) {",
     "  unsigned tk = 0, ts = 0, tsm = 0, tv = 0, tpv = 0;\n"
     "  const unsigned tq0 = clock();\n"
     "  mbar_wait(q_full, 0);\n"
     "  unsigned t0 = clock();\n"
     "  const unsigned tstart = t0;\n"
     "  for (int it = 0; it < n_tiles; ++it) {"),
    ("    mbar_wait(k_full + 8 * s, parity);\n    __syncwarp();\n",
     "    mbar_wait(k_full + 8 * s, parity);\n    __syncwarp();\n"
     "    const unsigned t1 = clock();\n    tk += t1 - t0;\n"),
    ("    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(sc);\n",
     "    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(sc);\n"
     "    const unsigned t2 = clock();\n    ts += t2 - t1;\n"),
    ("    // O += P·V: k16 step q reads V rows 16q .. 16q + 15\n"
     "    mbar_wait(v_full + 8 * s, parity);\n    __syncwarp();\n",
     "    fence_regs(acc);\n"
     "    const unsigned t3 = clock();\n    tsm += t3 - t2;\n"
     "    mbar_wait(v_full + 8 * s, parity);\n    __syncwarp();\n"
     "    const unsigned t4 = clock();\n    tv += t4 - t3;\n"),
    ("    if (lane == 0) mbar_arrive(empty + 8 * s);    // this warp read "
     "stage s\n  }\n",
     "    if (lane == 0) mbar_arrive(empty + 8 * s);\n"
     "    t0 = clock();\n    tpv += t0 - t4;\n  }\n"
     "  if (lane == 0 && (warp & 3) == 0 && blockIdx.y == 0 &&\n"
     "      (blockIdx.x == 0 || blockIdx.x == gridDim.x / 2 ||\n"
     "       blockIdx.x == gridDim.x - 1)) {\n"
     "    printf(\"phase H=%d heads=%d q0=%d wg=%d tiles=%d qwait=%u "
     "loop=%u waitK=%u S=%u softmax=%u waitV=%u PV=%u\\n\", H, heads, q0, "
     "wg, n_tiles, tstart - tq0, t0 - tstart, tk, ts, tsm, tv, tpv);\n"
     "  }\n"),
)


def instrumented_library() -> Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, probe in PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in the kernel: {anchor!r}")
        text = text.replace(anchor, probe)
    text = "#include <cstdio>\n" + text
    out = _build.BUILD_DIR / "phase"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_phase.cu"
    src.write_text(text)
    lib = out / "libflash_attention_phase.so"
    # the copy includes the shared header from `csrc/`
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="smollm_prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_phase_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    lib = instrumented_library()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    case = next(c for c in chip_smoke.ATTN_CASES if c[0] == args.case)
    _, b, sq, sk, kv, g, h, causal, dt = case
    q, k, v = chip_smoke.attention_inputs(b, sq, sk, kv, g, h, dt)
    want = fa.flash_attention_cuda(q, k, v, causal)     # the kernel itself
    torch.cuda.synchronize()
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fa._LAUNCH["flash_attention"] = fn
    print(f"case {case[0]}: {chip_smoke.nvidia_smi_line()}", flush=True)
    got = fa.flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    sys.stdout.flush()
    if not torch.equal(got, want):
        raise SystemExit("the instrumented copy's output differs")
    print("output bitwise equal to the kernel's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
