#!/usr/bin/env python3
"""Build report of the port's CUDA sources, on a machine with `nvcc`.

  python3 tools/kernel_build_report.py [name ...] [--src DIR]

For each source `src/repro_torch/kernels/csrc/<name>.cu` (default: all;
`--src` takes the sources of another unpacked tree):
compiles it with the flags of `kernels/_build.py` plus `-Xptxas -v` into
`src/repro_torch/kernels/_build/report/` (git-ignored), timing the build,
and prints one JSON line per kernel: ptxas' registers, stack, spill stores
and loads and static shared memory, and, from `cuobjdump -sass` of the
built library, the count of the SASS instructions that show which hardware
paths a kernel takes: HGMMA (`wgmma`), HMMA (`mma.sync`), UTMALDG (TMA
tensor loads), SYNCS (mbarrier operations), MUFU (exp2 and other special
functions), and `sass_sha1`, a digest of the kernel's SASS with the
addresses and encodings left out: two trees whose kernel has the same
digest run the same machine code, so give the same bits in the same time.
`ptxas_warnings` also lists ptxas' "Potential Performance Loss" notes,
such as a `wgmma` pipeline it had to serialise.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "MUFU")


def tool(name: str) -> str:
    """A program of the CUDA toolkit that holds `nvcc`."""
    from repro_torch.kernels import _build
    return str(Path(_build.nvcc_path()).parent / name)


def demangle(names):
    filt = shutil.which("cu++filt") or tool("cu++filt")
    if not Path(filt).exists():
        filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def ptxas_info(text: str) -> dict:
    """Per mangled kernel: registers, stack, spills, static shared memory."""
    info, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return info


def sass_counts(lib: Path) -> tuple:
    """Per mangled kernel: counts of SASS_OPS in `cuobjdump -sass`, and
    the sha1 of its instructions (addresses and encodings stripped)."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, digests, cur = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            digests[m.group(1)] = hashlib.sha1()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m is None or cur is None:
            continue
        digests[next(reversed(digests))].update(m.group(1).encode() + b"\n")
        op = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", m.group(1))
        if op and op.group(1) in cur:
            cur[op.group(1)] += 1
    return counts, {k: d.hexdigest()[:16] for k, d in digests.items()}


def report(name: str) -> None:
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "report"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(lib), str(_build.CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed (exit {proc.returncode}):\n"
                         f"{proc.stdout}{proc.stderr}")
    # ptxas reports a serialised wgmma pipeline as "info", not a warning
    warnings = sorted({re.sub(r"'\w+'", "'...'", ln.strip())
                       for ln in (proc.stdout + proc.stderr).splitlines()
                       if "warning" in ln.lower()
                       or "Performance Loss" in ln})
    info = ptxas_info(proc.stdout + proc.stderr)
    sass, digests = sass_counts(lib)
    names = demangle(sorted(set(info) | set(sass)))
    print(json.dumps({"source": f"{name}.cu", "build_s": round(seconds, 3),
                      "ptxas_warnings": warnings}), flush=True)
    for mangled in sorted(set(info) | set(sass)):
        print(json.dumps({"source": f"{name}.cu", "kernel": names[mangled],
                          **info.get(mangled, {}),
                          "sass": sass.get(mangled, {}),
                          "sass_sha1": digests.get(mangled)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="sources (default: all)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose kernels are built, e.g. "
                         "an unpacked git archive of another commit")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    names = args.names or sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in names:
        report(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
