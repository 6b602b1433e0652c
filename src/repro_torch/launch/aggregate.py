"""Aggregate dry-run JSON records into roofline tables (the counterpart of
`repro/launch/aggregate.py`; the records of `launch/dryrun.py`, whose keys
are the JAX package's, so either package's records read here).

  PYTHONPATH=src python -m repro_torch.launch.aggregate results/dryrun_torch [single|multi]

`roofline frac` is the useful compute time (MODEL_FLOPS over the devices
at the H100's bf16 peak, `roofline.PEAK_FLOPS_BF16`) over the bound time.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.launch.roofline import PEAK_FLOPS_BF16 as PEAK_FLOPS


def load(outdir: str, mesh: str = "single"):
    recs = []
    for f in sorted(Path(outdir).glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        if r.get("ok"):
            recs.append(r)
    return recs


def fmt_row(r, peak_flops: float = PEAK_FLOPS):
    rl = r["roofline"]
    meta = r.get("meta", {})
    n_dev = r.get("n_devices", 256)
    model_flops = meta.get("model_flops", 0.0)
    hlo_flops_total = rl["flops_per_device"] * n_dev
    ratio = model_flops / hlo_flops_total if hlo_flops_total else 0.0
    bound = rl["bound_time_s"]
    # roofline fraction: useful-compute time / bound time
    ideal_compute = model_flops / (n_dev * peak_flops)
    frac = ideal_compute / bound if bound else 0.0
    mem = r.get("memory", {}).get("peak_per_device_gib", float("nan"))
    return {
        "arch": r["arch"], "shape": r["shape"], "kind": r["kind"],
        "compute_s": rl["compute_time_s"],
        "memory_s": rl.get("memory_time_fused_s", rl["memory_time_s"]),
        "memory_raw_s": rl["memory_time_s"],
        "coll_s": rl["collective_time_s"], "dominant": rl["dominant"],
        "model_flops": model_flops, "hlo_ratio": ratio,
        "roofline_frac": frac, "mem_gib": mem,
        "n_coll": rl.get("n_collectives", 0),
    }


def markdown_table(rows):
    hdr = ("| arch | shape | kind | compute (s) | memory fused (s) | raw (s) "
           "| collective (s) | dominant | MODEL_FLOPS | MODEL/HLO "
           "| roofline frac | mem GiB/dev |")
    sep = "|" + "---|" * 12
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['memory_raw_s']:.3e} "
            f"| {r['coll_s']:.3e} | **{r['dominant']}** "
            f"| {r['model_flops']:.2e} | {r['hlo_ratio']:.2f} "
            f"| {r['roofline_frac']:.4f} | {r['mem_gib']} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else "results/dryrun_torch"
    mesh = argv[1] if len(argv) > 1 else "single"
    rows = [fmt_row(r) for r in load(outdir, mesh)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print(markdown_table(rows))
    print(f"\n{len(rows)} cells ({mesh} mesh)")
    if rows:
        worst = min(rows, key=lambda r: r["roofline_frac"] or 1)
        collb = max(rows, key=lambda r: r["coll_s"])
        print(f"worst roofline fraction: {worst['arch']} × {worst['shape']} "
              f"({worst['roofline_frac']:.4f})")
        print(f"most collective-bound: {collb['arch']} × {collb['shape']} "
              f"({collb['coll_s']:.3e}s)")


if __name__ == "__main__":
    main()
