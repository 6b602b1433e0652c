"""Multi-pod dry run of the port: every (architecture x input shape) cell
on the production meshes, one device's step run on fake tensors over a
fake process group, with memory and roofline records (the counterpart of
`repro/launch/dryrun.py`, which lowers and compiles for 512 host devices).

  single-pod: (16, 16)    = ("data", "model")          — 256 devices
  multi-pod:  (2, 16, 16) = ("pod", "data", "model")   — 512 devices

Usage:
  python -m repro_torch.launch.dryrun                    # 40 cells, both
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --mesh single      # single-pod only
  python -m repro_torch.launch.dryrun --graph            # + GRE PageRank
  python -m repro_torch.launch.dryrun --out results/dryrun_torch

A cell runs as rank 0 of a world of the mesh's size
(`torch.testing._internal.distributed.fake_pg`: collectives return at
once), under a `FakeTensorMode` (no tensor is allocated, no kernel
launches) and a `launch.roofline.StepCounter`.  Its record has the JAX
package's fields: `lower_s` is the seconds to make the inputs and
`compile_s` those of the fake step; `memory.peak_per_device_gib` is the
high-water mark of live fake storage on the device, the step's inputs
(parameters, optimizer state, batch) included; `roofline` is
`roofline.analyze` of the step (a train cell's AdamW holds its moments,
as after a first step).

What it predicts: the bytes a device holds at its peak and the work and
traffic a step asks for, at any mesh, from the port's own code.  What it
cannot: times (only bounds), the caching allocator's fragmentation and
the CUDA context, and sizes that depend on data (a masked route is taken
at every row; the graph cells' Agent-Graph shapes are the JAX package's
estimates, not a partition).

The process group is opened and destroyed here, and nothing is set at
import.  Exit code 1 when any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import all_cells
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(shape, axes, device_type=None):
    """A fake process group of `prod(shape)` ranks (this process rank 0)
    and its mesh; the group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group; "
                           "one is already initialised")
    import torch
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    size = 1
    for n in shape:
        size *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield make_mesh(shape, axes, device_type)
    finally:
        dist.destroy_process_group()


def run_fake(setup):
    """`setup()` and its step under a fake mode and a counter: (step
    seconds, setup seconds, the counter, the bytes live after setup)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    counter = rl.StepCounter()
    t0 = time.time()
    with FakeTensorMode(), counter:
        counter.counting = False
        step = setup()
        args = counter.live
        t1 = time.time()
        counter.counting = True
        step()
    return time.time() - t1, t1 - t0, counter, args


def record(arch, shape, kind, mesh, meta, counter, args, lower_s, run_s):
    gib = 2 ** 30
    return {"arch": arch, "shape": shape, "kind": kind,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "n_devices": int(mesh.size()),
            "lower_s": round(lower_s, 2), "compile_s": round(run_s, 2),
            "meta": meta, "ok": True,
            "memory": {"argument_bytes": int(args), "output_bytes": 0,
                       "temp_bytes": int(counter.peak - args),
                       "alias_bytes": 0,
                       "peak_bytes": int(counter.peak),
                       "peak_per_device_gib": round(counter.peak / gib, 3)},
            "xla_cost": {"flops": counter.cost.flops,
                         "bytes_accessed": counter.cost.hbm_bytes},
            "roofline": rl.analyze(counter)}


def run_cell(arch: str, shape: str, mesh) -> dict:
    from repro_torch.launch.cells import build_cell
    cell = build_cell(arch, shape, mesh)
    run_s, lower_s, counter, args = run_fake(cell.setup)
    return record(arch, shape, cell.kind, mesh, cell.meta, counter, args,
                  lower_s, run_s)


def run_graph_engine_dryrun(mesh) -> dict:
    """The paper's own workload on the mesh: 30 canonical PageRank
    supersteps on one shard of an estimated Agent-Graph (V = 2^26,
    E = 2^30) over every device, its exchanges through a
    `ProcessGroupComm` of the fake group."""
    from repro_torch.launch.cells import graph_superstep_setup
    setup, meta = graph_superstep_setup(int(mesh.size()))
    run_s, lower_s, counter, args = run_fake(setup)
    return record("gre-pagerank", f"rmat26x16_k{mesh.size()}",
                  "graph-superstep", mesh, meta, counter, args, lower_s,
                  run_s)


def _failed(rec_base, e) -> dict:
    return {**rec_base, "ok": False, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--graph", action="store_true",
                    help="also dry-run the GRE graph engine itself")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells())
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    n_fail = 0
    t_all = time.time()
    for mesh_name in names:
        shape, axes = MESHES[mesh_name]
        with fake_world(shape, axes) as mesh:
            if args.graph:
                try:
                    rec = run_graph_engine_dryrun(mesh)
                    print(f"[{mesh_name}] gre-pagerank superstep: "
                          f"run {rec['compile_s']}s "
                          f"mem/dev={rec['memory']['peak_per_device_gib']}"
                          f"GiB dominant={rec['roofline']['dominant']}",
                          flush=True)
                except Exception as e:
                    n_fail += 1
                    rec = _failed({"arch": "gre-pagerank",
                                   "mesh": mesh_name}, e)
                    print(f"[{mesh_name}] gre-pagerank FAILED: "
                          f"{type(e).__name__}: {str(e)[:160]}", flush=True)
                (outdir / f"graph_{mesh_name}.json").write_text(
                    json.dumps(rec, indent=1))
            for arch, shp in cells:
                tag = f"{arch}__{shp}__{mesh_name}"
                try:
                    rec = run_cell(arch, shp, mesh)
                    r = rec["roofline"]
                    print(f"[{mesh_name}] {arch:22s} {shp:14s} "
                          f"run={rec['compile_s']:7.1f}s "
                          f"mem/dev={rec['memory']['peak_per_device_gib']}"
                          f"GiB compute={r['compute_time_s']:.3e}s "
                          f"memory={r['memory_time_s']:.3e}s "
                          f"coll={r['collective_time_s']:.3e}s "
                          f"dominant={r['dominant']}", flush=True)
                except Exception as e:
                    n_fail += 1
                    rec = _failed({"arch": arch, "shape": shp,
                                   "mesh": mesh_name}, e)
                    print(f"[{mesh_name}] {arch:22s} {shp:14s} FAILED: "
                          f"{type(e).__name__}: {str(e)[:160]}", flush=True)
                (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    print(f"\ndry-run complete in {time.time() - t_all:.1f}s; "
          f"{n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
