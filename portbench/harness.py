"""One run of one cell: set-up, warm-up, the measured window, the check
that decides `correct`, and the result's line.

Everything that belongs to a cell is found by name: the workload in
`BENCHMARK.json`, its configuration in `configs/<config>.json`, its
traffic mix in `traffic/<mix>.json`, the deployment the configuration
names in `deploy/<deployment>.py`, each query kind of the mix in
`queries/<kind>.py`, and each metric in `metrics/<metric>.py`.  This file
names none of them.

The harness draws the inputs and builds the host graph; the deployment
builds its own device state from that graph (its `ingress`: one partition
of the whole graph, shards, whatever it serves from), and the harness
times that call.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import loadgen, tracing
from portbench.inputs import rmat

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules whose presence in the measured process means the JAX package or
# JAX ran there (compared by whole top-level name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
SAMPLES_PER_KIND = 8          # answers checked a kind, besides the longest
WARMUP_LIMIT_S = 300.0
# the part of a traced run's window under the profiler, from its start
# (bounds the trace's size and the time to read it)
TRACE_SLICE_S = 15.0


class CellError(RuntimeError):
    """The run cannot produce a result (no card, a forbidden module, ...)."""


# ------------------------------------------------------------- the spec
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise CellError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, name: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    workload `name` reports."""
    return [m for m in spec[section]
            if "workloads" not in m or name in m["workloads"]]


def plugin(folder: str, name: str):
    """The module `<folder>/<name>.py` of this benchmark, loaded by path
    (a name may hold `-` and `.`)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no {folder} file {path.relative_to(ROOT)}")
    key = f"portbench.{folder}.{name}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, name: str) -> dict:
    """Every file the workload `name` needs, loaded: its configuration,
    traffic mix, deployment, query kinds and metric readers."""
    cell = workload(spec, name)
    conf = next((c for c in spec["configs"] if c["name"] == cell["config"]),
                None)
    if conf is None:
        raise CellError(f"workload {name!r} names no listed configuration")
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    metrics = {m["name"]: plugin("metrics", m["name"])
               for sec in ("end_to_end", "per_layer")
               for m in cell_metrics(spec, name, sec)}
    deploy = plugin("deploy", cfg["deployment"])
    if not callable(getattr(deploy, "ingress", None)):
        path = (HERE / "deploy" / f"{cfg['deployment']}.py").relative_to(ROOT)
        raise CellError(f"the deployment {path} defines no "
                        f"ingress(graph, cfg, seed, device)")
    return {"cell": cell, "conf": conf, "cfg": cfg, "mix": mix,
            "deploy": deploy,
            "kinds": {k: plugin("queries", k) for k in mix["kinds"]},
            "metrics": metrics}


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN_MODULES))


def require_no_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise CellError(f"{when}: modules of JAX or the JAX package are "
                        f"loaded in this process: {found}")


def require_devices(chips: int) -> None:
    if not torch.cuda.is_available():
        raise CellError("no CUDA device: torch.cuda.is_available() is False "
                        "(the benchmark does not fall back to the CPU)")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell needs {chips} CUDA devices, "
                        f"{torch.cuda.device_count()} present")


# ------------------------------------------------------------- the run
@dataclasses.dataclass
class Request:
    client: int
    kind: str
    root: Optional[int]
    t_submit: float
    t_done: float = 0.0
    supersteps: int = 0
    failed: bool = False
    result: Optional[np.ndarray] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (`metrics/<name>.py`: `read(run)`)."""

    setup_seconds: float
    ingress_seconds: float
    window_s: float
    completed: List[Request]          # finished inside the window
    peak_mem_bytes: int
    # `(before, after)` the window of each metric that takes a snapshot
    snapshots: Dict[str, tuple]
    trace: Optional[tracing.TraceSummary]


class Sampler:
    """The answers the check reads: a uniform sample of each kind's
    answers finished in the window (reservoir sampling, drawn from the
    seed), and each kind's longest query by supersteps."""

    def __init__(self, seed: int):
        self.rng = loadgen.rng(seed, loadgen.PURPOSE_SAMPLE)
        self.k = SAMPLES_PER_KIND
        self.seen: Dict[str, int] = {}
        self.sample: Dict[str, list] = {}
        self.longest: Dict[str, Request] = {}

    def offer(self, req: Request) -> None:
        """Take `req` into the sample or not; the answers of requests that
        leave it (or never enter) are dropped."""
        n = self.seen.get(req.kind, 0)
        pool = self.sample.setdefault(req.kind, [])
        out = []
        if n < self.k:
            pool.append(req)
        else:
            j = int(self.rng.integers(n + 1))
            if j < self.k:
                out.append(pool[j])
                pool[j] = req
            else:
                out.append(req)
        self.seen[req.kind] = n + 1
        best = self.longest.get(req.kind)
        if best is None or req.supersteps > best.supersteps:
            self.longest[req.kind] = req
            if best is not None:
                out.append(best)
        for r in out:
            if r is not self.longest[r.kind] and \
                    all(r is not p for p in pool):
                r.result = None

    def by_kind(self) -> Dict[str, List[Request]]:
        out = {}
        for kind, pool in self.sample.items():
            reqs = list(pool)
            if all(r is not self.longest[kind] for r in reqs):
                reqs.append(self.longest[kind])
            out[kind] = reqs
        return out


def drive(dep, load: loadgen.ClosedLoop, clock, warm_deadline: float,
          seconds: float, tracer, on_window_open, sampler: Sampler):
    """The closed loop: every client keeps one query in flight.  Runs
    until the deployment is warmed up, then measures `seconds`, the first
    `TRACE_SLICE_S` of them under the profiler when tracing.  Returns
    `(window start, window end, requests finished in the window, trace
    summary or None)`."""
    def send(client):
        kind, root = load.next_query()
        dep.submit(Request(client, kind, root, clock()))

    for c in range(load.clients):
        send(c)
    while not dep.warmed_up():
        if clock() > warm_deadline:
            raise CellError("warm-up did not finish")
        for req in dep.step():
            req.t_done = clock()
            req.result = None
            send(req.client)
    on_window_open()
    tracer.start_window()
    t0 = clock()
    deadline = t0 + seconds
    trace_end = t0 + min(seconds, TRACE_SLICE_S)
    done, summary = [], None
    while clock() < deadline:
        finished = dep.step()
        now = clock()
        with tracer.span("clients"):
            for req in finished:
                req.t_done = now
                done.append(req)
                sampler.offer(req)
                send(req.client)
        if tracer.tracing and now >= trace_end:
            summary = tracer.stop_window(len(done))
    t1 = clock()
    if tracer.tracing:
        summary = tracer.stop_window(len(done))
    return t0, t1, done, summary


def device_edges(edges: rmat.EdgeList, device) -> dict:
    return {"src": torch.from_numpy(edges.src).to(device),
            "dst": torch.from_numpy(edges.dst).to(device),
            "weight": torch.from_numpy(edges.weight).to(device),
            "num_vertices": edges.num_vertices}


def check(parts: dict, edges: rmat.EdgeList, samples: Dict[str, list],
          device) -> Dict[str, float]:
    """Each kind's numbers: its sampled answers against the plain
    reference computed from the edge list in float64."""
    dev_edges = device_edges(edges, device)
    out = {}
    for kind, reqs in sorted(samples.items()):
        mod = parts["kinds"][kind]
        roots = [r.root for r in reqs]
        want = mod.reference(dev_edges, roots, _kind_params(parts, kind),
                             torch.float64)
        out.update(mod.compare([r.result for r in reqs], want, roots))
        del want
    return out


def control(parts: dict, edges: rmat.EdgeList, samples: Dict[str, list],
            device) -> Dict[str, float]:
    """The control's numbers: the plain reference computed in bfloat16,
    the precision below the configurations' float32, put in the program's
    place for the same sampled queries, checked as the program's answers
    are."""
    dev_edges = device_edges(edges, device)
    low = {}
    for kind, reqs in samples.items():
        ans = parts["kinds"][kind].reference(
            dev_edges, [r.root for r in reqs], _kind_params(parts, kind),
            torch.bfloat16).float().cpu().numpy()
        low[kind] = [dataclasses.replace(r, result=ans[:, i])
                     for i, r in enumerate(reqs)]
    del dev_edges
    return check(parts, edges, low, device)


def _kind_params(parts: dict, kind: str) -> dict:
    cfg = parts["cfg"]
    return (cfg.get("kinds") or {}).get(kind) or {}


def snapshot(parts: dict, dep) -> Dict[str, object]:
    """What each of the cell's metrics that defines `snapshot(deployment)`
    reads at this moment (a counter of the port, say): taken as the
    window opens and as it closes."""
    return {name: mod.snapshot(dep) for name, mod in parts["metrics"].items()
            if hasattr(mod, "snapshot")}


def limits(parts: dict) -> Dict[str, float]:
    out = {}
    for mod in parts["kinds"].values():
        out.update(mod.LIMITS)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None,
             keep: Optional[dict] = None) -> dict:
    """One run of the workload `name`; returns the result's fields.

    `device="cpu"` and `overrides` (merged into the configuration's
    `graph`) serve the tests alone: a run of the benchmark goes through
    `run.py`, which requires the card.  `keep`, when given, receives the
    edge list and the sampled answers (`control.py`)."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    spec = benchmark()
    parts = resolve(spec, name)
    cfg = parts["cfg"]
    if overrides:
        cfg = dict(cfg, graph=dict(cfg["graph"], **overrides))
        parts["cfg"] = cfg
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tracer = tracing.Tracer(trace, dev)
    try:
        edges, keys = rmat.make_graph(cfg["graph"], seed, dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        from repro_torch.graph.structures import Graph
        # the port gets copies; the reference reads `edges` after the window
        graph = Graph(edges.num_vertices, edges.src.copy(), edges.dst.copy(),
                      {"weight": edges.weight.copy()})
        t0 = clock()
        state = parts["deploy"].ingress(graph, cfg, seed, dev)
        sync(dev)
        ingress_seconds = clock() - t0
        del graph
        dep = parts["deploy"].Deployment(cfg, state, parts["kinds"], tracer)
        load = loadgen.ClosedLoop(parts["mix"], keys, seed,
                                  {k: m.TAKES_ROOT
                                   for k, m in parts["kinds"].items()})
        sampler = Sampler(seed)
        marks = {}

        def window_opens():
            sync(dev)
            require_no_jax("after set-up")
            marks["setup_seconds"] = clock() - t_start
            marks["before"] = snapshot(parts, dep)

        t_w0, t_w1, done, summary = drive(dep, load, clock,
                                          clock() + WARMUP_LIMIT_S, seconds,
                                          tracer, window_opens, sampler)
        after = snapshot(parts, dep)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finally:
        tracer.close()
    dep.close()
    del dep, state
    if cuda:
        torch.cuda.empty_cache()
    require_no_jax("after the window")
    record = RunRecord(setup_seconds=marks["setup_seconds"],
                       ingress_seconds=ingress_seconds,
                       window_s=t_w1 - t_w0, completed=done,
                       peak_mem_bytes=peak,
                       snapshots={k: (marks["before"][k], after[k])
                                  for k in after},
                       trace=summary)
    samples = sampler.by_kind()
    numbers = check(parts, edges, samples, dev)
    lim = limits(parts)
    failed = sum(r.failed for r in done)
    correct = (len(done) > 0 and failed == 0
               and all(k in numbers and numbers[k] <= lim[k] for k in lim))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, name, section):
        value = parts["metrics"][m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if keep is not None:
        keep.update(edges=edges, samples=samples, parts=parts,
                    record=record)
    return {"correct": bool(correct), "attempted": len(done),
            "failed": failed, "metrics": metrics, "record": record,
            "parts": parts, "graph": {"vertices": edges.num_vertices,
                                      "edges": edges.num_edges},
            "checks": {k: {"value": numbers.get(k), "limit": lim[k]}
                       for k in sorted(lim)}}
