"""Analytics jobs, one at a time: one `GREEngine` a query kind over the
whole graph's `DevicePartition`, each job `init_state` from its search key
(none for PageRank), `run` to quiescence or the kind's `max_steps`, then
its vertex values read back to the host."""
from __future__ import annotations

from collections import Counter, deque

WARMUP_JOBS = 2       # finished jobs of each kind before the window opens


def ingress(graph, cfg: dict, seed: int, device):
    """The whole graph's `DevicePartition` on `device`; `seed` changes
    nothing here."""
    del cfg, seed
    from repro_torch.core.engine import DevicePartition
    return DevicePartition.from_graph(graph, device=device)


class Deployment:
    def __init__(self, cfg: dict, part, kinds: dict, tracer):
        from repro_torch.core import frontier
        from repro_torch.core.engine import GREEngine
        self.part = part
        self.settings = cfg["kinds"]
        self.engines = {}
        for kind, mod in kinds.items():
            eng = GREEngine(mod.program(),
                            frontier=self.settings[kind]["frontier"])
            tracer.wrap(eng, "dense_scatter_combine", "scatter_combine")
            tracer.wrap(eng, "apply", "apply")
            self.engines[kind] = eng
        tracer.wrap(frontier, "frontier_counts", "frontier_counts")
        self.tracer = tracer
        self.queue: deque = deque()
        self.finished = Counter()

    def submit(self, req) -> None:
        self.queue.append(req)

    def step(self) -> list:
        req = self.queue.popleft()
        eng = self.engines[req.kind]
        with self.tracer.span("job.init_state"):
            state = eng.init_state(self.part, source=req.root)
        with self.tracer.span("job.run"):
            out = eng.run(self.part, state,
                          self.settings[req.kind]["max_steps"])
        with self.tracer.span("job.read_result"):
            req.result = out.vertex_data.cpu().numpy()
        req.supersteps = out.step
        self.finished[req.kind] += 1
        return [req]

    def warmed_up(self) -> bool:
        return all(self.finished[k] >= WARMUP_JOBS for k in self.engines)

    def close(self) -> None:
        self.engines.clear()
        self.queue.clear()
        self.part = None
