"""Persistent plan cache: measured `SuperstepPlan` winners, keyed by
scenario fingerprint.

One JSON file (human-diffable, committed or per-machine) mapping
`plan_cache_key` strings — graph fingerprint + program fingerprint +
mesh size (repro_torch.tuning.fingerprint) — to serialized plans
(`SuperstepPlan.to_json`) plus the probe measurements that crowned them.
Engines constructed with `plan="auto-tuned"` consult it at state init:
a HIT adopts the stored plan and runs ZERO probe supersteps (the search
is skipped entirely — the cache is the point); a MISS silently keeps
the engine's hand-picked defaults.  `tune()` (repro_torch.tuning.search)
writes entries after a search.

File format (`version` guards schema drift; unknown plan fields are
additionally rejected by `SuperstepPlan.from_json`):

    {"version": 1,
     "entries": {"<key>": {"plan": {...}, "probe_us": 123.4,
                           "default_us": 150.2, "space_size": 24}}}

The format and `CACHE_VERSION` are the JAX package's, so either package
reads the other's file.  The default location is `$GRE_PLAN_CACHE` or,
when that is unset, `.gre_plan_cache.torch.json` under the current
directory: a file of its own, so that plans the JAX package measured on
the CPU are not read by default; tests and benchmarks pass explicit paths.
"""
from __future__ import annotations

import json
import os
import warnings
from pathlib import Path
from typing import Dict, Optional

from repro_torch.core.plan import SuperstepPlan

CACHE_VERSION = 1


def default_cache_path() -> Path:
    return Path(os.environ.get("GRE_PLAN_CACHE",
                               ".gre_plan_cache.torch.json"))


class PlanCache:
    """JSON-file-backed plan store.  Reads are lazy and cached; `store`
    re-reads, merges, and atomically rewrites, so concurrent tuners on
    disjoint keys lose at most a race's worth of entries, never the
    file's integrity."""

    def __init__(self, path=None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._data: Optional[Dict] = None

    # ------------------------------------------------------------------ io
    def _load(self) -> Dict:
        if self._data is None:
            if self.path.exists():
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("version") != CACHE_VERSION:
                    # A foreign-version file (e.g. a CI cache restored
                    # across a schema bump) degrades to an EMPTY cache:
                    # every lookup misses, the engine keeps its defaults /
                    # runs a fresh search, and the next `store` rewrites
                    # the file at the current version.  Serving stacks
                    # must not crash on a stale artifact.
                    warnings.warn(
                        f"plan cache {self.path}: version "
                        f"{data.get('version')!r} != {CACHE_VERSION}; "
                        "ignoring stale entries (fresh search fallback)",
                        stacklevel=3)
                    data = {"version": CACHE_VERSION, "entries": {}}
                self._data = data
            else:
                self._data = {"version": CACHE_VERSION, "entries": {}}
        return self._data

    def _write(self) -> None:
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    # ----------------------------------------------------------------- api
    def lookup(self, key: str) -> Optional[SuperstepPlan]:
        """The stored winner for `key`, or None (miss).  Raises on a
        schema-drifted entry rather than executing a half-read plan."""
        entry = self._load()["entries"].get(key)
        if entry is None:
            return None
        return SuperstepPlan.from_json(entry["plan"])

    def entry(self, key: str) -> Optional[Dict]:
        """The raw entry dict (plan + measurement metadata), or None."""
        return self._load()["entries"].get(key)

    def store(self, key: str, plan: SuperstepPlan, **meta) -> None:
        """Persist `plan` under `key` with measurement metadata
        (probe_us, default_us, space_size, ...)."""
        self._load()  # ensure version check before mutating
        # merge with any entries written since our read
        if self.path.exists():
            self._data = None
            self._load()
        self._data["entries"][key] = {"plan": plan.to_json(), **meta}
        self._write()

    def keys(self):
        return list(self._load()["entries"])

    def __len__(self) -> int:
        return len(self._load()["entries"])
