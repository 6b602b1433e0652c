"""Checkpoint and restart (paper §6.3, generalised); the counterpart of
`repro/checkpoint/manager.py`.

GRE checkpoints only the native vertex states and the active bitmap,
"abandoning all agent data and temporal messages": agent slots are
rebuilt to the monoid identity on restore.  `graph_engine_snapshot` and
`graph_engine_restore` keep that contract on the port's `EngineState`.
Training snapshots are the parameters, the optimizer state and the step
(the data cursor is a pure function of the step, `data.tokens`).

`CheckpointManager` writes a snapshot as one flat `.npz` blob (bfloat16
stored as float32, a lossless widening) beside a `meta.json`, renames the
finished directory into place and then moves an atomic `latest` marker;
an optional writer thread takes the disk writes off the caller's path
(the device-to-host copy happens in `save`, so the caller may update its
tensors in place right after), and only the newest `keep` snapshots
stay.  Trees are nested dicts (or lists) of tensors, numpy arrays and
numbers; `restore(like)` fills a tree of that structure, each tensor with
the dtype and device of its `like` counterpart, or loads into a module's
state in place.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine import EngineState


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree, paths joined by
    '/'."""
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach,
    bfloat16 widened to float32 (npz has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _rebuild(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    key = prefix[:-1]
    arr = flat[key]
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: stored {arr.shape}, expected "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(arr).to(like.device, like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[Exception] = None
        if async_write:
            threading.Thread(target=self._drain, daemon=True).start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, metadata: Optional[Dict[str, Any]] = None
             ) -> None:
        """Snapshot `tree` (or a module's state) as step `step`.  The host
        copy is taken here; the disk write runs on the writer thread when
        asynchronous."""
        if isinstance(tree, torch.nn.Module):
            tree = tree.state_dict()
        flat = {key: _host(leaf) for key, leaf in _leaves(tree)}
        payload = (step, flat, metadata or {})
        if self.async_write:
            self._q.put(payload)
        else:
            self._write(payload)

    def wait(self) -> None:
        """Barrier: every queued snapshot is on disk (a failed write
        raises here)."""
        if self.async_write:
            self._q.join()
        if self._error is not None:
            raise RuntimeError("a checkpoint write failed") from self._error

    def _drain(self) -> None:
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except Exception as exc:       # the writer keeps running;
                self._error = exc          # wait() reports the failure
            finally:
                self._q.task_done()

    def _write(self, payload) -> None:
        step, flat, metadata = payload
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "state.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "keys": sorted(flat), "metadata": metadata,
             "time": time.time()}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (self.dir / "latest.tmp").write_text(str(step))
        os.replace(self.dir / "latest.tmp", self.dir / "latest")
        self._gc()

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[:-self.keep]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("-")[1]) for p in self.dir.glob("step-*")]

    def latest_step(self) -> Optional[int]:
        f = self.dir / "latest"
        if not f.exists():
            return None
        s = int(f.read_text())
        return s if (self.dir / f"step-{s}").exists() else None

    def restore(self, like, step: Optional[int] = None):
        """(tree, step): snapshot `step` (default the latest) in the
        structure of `like`, each tensor with its `like` counterpart's
        dtype and device.  A module as `like` gets the state loaded in
        place and comes back as the tree."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with np.load(self.dir / f"step-{step}" / "state.npz") as blob:
            flat = {key: blob[key] for key in blob.files}
        if isinstance(like, torch.nn.Module):
            like.load_state_dict(_rebuild(like.state_dict(), flat))
            return like, step
        return _rebuild(like, flat), step


def graph_engine_snapshot(state: EngineState, cap: int) -> Dict[str, Any]:
    """Paper §6.3: the master states and the active bitmap of the first
    `cap` slots (the masters), the step and the lane tracker; agent slots
    and in-flight messages are temporal and are not kept.  Copies, so the
    run may go on."""
    snap = {"vertex_data": state.vertex_data.clone(),
            "scatter_data": state.scatter_data[:cap].clone(),
            "active": state.active_scatter[:cap].clone(),
            "step": int(state.step)}
    if state.lane_active is not None:
        snap["lane_active"] = state.lane_active.clone()
    return snap


def graph_engine_restore(snapshot: Dict[str, Any], num_slots: int,
                         identity: float) -> EngineState:
    """A whole `EngineState` from a master-only snapshot: the slots past
    the snapshot's hold the monoid identity and are inactive."""
    sd = snapshot["scatter_data"]
    cap = sd.shape[0]
    full = torch.full((num_slots,) + tuple(sd.shape[1:]), identity,
                      dtype=sd.dtype, device=sd.device)
    full[:cap] = sd
    act = torch.zeros(num_slots, dtype=torch.bool, device=sd.device)
    act[:cap] = snapshot["active"]
    return EngineState(snapshot["vertex_data"], full, act,
                       int(snapshot["step"]), snapshot.get("lane_active"))
