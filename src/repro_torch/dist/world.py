"""Start and end a `torch.distributed` world on one host.

`run_world(fn, world_size, args)` spawns `world_size` processes (the
`spawn` context), joins them into one process group at
`tcp://127.0.0.1:<a free port>`, and calls `fn(comm, *args)` in each with
the rank's `ProcessGroupComm` (`comm.device` is the rank's device:
`cuda:(rank % device_count)`, or the CPU when `device="cpu"`).  It returns
one `RankResult` a rank, in rank order, with what `fn` returned (pickled
back to the parent, so keep it small: write large results to files).

A rank's exception reaches the parent with its traceback and is raised
there as `RankError`; the other ranks are then ended.  A rank that exits
without reporting, or a world that has not finished by `timeout` seconds,
is an error too: every collective carries the same timeout
(`init_process_group(timeout=...)`), so a hung collective ends as an
exception inside it, and the parent kills whatever is still running when
it gives up.  Each rank calls `destroy_process_group` on its way out.

`fn` must be importable by name (a module-level function), and so must
its arguments be picklable: spawned processes start from a fresh import.
"""
from __future__ import annotations

import datetime
import multiprocessing
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.comm import ProcessGroupComm

BACKENDS = ("gloo", "nccl")


class RankError(RuntimeError):
    """A rank of a world failed; the message holds its traceback."""


class RankResult(NamedTuple):
    rank: int
    value: Any          # what `fn` returned on this rank
    spawn_s: float      # parent's spawn call to the rank's first line
    init_s: float       # `init_process_group` and the device set-up


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_backend(backend: str, world_size: int, device: str) -> None:
    """Refuse, before any process starts, what the backend cannot run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world_size < 1:
        raise ValueError(f"need at least one rank, got {world_size}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a world on CUDA needs a card, and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' (with backend='gloo') to run on "
                           "the CPU")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("backend='nccl' runs on CUDA only")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"backend='nccl' needs one card a rank: "
                             f"{world_size} ranks, {cards} card(s); use "
                             f"backend='gloo' to share a card")


def _rank_main(rank, world_size, port, backend, device, timeout, fn, args,
               spawned_at, results):
    t0 = time.time()
    status, value, init_s = "ok", None, 0.0
    torch.set_num_threads(1)        # one host thread a rank beside the rest
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        comm = ProcessGroupComm(device=dev)
        init_s = time.time() - t0
        value = pickle.dumps(fn(comm, *args))
    except BaseException:           # reported to the parent, which raises
        status, value = "error", traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((status, rank, value, t0 - spawned_at, init_s))


def run_world(fn: Callable, world_size: int, args: Sequence = (),
              backend: str = "gloo", device: str = "cuda",
              timeout: float = 300.0) -> List[RankResult]:
    """Run `fn(comm, *args)` on `world_size` spawned ranks (see the module
    docstring); returns their `RankResult`s in rank order or raises
    `RankError` (a rank failed, died or outlived `timeout` seconds)."""
    check_backend(backend, world_size, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    spawned_at = time.time()
    procs = [ctx.Process(
        target=_rank_main, name=f"rank{r}", daemon=True,
        args=(r, world_size, port, backend, device, timeout, fn, tuple(args),
              spawned_at, results)) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done = {}
    try:
        while len(done) < world_size:
            try:
                status, rank, value, spawn_s, init_s = results.get(
                    timeout=0.2)
            except queue.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead and results.empty():
                    raise RankError(f"{', '.join(dead)} exited without a "
                                    f"result (exit codes "
                                    f"{[p.exitcode for p in procs]})")
                if time.monotonic() > deadline:
                    raise RankError(
                        f"the world of {world_size} did not finish in "
                        f"{timeout} s; ranks done: {sorted(done)}")
                continue
            if status != "ok":
                raise RankError(f"rank {rank} of {world_size} failed:\n"
                                f"{value}")
            done[rank] = RankResult(rank, pickle.loads(value), spawn_s,
                                    init_s)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
