"""Start and end a `torch.distributed` world on one host.

`run_world(fn, world_size, args)` spawns `world_size` processes (the
`spawn` context), joins them into one process group at
`tcp://127.0.0.1:<a free port>`, and calls `fn(comm, *args)` in each with
the rank's `ProcessGroupComm` (`comm.device` is the rank's device:
`cuda:(rank % device_count)`, or the CPU when `device="cpu"`).  It returns
one `RankResult` a rank, in rank order, with what `fn` returned (pickled
back to the parent, so keep it small: write large results to files).

A rank's exception reaches the parent with its traceback and is raised
there as `RankError`.  One rank's failure often makes the others fail in
their pending collectives, and their reports can reach the parent first,
so after the first failed report the parent reads on until every rank has
reported or exited (at most `FAILURE_GRACE_S` more seconds, never past the
timeout) and raises one `RankError` with every failed rank's traceback in
rank order; the other ranks are then ended.  A rank that exits
without reporting, or a world that has not finished by `timeout` seconds,
is an error too: every collective carries the same timeout
(`init_process_group(timeout=...)`), so a hung collective ends as an
exception inside it, and the parent kills whatever is still running when
it gives up.  Each rank reports, then calls `destroy_process_group` on its
way out.

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
FAILURE_GRACE_S = 5.0   # reading on after the first failed report


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
    # report before the teardown, which fails the others' pending collectives
    try:
        results.put((status, rank, value, t0 - spawned_at, init_s))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def collect_reports(results, procs: Sequence, deadline: float,
                    grace: float = FAILURE_GRACE_S) -> List[RankResult]:
    """Read one report a rank from `results` (a queue of `(status, rank,
    value, spawn_s, init_s)`) while `procs` (one a rank, with `name` and
    `exitcode`) run; returns the `RankResult`s in rank order.  Raises
    `RankError` when a rank failed, exited without a report or had not
    reported by `deadline` (a `time.monotonic()` value).  After the first
    failed report it reads on for at most `grace` seconds, until every
    other rank has reported or exited, and the error holds every failed
    rank's traceback in rank order: no guess is made at which one caused
    the others."""
    world_size = len(procs)
    done, failed = {}, {}
    until = deadline
    while len(done) + len(failed) < world_size:
        try:
            status, rank, value, spawn_s, init_s = results.get(timeout=0.2)
        except queue.Empty:
            silent = [r for r in range(world_size)
                      if r not in done and r not in failed]
            dead = [procs[r].name for r in silent
                    if procs[r].exitcode is not None]
            if failed:
                if time.monotonic() > until or (len(dead) == len(silent)
                                                and results.empty()):
                    break
                continue
            if dead and results.empty():
                raise RankError(f"{', '.join(dead)} exited without a "
                                f"result (exit codes "
                                f"{[p.exitcode for p in procs]})")
            if time.monotonic() > deadline:
                raise RankError(
                    f"the world of {world_size} did not finish in time; "
                    f"ranks done: {sorted(done)}")
            continue
        if status != "ok":
            if not failed:
                until = min(deadline, time.monotonic() + grace)
            failed[rank] = value
            continue
        done[rank] = RankResult(rank, pickle.loads(value), spawn_s, init_s)
    if failed:
        raise RankError("\n".join(
            f"rank {r} of {world_size} failed:\n{failed[r]}"
            for r in sorted(failed)))
    return [done[r] for r in range(world_size)]


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
    try:
        reports = collect_reports(results, procs, deadline)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return reports
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
