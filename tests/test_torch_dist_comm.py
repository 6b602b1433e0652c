"""`ProcessGroupComm` (`repro_torch.dist.comm`) on a world of 4 gloo ranks
on the CPU (`repro_torch.dist.world`), each call held bitwise against
`StackedComm(4)` on the same numpy-seeded input, and the world's failure
paths: a rank that raises, two that raise, a rank that hangs, NCCL where
it cannot run, and the parent's gathering of failed reports on a stub
queue.

One world a module runs every call (`comm_calls`, a module-level function
the spawned ranks import) and returns each rank's results; each call is
its own test.
"""
import pickle
import queue
import time

import numpy as np
import pytest
import torch

from repro_torch.dist.comm import StackedComm
from repro_torch.dist.world import (RankError, check_backend,
                                    collect_reports, run_world)

K = 4
WORLD_TIMEOUT = 120.0


def _inputs():
    """Per-shard rows `[K, ...]` from numpy seed 0.  The psum rows mix
    magnitudes 1e8 and 1, so a float32 sum in another order than
    0, 1, ..., K-1 gives other bits."""
    rng = np.random.default_rng(0)
    big = rng.choice([-1.0, 1.0], size=(K, 64)) * 1e8
    small = rng.normal(size=(K, 64))
    psum = np.where(rng.random((K, 64)) < 0.5, big, small).astype(np.float32)
    return {"psum": psum,
            "a2a": rng.normal(size=(K, K, 5, 2)).astype(np.float32),
            "a2a_cot": rng.normal(size=(K, K, 5, 2)).astype(np.float32),
            "a2a_bool": rng.random((K, K, 7)) < 0.5,
            "min": rng.normal(size=(K, 9)).astype(np.float32),
            "lanes": rng.random((K, 6)) < 0.3,
            "flags": np.array([False, False, True, False]),
            "gather": rng.integers(0, 1000, size=(K, 3, 2)).astype(np.int64)}


def _calls(comm, x):
    """Every call of one communicator on the rows it holds (`x[rows]`)."""
    rows = slice(comm.shards[0], comm.shards[-1] + 1)

    def t(name, **kw):
        return torch.from_numpy(x[name][rows]).requires_grad_(
            kw.get("grad", False))

    out = {}
    comm.values = 0
    out["psum"] = comm.psum(t("psum"))
    a = t("a2a", grad=True)
    y = comm.all_to_all(a)
    (y * t("a2a_cot")).sum().backward()
    out["a2a"], out["a2a_grad"] = y.detach(), a.grad
    out["a2a_bool"] = comm.all_to_all(t("a2a_bool"))
    out["pmin"] = comm.pmin(t("min"))
    out["pmax"] = comm.pmax(t("min"))
    out["pmax_bool"] = comm.pmax(t("lanes"))
    out["any"] = torch.tensor(comm.any(t("flags")))
    out["none"] = torch.tensor(comm.any(torch.zeros(len(comm.shards),
                                                    dtype=torch.bool)))
    out["all_gather"] = comm.all_gather(t("gather"))
    out["values"] = torch.tensor(comm.values)
    return {k: v.numpy() for k, v in out.items()}


def comm_calls(comm):
    return _calls(comm, _inputs())


def _raises(comm):
    if comm.rank == 2:
        raise KeyError("rank 2 planted this")
    comm.pmax(torch.zeros(1, 1))       # the others wait in a collective


def _two_raise(comm):
    if comm.rank == 1:
        raise KeyError("rank 1 planted this")
    if comm.rank == 3:
        raise ValueError("rank 3 planted that")
    comm.pmax(torch.zeros(1, 1))       # the others wait in a collective


def _hangs(comm):
    if comm.rank == 1:
        time.sleep(120)                # never joins the collective
    comm.any(torch.ones(1, dtype=torch.bool))


@pytest.fixture(scope="module")
def world_run():
    return run_world(comm_calls, K, device="cpu", timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world(world_run):
    return [r.value for r in world_run], _calls(StackedComm(K), _inputs())


def test_world_returns_every_rank_in_order(world_run):
    assert [r.rank for r in world_run] == list(range(K))
    assert all(r.spawn_s > 0 and r.init_s > 0 for r in world_run)


def test_psum_is_bitwise_the_stacked_fold(world):
    ranks, stacked = world
    x = _inputs()["psum"]
    backwards = x[3] + x[2] + x[1] + x[0]          # the order matters here
    assert not np.array_equal(backwards, stacked["psum"][0])
    for r, got in enumerate(ranks):
        assert got["psum"].shape == (1, 64)
        np.testing.assert_array_equal(got["psum"][0], stacked["psum"][r])


@pytest.mark.parametrize("call", ["a2a", "a2a_grad", "a2a_bool"])
def test_all_to_all_forward_and_backward(world, call):
    ranks, stacked = world
    for r, got in enumerate(ranks):
        assert got[call].dtype == stacked[call].dtype
        np.testing.assert_array_equal(got[call][0], stacked[call][r])


@pytest.mark.parametrize("call", ["pmin", "pmax", "pmax_bool"])
def test_pmin_pmax(world, call):
    ranks, stacked = world
    for r, got in enumerate(ranks):
        assert got[call].dtype == stacked[call].dtype
        np.testing.assert_array_equal(got[call][0], stacked[call][r])


def test_any_and_all_gather(world):
    ranks, stacked = world
    assert stacked["any"] and not stacked["none"]
    for got in ranks:
        assert got["any"] == stacked["any"] and got["none"] == stacked["none"]
        np.testing.assert_array_equal(got["all_gather"],
                                      stacked["all_gather"])


def test_values_add_up_to_the_stacked_count(world):
    ranks, stacked = world
    assert sum(int(got["values"]) for got in ranks) == int(stacked["values"])


def test_a_failing_rank_reaches_the_parent():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 2 planted this"):
        run_world(_raises, K, device="cpu", timeout=WORLD_TIMEOUT)
    assert time.monotonic() - t0 < WORLD_TIMEOUT


def test_two_failing_ranks_reach_the_parent_in_one_error():
    t0 = time.monotonic()
    with pytest.raises(RankError) as err:
        run_world(_two_raise, K, device="cpu", timeout=WORLD_TIMEOUT)
    assert time.monotonic() - t0 < WORLD_TIMEOUT
    text = str(err.value)
    assert "rank 1 planted this" in text and "rank 3 planted that" in text
    assert text.index("rank 1 of 4 failed") < text.index("rank 3 of 4 failed")


class _StubQueue:
    """The reports a world would put, in the given order."""

    def __init__(self, reports):
        self.reports = list(reports)

    def get(self, timeout):
        if not self.reports:
            time.sleep(min(timeout, 0.01))
            raise queue.Empty
        return self.reports.pop(0)

    def empty(self):
        return not self.reports


class _StubProc:
    def __init__(self, rank, exitcode):
        self.name, self.exitcode = f"rank{rank}", exitcode


@pytest.mark.parametrize("others", ["exited", "running"])
def test_collect_reports_keeps_reading_after_a_bystander_error(others):
    """A bystander's collective error reaches the parent before the rank
    that caused it: both tracebacks end up in the one error, in rank
    order, whether the silent ranks have exited or run on (the grace
    period ends the wait)."""
    bystander = ("error", 0, "RuntimeError: [gloo] Connection closed by "
                 "peer", 0.1, 0.1)
    planter = ("error", 2, "KeyError: 'rank 2 planted this'", 0.1, 0.1)
    ok = ("ok", 1, pickle.dumps(7), 0.1, 0.1)
    exitcode = 1 if others == "exited" else None
    procs = [_StubProc(r, exitcode) for r in range(K)]
    t0 = time.monotonic()
    with pytest.raises(RankError) as err:
        collect_reports(_StubQueue([bystander, planter, ok]), procs,
                        deadline=time.monotonic() + 60.0, grace=0.5)
    assert time.monotonic() - t0 < 5.0
    text = str(err.value)
    assert "rank 2 planted this" in text and "Connection closed" in text
    assert text.index("rank 0 of 4 failed") < text.index("rank 2 of 4 failed")
    assert "rank 1 of 4" not in text


def test_collect_reports_returns_every_rank_in_order():
    reports = [("ok", r, pickle.dumps(r * 10), 0.1, 0.2) for r in (2, 0, 1)]
    got = collect_reports(_StubQueue(reports), [_StubProc(r, None)
                                                for r in range(3)],
                          deadline=time.monotonic() + 60.0)
    assert [(r.rank, r.value) for r in got] == [(0, 0), (1, 10), (2, 20)]


def test_a_hung_rank_ends_inside_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RankError):
        run_world(_hangs, 2, device="cpu", timeout=8.0)
    assert time.monotonic() - t0 < 30.0


def test_nccl_refused_before_init():
    """NCCL needs one card a rank: refused before any process starts."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="one card a rank"):
            check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
        return
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="needs a card"):
        run_world(comm_calls, 2, backend="nccl", timeout=WORLD_TIMEOUT)
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(ValueError, match="CUDA only"):
        run_world(comm_calls, 2, backend="nccl", device="cpu")
