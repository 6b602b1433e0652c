"""What decides `correct`, on the CPU at a small scale: a sound run of
each cell passes; the control (the plain reference in bfloat16 in the
program's place) and each fault planted under the timed path fail.

The runs go through `harness.run_cell`, the whole run but the look for a
card, with the port's plain kernels.  The faults a cell here can have:
a superstep that returns its state unchanged, half of the batch left out
of the combine (half the edges of a job), and an answer altered where it
is produced.  No cell spans chips,
so there is no exchange to leave out.
"""
import dataclasses
import math

import pytest
import torch

from portbench import harness

SCALE = {"scale": 9}
SEED = 2**31 + 101
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
# long enough for every kind to finish queries inside the window on a
# loaded CPU (a kind with no answer to check makes a run not correct)
WINDOW_S = 1.0
IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}


def run(cell, trace=False, keep=None):
    return harness.run_cell(cell, SEED, WINDOW_S, trace,
                            device="cpu",
                            overrides=SCALE, keep=keep)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    res = run(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] is not None for c in res["checks"].values())
    want = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "per_layer" if trace else "end_to_end")}
    host_only = {"setup_s", "queries_per_s", "ingress_s",
                 "supersteps_per_query"}
    assert want & host_only <= set(res["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    keep = {}
    res = run(cell, keep=keep)
    assert res["correct"]
    ctl = harness.control(keep["parts"], keep["edges"], keep["samples"],
                          "cpu")
    lim = harness.limits(keep["parts"])
    assert any(ctl[k] > lim[k] for k in lim), ctl


def unchanged_state(monkeypatch):
    from repro_torch.core.engine import GREEngine

    def apply(self, part, state, combined):
        return dataclasses.replace(
            state, active_scatter=torch.zeros_like(state.active_scatter),
            step=state.step + 1)
    monkeypatch.setattr(GREEngine, "apply", apply)


def half_batch(monkeypatch):
    from repro_torch.kernels import ops

    def drop(msgs, op):
        msgs = msgs.clone()
        msgs[msgs.shape[0] // 2:] = IDENTITY[op]
        return msgs

    dense, tile = ops.segment_combine, ops.tile_segment_combine
    monkeypatch.setattr(ops, "segment_combine",
                        lambda m, d, n, op="sum", seg_ptr=None:
                        dense(drop(m, op), d, n, op, seg_ptr=seg_ptr))
    monkeypatch.setattr(ops, "tile_segment_combine",
                        lambda m, d, n, op="sum", valid=None:
                        tile(drop(m, op), d, n, op, valid))


def _alter(values):
    """The answer with its largest finite value raised by one."""
    t = values.clone()
    flat = t.view(-1)
    flat[int(torch.where(flat < math.inf, flat, -math.inf).argmax())] += 1.0
    return t


def altered_answer(monkeypatch):
    from repro_torch.core.engine import GREEngine
    run_ = GREEngine.run
    monkeypatch.setattr(
        GREEngine, "run", lambda self, part, state, max_steps=100:
        dataclasses.replace(s := run_(self, part, state, max_steps),
                            vertex_data=_alter(s.vertex_data)))


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert not res["correct"], res["checks"]
