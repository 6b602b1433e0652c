"""The command's refusals: no card, too few cards, JAX or the JAX package
in the process; and one cell end to end on the card (marked `cuda`)."""
import sys
import types

import pytest
import torch

from portbench import harness, run

WORKLOAD = harness.benchmark()["workloads"][0]["name"]
ARGS = ["--workload", WORKLOAD, "--seed", "1", "--seconds", "1",
        "--trace", "0"]


@pytest.fixture(autouse=True)
def _keep_environ(monkeypatch):
    """`run.main` points the kernel caches into the checkout."""
    for key in ("TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "repro",
                                  "repro.core.engine"])
def test_forbidden_module_is_found(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name.split(".")[0] in harness.forbidden_modules()
    with pytest.raises(harness.CellError):
        harness.require_no_jax("now")


@pytest.mark.parametrize("name", ["repro_torch", "repro_torch.core",
                                  "reprox", "jaxtyping"])
def test_other_module_passes(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    harness.require_no_jax("now")


def test_no_card_fails_without_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_fails(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]
                    ) != 0
    assert capsys.readouterr().out == ""


def test_result_line_fields(monkeypatch):
    """The line's keys, `checks` last, from a CPU run's fields."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    res = harness.run_cell(WORKLOAD, 3, 0.2, False, device="cpu",
                           overrides={"scale": 8})
    cell = harness.workload(harness.benchmark(), WORKLOAD)
    line = run.result_line(res, cell, False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["config"]["reduced"] == ["scale"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_cell_end_to_end_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for trace in (False, True):
        res = harness.run_cell(cell, 2**31 + 5, 2.0, trace, device="cuda",
                               overrides={"scale": 14})
        assert res["correct"], res["checks"]
        assert res["metrics"]


def test_counter_metric_reads_around_the_window(monkeypatch):
    """A metric that takes a snapshot reads the port's counter as the
    window opens and closes (here K1's launch count, which the plain CPU
    path leaves alone, bumped by each combine call)."""
    from repro_torch.kernels import ops, segment_combine
    for route in ("dense", "tile"):
        monkeypatch.setitem(segment_combine.LAUNCHES, route, 0)
    dense, tile = ops.segment_combine, ops.tile_segment_combine

    def counted(fn, route):
        def call(*args, **kwargs):
            segment_combine.LAUNCHES[route] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(ops, "segment_combine", counted(dense, "dense"))
    monkeypatch.setattr(ops, "tile_segment_combine", counted(tile, "tile"))
    res = harness.run_cell(WORKLOAD, 5, 0.5, True, device="cpu",
                           overrides={"scale": 8})
    before, after = res["record"].snapshots["k1_launches_per_query"]
    assert after > before > 0
    got = res["metrics"]["k1_launches_per_query"]["value"]
    assert got == (after - before) / res["attempted"] >= 1
