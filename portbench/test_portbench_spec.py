"""`BENCHMARK.json` against the benchmark's contract, and every workload
resolving by name to its own files."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert (ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves_by_name(name):
    parts = harness.resolve(SPEC, name)
    cell = parts["cell"]
    assert parts["cfg"]["name"] == cell["config"]
    assert parts["deploy"].Deployment
    for kind, mod in parts["kinds"].items():
        assert mod.LIMITS and callable(mod.reference) and callable(mod.compare)
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, name, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(SPEC, name, "per_layer")
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + WORKLOADS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(WORKLOADS)) == len(WORKLOADS)


def test_metric_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in METRICS:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_and_files():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert k in cfg["graph"] and k in cfg["published"]


def test_harness_names_no_cell():
    """Adding a configuration, mix or metric needs only new files: the
    harness's own code names none of them."""
    words = ({c["name"] for c in SPEC["configs"]} | set(WORKLOADS)
             | {w["traffic"] for w in SPEC["workloads"]}
             | {m["name"] for m in METRICS})
    for f in ("harness.py", "run.py", "loadgen.py", "tracing.py",
              "yardstick.py", "control.py"):
        text = (harness.HERE / f).read_text()
        for w in words:
            assert not re.search(rf"\b{re.escape(w)}\b", text), (f, w)
