"""The port's dry run (`launch/cells.py`, `launch/dryrun.py`,
`launch/aggregate.py`) against the JAX package's.

Every one of the 40 cells at its full config: `meta` equals JAX's
`build_cell(arch, shape, jax.make_mesh((1, 1), ...)).meta` key for key
and value for value (both analytic: no step runs for it).  A few reduced
cells (LM train, prefill and decode, GCN over the Agent-Graph exchange,
a molecule batch, AutoInt) and the graph superstep run their steps on
fake tensors over a fake (2, 2) mesh: their records carry the JAX
package's keys, the kernels are charged, and the peak covers the inputs.
`aggregate.markdown_table` equals JAX's on the same rows, string for
string.  `dryrun.main` writes one record a cell and exits 1 on a failed
one.
"""
from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch.distributed as dist

import jax

from repro.configs import all_cells as jall_cells
from repro.launch import aggregate as jagg
from repro.launch import cells as jcells
from repro_torch.configs import all_cells, get_config
from repro_torch.configs.base import GNNShape, LMShape, RecSysShape
from repro_torch.launch import aggregate, cells, dryrun

JAX_RECORD = {"arch", "shape", "kind", "mesh", "n_devices", "lower_s",
              "compile_s", "meta", "ok", "memory", "xla_cost", "roofline"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device_gib"}


def _plain(x):
    """numpy and jax scalars as Python numbers, tuples as lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "item"):
        return x.item()
    return x


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_there_are_the_jax_cells():
    assert list(all_cells()) == list(jall_cells())
    assert len(list(all_cells())) == 40


@pytest.mark.parametrize("arch,shape", list(all_cells()))
def test_meta_equals_jax(arch, shape, jax_mesh):
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 1}, size=1)
    got = cells.build_cell(arch, shape, duck)
    want = jcells.build_cell(arch, shape, jax_mesh)
    assert got.kind == want.kind
    assert _plain(got.meta) == _plain(want.meta)


@pytest.fixture
def mesh22():
    with dryrun.fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        yield mesh
    assert not dist.is_initialized()


def _reduced_lm(arch):
    from repro_torch.launch.train import reduced_lm_config
    return reduced_lm_config(get_config(arch)[0])


def _check_record(rec, kernels):
    assert JAX_RECORD <= set(rec)
    assert JAX_MEMORY <= set(rec["memory"])
    assert rec["ok"] and rec["n_devices"] == 4
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    rl = rec["roofline"]
    assert rl["bound_time_s"] == max(rl["compute_time_s"],
                                     rl["memory_time_s"],
                                     rl["collective_time_s"]) > 0
    for name in kernels:
        assert rl["kernel_calls"].get(name, 0) > 0, (name, rl["kernel_calls"])
    json.dumps(rec)


@pytest.mark.parametrize("arch,kind", [
    ("granite-moe-1b-a400m", "train"), ("smollm-135m", "train"),
    ("smollm-135m", "prefill"), ("granite-moe-1b-a400m", "decode")])
def test_reduced_lm_cells_run_on_a_fake_mesh(arch, kind, mesh22):
    cfg = _reduced_lm(arch)
    shape = LMShape(f"r_{kind}", kind, 64, 4)
    cell = cells._lm_cell(arch, cfg, shape, mesh22)
    run_s, lower_s, counter, args = dryrun.run_fake(cell.setup)
    rec = dryrun.record(arch, shape.name, cell.kind, mesh22, cell.meta,
                        counter, args, lower_s, run_s)
    want = {"train": ("flash_attention", "flash_attention_bwd",
                      "segment_combine"),
            "prefill": ("flash_attention",), "decode": ()}[kind]
    _check_record(rec, want)
    if kind == "train":
        calls = rec["roofline"]["kernel_calls"]
        assert calls["flash_attention"] == 2 * cfg.n_layers
        assert calls["flash_attention_bwd"] == cfg.n_layers
        assert calls["segment_combine"] == 1 + (2 * cfg.n_layers
                                                if cfg.moe else 0)
        assert rec["roofline"]["n_collectives"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("gcn-cora", GNNShape("r_full", "full_graph", 4000, 30000, 32)),
    ("gin-tu", GNNShape("r_mol", "molecule", 30, 64, 0, batch_graphs=16)),
    ("mace", GNNShape("r_mol", "molecule", 30, 64, 0, batch_graphs=8)),
    ("dimenet", GNNShape("r_mol", "molecule", 30, 64, 0, batch_graphs=8)),
    ("autoint", RecSysShape("r_train", "train", 256)),
    ("autoint", RecSysShape("r_serve", "serve", 64)),
    ("autoint", RecSysShape("r_ret", "retrieval", 1, n_candidates=4096))],
    ids=lambda x: getattr(x, "name", x))
def test_reduced_gnn_and_recsys_cells_run(arch, shape, mesh22):
    cfg, family = get_config(arch)
    if family == "recsys":
        cfg = dataclasses.replace(cfg, vocab_sizes=(100,) * cfg.n_sparse)
        cell = cells.recsys_cell(arch, cfg, shape, mesh22)
    else:
        cfg = dataclasses.replace(cfg, d_hidden=32)
        cell = cells.gnn_cell(arch, cfg, shape, mesh22)
    run_s, lower_s, counter, args = dryrun.run_fake(cell.setup)
    rec = dryrun.record(arch, shape.name, cell.kind, mesh22, cell.meta,
                        counter, args, lower_s, run_s)
    _check_record(rec, ("segment_combine",) if family == "gnn"
                  or shape.kind == "train" else ())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gin-tu"])
def test_cells_run_on_a_multi_pod_mesh(arch):
    """Two data axes ("pod", "data"): the dp group spans both."""
    with dryrun.fake_world((2, 2, 2), ("pod", "data", "model"),
                           "cpu") as mesh:
        if arch.startswith("granite"):
            cell = cells._lm_cell(arch, _reduced_lm(arch),
                                  LMShape("r_train", "train", 64, 8), mesh)
        else:
            cell = cells.gnn_cell(arch, dataclasses.replace(
                get_config(arch)[0], d_hidden=32), GNNShape(
                "r_mol", "molecule", 30, 64, 0, batch_graphs=16), mesh)
        run_s, lower_s, counter, args = dryrun.run_fake(cell.setup)
        rec = dryrun.record(arch, "r", cell.kind, mesh, cell.meta, counter,
                            args, lower_s, run_s)
    assert rec["ok"] and rec["n_devices"] == 8
    assert rec["roofline"]["n_collectives"] > 0
    assert not dist.is_initialized()


def test_graph_superstep_runs(mesh22):
    rec = dryrun.run_graph_engine_dryrun(mesh22)
    _check_record(rec, ("segment_combine",))
    assert rec["meta"]["supersteps"] == 30
    assert rec["roofline"]["kernel_calls"]["segment_combine"] >= 30
    assert rec["roofline"]["coll_bytes_by_type"]["all-to-all"] > 0


def test_markdown_table_equals_jax():
    rng = np.random.default_rng(0)
    recs = []
    for i, (arch, shape) in enumerate(list(all_cells())[:6]):
        recs.append({
            "arch": arch, "shape": shape, "kind": "train",
            "n_devices": 256, "meta": {"model_flops": float(rng.integers(
                1, 10**15))},
            "memory": {"peak_per_device_gib": round(float(rng.random()) * 9,
                                                    3)},
            "roofline": {"flops_per_device": float(rng.integers(1, 10**12)),
                         "bound_time_s": float(rng.random()),
                         "compute_time_s": float(rng.random()),
                         "memory_time_s": float(rng.random()),
                         "memory_time_fused_s": float(rng.random()),
                         "collective_time_s": float(rng.random()),
                         "dominant": ("compute", "memory",
                                      "collective")[i % 3],
                         "n_collectives": i}})
    rows = [jagg.fmt_row(r) for r in recs]
    assert aggregate.markdown_table(rows) == jagg.markdown_table(rows)
    ours = [aggregate.fmt_row(r, peak_flops=jagg.PEAK_FLOPS) for r in recs]
    assert aggregate.markdown_table(ours) == jagg.markdown_table(rows)


def test_main_writes_records_and_fails_on_a_failed_cell(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    out = tmp_path / "dry"
    code = dryrun.main(["--arch", "gcn-cora", "--shape", "molecule",
                        "--mesh", "single", "--graph", "--out", str(out)])
    assert code == 0
    rec = json.loads((out / "gcn-cora__molecule__single.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256
    assert json.loads((out / "graph_single.json").read_text())["ok"]
    aggregate.main([str(out), "single"])
    assert "gcn-cora | molecule" in capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(cells, "build_cell", broken)
    code = dryrun.main(["--arch", "gin-tu", "--shape", "molecule",
                        "--mesh", "single", "--out", str(out)])
    assert code == 1
    rec = json.loads((out / "gin-tu__molecule__single.json").read_text())
    assert not rec["ok"] and "planted" in rec["error"]
    assert not dist.is_initialized()
