"""The PyTorch port stands alone: it imports neither `jax` nor the JAX
package `repro`, and its entry points refuse CUDA when no card is present
instead of running on the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 14          # every module of the package imported
    assert out[1].strip() == "[]"


DIST_MODULES = ("repro_torch.core.partition",
                "repro_torch.core.partition_stream",
                "repro_torch.core.agent_graph", "repro_torch.core.exchange",
                "repro_torch.core.dist_engine", "repro_torch.dist",
                "repro_torch.dist.comm", "repro_torch.dist.world")


@pytest.mark.parametrize("module", DIST_MODULES)
def test_distributed_modules_stand_alone(module):
    """Each module of the distributed engine imports on its own, with
    neither `jax` nor `repro` loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


SLICE6_MODULES = ("repro_torch.core.incremental",
                  "repro_torch.serving.graph_scheduler",
                  "repro_torch.serving")


@pytest.mark.parametrize("module", SLICE6_MODULES)
def test_incremental_and_serving_modules_stand_alone(module):
    """Incremental re-convergence and graph serving import on their own,
    with neither `jax` nor `repro` loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


SLICE7_MODULES = ("repro_torch.tuning", "repro_torch.tuning.cache",
                  "repro_torch.tuning.evaluator",
                  "repro_torch.tuning.fingerprint",
                  "repro_torch.tuning.search", "repro_torch.tuning.space",
                  "repro_torch.core.multistage")


@pytest.mark.parametrize("module", SLICE7_MODULES)
def test_tuning_and_multistage_modules_stand_alone(module):
    """The plan autotuner and multi-stage BC import on their own, with
    neither `jax` nor `repro` loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


SLICE8_MODULES = ("repro_torch.models.gnn", "repro_torch.graph.sampler",
                  "repro_torch.nn.embedding", "repro_torch.optim.adamw",
                  "repro_torch.configs.gcn_cora", "repro_torch.configs.gin_tu")


def test_gnn_modules_stand_alone():
    """The GNN slice (models, sampler, embedding, optimizer, configs)
    imports with neither `jax` nor `repro` loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {', '.join(SLICE8_MODULES)}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_port_sources_never_import_jax_or_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|,|$)",
                         re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 14
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is a valid request here")
    from repro_torch.core.engine import DevicePartition, EngineState
    from repro_torch.graph.generators import ring_graph
    g = ring_graph(16, weights=True)
    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DevicePartition.from_graph(g, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineState.from_arrays({"vertex_data": np.zeros(3, np.float32),
                                 "scatter_data": np.zeros(4, np.float32),
                                 "active_scatter": np.zeros(4, bool)})
    assert DevicePartition.from_graph(g, device="cpu").device.type == "cpu"
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistGREEngine(algorithms.sssp_program(), 2, **kw)
    # the delta ingress builds its partition on the card unless the
    # partition it mutates lies on the CPU
    from repro_torch.graph.structures import EdgeDelta
    part = DevicePartition.from_graph(g, device="cpu")
    new, _ = part.apply_edge_delta(EdgeDelta(rem_src=g.src[:1],
                                             rem_dst=g.dst[:1]))
    assert new.device.type == "cpu" and new.src.device.type == "cpu"
    # the tuner's probes, multi-stage BC and its pipeline
    from repro_torch.core import multistage
    from repro_torch.tuning import ProbeEvaluator, tune
    prog = algorithms.bfs_program()
    calls = (lambda: tune(prog, g, cache=None),
             lambda: ProbeEvaluator(prog, g).partition(),
             lambda: multistage.betweenness_centrality(g),
             lambda: multistage._make_bc_batch(g, 4, 2))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ProbeEvaluator(prog, g, device="cpu").partition().device.type \
        == "cpu"


def test_lm_entry_points_raise_without_a_card():
    """`init_lm`, `params_from_numpy`, `init_cache`, `ContinuousBatcher`
    and the serve launcher default to CUDA and refuse it without a card;
    `device="cpu"` runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is a valid request here")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ContinuousBatcher
    cfg = serve.reduced_lm_config(get_config("smollm-135m")[0], layers=1,
                                  d_model=32, n_heads=2, n_kv=1, d_head=16,
                                  d_ff=32, vocab=128)
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = {"embed": params.embed.numpy(), "ln_out": params.ln_out.numpy(),
            "head": params.head.numpy(),
            "layers": {n: np.stack([getattr(params.layers[0], n).numpy()])
                       for n in ("ln_attn", "wq", "wk", "wv", "wo",
                                 "ln_ffn")}}
    tree["layers"]["ffn"] = {n: np.stack([w.numpy()]) for n, w in
                             params.layers[0].ffn.items()}
    calls = (lambda: tfm.init_lm(cfg, torch.Generator()),
             lambda: tfm.init_lm(cfg, torch.Generator(), device="cuda:0"),
             lambda: tfm.params_from_numpy(tree, cfg),
             lambda: tfm.init_cache(cfg, 2, 8),
             lambda: ContinuousBatcher(params, cfg, 2, 8),
             lambda: serve.main(["--batch", "1", "--gen", "2"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    back = tfm.params_from_numpy(tree, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                 params.parameters()))
    assert tfm.init_cache(cfg, 2, 8, device="cpu")["k"].device.type == "cpu"
    assert ContinuousBatcher(params, cfg, 2, 8, device="cpu").B == 2
    with pytest.raises(ValueError, match="params lie on"):
        ContinuousBatcher(params, cfg, 2, 8, device="meta")


def test_gnn_entry_points_raise_without_a_card():
    """`init_gnn`, `params_from_numpy`, `GraphBatch.build` and
    `GraphBatch.to` default to CUDA and refuse it without a card;
    `device="cpu"` runs.  The configs not ported yet name their slice."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is a valid request here")
    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    cfg = get_config("gcn-cora")[0]
    params = gnn.init_gnn(torch.Generator(), cfg, 4, 3, device="cpu")
    tree = {"layers": [{k: v.detach().numpy() for k, v in lp.items()}
                       for lp in params["layers"]],
            "out": params["out"].detach().numpy(),
            "out_b": params["out_b"].detach().numpy()}
    arrays = (np.zeros((3, 4), np.float32), np.array([0, 1]),
              np.array([1, 2]), np.ones(2, bool), np.zeros(3, np.int64),
              np.ones(3, bool))
    batch = gnn.GraphBatch.build(*arrays, device="cpu")
    calls = (lambda: gnn.init_gnn(torch.Generator(), cfg, 4, 3),
             lambda: gnn.params_from_numpy(tree, cfg),
             lambda: gnn.GraphBatch.build(*arrays),
             lambda: batch.to("cuda"))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    back = gnn.params_from_numpy(tree, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(gnn.parameters(back),
                                                 gnn.parameters(params)))
    assert batch.to("cpu").routes.dst.tolist() == [1, 2]
    for arch in ("dimenet", "mace", "autoint"):
        with pytest.raises(KeyError, match="item 11"):
            get_config(arch)


def test_world_refuses_cuda_without_a_card():
    """`repro_torch.dist.world.run_world` defaults to CUDA and refuses it,
    before any process starts, without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is a valid request here")
    from repro_torch.dist.world import run_world
    for kw in ({}, {"backend": "gloo"}, {"backend": "nccl"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_world(print, 2, **kw)
