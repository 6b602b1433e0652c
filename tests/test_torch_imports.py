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
