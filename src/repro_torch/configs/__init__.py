"""Architecture registry of the port: `--arch <id>` resolves here.

The port knows every LM config of the JAX package, dense and MoE, the GCN
and GIN configs (the GNN slice), and dimenet, mace and autoint (the
other-models slice).  The paper's graph workloads live in `gre_paper`.
Each arch pairs with its family's shape set (`get_shapes`); the 40
(arch x shape) pairs are the dry run's cells (`all_cells`).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

_MODULES = {   # the JAX package's order, which `all_cells` keeps
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "dimenet": "repro_torch.configs.dimenet",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gin-tu": "repro_torch.configs.gin_tu",
    "mace": "repro_torch.configs.mace",
    "autoint": "repro_torch.configs.autoint",
}

ALL_ARCHS = tuple(_MODULES)

_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def get_config(arch: str):
    """Returns (config, family) for an architecture id."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG, mod.FAMILY


def get_shapes(arch: str):
    """The arch's own input-shape set (its family's)."""
    _, family = get_config(arch)
    return _SHAPES[family]


def get_shape(arch: str, shape_name: str):
    for s in get_shapes(arch):
        if s.name == shape_name:
            return s
    raise KeyError(f"{arch} has no shape {shape_name!r}")


def all_cells():
    """All 40 (arch x shape) dry-run cells, in the JAX package's order."""
    for arch in ALL_ARCHS:
        for s in get_shapes(arch):
            yield arch, s.name
