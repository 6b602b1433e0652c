"""Architecture registry of the port: `--arch <id>` resolves here.

The port knows every LM config of the JAX package, dense and MoE, the GCN
and GIN configs (the GNN slice), and dimenet, mace and autoint (the
other-models slice).  The paper's graph workloads live in `gre_paper`.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gin-tu": "repro_torch.configs.gin_tu",
    "dimenet": "repro_torch.configs.dimenet",
    "mace": "repro_torch.configs.mace",
    "autoint": "repro_torch.configs.autoint",
}


def get_config(arch: str):
    """Returns (config, family) for an architecture id."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG, mod.FAMILY
