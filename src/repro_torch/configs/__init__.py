"""Architecture registry of the port: `--arch <id>` resolves here.

The port knows the dense LM configs (the LM serving slice), the GCN and
GIN configs (the GNN slice), and dimenet, mace and autoint (the
other-models slice).  The MoE configs come with the MoE slice; asking for
one raises a `KeyError` that says so.  The paper's graph workloads live in
`gre_paper`.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gin-tu": "repro_torch.configs.gin_tu",
    "dimenet": "repro_torch.configs.dimenet",
    "mace": "repro_torch.configs.mace",
    "autoint": "repro_torch.configs.autoint",
}

_NOT_YET = {
    "qwen3-moe-30b-a3b": "the MoE slice (nn/moe.py)",
    "granite-moe-1b-a400m": "the MoE slice (nn/moe.py)",
}


def get_config(arch: str):
    """Returns (config, family) for an architecture id."""
    if arch in _NOT_YET:
        raise KeyError(f"arch {arch!r} is not ported yet; it comes with "
                       f"{_NOT_YET[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG, mod.FAMILY
