"""Workload configuration dataclasses of the port: the graph family, the
LM family (dense and MoE) with its step shapes, the GNN family and the
recommender family (the counterpart of `repro/configs/base.py`)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GraphWorkloadConfig:
    """The paper's own workload family: vertex programs on R-MAT graphs."""
    name: str
    algorithm: str       # pagerank | sssp | cc | bfs
    scale: int           # log2 |V| (Graph500)
    edge_factor: int = 16
    max_steps: int = 30
    exchange: str = "agent"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """A decoder-only LM, with the fields of the JAX package's `LMConfig`.

    `q_chunk`/`kv_chunk`, `remat_block` and `seq_shard_activations` are
    kept so that a config means the same in both packages; the port's
    attention runs at the CUDA kernel's own tile sizes, `remat` checkpoints
    every layer (a `remat_block` of 1), and nothing is sharded over a mesh.
    """
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    activation: str = "silu"
    gated: bool = True
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    dtype: str = "bfloat16"
    attention_impl: str = "chunked"   # reference | chunked
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    remat_block: int = 1
    seq_shard_activations: bool = True
    tie_embeddings: bool = False

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (Megatron-style); the
        padded logit columns are masked in the forward pass."""
        return -(-self.vocab // 128) * 128

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        qkv = d * self.n_heads * self.d_head + 2 * d * self.n_kv * self.d_head
        attn = qkv + self.n_heads * self.d_head * d
        if self.moe:
            e = self.moe
            ff = e.n_experts * e.d_ff_expert * d * (3 if self.gated else 2)
            ff += d * e.n_experts  # router
        else:
            ff = d * f * (3 if self.gated else 2)
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        """Parameters a token passes through: the top-k experts' only."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        e = self.moe
        dense_ff = e.top_k * e.d_ff_expert * d * (3 if self.gated else 2)
        full_ff = e.n_experts * e.d_ff_expert * d * (3 if self.gated else 2)
        return self.param_count() - self.n_layers * (full_ff - dense_ff)


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES: Tuple[LMShape, ...] = (
    LMShape("train_4k", "train", 4096, 256),
    LMShape("prefill_32k", "prefill", 32768, 32),
    LMShape("decode_32k", "decode", 32768, 128),
    LMShape("long_500k", "decode", 524288, 1),
)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """A GNN, with the fields of the JAX package's `GNNConfig`: the gcn
    and gin families (`models/gnn.py`), dimenet (`models/dimenet.py`) and
    mace (`models/mace.py`)."""
    name: str
    family: str          # gcn | gin | dimenet | mace
    n_layers: int
    d_hidden: int
    # family-specific knobs
    aggregator: str = "sum"
    norm: str = "none"            # gcn: sym
    eps_learnable: bool = False   # gin
    n_bilinear: int = 8           # dimenet
    n_spherical: int = 7
    n_radial: int = 6
    l_max: int = 2                # mace
    correlation_order: int = 3
    n_rbf: int = 8
    d_out: int = 1
    n_classes: int = 16
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str            # full_graph | minibatch | molecule
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0


GNN_SHAPES: Tuple[GNNShape, ...] = (
    GNNShape("full_graph_sm", "full_graph", 2708, 10556, d_feat=1433),
    GNNShape("minibatch_lg", "minibatch", 232965, 114615892, d_feat=602,
             batch_nodes=1024, fanout=(15, 10)),
    GNNShape("ogb_products", "full_graph", 2449029, 61859140, d_feat=100),
    GNNShape("molecule", "molecule", 30, 64, batch_graphs=128),
)


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    n_dense: int = 0
    # per-field vocab sizes (criteo-like long tail)
    vocab_sizes: Tuple[int, ...] = ()
    mlp_dims: Tuple[int, ...] = (256, 128)
    dtype: str = "float32"

    def total_rows(self) -> int:
        return sum(self.vocab_sizes)


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    name: str
    kind: str            # train | serve | retrieval
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES: Tuple[RecSysShape, ...] = (
    RecSysShape("train_batch", "train", 65536),
    RecSysShape("serve_p99", "serve", 512),
    RecSysShape("serve_bulk", "serve", 262144),
    RecSysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)
