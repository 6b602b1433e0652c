"""The benchmark's fixed measures: the card's peak, the combine kernel's
least bytes and the grouping of device kernels by name.

Frozen copies, so that a change to the port cannot move what the benchmark
reads: `combine_bytes` and `route_bytes` are `repro_torch.launch.roofline`'s,
`GROUPS` is `tools/profile_torch_main_path.py`'s table with the tile
route's lane compaction in a group of its own ("compaction"; the tool files
it under "sort").
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W power limit.
# A card set below 700 W (`device.power_limit_w` in a run's line) reaches
# less under load; shares are stated against this peak all the same.
HBM_BYTES_PER_S = 3.35e12


def combine_bytes(e: int, d: int, v: int) -> int:
    """K1's dense route: `e` routed edges' messages, the row pointer and the
    `[v, d]` output, each once (the kernel never reads dst)."""
    return e * d * 4 + (v + 1) * 4 + v * d * 4


def route_bytes(lanes: int, e: int, d: int, v: int) -> int:
    """The tile route (compaction, sort of the valid lanes, K1): every
    lane's dst, the `e` routed lanes' messages and the output, each once."""
    return lanes * 4 + e * d * 4 + v * d * 4


# kernel-name fragment -> group; the first match wins
GROUPS = (("embedding_bag_", "embedding_bag_kernel"),
          ("merge_path_partition", "combine_kernel"),
          ("combine_d1_kernel", "combine_kernel"),
          ("combine_cols_kernel", "combine_kernel"),
          ("fold_carries", "combine_kernel"),
          ("compact_count", "compaction"), ("compact_scan", "compaction"),
          ("compact_write", "compaction"),
          ("flash_attention_", "attention_kernel"),
          ("gemm", "matmul"), ("nvjet", "matmul"), ("gemv", "matmul"),
          ("index", "gather"), ("gather", "gather"),
          ("sort", "sort"), ("radix", "sort"), ("Radix", "sort"),
          ("nonzero", "compact"), ("scan", "compact"),
          ("Memcpy", "memcpy"), ("Memset", "memset"))

# the groups whose device time K1's least bytes are held against
K1_GROUPS = ("combine_kernel", "compaction")


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def merged(intervals) -> list:
    """The union of `(start, end)` intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out
