"""The port's H100 roofline counter (`launch/roofline.py`): a step's work
counted per device while it runs on fake tensors.

Checked: a matmul's FLOPs at the local shard's shape on a fake 16 x 16
mesh (also through a DTensor, which `FlopCounterMode` would count at its
global shape); the link bytes of a known redistribute and of the port's
own collectives, by the ring rules; a K3 call and a K1 call charged their
bound counts (the functions `chip_smoke.py` prints its bounds with), never
the plain version's score buffer; `bound_time_s` the largest of the three
terms and `dominant` its name; the peak of live storage; the keys of the
JAX package's `analyze`.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.dist import comm as dcomm
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import fake_world

DEV = "meta"             # the fake tensors' device on a torch without CUDA


@pytest.fixture
def mesh16():
    with fake_world((16, 16), ("data", "model"), "cpu") as mesh:
        yield mesh


def _count(fn):
    counter = rl.StepCounter()
    with FakeTensorMode(), counter:
        fn()
    return counter


def test_matmul_flops_are_the_local_shards(mesh16):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def step():
        x = torch.empty(64, 2048, device=DEV, dtype=torch.bfloat16)
        w = torch.empty(2048, 8192 // 16, device=DEV, dtype=torch.bfloat16)
        x @ w                                   # a column-parallel block
        xd = DTensor.from_local(x, mesh16, (Replicate(), Replicate()),
                                run_check=False)
        wd = DTensor.from_local(w, mesh16, (Replicate(), Shard(1)),
                                run_check=False, shape=(2048, 8192),
                                stride=(8192, 1))
        xd @ wd
    c = _count(step)
    per_device = 2 * 64 * 2048 * (8192 // 16)
    assert c.cost.flops_by_dtype == {"bfloat16": 2 * per_device}
    a = rl.analyze(c)
    assert a["flops_per_device"] == 2 * per_device
    assert a["compute_time_s"] == pytest.approx(2 * per_device / 989e12)


def test_link_bytes_of_a_redistribute_and_of_the_collectives(mesh16):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    model = mesh16.get_group("model")

    def step():
        y = torch.empty(64, 512, device=DEV, dtype=torch.bfloat16)
        d = DTensor.from_local(y, mesh16, (Replicate(), Shard(1)),
                               run_check=False, shape=(64, 8192),
                               stride=(8192, 1))
        d.redistribute(mesh16, (Replicate(), Replicate()))
    c = _count(step)
    assert c.cost.coll_bytes == {"all-gather": 64 * 8192 * 2}
    assert c.cost.n_collectives == 1
    # the model group is ranks 0..15: two nodes of 8, so the IB rate
    assert c.cost.collective_s == pytest.approx(
        64 * 8192 * 2 / rl.INTER_NODE_BYTES_PER_S)

    def ours():
        x = torch.empty(32, 16, device=DEV)
        dcomm.group_all_gather(x, 0, model)       # 16 blocks gathered
        dcomm.group_reduce_scatter(torch.empty(64, 16, device=DEV), 0, model)
        dcomm.group_max(x, model)
    c = _count(ours)
    assert c.cost.coll_bytes == {"all-gather": 16 * 32 * 16 * 4,
                                 "all-to-all": 64 * 16 * 4,
                                 "all-reduce": 2 * 32 * 16 * 4}
    assert not c.warnings


def test_a_node_local_group_runs_at_the_nvlink_rate():
    with fake_world((2, 4), ("data", "model"), "cpu") as mesh:
        group = mesh.get_group("model")          # ranks 0..3: one node
        c = _count(lambda: dcomm.group_all_gather(
            torch.empty(1000, device=DEV), 0, group))
    assert c.cost.collective_s == pytest.approx(
        4 * 1000 * 4 / rl.NVLINK_BYTES_PER_S)


def test_k3_and_k1_calls_are_charged_their_bound_counts():
    b, s, kv, g, h = 2, 256, 2, 3, 64
    dt = torch.bfloat16

    def attention():
        q = torch.empty(b, s, kv, g, h, device=DEV, dtype=dt,
                        requires_grad=True)
        k = torch.empty(b, s, kv, h, device=DEV, dtype=dt,
                        requires_grad=True)
        v = torch.empty(b, s, kv, h, device=DEV, dtype=dt,
                        requires_grad=True)
        ops.flash_attention(q, k, v, causal=True).sum().backward()
    c = _count(attention)
    fwd = rl.attention_counts(b, s, s, kv, g, h, True, dt)
    bwd = rl.attention_bwd_counts(b, s, s, kv, g, h, True, dt)
    assert c.cost.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert c.cost.flops_by_dtype["bfloat16"] == fwd[0] + bwd[0]
    assert c.cost.bytes_by_op["flash_attention"] == fwd[1]
    assert c.cost.bytes_by_op["flash_attention_bwd"] == bwd[1]
    # no [.., Sq, Sk] score buffer was ever made
    assert c.peak < b * kv * g * s * s * 4

    e, d, v_ = 5000, 8, 300

    def combine():
        msgs = torch.empty(e, d, device=DEV)
        dst = torch.empty(e, device=DEV, dtype=torch.int32)
        ptr = torch.empty(v_ + 1, device=DEV, dtype=torch.int32)
        ops.segment_combine(msgs, dst, v_, "sum", seg_ptr=ptr)
    c = _count(combine)
    assert c.cost.kernels == {"segment_combine": 1}
    assert c.cost.bytes_by_op["segment_combine"] == rl.combine_bytes(e, d, v_)
    assert rl.bound_ms(e, d, v_) == pytest.approx(
        rl.combine_bytes(e, d, v_) / 3.35e12 * 1e3)


@pytest.mark.parametrize("sq,sk,causal", [(7, 7, True), (9, 4, True),
                                          (4, 9, True), (5, 3, False)])
def test_visible_pairs_and_bounds(sq, sk, causal):
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    assert rl.visible_pairs(sq, sk, causal) == pairs
    ms, by = rl.attention_bound(1, sq, sk, 1, 1, 64, causal, torch.float32)
    flops, nbytes = rl.attention_counts(1, sq, sk, 1, 1, 64, causal,
                                        torch.float32)
    assert ms == pytest.approx(max(flops / 67e12, nbytes / 3.35e12) * 1e3)
    assert by == ("operations" if flops / 67e12 >= nbytes / 3.35e12
                  else "bytes")


@pytest.mark.parametrize("which", ["compute", "memory", "collective"])
def test_bound_time_is_the_largest_term(which):
    c = rl.StepCounter()
    c.cost.flops_by_dtype = {"float32": 67e12 * (3.0 if which == "compute"
                                                 else 1.0)}
    c.cost.hbm_bytes = 3.35e12 * (3.0 if which == "memory" else 2.0)
    c.cost.collective_s = 3.5 if which == "collective" else 0.5
    a = rl.analyze(c)
    terms = {"compute": a["compute_time_s"], "memory": a["memory_time_s"],
             "collective": a["collective_time_s"]}
    assert a["dominant"] == which == max(terms, key=terms.get)
    assert a["bound_time_s"] == max(terms.values())


def test_peak_counts_live_storage_once():
    def step():
        a = torch.empty(1000, device=DEV)             # 4,000 B -> 4,096
        b = a.view(10, 100)                           # a view: no storage
        c = torch.empty(300, device=DEV)              # 1,200 B -> 1,536
        del c
        d = torch.empty(100, device=DEV)              # 400 B -> 512
        return b, d
    c = _count(step)
    assert c.peak == 4096 + 1536
    assert c.live == 0


def test_analyze_has_the_jax_keys():
    import jax
    import jax.numpy as jnp
    from repro.launch import roofline as jrl
    text = jax.jit(lambda x: x @ x).lower(
        jnp.ones((8, 8))).compile().as_text()
    want = set(jrl.analyze(text))
    got = set(rl.analyze(rl.StepCounter()))
    assert want <= got
    assert not dist.is_initialized()
