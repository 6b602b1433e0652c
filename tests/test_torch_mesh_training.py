"""`launch.train --mesh DxM` over gloo ranks on the CPU against the JAX
package's unsharded training, in float32 at reduced configs
(`reduced_lm_config`: 4 layers, d_model 128, 8 experts), from JAX's
`init_lm` weights.

Each mesh run is 3 AdamW steps of a 4 x 32 batch on `D·M` spawned ranks
(`dist.world.run_world`).  References: JAX's `lm_loss` and `AdamW` run
step by step at 1x1 (the body of `src/repro/launch/train.py`), and the
port's own 1x1 run.  Tolerances: each step's loss within 1e-5 relative of
JAX's (the mesh sums its tp shares and vocab blocks in another order, the
port's CPU attention is the full softmax); the final parameters within
1e-4 of the port's 1x1 run (both snapshots are the whole model, the mesh
one gathered from the ranks' blocks).  The reduced MoE config routes
every token to all 8 experts at a capacity above the token count, so no
hit is dropped; the `moe-drop` case routes the top 2 of the 8 at
capacity factor 0.5 (`DROP`), which drops at least half of the hits, and
which ones depends on each hit's place in its expert's queue over the
whole batch: a mesh run that split the tokens over dp with each rank's
queue starting at 0 would keep others.

`--grad-compression` quantizes each rank's gradient blocks with their own
scales, where the 1x1 run takes one scale a tensor: its losses stay
within 1e-4 relative of the compressed 1x1 run's and move off the
uncompressed mesh run's.  A crashed mesh run resumed from its snapshot
equals the uninterrupted mesh run bit for bit.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.optim.adamw import AdamW as JAdamW, cosine_warmup as jcosine
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.nn.moe import capacity

STEPS, BATCH, SEQ, LR = 3, 4, 32, 3e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
ARCHS = {"dense": "smollm-135m", "moe": "granite-moe-1b-a400m"}
# top 2 of 8 experts, capacity max(8, round(128·2/8·0.5)) = 16 slots an
# expert: 128 slots for the 256 hits of a 4 x 32 batch
DROP = {"top_k": 2, "capacity_factor": 0.5}


def _argv(arch, mesh, *extra):
    return ["--arch", arch, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--mesh", mesh,
            "--device", "cpu", *extra]


def _configs(arch, kv=None, moe=None):
    jcfg = jtrain.reduced_lm_config(jget_config(arch)[0])
    cfg = train.reduced_lm_config(get_config(arch)[0])
    if kv is not None:           # smollm's ratio: 3 kv heads, 9 query heads
        jcfg = dataclasses.replace(jcfg, n_heads=3 * kv, n_kv=kv)
        cfg = dataclasses.replace(cfg, n_heads=3 * kv, n_kv=kv)
    if moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return jcfg, cfg


def _jax_losses(jcfg, jparams):
    """JAX's step-by-step 1x1 training: each step's loss before its
    update."""
    opt = JAdamW(lr=LR, schedule=jcosine(10, STEPS))
    state = opt.init(jparams)
    stream = JTokenStream(jcfg.vocab, BATCH, SEQ, seed=0)
    step = jax.jit(lambda p, s, b: _jax_step(opt, jcfg, p, s, b))
    params, out = jparams, []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        params, state, loss = step(params, state, batch)
        out.append(float(loss))
    return out


def _jax_step(opt, jcfg, params, state, batch):
    (loss, _), grads = jax.value_and_grad(jtfm.lm_loss, has_aux=True)(
        params, batch, jcfg)
    params, state = opt.update(grads, state, params)
    return params, state, loss


def _run(arch, mesh, tree, cfg, ckpt, *extra):
    """(losses, the final snapshot's arrays, `final_params`' arrays)."""
    losses = []
    final = Path(ckpt).with_suffix(".pt")
    train.main(_argv(arch, mesh, "--ckpt", str(ckpt), "--ckpt-every",
                     "100", *extra), init_params=tree, cfg=cfg,
               on_step=lambda s, loss, sec: losses.append(loss),
               final_params=final)
    with np.load(Path(ckpt) / f"step-{STEPS}" / "state.npz") as z:
        state = {k: z[k] for k in z.files}
    params = {k: v.numpy() for k, v in torch.load(final).items()}
    return losses, state, params


@pytest.fixture(scope="module", params=[
    ("dense", "2x2", None, None), ("moe", "2x2", None, None),
    ("dense", "1x2", 3, None), ("moe", "2x2", None, DROP)],
    ids=["dense-2x2", "moe-2x2", "kv3-1x2", "moe-drop-2x2"])
def runs(request):
    kind, mesh, kv, moe = request.param
    arch = ARCHS[kind]
    jcfg, cfg = _configs(arch, kv, moe)
    if moe is not None:          # fewer slots than hits: some are dropped
        m = cfg.moe
        assert m.n_experts * capacity(BATCH * SEQ, m.top_k, m.n_experts,
                                      m.capacity_factor) < (
            BATCH * SEQ * m.top_k)
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jparams)
    with tempfile.TemporaryDirectory() as d:
        one = _run(arch, "1x1", tree, cfg, Path(d) / "one")
        sharded = _run(arch, mesh, tree, cfg, Path(d) / "mesh")
    return {"jax": _jax_losses(jcfg, jparams), "one": one,
            "mesh": sharded, "cfg": cfg, "mesh_shape": mesh}


def test_mesh_losses_match_jax(runs):
    np.testing.assert_allclose(runs["mesh"][0], runs["jax"],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(runs["one"][0], runs["jax"],
                               rtol=LOSS_RTOL, atol=0)


def test_mesh_parameters_match_the_unsharded_run(runs):
    one, sharded = runs["one"][1], runs["mesh"][1]
    assert sorted(one) == sorted(sharded)
    params = [k for k in one if k.startswith("params/")]
    assert params
    for key in params:
        assert one[key].shape == sharded[key].shape, key
        np.testing.assert_allclose(sharded[key], one[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def test_final_params_are_the_snapshot_parameters(runs):
    """`train.main(final_params=)`: the whole model after the last step,
    a mesh run's gathered from the ranks, as its snapshot holds it."""
    for _, state, params in (runs["one"], runs["mesh"]):
        assert sorted(params) == sorted(
            k[len("params/"):] for k in state if k.startswith("params/"))
        for name, value in params.items():
            np.testing.assert_array_equal(value, state[f"params/{name}"],
                                          err_msg=name)


def test_the_kv_heads_case_keeps_attention_whole():
    """tp = 2 does not divide 3 kv heads: attention's weights stay whole
    on every tp rank (the case `runs[kv3-1x2]` trains), while JAX's specs
    split them."""
    from repro_torch.dist import sharding as shd
    _, cfg = _configs(ARCHS["dense"], 3)
    specs = shd.lm_mesh_specs(cfg, ("data",), "model",
                              {"data": 1, "model": 2})
    assert specs["layers.0.wq"] == shd.P(None, None)
    assert shd.lm_param_specs(cfg, ("data",), "model")[
        "layers.0.wq"] == shd.P(None, "model")
    assert specs["layers.0.ffn.w_in"] == shd.P(None, "model")


def test_grad_compression_compresses_each_rank_block(tmp_path):
    arch = ARCHS["dense"]
    jcfg, cfg = _configs(arch)
    tree = jax.tree.map(np.array, jtfm.init_lm(jax.random.PRNGKey(0), jcfg))
    one, _, _ = _run(arch, "1x1", tree, cfg, tmp_path / "one",
                     "--grad-compression")
    sharded, state, _ = _run(arch, "2x2", tree, cfg, tmp_path / "mesh",
                             "--grad-compression")
    plain, _, _ = _run(arch, "2x2", tree, cfg, tmp_path / "plain")
    np.testing.assert_allclose(sharded, one, rtol=1e-4, atol=0)
    assert sharded[0] == pytest.approx(plain[0], rel=1e-6)
    assert max(abs(a - b) for a, b in zip(sharded[1:], plain[1:])) > 1e-6
    assert any(k.startswith("err/") for k in state)


def test_mesh_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    arch = ARCHS["moe"]
    jcfg, cfg = _configs(arch)
    tree = jax.tree.map(np.array, jtfm.init_lm(jax.random.PRNGKey(1), jcfg))
    argv = _argv(arch, "2x2", "--ckpt-every", "2")
    full = train.main(argv + ["--ckpt", str(tmp_path / "full")],
                      init_params=tree, cfg=cfg)
    with pytest.raises(SystemExit) as crash:
        train.main(argv + ["--ckpt", str(tmp_path / "crash"), "--fail-at",
                           "2"], init_params=tree, cfg=cfg)
    assert crash.value.code == 42
    steps = []
    resumed = train.main(argv + ["--ckpt", str(tmp_path / "crash")],
                         init_params=tree, cfg=cfg,
                         on_step=lambda s, loss, sec: steps.append(s))
    assert steps == [2]
    assert resumed == full
    with np.load(tmp_path / "full" / f"step-{STEPS}" / "state.npz") as a, \
            np.load(tmp_path / "crash" / f"step-{STEPS}" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_mesh_that_does_not_split_is_refused_before_any_rank():
    _, cfg = _configs(ARCHS["dense"])
    with pytest.raises(ValueError, match="does not split"):
        train.main(_argv(ARCHS["dense"], "1x3"), cfg=cfg)
    assert not torch.distributed.is_initialized()
