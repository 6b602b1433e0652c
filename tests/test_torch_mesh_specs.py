"""The port's mesh and sharding layer (`launch/mesh.py`,
`dist/sharding.py`, `nn/layers.layernorm`) against the JAX package's.

Spec trees are compared entry for entry, the port's per-layer specs
being the JAX package's stacked `[L, ...]` specs without the layer axis.
JAX's tests see one CPU device, so `mesh_axes` is compared on a
duck-typed mesh of axis names and sizes.  The blocks a rank holds are
cut as rank 0 of a fake process group of 4 ranks.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from repro.configs import ALL_ARCHS, get_config as jget_config
from repro.dist import sharding as jshd
from repro.launch import mesh as jmesh
from repro.nn import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tfm
from repro_torch.nn import layers

MESHES = {(2, 2): (("data", "model"), ("data",), "model"),
          (2, 2, 2): (("pod", "data", "model"), ("pod", "data"), "model")}
LM_ARCHS = [a for a in ALL_ARCHS if get_config(a)[1] == "lm"]


def _jax_leaf(specs, name):
    """The JAX spec of the port's parameter `name` (a layer's without its
    layer axis)."""
    if not name.startswith("layers."):
        return tuple(specs[name])
    _, _, rest = name.split(".", 2)
    spec = specs["layers"]
    for part in rest.split("."):
        spec = spec[part]
    return tuple(spec)[1:]


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_placements_equal_jax(arch, shape):
    _, dp, tp = MESHES[shape]
    cfg = get_config(arch)[0]
    jspecs = jshd.lm_param_specs(jget_config(arch)[0], dp, tp)
    specs = shd.lm_param_specs(cfg, dp, tp)
    assert sorted(specs) == sorted(tfm.param_shapes(cfg))
    for name, spec in specs.items():
        assert tuple(spec) == _jax_leaf(jspecs, name), name
    assert shd.dp_entry(dp) == jshd.dp_entry(dp)


def test_mesh_specs_replicate_heads_that_do_not_divide_and_fsdp_experts():
    smollm = get_config("smollm-135m")[0]          # 3 kv heads
    granite = get_config("granite-moe-1b-a400m")[0]
    sizes = {"data": 2, "model": 2}
    s = shd.lm_mesh_specs(smollm, ("data",), "model", sizes)
    assert s["layers.0.wq"] == shd.P(None, None)
    assert s["layers.0.wo"] == shd.P(None, None)
    assert s["layers.0.ffn.w_in"] == shd.P(None, "model")
    g = shd.lm_mesh_specs(granite, ("data",), "model", sizes)
    assert g["layers.0.wq"] == shd.P(None, "model")
    assert g["layers.0.moe.w_in"] == shd.P("model", "data", None)
    assert g["layers.0.moe.w_out"] == shd.P("model", None, "data")
    assert g["layers.0.moe.router"] == shd.P(None, None)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (16, 16), (2, 16, 16),
                                   (4, 1), (1, 8)], ids=str)
def test_mesh_axes_equal_jax(shape):
    names = (("pod", "data", "model") if len(shape) == 3
             else ("data", "model"))
    duck = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 size=int(np.prod(shape)))
    assert tmesh.mesh_axes(duck) == jmesh.mesh_axes(duck)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 96), (3, 1)], ids=str)
def test_layernorm_equals_jax(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 0.5
    g = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jlayers.layernorm(
        jnp.asarray(x).astype(jdt),
        {"gamma": jnp.asarray(g).astype(jdt),
         "beta": jnp.asarray(b).astype(jdt)})).astype(np.float32)
    got = layers.layernorm(torch.from_numpy(x).to(tdt),
                           {"gamma": torch.from_numpy(g).to(tdt),
                            "beta": torch.from_numpy(b).to(tdt)})
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * (1 + np.abs(want).max()))
    init = layers.layernorm_init(shape[-1], tdt, device="cpu")
    jinit = jlayers.layernorm_init(shape[-1], jdt)
    for k in ("gamma", "beta"):
        np.testing.assert_array_equal(init[k].float().numpy(),
                                      np.asarray(jinit[k], np.float32))


@pytest.fixture
def fake_world():
    """Rank 0 of a fake process group of 4 ranks and its (2, 2) mesh."""
    from repro_torch.launch.dryrun import fake_world as world
    with world((2, 2), ("data", "model"), "cpu") as mesh:
        yield mesh
    assert not dist.is_initialized()


def test_importing_the_mesh_modules_touches_no_group():
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parent.parent / "src")
    code = ("import os, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.dist.sharding\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.cells\n"
            "print(dist.is_initialized(), 'XLA_FLAGS' in os.environ)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env=dict(os.environ, PYTHONPATH=src)).stdout
    assert out.split() == ["False", "False"]


def test_meshes_and_blocks_on_a_fake_group(fake_world):
    mesh = fake_world
    assert tmesh.mesh_axes(mesh) == {"dp": ("data",), "tp": "model",
                                     "all": ("data", "model"), "dp_size": 2,
                                     "tp_size": 2, "n_devices": 4}
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec, want in ((shd.P("model", None), t[:4]),
                       (shd.P(None, "model"), t[:, :3]),
                       (shd.P(("data", "model"), None), t[:2]),
                       (shd.P(None, None), t)):
        blk = shd.local_block(t, spec, mesh)
        assert torch.equal(blk, want)
        assert blk.untyped_storage().data_ptr() != t.untyped_storage(
        ).data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        shd.local_block(t, shd.P(None, ("data", "model")), mesh)


def test_meshes_lay_the_ranks_out_row_major():
    """`DistCtx.dp_group` over two data axes relies on it."""
    from repro_torch.launch.dryrun import fake_world as world
    from repro_torch.models.transformer import DistCtx
    with world((2, 2, 2), ("pod", "data", "model"), "cpu") as mesh:
        assert np.array_equal(mesh.mesh.numpy(),
                              np.arange(8).reshape(2, 2, 2))
        ctx = DistCtx(mesh, ("pod", "data"), "model")
        assert dist.get_process_group_ranks(ctx.dp_group) == [0, 2, 4, 6]
        assert dist.get_process_group_ranks(ctx.tp_group) == [0, 1]


def test_fake_mesh_sizes_follow_the_production_meshes():
    from repro_torch.launch.dryrun import MESHES as DRY, fake_world as world
    for name, (shape, axes) in DRY.items():
        with world(shape, axes, "cpu") as mesh:
            ax = tmesh.mesh_axes(mesh)
            assert ax["n_devices"] == int(np.prod(shape))
            assert ax["tp_size"] == 16
            assert ax["dp"] == axes[:-1]
