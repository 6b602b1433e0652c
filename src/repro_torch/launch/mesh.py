"""Device meshes of the port (the counterpart of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the current
default process group: one rank a device, named axes `("data", "model")`
or `("pod", "data", "model")`.  The functions build it when called, so
importing this module touches no process group; the caller starts the
group first (`repro_torch.dist.world.run_world` for real ranks, the dry
run's fake group for a production mesh on one host).
"""
from __future__ import annotations

from math import prod
from typing import Dict, Tuple

from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with axis names `axes` over the default
    group, whose world size must be `prod(shape)`."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) over ("data", "model"): 256 devices; with `multi_pod`,
    (2, 16, 16) over ("pod", "data", "model"): 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any mesh with
    `axis_names` and a `shape` mapping (a JAX mesh)."""
    names = getattr(mesh, "axis_names", None)
    if names is None:                       # a torch DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in names}


def mesh_axes(mesh) -> dict:
    """Logical roles: the dp axes, the tp axis ("model", else the last),
    every axis, and their sizes; the JAX package's dict, key for key."""
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    tp = "model" if "model" in names else names[-1]
    dp = tuple(n for n in names if n != tp)
    return {"dp": dp, "tp": tp, "all": names,
            "dp_size": int(prod(sizes[a] for a in dp)) if dp else 1,
            "tp_size": sizes[tp],
            "n_devices": int(prod(sizes.values()))}
