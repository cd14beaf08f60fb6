"""Production mesh construction, the port's copy of
``repro.launch.mesh``: the same shapes and axis names, as
``torch.distributed`` device meshes.

Functions, not module-level constants: importing this module never
touches process-group state.  A mesh needs a default process group of
the mesh's size (``torch.distributed.init_process_group``; the dry-run
starts a ``"fake"`` one of 256 or 512 ranks).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape, axes = MULTI if multi_pod else SINGLE
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group.  ``device_type`` defaults to ``"cuda"`` where a card is
    visible, else ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a default process group of {need} "
            "ranks; call torch.distributed.init_process_group first (the "
            "dry-run uses the 'fake' backend)")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {shape} mesh needs a world of {need} ranks; the default "
            f"group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
