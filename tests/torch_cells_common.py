"""The comparison of the port's ``launch/cells.py::build_cell`` with the
reference's on one production mesh (``tests/test_torch_cells.py``,
``tests/test_torch_cells_multi.py``).

The reference builds its cell on a ``jax.sharding.AbstractMesh`` (no
devices); the port on a ``DeviceMesh`` of a ``"fake"`` process group of
the mesh's size, started in the test process for the module and
destroyed after it.  For a cell: ``meta`` equal key by key, the same
number of argument leaves in the same order, each with the same global
shape and dtype, each leaf's rank-0 local shape equal to the reference
sharding's ``shard_shape``, and the per-device argument bytes equal (the
reference dry-run's ``_arg_bytes_per_device``, written out here: its
module sets ``XLA_FLAGS`` when imported).
"""
import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh
from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import MULTI, SINGLE, make_mesh

MESHES = {"single": SINGLE, "multi": MULTI}
MOE = ("deepseek-moe-16b", "granite-moe-3b-a800m")
# the MoE cells held here (each reference build takes 5 to 9 s): expert
# parallelism (deepseek's 64 experts on the 16-wide axis) on one mesh,
# the expert-TP fallback (granite-moe's 40) on the other; the rest are
# the one-off comparison of all 72 cells
MOE_HELD = {"single": "deepseek-moe-16b/train_4k",
            "multi": "granite-moe-3b-a800m/decode_32k"}


def held_cells(kind: str) -> list:
    out = []
    for arch, shape in configs.all_cells(include_bonus=True):
        cell = f"{arch}/{shape}"
        if arch not in MOE or cell == MOE_HELD[kind]:
            out.append(cell)
    return out


@pytest.fixture(scope="module")
def port_mesh(request):
    shape, axes = MESHES[request.module.KIND]
    dryrun.start_fake_group(math.prod(shape))
    yield make_mesh(shape, axes, device_type="cpu")
    torch.distributed.destroy_process_group()


def _ref_arg_bytes(args) -> int:
    total = 0
    for leaf in jax.tree.leaves(args):
        shard = leaf.sharding.shard_shape(leaf.shape)
        total += int(np.prod(shard)) * leaf.dtype.itemsize
    return total


def _dtype_name(d) -> str:
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else \
        np.dtype(d).name


def compare_cell(kind: str, cell: str, mesh) -> None:
    arch, shape = cell.split("/")
    mshape, axes = MESHES[kind]
    _, jargs, jmeta, _ = jcells.build_cell(arch, shape,
                                           AbstractMesh(mshape, axes))
    _, targs, tmeta, _ = cells.build_cell(arch, shape, mesh)
    assert tmeta == jmeta
    jl = jax.tree.leaves(jargs)
    tl = dryrun._leaves(targs)
    assert len(tl) == len(jl)
    for i, (j, t) in enumerate(zip(jl, tl)):
        assert tuple(t.shape) == tuple(j.shape), i
        assert _dtype_name(t.dtype) == _dtype_name(j.dtype), i
        assert tuple(t.to_local().shape) == tuple(
            j.sharding.shard_shape(j.shape)), i
        assert t.to_local().device.type == "meta"
    assert dryrun.arg_bytes_per_device(targs) == _ref_arg_bytes(jargs)


def registry_covers_reference() -> None:
    assert list(configs.all_cells()) == list(jconfigs.all_cells())
    assert list(configs.all_cells(include_bonus=True)) == \
        list(jconfigs.all_cells(include_bonus=True))
    assert configs.SKIPPED == jconfigs.SKIPPED
    assert len(list(configs.all_cells())) + len(configs.SKIPPED) == 40
