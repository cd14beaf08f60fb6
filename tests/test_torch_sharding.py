"""The port's sharding rules (``repro_torch.parallel.sharding``) and
meshes (``repro_torch.launch.mesh``) against the reference's, on the
CPU.

For every architecture of ``ARCHS + BONUS_ARCHS`` at full width, on both
production meshes, each rule's spec tree equals the reference's
``PartitionSpec`` tree entry for entry (the reference is given a
``jax.sharding.AbstractMesh``, the port a stub with the same axis names
and sizes), each spec's placements are the reference spec translated
(``Shard(d)`` on a mesh dim whose axis splits tensor dim ``d``,
``Replicate()`` elsewhere), the parameter spec tree follows the port's
parameter tree leaf for leaf, and each leaf's per-device shape is
``NamedSharding.shard_shape``'s.
"""
from types import SimpleNamespace

import pytest
from torch.distributed.tensor import Replicate, Shard

import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from repro import configs as jconfigs
from repro.parallel import sharding as jshr
from repro_torch import configs
from repro_torch.launch import cells, mesh as tmesh
from repro_torch.models import transformer
from repro_torch.models.recsys import mind
from repro_torch.parallel import sharding as shr
from repro_torch.train.tree import flatten_with_path
from release_xla import release_compiled  # noqa: F401

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = configs.ARCHS + configs.BONUS_ARCHS


def _meshes(kind):
    shape, axes = MESHES[kind]
    stub = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return AbstractMesh(shape, axes), stub


def _pairs(ref_tree, port_tree):
    """``[(path, reference P, port Spec)]`` over both trees, which must
    have the same keys."""
    if isinstance(port_tree, shr.Spec):
        assert isinstance(ref_tree, P)
        return [((), ref_tree, port_tree)]
    assert isinstance(ref_tree, dict) and set(ref_tree) == set(port_tree)
    return [((k,) + path, r, p) for k in sorted(port_tree)
            for path, r, p in _pairs(ref_tree[k], port_tree[k])]


def _expected_placements(spec: P, axes):
    """The reference spec translated: the dim each mesh axis splits."""
    owner = {}
    for d, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in axes)


def _check(ref_tree, port_tree, stub, axes):
    pairs = _pairs(ref_tree, port_tree)
    assert pairs
    for path, r, p in pairs:
        assert tuple(r) == p.entries, path
        assert shr.to_placements(p, stub) == _expected_placements(r, axes), \
            path
    return pairs


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference(arch, kind):
    amesh, stub = _meshes(kind)
    axes = MESHES[kind][1]
    mod, jmod = configs.get(arch), jconfigs.get(arch)
    assert shr.dp_axes(stub) == jshr.dp_axes(amesh)
    if mod.FAMILY == "lm":
        cfg, jcfg = mod.make_config(), jmod.make_config()
        pspecs = shr.lm_param_specs(cfg, stub)
        pairs = _check(jshr.lm_param_specs(jcfg, amesh), pspecs, stub, axes)
        _check(jshr.lm_param_specs(jcfg, amesh, fsdp=False),
               shr.lm_param_specs(cfg, stub, fsdp=False), stub, axes)
        _check(jshr.lm_batch_specs(amesh), shr.lm_batch_specs(stub), stub,
               axes)
        _check(jshr.lm_act_spec(jcfg, amesh), shr.lm_act_spec(cfg, stub),
               stub, axes)
        for seq in (False, True):
            for batch in (0, 1, 128):
                _check(jshr.lm_cache_specs(jcfg, amesh, seq, batch),
                       shr.lm_cache_specs(cfg, stub, seq, batch), stub, axes)
        _check(jshr.opt_state_specs(jshr.lm_param_specs(jcfg, amesh)),
               shr.opt_state_specs(pspecs), stub, axes)
        # the spec tree follows the port's parameter tree, leaf for leaf,
        # and every leaf splits as the reference's NamedSharding does
        params = cells.eval_shape(transformer.init_params, cfg)
        leaves = {tuple(p): t for p, t in flatten_with_path(params)}
        assert set(leaves) == {path for path, _, _ in pairs}
        for path, r, p in pairs:
            shape = tuple(leaves[path].shape)
            assert len(p.entries) == len(shape), path
            assert shr.shard_shape(p, shape, stub) == \
                NamedSharding(amesh, r).shard_shape(shape), path
    elif mod.FAMILY == "gnn":
        _check(jshr.gnn_full_graph_specs(amesh),
               shr.gnn_full_graph_specs(stub), stub, axes)
    else:
        pspecs = shr.mind_param_specs(stub)
        pairs = _check(jshr.mind_param_specs(amesh), pspecs, stub, axes)
        _check(jshr.mind_batch_specs(amesh), shr.mind_batch_specs(stub),
               stub, axes)
        params = cells.eval_shape(mind.init_params, mod.make_config())
        leaves = {tuple(p): t for p, t in flatten_with_path(params)}
        for path, r, p in pairs:
            shape = tuple(leaves[path].shape)
            assert shr.shard_shape(p, shape, stub) == \
                NamedSharding(amesh, r).shard_shape(shape), path


def test_expert_parallel_and_expert_tp_fallback():
    """deepseek's 64 experts split over the 16-wide model axis; granite
    -moe's 40 do not, and fall back to splitting ``d_ff`` (expert-TP)."""
    _, stub = _meshes("single")
    ep = shr.lm_param_specs(configs.get("deepseek-moe-16b").make_config(),
                            stub)["layers"]
    tp = shr.lm_param_specs(configs.get("granite-moe-3b-a800m")
                            .make_config(), stub)["layers"]
    assert ep["e_up"].entries == (None, "model", "data", None)
    assert tp["e_up"].entries == (None, None, "data", "model")
    assert shr.to_placements(tp["e_down"], stub) == (Shard(3), Shard(2))


def test_placements_row_major_tuple_and_errors():
    _, stub = _meshes("multi")
    spec = shr.Spec(("pod", "data"), None)
    assert shr.to_placements(spec, stub) == (Shard(0), Shard(0),
                                             Replicate())
    assert shr.shard_shape(spec, (64, 3), stub) == (2, 3)
    assert shr.to_placements(shr.Spec(), stub) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shr.to_placements(shr.Spec(("data", "pod")), stub)
    with pytest.raises(ValueError, match="two dims"):
        shr.to_placements(shr.Spec("data", "data"), stub)
    with pytest.raises(ValueError, match="does not split"):
        shr.shard_shape(shr.Spec("model"), (10,), stub)


def test_mesh_needs_a_group_of_its_size():
    """Importing ``launch.mesh`` touches no process-group state; a mesh
    without a default group, or with one of another size, raises."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert tmesh.SINGLE == MESHES["single"] and tmesh.MULTI == \
        MESHES["multi"]
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("data",))
