"""The port's dry-run (``repro_torch.launch.dryrun``, ``comm_stats``,
the cells' traced steps) on the CPU.

* ``comm_stats.collective_bytes`` returns the reference's
  ``hlo_stats.collective_bytes`` dict when both are fed the same
  collectives (the reference's input a short HLO text written here),
  and :class:`~repro_torch.launch.comm_stats.CommRecorder` records a
  functional and an in-place collective with their bytes and group.
* One cell of each family, traced at its smoke config under a fake
  group on a (2, 2) mesh (the train cells) and a (2, 2, 2) mesh (the
  serving cells): every collective of a known kind, and rank 0's FLOPs
  not above the one-device step's (the same step on the arguments'
  whole tensors); on a (1, 1) mesh they are equal.
* ``run_sssp`` on the CPU at scale 10 over a world of 4: one round's
  collectives are the packed-key exchanges (v1 an ``all-reduce`` of 8·n
  bytes; v2 a ``reduce-scatter`` of 8·n in and 8·n/p out; v3 an
  ``all-to-all`` of p·2·capacity int64s), the same on both backends,
  rank 0's round relaxes edges, and on ``blocked`` the round's exchanged
  keys and state were held bitwise against the plain round's.  Without
  ``device="cpu"`` and no card it fails.
* The command line writes an artifact and exits 0 for one cell.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_stats
from repro_torch.launch import cells, comm_stats, dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.parallel.dtensor_ops import is_dtensor
from repro_torch.train.tree import tree_map
from release_xla import release_compiled  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"

_HLO = """
HloModule m
%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}
ENTRY %main (p0: f32[1024], p1: s32[2,8]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %p1 = s32[2,8]{1,0} parameter(1)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p0), replica_groups=[1,4]<=[4], to_apply=%add
  %ag = s32[8,8]{1,0} all-gather(s32[2,8]{1,0} %p1), replica_groups=[1,4]<=[4], dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %p0), replica_groups=[1,4]<=[4], dimensions={0}, to_apply=%add
  %aa = f32[1024]{0} all-to-all(f32[1024]{0} %p0), replica_groups=[2,2]<=[4], dimensions={0}
  %ar2 = f32[1024]{0} all-reduce(f32[1024]{0} %ar), replica_groups=[2,2]<=[4], to_apply=%add
  ROOT %cp = f32[1024]{0} collective-permute(f32[1024]{0} %ar2), source_target_pairs={{0,1},{1,0}}
}
"""

_RECORDS = [
    {"kind": "all-reduce", "in_bytes": 4096, "out_bytes": 4096, "group": 4},
    {"kind": "all-gather", "in_bytes": 64, "out_bytes": 256, "group": 4},
    {"kind": "reduce-scatter", "in_bytes": 4096, "out_bytes": 1024,
     "group": 4},
    {"kind": "all-to-all", "in_bytes": 4096, "out_bytes": 4096, "group": 2},
    {"kind": "all-reduce", "in_bytes": 4096, "out_bytes": 4096, "group": 2},
    {"kind": "collective-permute", "in_bytes": 4096, "out_bytes": 4096,
     "group": 1},
]


def test_collective_bytes_match_reference():
    ref = hlo_stats.collective_bytes(_HLO)
    assert ref["counts"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 1}
    assert comm_stats.collective_bytes(_RECORDS) == ref
    assert comm_stats.collective_bytes([]) == hlo_stats.collective_bytes("")


@pytest.fixture
def fake_world():
    """Start a fake group of the asked size; destroy it after the test."""
    def start(world):
        dryrun.start_fake_group(world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_recorder_sees_functional_and_inplace(fake_world):
    from torch.distributed import _functional_collectives as funcol
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with comm_stats.CommRecorder() as rec:
        gather = getattr(funcol, "all_gather_single", None) or \
            funcol.all_gather_tensor
        gather(torch.empty(3, 5, device="meta"), 0, (mesh, 1))
        x = torch.ones(6)
        dist.all_reduce(x)
    kinds = [(r["kind"], r["in_bytes"], r["out_bytes"], r["group"])
             for r in rec.records]
    assert ("all-gather", 60, 120, 2) in kinds
    assert ("all-reduce", 24, 24, 4) in kinds


TRAIN_CELLS = ("qwen3-0.6b/train_4k", "gin-tu/full_graph_sm",
               "mind/train_batch")
SERVE_CELLS = ("qwen3-0.6b/decode_32k", "gin-tu/molecule",
               "mind/serve_p99")


def _plain(tree):
    """The arguments as plain tensors: each DTensor's whole (``meta``)
    tensor, a graph batch without its sharding context."""
    def one(t):
        if is_dtensor(t):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t
    if isinstance(tree, GraphBatch):
        import dataclasses
        return dataclasses.replace(tree, shard_ctx=None, **{
            f.name: one(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, tuple) and any(isinstance(t, GraphBatch)
                                       for t in tree):
        return tuple(_plain(t) for t in tree)
    return tree_map(one, tree)


def _one_device_flops(fn, args):
    _, flops = comm_stats.flops_of(fn, *_plain(args))
    return flops


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 2, 2)])
def test_cells_trace_under_a_fake_group(shape, fake_world):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    fake_world(math.prod(shape))
    mesh = make_mesh(shape, names, device_type="cpu")
    for cell in SERVE_CELLS if len(shape) == 3 else TRAIN_CELLS:
        arch, sh = cell.split("/")
        fn, args, meta, out_places = cells.build_cell(arch, sh, mesh,
                                                      smoke=True)
        _, records, flops, _, _ = dryrun.trace_cell(fn, args, out_places)
        c = comm_stats.collective_bytes(records)
        assert set(c["counts"]) <= set(comm_stats.COLLECTIVE_OPS), cell
        plain = _one_device_flops(fn, args)
        assert plain > 0, cell
        if shape == (1, 1):
            assert flops == plain, cell
            assert c["ring_bytes"] == 0, cell
        else:
            assert 0 < flops <= plain, cell
            assert c["total"] > 0, cell


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_sssp_iteration_bytes(version, tmp_path, fake_world):
    world, scale = 4, 10
    n = 1 << scale
    block = n // world
    arts = {}
    shard = None
    for backend in ("segment_min", "blocked"):
        art = dryrun.run_sssp("single", scale, 16, version, backend,
                              device="cpu", out_dir=str(tmp_path),
                              shard=shard, world=world)
        shard = art.pop("_shard")
        assert art["ok"], art.get("error")
        assert art["world"] == world and art["rank0"]["block"] == block
        assert art["rank0"]["edges"] == 2 * 16 * n // world
        assert art["rank0"]["n_relax"] > 0
        arts[backend] = art
    assert arts["segment_min"]["collectives"] == \
        arts["blocked"]["collectives"]
    assert arts["segment_min"]["rank0"]["n_relax"] == \
        arts["blocked"]["rank0"]["n_relax"]
    rnd = arts["blocked"]["collectives_round"]
    it = arts["blocked"]["collectives"]
    if version == "v1":
        # the packed (value, winner) keys of every vertex, then 5 counters
        assert rnd["per_op"] == {"all-reduce": 8 * n + 5 * 4}
        assert set(it["counts"]) == {"all-reduce"}
    elif version == "v2":
        assert rnd["per_op"]["reduce-scatter"] == 8 * n
        assert "all-to-all" not in it["counts"]
    else:
        cap = max(block // 16, 8)
        assert rnd["per_op"]["all-to-all"] == world * 2 * cap * 8
        assert "reduce-scatter" not in rnd["counts"]
    if version != "v1":
        assert rnd["counts"]["all-reduce"] >= 1
    # the blocked round held bitwise against the plain one: every key
    # the exchange sent (v1, v2: all n destinations; v3: its capacity)
    assert arts["segment_min"]["rank0"]["keys_vs_plain"] == 0
    assert arts["blocked"]["rank0"]["keys_vs_plain"] == (
        n if version != "v3" else world * 2 * max(block // 16, 8))


def test_sssp_blocked_round_is_held_against_plain(tmp_path, monkeypatch,
                                                 fake_world):
    """A blocked round whose partials differ from the plain round's in
    one destination's winner fails the dry-run."""
    from repro_torch.core import relax
    fused = relax.blocked_shard_partials_fused

    def off_by_one(*a, **kw):
        best, win, *rest = fused(*a, **kw)
        hit = int(torch.nonzero(torch.isfinite(best))[-1])
        win = win.clone()
        win[hit] += 1
        return (best, win, *rest)
    monkeypatch.setattr(relax, "blocked_shard_partials_fused", off_by_one)
    art = dryrun.run_sssp("single", 10, 16, "v2", "blocked", device="cpu",
                          out_dir=str(tmp_path), world=4)
    assert not art["ok"] and "differ from the plain round" in art["error"]


def test_replicate_fallback_is_scoped(fake_world):
    """The fallback replicates an operator DTensor has no strategy for
    (``searchsorted``) and names it; outside the context DTensor's own
    propagation, and its error, are back."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.parallel.dtensor_ops import replicate_fallback
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    prop = DTensor._op_dispatcher.sharding_propagator
    before = (prop.propagate_op_sharding,
              prop.propagate_op_sharding_non_cached)
    a = DTensor.from_local(torch.arange(8), mesh, [Replicate()] * 2)
    with replicate_fallback() as replicated:
        out = torch.searchsorted(a, a)
        assert out.placements == (Replicate(), Replicate())
        assert replicated == {"aten.searchsorted.Tensor"}
    assert (prop.propagate_op_sharding,
            prop.propagate_op_sharding_non_cached) == before
    with pytest.raises(Exception):
        torch.searchsorted(a, a)


def test_sssp_reduce_scatter_out_bytes(fake_world):
    """v2's exchange hands rank 0 its block: 8·n/p bytes out."""
    world, scale = 4, 10
    fake_world(world)
    shard = dryrun.rank0_shard(scale, 16, world, device="cpu")
    it = dryrun.sssp_iteration(shard, "v2", world, torch.device("cpu"))
    rs = [r for r in it["round"] if r["kind"] == "reduce-scatter"]
    assert [(r["in_bytes"], r["out_bytes"], r["group"]) for r in rs] == \
        [(8 << scale, (8 << scale) // world, world)]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_sssp_needs_the_card_unless_cpu_asked(tmp_path, fake_world):
    art = dryrun.run_sssp("single", 10, 16, "v2", out_dir=str(tmp_path),
                          world=4)
    assert not art["ok"] and "no CUDA device" in art["error"]


def test_cli_writes_an_artifact(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gin-tu", "--shape", "molecule", "--mesh", "single", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    art = json.loads((tmp_path / "single" /
                      "gin-tu__molecule.json").read_text())
    assert art["ok"] and art["mesh_shape"] == {"data": 16, "model": 16}
    assert art["memory"]["available"] is False
    assert art["cost"]["flops"] > 0 and art["arg_bytes_per_device"] > 0
    assert set(art["collectives"]) == {"per_op", "counts", "total",
                                       "ring_bytes"}
    assert art["meta"]["nodes"] == 3840 and art["timing"]["trace_s"] > 0
    assert "1/1 cells traced" in out.stdout
