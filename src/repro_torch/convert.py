"""Carry the reference's state into the port.

The shortest-path system has no weights: its state is the graph and its
layouts.  :func:`from_reference` turns the numpy arrays of a reference
``HostGraph``, ``DeviceGraph`` or ``BlockedGraph`` into the port's
containers, so that both packages can run on byte-identical inputs.  The
caller flattens the reference object into numpy arrays (the port imports
nothing of the reference package):

* ``HostGraph``: its fields ``n, src, dst, w, row_ptr, deg, rtow, max_w``;
* ``DeviceGraph``: ``src, dst, w, row_ptr, deg, rtow, max_w, n_edges2``;
* ``BlockedGraph``: its static fields ``n, block_v, n_blocks,
  n_dst_blocks, src_base, tile_e, dense_grid_tiles``, ``deg``, and one
  ``slabs/<i>/<field>`` entry per slab field (``src_local, dst, w,
  tile_dst, tile_first, bucket_nonempty``);
* ``ShardedGraph``: its fields ``src, dst, w, deg, rtow, n_edges2,
  n_true``;
* ``BlockedShards`` with its ``BlockedShardMeta``: the stacked arrays
  ``src_local, dst, w, tile_dst, tile_first, bucket_nonempty`` and the
  meta fields ``block_v, tile_e, n_src_blocks, n_dst_blocks,
  dense_grid_tiles``.

The port's vertex->tile index (``TileIndex``), which the reference does
not have, is built here from the carried slots, as the port's own layout
functions build it.

:func:`landmarks_from_reference` carries a reference ``LandmarkSet``
across, flattened into its ``.npz`` fields ``landmarks, D, strategy, sym,
max_hops``, so that both packages prune with the same matrix.

:func:`lm_params_from_reference` does the same for the language model's
parameter pytree, flattened by the caller into ``{"embed": ...,
"ln_f": ..., "layers/wq": ..., ...}`` numpy arrays (bf16 leaves as their
exact float32 values: the port needs no ``ml_dtypes``), and
:func:`mind_params_from_reference` for MIND's ``{"item_embed": ...,
"s_map": ...}``, and :func:`gnn_params_from_reference` for the four GNN
models' trees (``/``-joined paths, list positions as numbers:
``layers/A``, ``head/w/0``, ``blocks/bilinear``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.distributed import (BlockedShardMeta, BlockedShards,
                               ShardedGraph, stack_tile_index)
from .core.graph import BlockedGraph, DeviceGraph, HostGraph, tile_index
from .core.landmarks import LandmarkSet

_SLAB_FIELDS = ("src_local", "dst", "w", "tile_dst", "tile_first",
                "bucket_nonempty")


def _host(a: dict) -> HostGraph:
    return HostGraph(n=int(a["n"]), src=np.asarray(a["src"], np.int32),
                     dst=np.asarray(a["dst"], np.int32),
                     w=np.asarray(a["w"], np.float32),
                     row_ptr=np.asarray(a["row_ptr"], np.int32),
                     deg=np.asarray(a["deg"], np.int32),
                     rtow=np.asarray(a["rtow"], np.float32),
                     max_w=float(a["max_w"]))


def _device(a: dict, dev: torch.device) -> DeviceGraph:
    def t(key, dtype):
        return torch.from_numpy(np.array(a[key])).to(dev, dtype)
    return DeviceGraph(src=t("src", torch.int64), dst=t("dst", torch.int64),
                       w=t("w", torch.float32),
                       row_ptr=t("row_ptr", torch.int64),
                       deg=t("deg", torch.int32), rtow=t("rtow", torch.float32),
                       max_w=t("max_w", torch.float32),
                       n_edges2=t("n_edges2", torch.int32))


def _blocked(a: dict, dev: torch.device) -> BlockedGraph:
    if int(a["src_base"]) != 0 or int(a["n_blocks"]) != int(a["n_dst_blocks"]):
        raise ValueError("a shard slice is no whole-graph BlockedGraph: "
                         "convert the stacked shard layout "
                         "(distributed.shard_blocked) instead")
    nb, bv = int(a["n_blocks"]), int(a["block_v"])
    slabs = [{f: np.asarray(a[f"slabs/{i}/{f}"]) for f in _SLAB_FIELDS}
             for i in range(nb)]
    ntiles = [s["tile_dst"].shape[0] for s in slabs]
    slab_ptr = np.concatenate([[0], np.cumsum(ntiles)])
    cat = lambda f, dtype: torch.from_numpy(np.ascontiguousarray(
        np.concatenate([s[f] for s in slabs]).astype(dtype))).to(dev)
    src = np.concatenate([s["src_local"].astype(np.int32) + i * bv
                          for i, s in enumerate(slabs)])
    w = np.concatenate([s["w"] for s in slabs]).astype(np.float32)
    tf = np.concatenate([s["tile_first"] for s in slabs]).astype(bool)
    return BlockedGraph(
        n=int(a["n"]), block_v=bv, n_blocks=nb,
        n_dst_blocks=int(a["n_dst_blocks"]), tile_e=int(a["tile_e"]),
        dense_grid_tiles=int(a["dense_grid_tiles"]),
        slab_ptr=tuple(int(x) for x in slab_ptr),
        src=torch.from_numpy(src).to(dev), dst=cat("dst", np.int32),
        w=cat("w", np.float32), tile_dst=cat("tile_dst", np.int32),
        tile_first=cat("tile_first", bool),
        bucket_nonempty=torch.from_numpy(np.stack(
            [s["bucket_nonempty"].astype(bool) for s in slabs])).to(dev),
        deg=torch.from_numpy(np.array(a["deg"], np.int32)).to(dev),
        index=tile_index(src, w, tf, int(a["tile_e"]), nb * bv).to(dev))


def _sharded(a: dict) -> ShardedGraph:
    return ShardedGraph(src=np.asarray(a["src"], np.int32),
                        dst=np.asarray(a["dst"], np.int32),
                        w=np.asarray(a["w"], np.float32),
                        deg=np.asarray(a["deg"], np.int32),
                        rtow=np.asarray(a["rtow"], np.float32),
                        n_edges2=int(a["n_edges2"]), n_true=int(a["n_true"]))


def _blocked_shards(a: dict):
    """The reference's ``[P, S, NT*tile_e]`` stack with block-local source
    ids becomes the port's ``[P, S*NT*tile_e]`` one with shard-local
    ids (each slab's offset added)."""
    meta = BlockedShardMeta(**{f.name: int(a[f.name]) for f in
                               dataclasses.fields(BlockedShardMeta)})
    src = np.asarray(a["src_local"], np.int32)
    p, n_sb = src.shape[:2]
    offs = (np.arange(n_sb, dtype=np.int32) * meta.block_v)[None, :, None]
    flat = lambda f, dtype: np.asarray(a[f], dtype).reshape(p, -1)
    src, w, tf = ((src + offs).reshape(p, -1), flat("w", np.float32),
                  flat("tile_first", bool))
    index = stack_tile_index([
        tile_index(src[q], w[q], tf[q], meta.tile_e, n_sb * meta.block_v)
        for q in range(p)])
    arrays = BlockedShards(
        src=src, dst=flat("dst", np.int32), w=w,
        tile_dst=flat("tile_dst", np.int32), tile_first=tf,
        bucket_nonempty=np.asarray(a["bucket_nonempty"], bool),
        **index._asdict())
    return arrays, meta


def from_reference(arrays: dict, device):
    """The port's container for a flattened reference graph or layout
    (see the module docstring for the keys).  A ``HostGraph`` and the
    sharded layouts stay on the host (each rank moves its own shard);
    the others land on ``device``."""
    dev = torch.device(device)
    if any(k.startswith("slabs/") for k in arrays):
        return _blocked(arrays, dev)
    if "src_local" in arrays:
        return _blocked_shards(arrays)
    if "n_true" in arrays:
        return _sharded(arrays)
    if "n_edges2" in arrays:
        return _device(arrays, dev)
    return _host(arrays)


def landmarks_from_reference(arrays: dict, device) -> LandmarkSet:
    """The port's :class:`LandmarkSet` for a flattened reference one
    (``landmarks``, ``D``, ``strategy``, ``sym``, ``max_hops``), with
    ``D`` on ``device``."""
    return LandmarkSet(
        landmarks=np.asarray(arrays["landmarks"], np.int64),
        D=torch.from_numpy(np.array(arrays["D"], np.float32)).to(
            torch.device(device)),
        strategy=str(arrays["strategy"]), sym=bool(arrays["sym"]),
        max_hops=int(arrays["max_hops"]))


# leaves the reference keeps in float32 whatever the model's dtype: the
# MoE router (``transformer.py:120`` there), which routes in f32
_F32_LEAVES = ("layers/router",)


def lm_params_from_reference(arrays: dict, dtype, device) -> dict:
    """The port's parameter dict (:mod:`repro_torch.models.transformer`)
    from the reference's ``init_params`` pytree flattened with ``/``-joined
    keys (``layers/<name>`` for the stacked per-layer tensors, the MoE
    experts ``[L, E, d_in, d_out]`` among them).  Every leaf is cast to
    ``dtype``, the model's ``cfg.dtype``, as the reference stores it (a
    float32 copy of a bf16 leaf casts back exactly), except the MoE
    ``router``, which stays float32 as in the reference."""
    dev = torch.device(device)
    out = {"layers": {}}
    for key, a in arrays.items():
        t = torch.from_numpy(np.array(a, np.float32)).to(
            dev, torch.float32 if key in _F32_LEAVES else dtype)
        head, _, name = key.partition("/")
        if head == "layers" and name:
            out["layers"][name] = t
        elif not name:
            out[head] = t
        else:
            raise ValueError(f"unexpected parameter key {key!r}")
    return out


def mind_params_from_reference(arrays: dict, device) -> dict:
    """The port's MIND parameters (:mod:`repro_torch.models.recsys.mind`)
    from the reference's ``init_params`` leaves as numpy arrays
    (``item_embed`` ``[V, D]``, ``s_map`` ``[D, D]``), float32 on
    ``device``."""
    if set(arrays) != {"item_embed", "s_map"}:
        raise ValueError(f"MIND parameters are item_embed and s_map, got "
                         f"{sorted(arrays)}")
    return {k: torch.from_numpy(np.array(a, np.float32)).to(
        torch.device(device)) for k, a in arrays.items()}


def gnn_params_from_reference(arrays: dict, device) -> dict:
    """The port's parameter tree of a GNN model (:mod:`repro_torch.models.
    gnn`: GIN, GatedGCN, PNA, DimeNet) from the reference's
    ``init_params`` pytree flattened into ``/``-joined paths, a list
    position written as its number (``layer0/mlp/w/1``, ``layers/eps``,
    ``head/b/0``, ``blocks/out_mlp/w/0``), float32 on ``device``.  The
    stacked per-layer leaves keep their leading layer axis."""
    dev = torch.device(device)
    tree: dict = {}
    for key, a in arrays.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.from_numpy(np.array(a, np.float32)).to(dev)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            if sorted(map(int, node)) != list(range(len(node))):
                raise ValueError(f"list positions {sorted(node)} have gaps")
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)
