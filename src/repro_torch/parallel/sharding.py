"""Sharding rules: parameter / batch / activation placements per family,
the port's copy of ``repro.parallel.sharding``.

Axis conventions (``launch/mesh.py``):
  single-pod mesh (16, 16)  -> ("data", "model")
  multi-pod  mesh (2,16,16) -> ("pod", "data", "model")

DP = batch over ("pod","data"); TP = heads/ffn/vocab over "model";
FSDP = parameter d_model dims over "data"; EP = experts over "model"
(falling back to expert-TP when n_experts doesn't divide the axis, e.g.
granite-moe's 40 experts on a 16-wide axis); SP = optional residual-stream
sequence sharding over "model" (Megatron-SP) for the deep 34B config.

A rule gives a :class:`Spec` per tensor: the reference's
``PartitionSpec`` entries, one per tensor dim (an axis name, a tuple of
names, or ``None``).  :func:`to_placements` turns a spec into one
DTensor placement per mesh dim.  The rules read only ``mesh.axis_names``
and ``mesh.shape`` (a name -> size mapping, as a JAX mesh's); a
``DeviceMesh`` is adapted by :func:`mesh_view`.
"""
from __future__ import annotations

import dataclasses
import math
from types import MappingProxyType
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ..models.transformer import LMConfig


@dataclasses.dataclass(frozen=True, init=False)
class Spec:
    """The entries of a ``PartitionSpec``: per tensor dim an axis name, a
    tuple of axis names (split row-major, the first outermost) or
    ``None``.  ``Spec()`` is replicated.  As JAX's, a one-name tuple is
    kept as the name and an empty one as ``None``."""
    entries: tuple

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        object.__setattr__(self, "entries", tuple(norm(e) for e in entries))

    def __repr__(self):
        return "Spec" + repr(self.entries)

    def axes(self, dim: int) -> tuple:
        """The mesh axes that split tensor dim ``dim``, outermost first."""
        e = self.entries[dim] if dim < len(self.entries) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


@dataclasses.dataclass(frozen=True)
class MeshView:
    """What the rules read of a mesh: its axis names in order and their
    sizes by name."""
    axis_names: tuple
    shape: MappingProxyType

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def mesh_view(mesh) -> MeshView:
    """``mesh`` as the rules read it: a ``DeviceMesh`` (``mesh_dim_names``
    and ``mesh.shape``), or anything with ``axis_names`` and a ``shape``
    mapping (a stub, or a JAX mesh)."""
    if isinstance(mesh, MeshView):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshView(tuple(names), MappingProxyType(
            dict(zip(names, (int(s) for s in mesh.shape)))))
    return MeshView(tuple(mesh.axis_names), MappingProxyType(
        {a: int(mesh.shape[a]) for a in mesh.axis_names}))


def to_placements(spec: Spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: mesh axis ``a``
    shards tensor dim ``d`` where ``a`` is in ``spec``'s entry ``d``.  A
    tuple entry is split row-major, as JAX splits it; DTensor splits a
    dim sharded on several mesh dims in mesh order, so the tuple must
    list its axes in mesh order (every rule here does)."""
    from torch.distributed.tensor import Replicate, Shard

    view = mesh_view(mesh)
    owner = {}
    for d in range(len(spec.entries)):
        axes = spec.axes(d)
        order = [view.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in "
                             f"mesh order {view.axis_names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in view.axis_names)


def shard_shape(spec: Spec, shape, mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor under ``spec``: each dim
    divided by the product of its axes' sizes (the reference's
    ``NamedSharding.shard_shape``; the dims must divide evenly)."""
    view = mesh_view(mesh)
    out = []
    for d, n in enumerate(shape):
        k = math.prod(view.shape[a] for a in spec.axes(d))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{k} ways under {spec}")
        out.append(n // k)
    return tuple(out)


def meta_dtensor(shape, dtype, mesh, spec: Spec):
    """A DTensor of global ``shape`` with ``spec``'s placements over
    ``mesh`` (a ``DeviceMesh``) whose local tensor is this rank's shard
    on ``meta``: the counterpart of a ``jax.ShapeDtypeStruct`` with a
    ``NamedSharding``; nothing is allocated."""
    import torch
    from .dtensor_ops import wrap

    shape = tuple(int(x) for x in shape)
    local = torch.empty(shard_shape(spec, shape, mesh), dtype=dtype,
                        device="meta")
    return wrap(local, mesh, to_placements(spec, mesh), shape)


def dp_axes(mesh) -> tuple:
    names = mesh_view(mesh).axis_names
    return tuple(n for n in names if n in ("pod", "data"))


def _div(n: int, k: int) -> bool:
    return n % k == 0


def lm_param_specs(cfg: LMConfig, mesh, fsdp: bool = True):
    """Spec tree matching ``transformer.init_params`` output."""
    mesh = mesh_view(mesh)
    model = "model" if "model" in mesh.axis_names else None
    msz = mesh.shape.get("model", 1)
    data = "data" if fsdp and "data" in mesh.axis_names else None
    dsz = mesh.shape.get("data", 1) if data else 1
    d_ok = _div(cfg.d_model, max(dsz, 1))
    dshard = data if d_ok else None

    def tp(dim_model_sz: int):
        return model if _div(dim_model_sz, msz) else None

    hd_all = cfg.n_heads * cfg.hd
    kv_all = cfg.n_kv * cfg.hd
    layer = {
        "ln1": Spec(None, None),
        "ln2": Spec(None, None),
        "wq": Spec(None, dshard, tp(hd_all)),
        "wk": Spec(None, dshard, tp(kv_all)),
        "wv": Spec(None, dshard, tp(kv_all)),
        "wo": Spec(None, tp(hd_all), dshard),
    }
    if cfg.qk_norm:
        layer["q_norm"] = Spec(None, None)
        layer["k_norm"] = Spec(None, None)
    if cfg.moe:
        ep = _div(cfg.n_experts, msz)          # expert-parallel possible?
        if ep:
            layer["router"] = Spec(None, None, None)
            layer["e_up"] = Spec(None, model, dshard, None)
            layer["e_down"] = Spec(None, model, None, dshard)
            if cfg.mlp == "swiglu":
                layer["e_gate"] = Spec(None, model, dshard, None)
        else:                                   # expert-TP fallback
            layer["router"] = Spec(None, None, None)
            layer["e_up"] = Spec(None, None, dshard, tp(cfg.d_ff))
            layer["e_down"] = Spec(None, None, tp(cfg.d_ff), dshard)
            if cfg.mlp == "swiglu":
                layer["e_gate"] = Spec(None, None, dshard, tp(cfg.d_ff))
        if cfg.n_shared:
            fs = cfg.d_ff * cfg.n_shared
            layer["s_up"] = Spec(None, dshard, tp(fs))
            layer["s_down"] = Spec(None, tp(fs), dshard)
            if cfg.mlp == "swiglu":
                layer["s_gate"] = Spec(None, dshard, tp(fs))
    else:
        layer["w_up"] = Spec(None, dshard, tp(cfg.d_ff))
        layer["w_down"] = Spec(None, tp(cfg.d_ff), dshard)
        if cfg.mlp == "swiglu":
            layer["w_gate"] = Spec(None, dshard, tp(cfg.d_ff))

    out = {
        "embed": Spec(tp(cfg.vocab), dshard),
        "layers": layer,
        "ln_f": Spec(None),
    }
    if not cfg.tied_embed:
        out["lm_head"] = Spec(dshard, tp(cfg.vocab))
    return out


def lm_batch_specs(mesh):
    dp = dp_axes(mesh)
    return {"tokens": Spec(dp, None)}


def lm_act_spec(cfg: LMConfig, mesh) -> Optional[Spec]:
    dp = dp_axes(mesh)
    if cfg.seq_shard and "model" in mesh_view(mesh).axis_names:
        return Spec(dp, "model", None)
    return Spec(dp, None, None)


def lm_cache_specs(cfg: LMConfig, mesh, shard_seq: bool = False,
                   batch: int = 0):
    """KV cache [L, B, S, KV, HD].  ``batch``: guard divisibility (0=skip)."""
    mesh = mesh_view(mesh)
    dp = dp_axes(mesh)
    if batch:
        dsz = math.prod(mesh.shape[a] for a in dp) if dp else 1
        if batch % max(dsz, 1) != 0:
            dp = None
    seq = "model" if shard_seq and "model" in mesh.axis_names else None
    kv = None
    if not shard_seq and _div(cfg.n_kv, mesh.shape.get("model", 1)):
        kv = "model"
    return {"k": Spec(None, dp, seq, kv, None),
            "v": Spec(None, dp, seq, kv, None),
            "pos": Spec(dp)}


def opt_state_specs(param_specs: dict) -> dict:
    """AdamW state mirrors param sharding (m, v, master)."""
    return {"m": param_specs, "v": param_specs, "step": Spec(),
            "master": param_specs}


def tree_placements(mesh, spec_tree):
    """The placements of every :class:`Spec` of ``spec_tree``, tree kept
    (the reference's ``tree_shardings``)."""
    if isinstance(spec_tree, Spec):
        return to_placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: tree_placements(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(tree_placements(mesh, v) for v in spec_tree)


# --- GNN -------------------------------------------------------------------

def gnn_full_graph_specs(mesh):
    """Full-batch node/edge arrays sharded over every mesh axis."""
    flat = tuple(mesh_view(mesh).axis_names)
    return {
        "node_feat": Spec(flat, None), "senders": Spec(flat),
        "receivers": Spec(flat), "labels": Spec(flat),
        "pos": Spec(flat, None), "triplet": Spec(flat),
    }


# --- recsys ----------------------------------------------------------------

def mind_param_specs(mesh):
    model = "model" if "model" in mesh_view(mesh).axis_names else None
    return {"item_embed": Spec(model, None), "s_map": Spec(None, None)}


def mind_batch_specs(mesh):
    dp = dp_axes(mesh)
    return {"hist": Spec(dp, None), "hist_mask": Spec(dp, None),
            "target": Spec(dp)}
