"""Per-(architecture x input-shape) cell builders for the dry-run, the
port's copy of ``repro.launch.cells``.

``build_cell(arch, shape, mesh)`` returns ``(fn, args, meta,
out_placements)``.  ``args`` are DTensors over ``meta`` local tensors
with the placements of ``parallel/sharding.py``'s rules: the counterpart
of ``jax.ShapeDtypeStruct``s with ``NamedSharding``s.  There is no
device and nothing is allocated (by design, not as a CPU fallback):
``fn(*args)`` traces the full distributed step on this rank, issuing its
collectives, under a process group whose world is the mesh (the
dry-run's ``"fake"`` one).  ``out_placements`` is the reference's
``out_shardings`` (``None`` where it has none): the placements the
dry-run redistributes the outputs to.

``meta`` has the reference's keys and values, ``scan_mult`` included
(the reference's cost analysis counts each scan body once; the port
traces every layer and microbatch, so its FLOPs are not divided by it).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..models import transformer
from ..models.gnn import common as gnn_common, dimenet as dimenet_mod
from ..models.gnn import gatedgcn as gatedgcn_mod, gin as gin_mod
from ..models.gnn import pna as pna_mod
from ..models.recsys import mind as mind_mod
from ..parallel import sharding as shr
from ..parallel.sharding import meta_dtensor
from ..train import loop as train_loop
from ..train import optimizer as opt_mod
from ..train.tree import leaves, tree_map

GNN_FWD = {"gin": (gin_mod, gin_mod.forward),
           "pna": (pna_mod, pna_mod.forward),
           "gatedgcn": (gatedgcn_mod, gatedgcn_mod.forward),
           "dimenet": (dimenet_mod, dimenet_mod.forward)}


class _MetaInit(TorchDispatchMode):
    """Every tensor an init function makes is made on ``meta``, and its
    random draws are dropped: the shapes and dtypes of the parameters
    without their values (``jax.eval_shape`` of the init)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if "generator" in kwargs:
            kwargs["generator"] = None
        return func(*args, **kwargs)


def eval_shape(init, *args):
    """``init(*args, torch.Generator())`` with every tensor on ``meta``."""
    with _MetaInit():
        return init(*args, torch.Generator())


def _attach(struct_tree, spec_tree, mesh, dtype=None):
    """Meta tensors -> DTensors with the matching specs (one spec for
    every leaf where ``spec_tree`` is a :class:`~..parallel.sharding.
    Spec`); ``dtype`` overrides the leaves' dtype."""
    one = lambda s, sp: meta_dtensor(s.shape, dtype or s.dtype, mesh, sp)
    if isinstance(spec_tree, shr.Spec):
        return tree_map(lambda s: one(s, spec_tree), struct_tree)
    return tree_map(one, struct_tree, spec_tree)


def _placements_of(tree):
    return tree_map(lambda t: tuple(t.placements), tree)


def _opt_state(params_s, pspecs, mesh, master: bool):
    """The AdamW state of ``params_s`` (``adamw_init``'s tree: f32 m, v
    and master weights with the parameters' specs, an int32 step)."""
    state = {"m": _attach(params_s, pspecs, mesh, torch.float32),
             "v": _attach(params_s, pspecs, mesh, torch.float32),
             "step": meta_dtensor((), torch.int32, mesh, shr.Spec())}
    if master:
        state["master"] = _attach(params_s, pspecs, mesh, torch.float32)
    return state


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def build_cell(arch: str, shape: str, mesh, *, smoke: bool = False):
    """Returns ``(fn, args, meta, out_placements-or-None)``.  ``smoke``
    takes the architecture's ``smoke_config()`` at the same shape (the
    tests' size)."""
    mod = configs.get(arch)
    if mod.FAMILY == "lm":
        return _lm_cell(mod, shape, mesh, smoke)
    if mod.FAMILY == "gnn":
        return _gnn_cell(mod, shape, mesh, smoke)
    if mod.FAMILY == "recsys":
        return _mind_cell(mod, shape, mesh, smoke)
    raise ValueError(mod.FAMILY)


def _mesh_size(mesh) -> int:
    return shr.mesh_view(mesh).size


# --- LM ---------------------------------------------------------------------

def _lm_cell(mod, shape_name: str, mesh, smoke: bool):
    cfg = mod.smoke_config() if smoke else mod.make_config()
    sh = mod.SHAPES[shape_name]
    view = shr.mesh_view(mesh)
    dp = shr.dp_axes(mesh)
    dp_size = math.prod(view.shape[a] for a in dp) if dp else 1
    msz = view.shape.get("model", 1)
    vshard = "model" if cfg.vocab % msz == 0 else None
    pspecs = shr.lm_param_specs(cfg, mesh)
    params_s = _attach(eval_shape(transformer.init_params, cfg), pspecs,
                       mesh)
    act = shr.to_placements(shr.lm_act_spec(cfg, mesh), mesh)
    meta = {"arch": cfg.name, "shape": shape_name,
            "params": cfg.param_count(),
            "active_params": _lm_active_params(cfg)}

    if sh["kind"] == "train":
        opt_cfg = opt_mod.AdamWConfig()
        opt_s = _opt_state(params_s, pspecs, mesh, opt_cfg.master_weights)
        mb = getattr(mod, "MICROBATCHES", {}).get(shape_name, 1)
        step = train_loop.make_lm_train_step(cfg, opt_cfg, act,
                                             microbatches=mb)
        batch_s = {"tokens": meta_dtensor((sh["batch"], sh["seq"]),
                                          torch.int32, mesh,
                                          shr.Spec(dp, None))}
        meta["microbatches"] = mb
        meta["tokens"] = sh["batch"] * sh["seq"]
        # the reference's cost analysis counts scan/while bodies ONCE;
        # the layer stack and the microbatch accumulator are both scans
        meta["scan_mult"] = cfg.n_layers * mb
        out = (_placements_of(params_s), _placements_of(opt_s), None)
        return step, (params_s, opt_s, batch_s), meta, out

    if sh["kind"] == "prefill":
        chunks = getattr(mod, "PREFILL_CHUNKS", {}).get(shape_name, 1)

        def fn(params, tokens):
            return transformer.prefill(cfg, params, tokens, sh["seq"],
                                       chunks, act_placements=act)
        toks = meta_dtensor((sh["batch"], sh["seq"]), torch.int32, mesh,
                   shr.Spec(dp, None))
        meta["tokens"] = sh["batch"] * sh["seq"]
        meta["prefill_chunks"] = chunks
        meta["scan_mult"] = cfg.n_layers * chunks
        cspecs = shr.lm_cache_specs(cfg, mesh, shard_seq=True)
        out = (shr.tree_placements(mesh, cspecs),
               shr.to_placements(shr.Spec(dp, vshard), mesh))
        return fn, (params_s, toks), meta, out

    if sh["kind"] == "decode":
        cspecs = shr.lm_cache_specs(cfg, mesh, shard_seq=True,
                                    batch=sh["batch"])
        cache_s = _attach(eval_shape(
            lambda c, gen: transformer.init_cache(c, sh["batch"],
                                                  sh["cache"], "meta"),
            cfg), cspecs, mesh)

        def fn(params, cache, tok):
            return transformer.decode_step(cfg, params, cache, tok,
                                           act_placements=act)
        bd = dp if sh["batch"] % max(dp_size, 1) == 0 else None
        tok = meta_dtensor((sh["batch"],), torch.int32, mesh, shr.Spec(bd))
        meta["tokens"] = sh["batch"]
        meta["kv_cache"] = sh["cache"]
        meta["scan_mult"] = cfg.n_layers
        out = (shr.to_placements(shr.Spec(bd, vshard), mesh),
               _placements_of(cache_s))
        return fn, (params_s, cache_s, tok), meta, out

    raise ValueError(sh["kind"])


def _lm_active_params(cfg: transformer.LMConfig) -> int:
    """Per-token active parameters (MoE: shared + top_k experts)."""
    if not cfg.moe:
        return cfg.param_count()
    d = cfg.d_model
    nmat = 3 if cfg.mlp == "swiglu" else 2
    e_ff = nmat * d * cfg.d_ff
    attn = d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv * cfg.hd + \
        cfg.n_heads * cfg.hd * d
    per_layer = attn + (cfg.top_k + cfg.n_shared) * e_ff + d * cfg.n_experts
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d


# --- GNN --------------------------------------------------------------------

def _gnn_cell(mod, shape_name: str, mesh, smoke: bool):
    sh = mod.SHAPES[shape_name]
    ndev = _mesh_size(mesh)
    flat = tuple(shr.mesh_view(mesh).axis_names)
    model_name = mod.MODEL
    gmod, fwd = GNN_FWD[model_name]
    graph_level = sh["kind"] == "train_graphs"

    if sh["kind"] == "train_sampled":
        n_nodes, n_edges = sh["sub_nodes"], sh["sub_edges"]
    elif sh["kind"] == "train_graphs":
        n_nodes = sh["n_nodes"] * sh["batch"]
        n_edges = 2 * sh["n_edges"] * sh["batch"]
    else:
        n_nodes, n_edges = sh["n_nodes"], 2 * sh["n_edges"]
    n_pad = _pad_to(n_nodes, ndev)
    e_pad = _pad_to(n_edges, ndev)

    kw = {"remat": sh["kind"] != "train_graphs"}
    if n_nodes >= 1_000_000:
        # million-node full-batch cells compute in bf16 (fp32 loss/stats)
        kw["dtype"] = torch.bfloat16
    if model_name == "dimenet":
        kw["triplet_chunks"] = sh.get("dimenet_chunks", 1)
    dims = dict(d_in=sh["d_feat"], n_classes=sh["n_classes"],
                graph_level=graph_level)
    if smoke:
        base = mod.smoke_config()
        over = {"d_in": sh["d_feat"], "graph_level": graph_level, **kw}
        out_field = "n_out" if hasattr(base, "n_out") else "n_classes"
        over[out_field] = sh["n_classes"]
        cfg = dataclasses.replace(base, **over)
    else:
        cfg = mod.make_config(**dims, **kw)
    rep = shr.Spec()
    params_s = _attach(eval_shape(gmod.init_params, cfg), rep, mesh)
    opt_cfg = opt_mod.AdamWConfig(master_weights=False)
    opt_s = _opt_state(params_s, rep, mesh, False)

    n_graphs = sh.get("batch", 1)
    S = lambda shape, dt: meta_dtensor(shape, dt, mesh, shr.Spec(flat, *(
        [None] * (len(shape) - 1))))
    gb_s = gnn_common.GraphBatch(
        node_feat=S((n_pad, sh["d_feat"]), torch.float32),
        senders=S((e_pad,), torch.int32),
        receivers=S((e_pad,), torch.int32),
        edge_feat=None,
        graph_ids=S((n_pad,), torch.int32),
        n_graphs=n_graphs,
        labels=(meta_dtensor((n_graphs,), torch.float32, mesh, rep)
                if graph_level else S((n_pad,), torch.int32)),
        edge_mask=S((e_pad,), torch.bool),
        shard_ctx=(mesh, flat),
    )
    if model_name == "dimenet":
        t_pad = _pad_to(e_pad * sh["triplet_cap"],
                        ndev * max(sh.get("dimenet_chunks", 1), 1))
        gb_s = gb_s._replace(
            pos=S((n_pad, 3), torch.float32),
            triplet_kj=S((t_pad,), torch.int32),
            triplet_ji=S((t_pad,), torch.int32),
            triplet_mask=S((t_pad,), torch.bool))

    if graph_level:
        step = train_loop.make_gnn_regression_step(fwd, cfg, opt_cfg)
    else:
        step = train_loop.make_gnn_train_step(fwd, cfg, opt_cfg)
    # scan trip products per model: gin/pna scan n_layers-1 (layer0 is
    # unrolled), gatedgcn scans all layers, dimenet scans n_blocks blocks
    # each containing a triplet-chunk scan
    chunks = max(kw.get("triplet_chunks", 1), 1)
    if model_name == "dimenet":
        scan_mult = cfg.n_blocks * chunks
    elif model_name == "gatedgcn":
        scan_mult = cfg.n_layers
    else:
        scan_mult = max(cfg.n_layers - 1, 1)
    meta = {"arch": cfg.name, "shape": shape_name, "nodes": n_pad,
            "edges": e_pad, "scan_mult": scan_mult,
            "params": int(sum(math.prod(p.shape)
                              for p in leaves(params_s)))}
    out = (_placements_of(params_s), _placements_of(opt_s), None)
    return step, (params_s, opt_s, gb_s), meta, out


# --- recsys (MIND) ----------------------------------------------------------

def _mind_cell(mod, shape_name: str, mesh, smoke: bool):
    cfg = mod.smoke_config() if smoke else mod.make_config()
    sh = mod.SHAPES[shape_name]
    view = shr.mesh_view(mesh)
    dp = shr.dp_axes(mesh)
    flat = tuple(view.axis_names)
    pspecs = shr.mind_param_specs(mesh)
    params_s = _attach(eval_shape(mind_mod.init_params, cfg), pspecs, mesh)
    meta = {"arch": cfg.name, "shape": shape_name,
            "params": cfg.n_items * cfg.embed_dim + cfg.embed_dim ** 2}

    dp_size = math.prod(view.shape[a] for a in dp) if dp else 1

    def batch_structs(b):
        bd = dp if b % max(dp_size, 1) == 0 else None
        return {"hist": meta_dtensor((b, cfg.hist_len), torch.int32, mesh,
                            shr.Spec(bd, None)),
                "hist_mask": meta_dtensor((b, cfg.hist_len), torch.bool, mesh,
                                 shr.Spec(bd, None)),
                "target": meta_dtensor((b,), torch.int32, mesh, shr.Spec(bd))}

    if sh["kind"] == "train":
        opt_cfg = opt_mod.AdamWConfig(master_weights=False)
        opt_s = _opt_state(params_s, pspecs, mesh, False)
        mb = getattr(mod, "MICROBATCHES", {}).get(shape_name, 1)
        step = train_loop.make_mind_train_step(cfg, opt_cfg, microbatches=mb)
        meta["microbatches"] = mb
        meta["scan_mult"] = mb
        out = (_placements_of(params_s), _placements_of(opt_s), None)
        return step, (params_s, opt_s, batch_structs(sh["batch"])), meta, out

    if sh["kind"] == "serve":
        def fn(params, batch):
            return mind_mod.serve_interests(cfg, params, batch)
        return fn, (params_s, batch_structs(sh["batch"])), meta, None

    if sh["kind"] == "retrieval":
        def fn(params, batch, cand_ids):
            ints = mind_mod.serve_interests(cfg, params, batch)
            return mind_mod.retrieval_scores(cfg, params, ints[0], cand_ids)
        ndev = _mesh_size(mesh)
        n_cand = -(-sh["n_candidates"] // ndev) * ndev  # pad to mesh size
        cand = meta_dtensor((n_cand,), torch.int32, mesh, shr.Spec(flat))
        return fn, (params_s, batch_structs(sh["batch"]), cand), meta, None

    raise ValueError(sh["kind"])
