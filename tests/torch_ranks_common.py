"""The gloo rank work of the CPU tests, run once a session for each world
size and read by the files that hold it against the reference or the
one-device port (``tests/test_torch_compress.py``,
``tests/test_torch_gnn_sharded.py``, ``tests/test_torch_lm_sharded.py``).

Each rank is a child process that starts a gloo group over a
``FileStore``, runs :func:`rank_work` and writes its results (a dict of
arrays, keys prefixed by what made them) to an ``.npz``.
:func:`shared_ranks` runs the children once: under xdist the first
worker to ask does it under a file lock in the run's common temporary
directory, and the others read its files.  This module imports neither
jax nor the reference: the children import it.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT_S = 180

# --- the cases (numpy inputs from seeds) -------------------------------------


def compress_case(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return rng.normal(0, scale, shape).astype(np.float32)


# the compressed tree's leaves: name -> (seed of rank 0, shape, scale)
TREE = {"tw": (300, (4, 9), 0.1), "tb0": (400, (5,), 0.1),
        "tb1": (500, (2, 2), 3.0)}

N, M, F = 32, 48, 5                   # GNN: nodes, edges, features
GNN_OPS = ("gather", "sum", "max", "min")
# the GNN ops' meshes at each world size: 1-D, and (2, 2) at 4 ranks
GNN_MESHES = {2: ("2",), 4: ("4", "2x2")}
LR = 1e-3


def gnn_arrays():
    rng = np.random.default_rng(7)
    return {"table": rng.normal(size=(N, F)).astype(np.float32),
            "vals": rng.normal(size=(M, F)).astype(np.float32),
            "idx": rng.integers(0, N - 4, M).astype(np.int64),
            "w_m": rng.normal(size=(M, F)).astype(np.float32),
            "w_n": rng.normal(size=(N, F)).astype(np.float32)}


def gin_case():
    """The smoke GIN and a 32-node graph (numpy)."""
    from repro_torch.models.gnn import gin
    cfg = gin.GINConfig(name="gin-smoke", n_layers=2, d_hidden=16, d_in=8,
                        n_classes=4)
    rng = np.random.default_rng(3)
    g = {"node_feat": rng.normal(size=(32, 8)).astype(np.float32),
         "senders": rng.integers(0, 32, 64).astype(np.int64),
         "receivers": rng.integers(0, 32, 64).astype(np.int64),
         "graph_ids": np.zeros(32, np.int64),
         "labels": rng.integers(0, 4, 32).astype(np.int64),
         "edge_mask": rng.random(64) < 0.9}
    return cfg, g


# the LM cases on a (2, 2) mesh: a dense model with its sequence split
# over ``model`` (``seq_shard``), an expert-parallel MoE (8 experts) and
# the expert-TP fallback (5 experts on a 2-wide axis)
LM_CASES = {"qwen3-0.6b": {"seq_shard": True}, "deepseek-moe-16b": {},
            "granite-moe-3b-a800m": {}}
LM_BATCH, LM_PROMPT, LM_CACHE, LM_STEPS = 4, 6, 8, 2


def lm_case(arch: str):
    """The arch's smoke config (f32) with a capacity that drops no token
    at either token count (a rank routes its own rows, so its capacity
    comes from its count, as expert-parallel layers do), its seeded
    parameters, the prompts ``[B, S]`` and ``LM_STEPS`` decode tokens
    ``[steps, B]``."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              capacity_factor=2.0, **LM_CASES[arch])
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    steps = rng.integers(0, cfg.vocab, (LM_STEPS, LM_BATCH))
    return cfg, params, tokens.astype(np.int64), steps.astype(np.int64)


# --- the work of one rank ----------------------------------------------------

def _chunk(x, rank, world):
    return x[rank * len(x) // world:(rank + 1) * len(x) // world]


def _compress_work(rank, world, res):
    import torch
    from repro_torch.parallel.compress import compressed_psum, \
        compressed_tree_psum
    t = lambda *a: torch.from_numpy(compress_case(*a))
    g, e = t(100 + rank, (257,)), t(200 + rank, (257,), 1e-3)
    res["mean"], res["err"] = (x.numpy() for x in compressed_psum(g, None, e))
    res["mean0"], res["err0"] = (x.numpy() for x in compressed_psum(g))
    tree = {"w": t(TREE["tw"][0] + rank, *TREE["tw"][1:]),
            "b": [t(TREE[k][0] + rank, *TREE[k][1:]) for k in ("tb0", "tb1")]}
    m, errs = compressed_tree_psum(tree, None)
    res["tw"], res["tb0"], res["tb1"] = m["w"], m["b"][0], m["b"][1]
    res["ew"] = errs["w"]
    res["tw2"] = compressed_tree_psum(tree, None, errs)[0]["w"]


def _gnn_ops_work(rank, world, res):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models.gnn import sharded_ops as so
    a = gnn_arrays()
    chunk = lambda x: _chunk(x, rank, world)
    fns = {"gather": so.gather0, "sum": so.scatter_sum0,
           "max": so.scatter_max0, "min": so.scatter_min0}
    for spec in GNN_MESHES[world]:
        shape = tuple(int(x) for x in spec.split("x"))
        names = ("data", "model")[:len(shape)]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        ctx = (mesh, names)
        dt = lambda t: DTensor.from_local(t, mesh, [Shard(0)] * len(shape),
                                          run_check=False)
        idx = torch.from_numpy(chunk(a["idx"]))
        for op, fn in fns.items():
            src = a["table"] if op == "gather" else a["vals"]
            w = a["w_m"] if op == "gather" else a["w_n"]
            local = torch.from_numpy(chunk(src)).requires_grad_()
            args = (dt(local), dt(idx)) if op == "gather" else \
                (dt(local), dt(idx), N)
            y = fn(ctx, *args)
            assert isinstance(y, DTensor) and tuple(y.shape) == \
                (M if op == "gather" else N, F)
            (y.to_local() * torch.from_numpy(chunk(w))).sum().backward()
            key = spec + "/" + op
            res[key] = y.full_tensor().detach().numpy()
            res[key + "_grad"] = local.grad.numpy()
            plain = fn(ctx, torch.from_numpy(chunk(src)), idx, *args[2:])
            res[key + "_plain"] = plain.detach().numpy()


def _gin_work(rank, world, res):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.gnn import common, gin
    from repro_torch.parallel.dtensor_ops import replicate_fallback
    from repro_torch.train import loop, optimizer as opt
    from repro_torch.train.tree import leaves, tree_map
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg, g = gin_case()
    rep = lambda t: DTensor.from_local(t, mesh, [Replicate()] * 2,
                                       run_check=False)
    params = tree_map(rep, gin.init_params(cfg,
                                           torch.Generator().manual_seed(0)))
    gb = common.GraphBatch(
        edge_feat=None, shard_ctx=(mesh, ("data", "model")),
        **{k: DTensor.from_local(torch.from_numpy(_chunk(v, rank, world)),
                                 mesh, [Shard(0)] * 2, run_check=False)
           for k, v in g.items()})
    ocfg = opt.AdamWConfig(lr=LR, master_weights=False, warmup_steps=0)
    loss_fn = lambda p, b: (lambda l: (l, {"loss": l}))(
        common.node_ce_loss(gin.forward(cfg, p, b), b.labels))
    with replicate_fallback():
        loss, _, grads = loop.value_and_grad(loss_fn, params, gb)
        new, _, _ = loop.make_gnn_train_step(gin.forward, cfg, ocfg)(
            params, opt.adamw_init(params, ocfg), gb)
    res["loss"] = loss.full_tensor().numpy()
    for i, t in enumerate(leaves(grads)):
        res[f"g{i}"] = t.full_tensor().numpy()
    for i, t in enumerate(leaves(new)):
        res[f"p{i}"] = t.full_tensor().numpy()


def _lm_work(rank, world, res):
    """Each LM case on a (2, 2) mesh with the rules' placements: the
    forward's logits and aux loss, then prefill and ``LM_STEPS`` decode
    steps over the cache with ``lm_cache_specs(shard_seq=True)``
    (batch over ``data``, positions over ``model``)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shr
    from repro_torch.parallel.dtensor_ops import replicate_fallback
    from repro_torch.train.tree import tree_map
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    put = lambda t, spec: distribute_tensor(
        t, mesh, shr.to_placements(spec, mesh), src_data_rank=None)
    for arch in LM_CASES:
        cfg, params, tokens, steps = lm_case(arch)
        dparams = tree_map(put, params, shr.lm_param_specs(cfg, mesh))
        act = shr.to_placements(shr.lm_act_spec(cfg, mesh), mesh)
        tok = put(torch.from_numpy(tokens), shr.Spec(("data",), None))
        cspecs = shr.lm_cache_specs(cfg, mesh, shard_seq=True,
                                    batch=LM_BATCH)
        out = lambda t: np.asarray(t.full_tensor() if hasattr(
            t, "full_tensor") else t)
        with torch.no_grad(), replicate_fallback():
            logits, aux = T.forward(cfg, dparams, tok, attn="plain",
                                    act_placements=act)
            res[f"{arch}/logits"], res[f"{arch}/aux"] = out(logits), out(aux)
            cache, last = T.prefill(cfg, dparams, tok, LM_CACHE,
                                    attn="plain", act_placements=act)
            cache = {k: v.redistribute(
                mesh, shr.to_placements(cspecs[k], mesh))
                for k, v in cache.items()}
            res[f"{arch}/prefill"] = out(last)
            for j, st in enumerate(steps):
                lg, cache = T.decode_step(
                    cfg, dparams, cache, put(torch.from_numpy(st),
                                             shr.Spec(("data",))),
                    attn="plain", act_placements=act)
                res[f"{arch}/decode{j}"] = out(lg)
            for k in ("k", "v", "pos"):
                res[f"{arch}/cache_{k}"] = out(cache[k])


def rank_work(rank: int, world: int) -> dict:
    """Every piece of rank work at this world size, keys prefixed."""
    res = {}
    parts = [("compress", _compress_work), ("gnn", _gnn_ops_work)]
    if world == 4:
        parts += [("gin", _gin_work), ("lm", _lm_work)]
    for prefix, work in parts:
        out = {}
        work(rank, world, out)
        res.update({f"{prefix}/{k}": np.asarray(v) for k, v in out.items()})
    return res


def child_main(argv) -> None:
    import torch
    import torch.distributed as tdist
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    res = rank_work(rank, world)
    tdist.destroy_process_group()
    np.savez(f"{out}.{rank}.npz", **res)


# --- running the ranks ---------------------------------------------------------

def run_ranks(world: int, tmp: Path) -> None:
    """Run :func:`rank_work` as ``world`` gloo ranks, writing
    ``tmp/result.<rank>.npz``; fails the test if a child errs or
    outlives its timeout (it is then killed)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(Path(__file__).resolve().parent)]))
    code = "import sys, torch_ranks_common as c; c.child_main(sys.argv[1:])"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), str(world),
         str(tmp / "store"), str(tmp / "result")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for rank, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {world} did not finish in "
                            f"{CHILD_TIMEOUT_S} s")
            assert proc.returncode == 0, f"rank {rank}: {err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


_LOADED = {}


def shared_ranks(world: int, tmp_path_factory, worker_id: str,
                 prefix: str) -> list:
    """Every rank's results at ``world`` whose keys start with
    ``prefix/`` (prefix taken off): the ranks run once a session."""
    if world not in _LOADED:
        from filelock import FileLock
        root = tmp_path_factory.getbasetemp()
        if worker_id != "master":        # the run's directory, shared
            root = root.parent
        d = root / f"torch_ranks_{world}"
        with FileLock(str(d) + ".lock"):
            if not (d / "done").exists():
                d.mkdir(exist_ok=True)
                run_ranks(world, d)
                (d / "done").write_text("ok")
        _LOADED[world] = [dict(np.load(d / f"result.{rank}.npz"))
                          for rank in range(world)]
    cut = len(prefix) + 1
    return [{k[cut:]: v for k, v in r.items() if k.startswith(prefix + "/")}
            for r in _LOADED[world]]
