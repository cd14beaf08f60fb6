"""Port parity: the sharded v2 and v3 engines over 2 and 4 gloo ranks
(``repro_torch.core.distributed``), in child processes.

Each rank is a child process with a gloo group over a FileStore under
``tmp_path``; every rank must return the same results, and those must
equal the port's single-device solves bitwise (``dist``, ``parent``, the
logical counters):

* v2 and v3 (default capacity, and a capacity of 8 that takes both the
  compact and the dense exchange) on both backends, tree solves, and
  ``fused_rounds=4`` on ``blocked`` (grouped complete rounds);
* ALT p2p (the ALT contract against the unpruned query, ``n_relax`` and
  ``n_pruned`` against the single-device ALT query) and knear;
* ``sssp_distributed_batch`` at v1, v2 and v3 with per-slot knear k.

Bucket fusion (``segment_min`` with ``fused_rounds=4``) relaxes more than
the single-device engine by design, so it is held against the reference
at the same number of shards instead: a child process runs the JAX
engines on ``P`` forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=P``), as
``tests/test_distributed_sssp.py`` does, on one small graph.
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import landmarks as tlm
from repro_torch.core.sssp import sssp
from repro_torch.serve.queries import reconstruct_path
from test_torch_distributed import GRAPHS, _assert_same, _graph, _port_out
from release_xla import release_compiled  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT_S = 240
# (version, backend, fused_rounds, capacity) of the tree solves
TREES = [(v, b, 0, c) for v, c in (("v2", None), ("v3", None), ("v3", 8))
         for b in ("segment_min", "blocked")] \
    + [("v2", "blocked", 4, None), ("v3", "blocked", 4, 8)]
# (version, backend) of the queries
QUERIES = [("v2", "blocked"), ("v3", "segment_min")]
BATCH_KS = [3, 12, 1, 30]
FUSION_GRAPH = "kron8"


def _tree_key(version, backend, fused, capacity):
    return f"{version}/{backend}/f{fused}/c{capacity}"


_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as tdist
from repro_torch.core.distributed import (EXCHANGES, shard_blocked,
                                          shard_graph, sssp_distributed,
                                          sssp_distributed_batch)
from repro_torch.core.landmarks import build_landmarks, hop_bfs
from repro_torch.core.sssp import metrics_dict
from repro_torch.data import generators
from repro_torch.serve.queries import reconstruct_path
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
spec = json.loads(sys.argv[5])
torch.set_num_threads(1)
tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                         rank=rank, world_size=world)

def full(d, p, m, n):
    return dict(dist=d[:n].view(torch.int32).tolist(),
                parent=p[:n].tolist(), metrics=metrics_dict(m))

res = {}
for name, (maker, kw) in spec["graphs"].items():
    g = getattr(generators, maker)(**kw)
    src = int(np.argmax(g.deg))
    sg = shard_graph(g, world)
    layout = {"blocked": shard_blocked(sg, block_v=64, tile_e=64)}
    lay = lambda backend: layout if backend == "blocked" else {}
    for version, backend, fused, cap in spec["trees"]:
        EXCHANGES.reset()
        d, p, m = sssp_distributed(sg, src, version=version, backend=backend,
                                   fused_rounds=fused, capacity=cap,
                                   device="cpu", **lay(backend))
        r = full(d, p, m, g.n)
        r["exchanges"] = EXCHANGES.as_dict()
        res[f"{name}/{version}/{backend}/f{fused}/c{cap}"] = r
    tgt = int(np.argmax(hop_bfs(g.row_ptr.astype(np.int64),
                                g.dst.astype(np.int64), g.n, src)))
    lm = build_landmarks(g, 4, device="cpu")
    for version, backend in spec["queries"]:
        d, p, m = sssp_distributed(sg, src, version=version, backend=backend,
                                   goal="p2p", goal_param=tgt, landmarks=lm,
                                   device="cpu", **lay(backend))
        res[f"{name}/{version}/{backend}/p2p-alt"] = dict(
            target=tgt, dist_t=int(d[tgt:tgt + 1].view(torch.int32)),
            path=reconstruct_path(p.numpy(), src, tgt),
            metrics=metrics_dict(m))
        d, p, m = sssp_distributed(sg, src, version=version, backend=backend,
                                   goal="knear", goal_param=12,
                                   device="cpu", **lay(backend))
        res[f"{name}/{version}/{backend}/knear"] = full(d, p, m, g.n)
    srcs = spec["batch_sources"][name]
    for version in ("v1", "v2", "v3"):
        backend = "blocked" if version == "v2" else "segment_min"
        d, p, m = sssp_distributed_batch(
            sg, srcs, version=version, backend=backend, goal="knear",
            goal_params=spec["batch_ks"], device="cpu", **lay(backend))
        res[f"{name}/{version}/batch"] = [
            full(d[i], p[i], type(m)(*(x[i] for x in m)), g.n)
            for i in range(len(srcs))]
    if name == spec["fusion_graph"]:
        for version in ("v2", "v3"):
            d, p, m = sssp_distributed(sg, src, version=version,
                                       backend="segment_min", fused_rounds=4,
                                       device="cpu")
            res[f"{name}/{version}/fusion"] = full(d, p, m, g.n)
tdist.destroy_process_group()
with open(out + "." + str(rank), "w") as f:
    json.dump(res, f)
"""

_REF_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh
import repro.data.generators as rgen
from repro.core.distributed import shard_graph, sssp_distributed
maker, kw = json.loads(sys.argv[1])
g = getattr(rgen, maker)(**kw)
src = int(np.argmax(g.deg))
res = {}
for p in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:p]), ("graph",))
    for version in ("v2", "v3"):
        d, par, m = sssp_distributed(shard_graph(g, p), src, mesh,
                                     ("graph",), version=version,
                                     backend="segment_min", fused_rounds=4)
        res[f"{p}/{version}"] = dict(
            dist=np.asarray(d)[:g.n].view(np.int32).tolist(),
            parent=np.asarray(par)[:g.n].tolist(),
            metrics={f: float(getattr(m, f)) for f in m._fields})
print(json.dumps(res))
"""


def _wait(procs, what):
    """Every child's stdout; fails the test if one errs or outlives the
    timeout (it is then killed)."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    outs = []
    try:
        for i, proc in enumerate(procs):
            try:
                out, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{what} {i} did not finish in "
                            f"{CHILD_TIMEOUT_S} s")
            assert proc.returncode == 0, f"{what} {i}: {err[-3000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _spec() -> dict:
    return dict(graphs=GRAPHS, trees=TREES, queries=QUERIES,
                batch_sources={name: _batch_sources(name) for name in GRAPHS},
                batch_ks=BATCH_KS, fusion_graph=FUSION_GRAPH)


def _run_ranks(world: int, tmp: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = tmp / "result"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), str(world),
         str(tmp / "store"), str(out), json.dumps(_spec())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    _wait(procs, f"rank of {world}")
    return [json.loads(Path(f"{out}.{rank}").read_text())
            for rank in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def results(world):
        if world not in cache:
            cache[world] = _run_ranks(world,
                                      tmp_path_factory.mktemp(f"p{world}"))
        return cache[world]
    return results


@pytest.fixture(scope="module")
def reference_fusion():
    """The reference's v2 and v3 bucket fusion at P = 2 and 4 on
    ``FUSION_GRAPH``, from one child with 4 forced host devices."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_CHILD, json.dumps(GRAPHS[FUSION_GRAPH])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    (out,) = _wait([proc], "reference child")
    return json.loads(out.strip().splitlines()[-1])


def _same_on_every_rank(every, key):
    got = every[0][key]
    for rank, other in enumerate(every[1:], 1):
        assert other[key] == got, f"rank {rank} differs on {key}"
    return got


def _as_out(r):
    return (np.asarray(r["dist"], np.int32).view(np.float32),
            np.asarray(r["parent"], np.int32), r["metrics"])


@functools.lru_cache(maxsize=None)
def _batch_sources(name):
    rg, _ = _graph(name)
    rng = np.random.default_rng(11)
    return [int(np.argmax(rg.deg))] + [
        int(x) for x in rng.choice(rg.n, 3, replace=False)]


@functools.lru_cache(maxsize=None)
def _single(name, goal="tree", gp=None, source=None):
    _, hg = _graph(name)
    s = int(np.argmax(hg.deg)) if source is None else source
    return _port_out(sssp(hg, s, goal=goal, goal_param=gp, device="cpu"))


@pytest.mark.parametrize("tree", TREES, ids=[_tree_key(*t) for t in TREES])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("world", [2, 4])
def test_v2_v3_over_ranks_match_single_device(world, name, tree, ranks):
    got = _same_on_every_rank(ranks(world), f"{name}/{_tree_key(*tree)}")
    _assert_same(_single(name), _as_out(got), f"P={world} {name} {tree}")
    version, backend, fused, cap = tree
    ex = got["exchanges"]
    if version == "v2":
        assert ex["compact"] == 0 and ex["dense"] > 0
    elif cap == 8:
        # wide rounds overflow 8 candidates a block, narrow ones do not
        assert ex["compact"] > 0 and ex["dense"] > 0, ex
    else:
        assert ex["compact"] > 0, ex
    m = got["metrics"]
    if backend == "blocked":
        assert 0 < m["n_tiles_scanned"] < m["n_tiles_dense"]
        assert m["n_invocations"] > 0 and m["n_invocations"] % world == 0


@pytest.mark.parametrize("query", ["p2p-alt", "knear"])
@pytest.mark.parametrize("engine", QUERIES, ids=["/".join(q)
                                                 for q in QUERIES])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("world", [2, 4])
def test_queries_over_ranks_match_single_device(world, name, engine, query,
                                                ranks):
    key = f"{name}/{'/'.join(engine)}/{query}"
    got = _same_on_every_rank(ranks(world), key)
    what = f"P={world} {key}"
    if query == "knear":
        _assert_same(_single(name, "knear", 12), _as_out(got), what)
        return
    _, hg = _graph(name)
    s, t = int(np.argmax(hg.deg)), got["target"]
    lm = tlm.build_landmarks(hg, 4, device="cpu")
    alt = _port_out(sssp(hg, s, goal="p2p", goal_param=t, landmarks=lm,
                         device="cpu"))
    plain = _single(name, "p2p", t)
    assert np.int32(got["dist_t"]).view(np.float32).tobytes() == \
        plain[0][t].tobytes(), what
    assert got["path"] == reconstruct_path(plain[1], s, t), what
    for f in ("n_relax", "n_pruned"):
        assert got["metrics"][f] == alt[2][f], (what, f)
    assert got["metrics"]["n_pruned"] > 0, what


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("world", [2, 4])
def test_batch_over_ranks_slots_match_single_device(world, name, version,
                                                    ranks):
    slots = _same_on_every_rank(ranks(world), f"{name}/{version}/batch")
    for i, (s, k) in enumerate(zip(_batch_sources(name), BATCH_KS)):
        _assert_same(_single(name, "knear", k, s), _as_out(slots[i]),
                     f"P={world} {name} {version} batch slot {i}")


@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("world", [2, 4])
def test_bucket_fusion_matches_reference_at_same_ranks(world, version, ranks,
                                                       reference_fusion):
    got = _same_on_every_rank(ranks(world),
                              f"{FUSION_GRAPH}/{version}/fusion")
    want = reference_fusion[f"{world}/{version}"]
    want = (*_as_out(want)[:2], {f: int(v) if not f.startswith("n_tiles")
                                 and f != "n_invocations" else v
                                 for f, v in want["metrics"].items()})
    _assert_same(want, _as_out(got), f"P={world} {version} bucket fusion")
    # the local waves relax more than the single-device engine
    assert got["metrics"]["n_trav"] != _single(FUSION_GRAPH)[2]["n_trav"]
