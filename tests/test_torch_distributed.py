"""Port parity: the sharded v1 engine (``repro_torch.core.distributed``).

Both packages run on byte-identical inputs: the graphs are the
reference's, carried into the port with ``convert.from_reference``, and
the mid-solve states are made with numpy.  Everything is bitwise:

* the shard layouts (``shard_graph``, ``shard_blocked``,
  ``slice_for_shard``) against the reference's, at P = 1, 2 and 4;
* the partials kernel's plain version against the reference's Pallas
  kernel (interpret mode) and its jnp twin, on every shard of P = 4,
  without and with the ALT cut;
* the v1 engine at one rank (an in-process gloo group) against the
  reference's v1 on a one-device mesh: tree solves and the p2p (with and
  without landmarks), bounded and knear queries;
* the v1 engine at 2 and 4 gloo ranks (child processes, a FileStore
  under ``tmp_path``) against the single-device solves and queries of
  both packages;
* what earlier slices left raising (v2/v3 and their knobs, batches,
  repairs, the adaptive policy, ``config=``), at one rank against the
  reference.  ``tests/test_torch_distributed_v2.py`` and
  ``tests/test_torch_distributed_v2_ranks.py`` hold v2 and v3 in full.
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import repro.core.graph as rgraph
import repro.data.generators as rgen
from repro.core import distributed as rdist
from repro.core import landmarks as rlm
from repro.core.config import ConfigError as RefConfigError
from repro.core.config import EngineConfig as RefConfig
from repro.core.sssp import sssp as ref_sssp
from repro.kernels.edge_relax import ops as rops
from repro_torch import convert
from repro_torch.core import distributed as tdistributed
from repro_torch.core import graph as tgraph
from repro_torch.core import landmarks as tlm
from repro_torch.core import relax as trelax
from repro_torch.core.config import ConfigError, EngineConfig
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
from repro_torch.kernels.edge_relax import ops
from repro_torch.serve.queries import reconstruct_path
from test_torch_alt_p2p import lm_arrays
from test_torch_graph import SLAB_FIELDS, ref_arrays
from release_xla import release_compiled  # noqa: F401

GEOM = dict(block_v=64, tile_e=64)
GRAPHS = {"kron8": ("kronecker", dict(scale=8, edge_factor=8, seed=1)),
          "road16": ("road_grid", dict(side=16, seed=2))}
SRC = Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are many tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _graph(name):
    maker, kwargs = GRAPHS[name]
    rg = getattr(rgen, maker)(**kwargs)
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


def _sharded_arrays(rsg) -> dict:
    return {f: np.asarray(getattr(rsg, f)) for f in rsg._fields}


def _blocked_arrays(rb, rm) -> dict:
    out = {f: np.asarray(getattr(rb, f)) for f in rb._fields}
    for f in ("block_v", "tile_e", "n_src_blocks", "n_dst_blocks",
              "dense_grid_tiles"):
        out[f] = getattr(rm, f)
    return out


@functools.lru_cache(maxsize=None)
def _layouts(name, p):
    """Both packages' sharded graph and blocked layout, the port's built
    by its own code, plus the reference's carried over."""
    rg, hg = _graph(name)
    rsg = rdist.shard_graph(rg, p)
    rb, rm = rdist.shard_blocked(rsg, **GEOM)
    tsg = tdistributed.shard_graph(hg, p)
    return (rsg, (rb, rm), tsg, tdistributed.shard_blocked(tsg, **GEOM),
            convert.from_reference(_blocked_arrays(rb, rm), "cpu"))


# ---------------------------------------------------------------------------
# (a) layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_shard_layouts_match_reference(name, p):
    rsg, (rb, rm), tsg, (tb, tm), carried = _layouts(name, p)
    for f in ("src", "dst", "w", "deg", "rtow"):
        np.testing.assert_array_equal(np.asarray(getattr(rsg, f)),
                                      getattr(tsg, f), err_msg=f)
    assert (tsg.n_edges2, tsg.n_true) == (int(rsg.n_edges2),
                                          int(rsg.n_true))
    carried_sg = convert.from_reference(_sharded_arrays(rsg), "cpu")
    for f in tsg._fields:
        np.testing.assert_array_equal(getattr(carried_sg, f),
                                      getattr(tsg, f), err_msg=f)
    for f in ("block_v", "tile_e", "n_src_blocks", "n_dst_blocks",
              "dense_grid_tiles"):
        assert getattr(tm, f) == getattr(rm, f), f
    # the reference's [P, S, NT*tile_e] stack, block-local source ids
    offs = (np.arange(rm.n_src_blocks) * rm.block_v)[None, :, None]
    np.testing.assert_array_equal(
        (np.asarray(rb.src_local) + offs).reshape(p, -1), tb.src)
    for f in ("dst", "w", "tile_dst", "tile_first", "bucket_nonempty"):
        want = np.asarray(getattr(rb, f))
        np.testing.assert_array_equal(want.reshape(getattr(tb, f).shape),
                                      getattr(tb, f), err_msg=f)
    assert carried[1] == tm
    for f in tb._fields:
        np.testing.assert_array_equal(getattr(carried[0], f),
                                      getattr(tb, f), err_msg=f)
    # one shard at a time, without uniform tile padding
    rg, hg = _graph(name)
    for q in range(p):
        rs = rgraph.slice_for_shard(rg, q, p, **GEOM)
        ts = tgraph.slice_for_shard(hg, q, p, **GEOM)
        for f in ("n", "block_v", "n_blocks", "n_dst_blocks", "src_base",
                  "tile_e", "dense_grid_tiles"):
            assert getattr(ts, f) == getattr(rs, f), f
        np.testing.assert_array_equal(np.asarray(rs.deg), ts.deg)
        for b, slab in enumerate(rs.slabs):
            mine = ts.slab(b)
            for f in SLAB_FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(slab, f)),
                                              getattr(mine, f),
                                              err_msg=f"{q}/{b}/{f}")


# ---------------------------------------------------------------------------
# (b) the partials kernel's plain version
# ---------------------------------------------------------------------------

def _shard_state(n_src, n_pad, seed):
    """A mid-solve state of one shard's sources: some settled, half of
    them on a path, the rest unreached; parents are global ids."""
    rng = np.random.default_rng(seed)
    dist = np.full(n_src, np.inf, np.float32)
    seeds = rng.choice(n_src, n_src // 3, replace=False)
    dist[seeds] = rng.uniform(0.0, 3.0, seeds.size).astype(np.float32)
    parent = np.full(n_src, -1, np.int32)
    parent[seeds] = rng.integers(0, n_pad, seeds.size)
    paths = np.zeros(n_src, bool)
    paths[seeds[: seeds.size // 2]] = True
    return dist, paths, parent


def _partials_inputs(name, q, seed):
    """Shard ``q`` of the P = 4 layouts at a seeded mid-solve state: the
    reference's call arguments (its engine adds the slab offsets per
    call), the port's, and the keyword arguments of each."""
    _, (rb, rm), _, _, (tb, tm) = _layouts(name, 4)
    block = tm.n_src_blocks * tm.block_v
    n_out = tm.n_dst_blocks * tm.block_v
    dist, paths, parent = _shard_state(block, n_out, seed=seed)
    offs = (np.arange(rm.n_src_blocks, dtype=np.int32)
            * rm.block_v)[:, None]
    slabs = [jnp.asarray(np.asarray(getattr(rb, f))[q]).reshape(-1)
             for f in ("dst", "w", "tile_dst", "tile_first")]
    src = (jnp.asarray(rb.src_local[q]) + offs).reshape(-1)
    ref_args = (jnp.asarray(dist), jnp.asarray(paths), jnp.asarray(parent),
                src, *slabs)
    t = lambda a: torch.from_numpy(np.array(a))
    port_args = (t(dist), t(paths), t(parent), t(tb.src[q]), t(tb.dst[q]),
                 t(tb.w[q]), t(tb.tile_first[q]))
    return (ref_args, dict(block_v=rm.block_v, tile_e=rm.tile_e,
                           n_dst_blocks=rm.n_dst_blocks),
            port_args, dict(tile_e=tm.tile_e, n_out=n_out))


def _assert_partials_equal(refs, got, what):
    val, win, cnt = got
    assert cnt.dtype == torch.int32 and win.dtype == torch.int32
    for r in refs:
        np.testing.assert_array_equal(np.asarray(r[0]).view(np.int32),
                                      val.numpy().view(np.int32),
                                      err_msg=what)
        np.testing.assert_array_equal(np.asarray(r[1]), win.numpy(),
                                      err_msg=what)
        np.testing.assert_array_equal(np.asarray(r[2]), cnt.numpy(),
                                      err_msg=what)


@pytest.mark.parametrize("window", [(0.0, 1.5), (0.5, 2.5)],
                         ids=["lb0", "mid"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_partials_plain_version_matches_reference(name, window):
    lb, ub = np.float32(window[0]), np.float32(window[1])
    t = lambda a: torch.from_numpy(np.array(a))
    for q in range(4):
        ref_args, ref_kw, args, kw = _partials_inputs(name, q, seed=q)
        refs = [rops.relax_partials(*ref_args, lb, ub, **ref_kw,
                                    use_kernel=use_kernel)
                for use_kernel in (True, False)]
        got = ops.relax_partials(*args, t(lb), t(ub), **kw)
        _assert_partials_equal(refs, got, f"shard {q}")
        assert list(ops.PARTIAL_COUNTERS) == list(rops.PARTIAL_COUNTERS)


ALT_BOUNDS = ("inf", "below-all", "tie", "between")


def _alt_case(args, lb, ub, n_out, bound, seed):
    """A seeded ``alt_lb`` over ``n_out`` destinations (+inf on 15% of
    them) and the prune bound of case ``bound``, from the shard's
    in-window candidates: +inf, below every ``cand + alt_lb[dst]``,
    exactly at one of them (a tie, which ``<=`` keeps), or at their
    median."""
    rng = np.random.default_rng(seed)
    alt_lb = (rng.integers(0, 12, n_out) / 8).astype(np.float32)
    alt_lb[rng.random(n_out) < 0.15] = np.inf
    dist, paths, _, src, dst, w, _ = (a.numpy() for a in args)
    cand = dist[src] + w
    ok = paths[src] & (cand >= lb) & (cand < ub)
    s = (cand + alt_lb[dst])[ok]
    s = np.sort(s[np.isfinite(s)])
    assert s.size > 2
    pick = {"inf": np.float32(np.inf), "below-all": s[0] / 2,
            "tie": s[s.size // 3], "between": np.float32(
                (float(s[s.size // 2]) + float(s[s.size // 2 - 1])) / 2)}
    return alt_lb, np.float32(pick[bound])


@pytest.mark.parametrize("bound", ALT_BOUNDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_partials_alt_plain_version_matches_reference(name, bound):
    lb, ub = np.float32(0.5), np.float32(2.5)
    t = lambda a: torch.from_numpy(np.array(a))
    for q in range(4):
        ref_args, ref_kw, args, kw = _partials_inputs(name, q, seed=q)
        alt_lb, pb = _alt_case(args, lb, ub, kw["n_out"], bound, seed=10 + q)
        refs = [rops.relax_partials(*ref_args, lb, ub, **ref_kw,
                                    use_kernel=use_kernel,
                                    alt_lb=jnp.asarray(alt_lb),
                                    prune_bound=pb)
                for use_kernel in (True, False)]
        got = ops.relax_partials(*args, t(lb), t(ub), t(alt_lb), t(pb),
                                 **kw)
        _assert_partials_equal(refs, got, f"shard {q}")
        trav, rlx, tiles, prn = got[2].tolist()
        free = ops.relax_partials(*args, t(lb), t(ub), **kw)[2].tolist()
        # the cut moves parent-excluded candidates from n_relax to n_pruned
        assert (trav, tiles) == (free[0], free[2]) and free[3] == 0
        assert free[1] == rlx + prn, f"shard {q}"
        if bound == "inf":
            assert prn == 0
        elif bound == "below-all":
            assert rlx == 0 and prn > 0
            assert not torch.isfinite(got[0]).any()
        else:
            assert rlx > 0 and prn > 0, f"shard {q}"


# ---------------------------------------------------------------------------
# (c) the engine at one rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_one(tmp_path):
    """A gloo process group of world size 1 in this process."""
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    tdist.destroy_process_group()


def _assert_same(want, got, what):
    np.testing.assert_array_equal(want[0].view(np.int32),
                                  got[0].view(np.int32),
                                  err_msg=f"{what}: dist")
    np.testing.assert_array_equal(want[1], got[1], err_msg=f"{what}: parent")
    bad = {f: (want[2][f], got[2][f]) for f in LOGICAL_METRIC_FIELDS
           if want[2][f] != got[2][f]}
    assert not bad, (what, bad)


def _ref_out(out):
    dist, parent, m = out
    return (np.asarray(dist), np.asarray(parent),
            {f: float(getattr(m, f)) if f.startswith("n_tiles")
             or f == "n_invocations" else int(getattr(m, f))
             for f in m._fields})


def _port_out(out):
    dist, parent, m = out
    return dist.numpy(), parent.numpy(), metrics_dict(m)


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_v1_matches_reference_at_one_rank(name, backend, gloo_one):
    rg, _ = _graph(name)
    rsg, ref_layout, tsg, _, carried = _layouts(name, 1)
    src = int(np.argmax(rg.deg))
    blocked = backend == "blocked"
    want = _ref_out(rdist.sssp_distributed(
        rsg, src, jax.make_mesh((1,), ("graph",)), ("graph",),
        version="v1", backend=backend,
        **({"blocked": ref_layout} if blocked else {})))
    got = _port_out(tdistributed.sssp_distributed(
        tsg, src, version="v1", backend=backend, device="cpu",
        **({"blocked": carried} if blocked else {})))
    _assert_same(want, got, f"{name} v1/{backend}")
    for f in ("n_tiles_scanned", "n_tiles_dense", "n_invocations"):
        assert got[2][f] == want[2][f], f
    if backend == "blocked":
        assert 0 < got[2]["n_tiles_scanned"] < got[2]["n_tiles_dense"]


@functools.lru_cache(maxsize=None)
def _query_case(name):
    """The max-degree source, its farthest-hop target (the pair
    ``tests/test_alt_p2p.py`` shards), and the reference's 4
    ``"farthest"`` landmarks in both packages."""
    rg, hg = _graph(name)
    s = int(np.argmax(rg.deg))
    t = int(np.argmax(tlm.hop_bfs(hg.row_ptr.astype(np.int64),
                                  hg.dst.astype(np.int64), hg.n, s)))
    rset = rlm.build_landmarks(rg.to_device(), n_landmarks=4,
                               strategy="farthest")
    return s, t, rset, convert.landmarks_from_reference(lm_arrays(rset),
                                                        "cpu")


QUERIES = ("p2p", "p2p-alt", "bounded", "knear")


def _query_args(name, query):
    """``(source, goal, goal_param, reference landmarks, port
    landmarks)`` of one query: the target above, D = 2.5 as
    ``tests/test_distributed_sssp.py`` bounds, k = 12."""
    s, t, rset, tset = _query_case(name)
    goal, gp = {"p2p": ("p2p", t), "p2p-alt": ("p2p", t),
                "bounded": ("bounded", 2.5), "knear": ("knear", 12)}[query]
    alt = query == "p2p-alt"
    return s, goal, gp, rset if alt else None, tset if alt else None


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_v1_queries_match_reference_at_one_rank(name, backend, query,
                                                gloo_one):
    rsg, ref_layout, tsg, _, carried = _layouts(name, 1)
    s, goal, gp, rset, tset = _query_args(name, query)
    blocked = backend == "blocked"
    want = _ref_out(rdist.sssp_distributed(
        rsg, s, jax.make_mesh((1,), ("graph",)), ("graph",),
        version="v1", backend=backend, goal=goal, goal_param=gp,
        landmarks=rset, **({"blocked": ref_layout} if blocked else {})))
    before = ops.LAUNCHES.edge_relax_partials_alt
    got = _port_out(tdistributed.sssp_distributed(
        tsg, s, version="v1", backend=backend, device="cpu", goal=goal,
        goal_param=gp, landmarks=tset,
        **({"blocked": carried} if blocked else {})))
    assert ops.LAUNCHES.edge_relax_partials_alt == before   # CPU: plain
    _assert_same(want, got, f"{name} v1/{backend} {query}={gp}")
    for f in ("n_tiles_scanned", "n_tiles_dense", "n_invocations"):
        assert got[2][f] == want[2][f], f
    if query == "p2p-alt":
        assert got[2]["n_pruned"] > 0
        tree = _port_out(tdistributed.sssp_distributed(
            tsg, s, version="v1", backend=backend, device="cpu", goal="p2p",
            goal_param=gp, **({"blocked": carried} if blocked else {})))
        t = gp
        assert got[0][t].tobytes() == tree[0][t].tobytes()
        assert reconstruct_path(got[1], s, t) == reconstruct_path(tree[1],
                                                                  s, t)
        assert got[2]["n_relax"] < tree[2]["n_relax"]


# ---------------------------------------------------------------------------
# (d) the engine over 2 and 4 gloo ranks, in child processes
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as tdist
from repro_torch.core.distributed import (shard_blocked, shard_graph,
                                          sssp_distributed)
from repro_torch.core.landmarks import build_landmarks, hop_bfs
from repro_torch.core.sssp import metrics_dict
from repro_torch.data import generators
from repro_torch.serve.queries import reconstruct_path
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                         rank=rank, world_size=world)
res = {}
for name, (maker, kw) in json.loads(sys.argv[5]).items():
    g = getattr(generators, maker)(**kw)
    src = int(np.argmax(g.deg))
    tgt = int(np.argmax(hop_bfs(g.row_ptr.astype(np.int64),
                                g.dst.astype(np.int64), g.n, src)))
    lm = build_landmarks(g, 4, device="cpu")
    sg = shard_graph(g, world)
    for backend in ("segment_min", "blocked"):
        opts = ({"blocked": shard_blocked(sg, block_v=64, tile_e=64)}
                if backend == "blocked" else {})
        for query, q in (("tree", {}), ("knear", dict(goal="knear",
                                                      goal_param=12)),
                         ("p2p-alt", dict(goal="p2p", goal_param=tgt,
                                          landmarks=lm))):
            d, p, m = sssp_distributed(sg, src, version="v1",
                                       backend=backend, device="cpu",
                                       **opts, **q)
            d, p = d[:g.n], p[:g.n]
            r = dict(metrics=metrics_dict(m))
            if query == "p2p-alt":
                r.update(target=tgt, dist_t=int(d[tgt:tgt + 1].view(
                    torch.int32)), path=reconstruct_path(p.numpy(), src,
                                                         tgt))
            else:
                r.update(dist=d.view(torch.int32).tolist(),
                         parent=p.tolist())
            key = name + "/" + backend
            res[key if query == "tree" else key + "/" + query] = r
tdist.destroy_process_group()
with open(out + "." + str(rank), "w") as f:
    json.dump(res, f)
"""


def _run_ranks(world: int, tmp: Path) -> list:
    """Every rank's results; fails the test if a child errs or outlives
    its timeout (it is then killed)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = tmp / "result"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), str(world),
         str(tmp / "store"), str(out), json.dumps(GRAPHS)],
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


@functools.lru_cache(maxsize=None)
def _single(name):
    """The single-device solves of both packages on ``segment_min``."""
    rg, hg = _graph(name)
    src = int(np.argmax(rg.deg))
    return (_ref_out(ref_sssp(rg.to_device(), src, backend="segment_min")),
            _port_out(sssp(hg, src, backend="segment_min", device="cpu")))


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("world", [2, 4])
def test_v1_over_ranks_matches_single_device(world, name, backend, ranks):
    every = ranks(world)
    got = every[0][f"{name}/{backend}"]
    for rank, other in enumerate(every[1:], 1):
        assert other[f"{name}/{backend}"] == got, f"rank {rank} differs"
    got = (np.asarray(got["dist"], np.int32).view(np.float32),
           np.asarray(got["parent"], np.int32), got["metrics"])
    for want, what in zip(_single(name), ("reference", "port")):
        _assert_same(want, got, f"P={world} {name} v1/{backend} vs "
                                f"{what} single device")
    if backend == "blocked":
        # every rank launched once per kept round (the round after the
        # last transition is dropped)
        assert got[2]["n_invocations"] == world * (got[2]["n_host_syncs"]
                                                   - 1)
        assert 0 < got[2]["n_tiles_scanned"] < got[2]["n_tiles_dense"]


@functools.lru_cache(maxsize=None)
def _single_query(name, query):
    """The port's single-device query from the max-degree source: knear
    (k = 12), or p2p to the farthest-hop target with 4 landmarks built by
    the port (as the children build them) and without."""
    _, hg = _graph(name)
    s = int(np.argmax(hg.deg))
    if query == "knear":
        return s, _port_out(sssp(hg, s, goal="knear", goal_param=12,
                                 device="cpu"))
    t = int(np.argmax(tlm.hop_bfs(hg.row_ptr.astype(np.int64),
                                  hg.dst.astype(np.int64), hg.n, s)))
    lm = tlm.build_landmarks(hg, 4, device="cpu")
    kw = dict(goal="p2p", goal_param=t, device="cpu")
    return s, t, (_port_out(sssp(hg, s, landmarks=lm, **kw)),
                  _port_out(sssp(hg, s, **kw)))


@pytest.mark.parametrize("query", ["knear", "p2p-alt"])
@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("world", [2, 4])
def test_v1_queries_over_ranks_match_single_device(world, name, backend,
                                                   query, ranks):
    key = f"{name}/{backend}/{query}"
    every = ranks(world)
    got = every[0][key]
    for rank, other in enumerate(every[1:], 1):
        assert other[key] == got, f"rank {rank} differs"
    what = f"P={world} {name} v1/{backend} {query}"
    if query == "knear":
        _, want = _single_query(name, query)
        _assert_same(want, (np.asarray(got["dist"], np.int32).view(
            np.float32), np.asarray(got["parent"], np.int32),
            got["metrics"]), what)
        return
    s, t, (alt, plain) = _single_query(name, query)
    assert got["target"] == t
    # the ALT contract against the unpruned query, the counters against
    # the single-device ALT query (tests/test_alt_p2p.py's sharded gate)
    assert np.int32(got["dist_t"]).view(np.float32).tobytes() == \
        plain[0][t].tobytes(), what
    assert got["path"] == reconstruct_path(plain[1], s, t), what
    for f in ("n_relax", "n_pruned"):
        assert got["metrics"][f] == alt[2][f], (what, f)
    assert got["metrics"]["n_pruned"] > 0, what


# ---------------------------------------------------------------------------
# (e) what earlier slices left raising, and bad arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(version="v2"), dict(version="v3"),
    dict(version="v1", fused_rounds=4), dict(version="v1", capacity=8),
    dict(version="v1", policy="adaptive"),
    dict(version="v1", config=object())],
    ids=["default-v2", "v2", "v3", "fused_rounds", "capacity", "policy",
         "config"])
def test_later_slices_raise(kw, gloo_one):
    """What earlier slices left raising now runs (ROADMAP queue 1 item
    10): each case's solve, its one-slot batch and its repair, bitwise
    the reference's at one rank.  As in the reference, v1 ignores
    ``fused_rounds``, ``capacity`` on v1 is a config error (the case then
    runs v3 with it), and so is a ``config`` that is no config (the case
    then runs a v1 one)."""
    rsg, _, tsg, _, _ = _layouts("road16", 1)
    s = int(np.argmax(_graph("road16")[1].deg))
    mesh = jax.make_mesh((1,), ("graph",))
    ref_kw = dict(kw)
    if "capacity" in kw or "config" in kw:
        with pytest.raises(ConfigError):
            tdistributed.sssp_distributed(tsg, s, device="cpu", **kw)
        with pytest.raises(ConfigError):
            tdistributed.sssp_distributed_batch(tsg, [s], device="cpu", **kw)
        with pytest.raises(RefConfigError):
            rdist.sssp_distributed(rsg, s, mesh, ("graph",), **kw)
        if "capacity" in kw:
            kw = ref_kw = dict(version="v3", capacity=8)
        else:
            kw = dict(config=EngineConfig(tier="sharded", shard_version="v1"))
            ref_kw = dict(config=RefConfig(tier="sharded",
                                           shard_version="v1"))
    want = _ref_out(rdist.sssp_distributed(rsg, s, mesh, ("graph",),
                                           **ref_kw))
    got = _port_out(tdistributed.sssp_distributed(tsg, s, device="cpu",
                                                  **kw))
    _assert_same(want, got, f"{kw}")
    if kw.get("version") == "v1" and "fused_rounds" in kw:
        plain = _port_out(tdistributed.sssp_distributed(
            tsg, s, version="v1", device="cpu"))
        _assert_same(plain, got, "v1 ignores fused_rounds")
    batch = tdistributed.sssp_distributed_batch(tsg, [s], device="cpu", **kw)
    _assert_same(got, _port_out((batch[0][0], batch[1][0], type(batch[2])(
        *(m[0] for m in batch[2])))), f"{kw} batch")
    # the repair at the case's version, from the source alone: the
    # Bellman-Ford fixpoint of the full window
    n = tsg.n_true
    dist = np.full(n, np.inf, np.float32)
    parent = np.full(n, -1, np.int32)
    front = np.zeros(n, bool)
    dist[s], parent[s], front[s] = 0.0, s, True
    rkw = {k: v for k, v in kw.items() if k in ("version", "capacity")}
    if "config" in kw:
        rkw = dict(version="v1")
    want = _ref_out(rdist.repair_distributed(rsg, dist, parent, front, mesh,
                                             ("graph",), **rkw))
    got = _port_out(tdistributed.repair_distributed(tsg, dist, parent, front,
                                                    device="cpu", **rkw))
    _assert_same(want, got, f"repair {rkw}")
    assert got[0].tobytes() == _port_out(tdistributed.sssp_distributed(
        tsg, s, version="v1", device="cpu"))[0].tobytes()


def test_needs_a_process_group():
    _, _, tsg, _, _ = _layouts("road16", 1)
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tdistributed.sssp_distributed(tsg, 0, version="v1", device="cpu")


def _alt_for(n):
    """Raw ALT operands over ``n`` vertices: 2 landmarks at distance 0."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return trelax.AltData(D=torch.zeros(2, n), delta=f32(2.0 ** -20),
                          sym=f32(1.0))


@pytest.mark.parametrize("case", ["shards", "blocked-with-segment_min",
                                  "layout-and-options", "group-backend",
                                  "world", "backend", "source", "version",
                                  "goal", "p2p-without-target",
                                  "target", "landmarks-width"])
def test_bad_arguments_raise(case, gloo_one, monkeypatch):
    _, _, tsg, layout, _ = _layouts("road16", 1)
    _, _, tsg2, layout2, _ = _layouts("road16", 2)
    kw = dict(version="v1", device="cpu")
    call = {
        "shards": (tsg, dict(backend="blocked", blocked=layout2)),
        "blocked-with-segment_min": (tsg, dict(blocked=layout)),
        "layout-and-options": (tsg, dict(backend="blocked", blocked=layout,
                                         tile_e=64)),
        "group-backend": (tsg, {}),
        "world": (tsg2, {}),
        "backend": (tsg, dict(backend="nope")),
        "source": (tsg, dict(source=tsg.n_true)),
        "version": (tsg, dict(version="v9")),
        "goal": (tsg, dict(goal="nearest")),
        "p2p-without-target": (tsg, dict(goal="p2p")),
        "target": (tsg, dict(goal="p2p", goal_param=tsg.n_true)),
        "landmarks-width": (tsg, dict(goal="p2p", goal_param=1,
                                      landmarks=_alt_for(tsg.n_true + 1))),
    }[case]
    sg, extra = call
    if case == "group-backend":
        # a group that does not match the device (NCCL with a CPU solve)
        monkeypatch.setattr(tdistributed.tdist, "get_backend",
                            lambda group=None: "nccl")
    args = dict(kw, source=0)
    args.update(extra)
    with pytest.raises(ValueError):
        tdistributed.sssp_distributed(sg, args.pop("source"), **args)


@pytest.mark.parametrize("goal,gp", [("tree", None), ("bounded", 2.5),
                                     ("knear", 12)])
def test_landmarks_ignored_off_p2p(goal, gp, gloo_one):
    # the reference ignores landmarks under a goal other than p2p; a set
    # too wide for the graph, which p2p refuses, shows that nothing reads
    # them
    _, _, tsg, _, _ = _layouts("road16", 1)
    s = int(np.argmax(_graph("road16")[1].deg))
    kw = dict(version="v1", device="cpu", goal=goal, goal_param=gp)
    want = _port_out(tdistributed.sssp_distributed(tsg, s, **kw))
    got = _port_out(tdistributed.sssp_distributed(
        tsg, s, landmarks=_alt_for(tsg.n_true + 1), **kw))
    _assert_same(want, got, f"{goal} with landmarks")
    assert got[2]["n_pruned"] == 0
