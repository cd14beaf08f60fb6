"""Port parity: the query planner (``repro_torch.serve.queries``).

``plan`` and ``finalize`` against the reference's, each fed its own
package's engine results for the same query on byte-identical graphs:
tree, p2p with and without ALT pruning, bounded and knear.  The
finalized arrays, distance, path, nearest list and normalized metrics
must be equal; ``finalize`` takes torch tensors or numpy alike.
"""
import functools

import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core.landmarks import build_landmarks as ref_build_landmarks
from repro.core.sssp import sssp as ref_sssp
from repro.serve import queries as rq
from repro_torch import convert
from repro_torch.core.landmarks import LandmarkSet
from repro_torch.core.sssp import sssp
from repro_torch.serve import queries as pq
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401


@functools.lru_cache(maxsize=None)
def _graph():
    rg = rgen.kronecker(8, 8, seed=1)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    rset = ref_build_landmarks(rg.to_device(), 4, "farthest")
    tset = LandmarkSet(landmarks=np.asarray(rset.landmarks),
                       D=torch.from_numpy(np.array(rset.D)),
                       strategy=rset.strategy, sym=bool(rset.sym),
                       max_hops=int(rset.max_hops))
    return rg, hg, rset, tset


def _queries(rg):
    s = int(np.argmax(rg.deg))
    far = 100
    return [dict(kind="tree"), dict(kind="p2p", target=far),
            dict(kind="p2p", target=far, alt=True),
            dict(kind="p2p", target=s), dict(kind="bounded", bound=0.75),
            dict(kind="knear", k=12), dict(kind="knear", k=1)], s


def _compare(a, b, what):
    np.testing.assert_array_equal(a.dist.view(np.int32),
                                  b.dist.view(np.int32), err_msg=what)
    np.testing.assert_array_equal(a.parent, b.parent, err_msg=what)
    assert a.dist.dtype == b.dist.dtype and a.parent.dtype == b.parent.dtype
    assert a.distance == b.distance and a.path == b.path, what
    assert a.nearest == b.nearest, what
    assert a.metrics == b.metrics, what


@pytest.mark.parametrize("index", range(7))
def test_plan_and_finalize_match_the_reference(index):
    rg, hg, rset, tset = _graph()
    qs, s = _queries(rg)
    q = dict(qs[index])
    alt = q.pop("alt", False)
    rquery = rq.Query(gid="g", source=s, **q)
    pquery = pq.Query(gid="g", source=s, **q)
    rplan, pplan = rq.plan(rquery), pq.plan(pquery)
    assert dataclasses_tuple(rplan) == dataclasses_tuple(pplan)
    assert rplan.key == pplan.key == ("g", q["kind"])
    kw = dict(goal=pplan.goal,
              goal_param=None if q["kind"] == "tree" else pplan.goal_param)
    ref_out = ref_sssp(rg.to_device(), s, **kw,
                       **(dict(landmarks=rset) if alt else {}))
    out = sssp(hg, s, device="cpu", **kw,
               **(dict(landmarks=tset) if alt else {}))
    if alt:
        assert int(out[2].n_pruned) > 0
    rres = rq.finalize(rquery, np.asarray(rg.deg), *ref_out)
    pres = pq.finalize(pquery, hg.deg, *out)
    assert isinstance(pres.dist, np.ndarray)
    _compare(rres, pres, f"{q} alt={alt}")
    # numpy in, same answer
    pnp = pq.finalize(pquery, np.asarray(hg.deg), out[0].numpy(),
                      out[1].numpy(), out[2])
    _compare(pnp, pres, f"{q} numpy")


def dataclasses_tuple(p):
    return (p.gid, p.goal, p.goal_param)


def test_query_validation_matches_the_reference():
    for kw, match in ((dict(kind="nope"), "unknown query kind"),
                      (dict(kind="p2p"), "requires target"),
                      (dict(kind="bounded"), "requires bound"),
                      (dict(kind="knear", k=0), "k must be >= 1"),
                      (dict(kind="bounded", bound=-1.0), "bound must be"),
                      (dict(kind="p2p", target=-3), "non-negative")):
        for mod in (rq, pq):
            with pytest.raises(ValueError, match=match):
                mod.Query(gid="g", source=0, **kw)
    with pytest.raises(ValueError, match="non-negative"):
        pq.Query(gid="g", source=-1)
    assert pq.plan(pq.Query(gid="g", source=3)).goal_param == 0


def test_reconstruct_path_takes_tensors():
    parent = torch.tensor([0, 0, 1, -1], dtype=torch.int32)
    assert pq.reconstruct_path(parent, 0, 2) == [0, 1, 2]
    assert pq.reconstruct_path(parent.numpy(), 0, 3) is None
    assert pq.reconstruct_path(parent, 0, 0) == [0]
