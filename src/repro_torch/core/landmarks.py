"""ALT landmark sets: selection, weighted distances, float safety (port of
``repro.core.landmarks``).

A :class:`LandmarkSet` holds per-landmark weighted distances ``D[l, v] =
d(L_l, v)``, computed with this package's own tree solves, from which a
p2p solve derives admissible lower bounds on ``d(v, t)``
(:func:`repro_torch.core.relax.alt_lower_bounds`).

Exactness contract: pruning with these bounds leaves d(s, t) and its
parent chain bitwise equal to the unpruned solve.  f32 path sums carry
rounding, so the set carries the slack factor ``delta = 2^-24 * (2 H +
64)`` (``H`` the largest finite hop count the selection BFS saw), which
deflates the bounds and inflates the prune threshold.  A directed
(non-symmetric) graph gets only the forward difference; the symmetry
check here decides that once per build.

Selection strategies (:data:`LANDMARK_STRATEGIES`):

* ``"farthest"``: farthest-point traversal in the hop metric, from the
  max-degree vertex, adding the vertex farthest in hops from the chosen
  set each time;
* ``"max_degree"``: the k highest-degree vertices (ties by id).

The selection, the symmetry check and the ``.npz`` format are the
reference's, so an artifact saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .relax import AltData

__all__ = ["LANDMARK_STRATEGIES", "hop_bfs", "select_landmarks",
           "LandmarkSet", "build_landmarks", "save", "load"]

LANDMARK_STRATEGIES = ("farthest", "max_degree")

# one f32 ulp-scale rounding unit: the slack per landmark sum is
# delta = _EPS * (2 H + 64) for hop bound H
_EPS = float(np.float32(2.0) ** -24)


def hop_bfs(row_ptr: np.ndarray, dst: np.ndarray, n: int,
            root: int) -> np.ndarray:
    """Hop distances from ``root`` (-1 where unreached), vectorized BFS."""
    hop = np.full(n, -1, np.int64)
    frontier = np.array([root], np.int64)
    hop[frontier] = 0
    level = 0
    while frontier.size:
        starts = row_ptr[frontier]
        counts = row_ptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offsets = np.repeat(
            starts - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        nbrs = dst[offsets + np.arange(total)]
        nbrs = np.unique(nbrs[hop[nbrs] < 0])
        level += 1
        hop[nbrs] = level
        frontier = nbrs
    return hop


def _check_symmetric(src: torch.Tensor, dst: torch.Tensor,
                     w: torch.Tensor) -> bool:
    """True iff the directed edge multiset equals its own reverse (weights
    exactly equal): the condition for the reverse ALT difference and the
    landmark-seeded upper bound.  The reference's test (both orders
    sorted lexicographically, then compared), with stable sorts on the
    tensors' device in place of ``np.lexsort`` on the host."""
    def ordered(a, b):
        # (a, b, w) order: stable sorts by the last key first
        o = torch.sort(w, stable=True).indices
        for key in (b, a):
            o = o[torch.sort(key[o], stable=True).indices]
        return a[o], b[o], w[o]
    return all(x.equal(y) for x, y in zip(ordered(src, dst),
                                          ordered(dst, src)))


def select_landmarks(row_ptr: np.ndarray, dst: np.ndarray,
                     deg: np.ndarray, n_landmarks: int,
                     strategy: str) -> tuple:
    """Landmark vertex ids, picked on the host.  Returns ``(landmarks
    int64[L], max_hops int)``, ``max_hops`` the largest finite hop
    distance any selection BFS saw (``max_degree`` runs one BFS per pick
    only to measure it)."""
    n = deg.shape[0]
    k = min(n_landmarks, n)
    max_hops = 1
    if strategy == "max_degree":
        landmarks = np.argsort(-deg, kind="stable")[:k].astype(np.int64)
        for lm in landmarks:
            hop = hop_bfs(row_ptr, dst, n, int(lm))
            max_hops = max(max_hops, int(hop.max()))
        return landmarks, max_hops
    if strategy != "farthest":
        raise ValueError(f"unknown landmark strategy {strategy!r}; "
                         f"expected one of {LANDMARK_STRATEGIES}")
    # unreached vertices count as infinitely far, so every component
    # attracts a landmark
    chosen = [int(np.argmax(deg))]
    min_hop = np.full(n, np.iinfo(np.int64).max, np.int64)
    for _ in range(k):
        hop = hop_bfs(row_ptr, dst, n, chosen[-1])
        max_hops = max(max_hops, int(hop.max()))
        reached = hop >= 0
        min_hop[reached] = np.minimum(min_hop[reached], hop[reached])
        if len(chosen) == k:
            break
        cand = min_hop.copy()
        cand[np.asarray(chosen, np.int64)] = -1
        chosen.append(int(np.argmax(cand)))
    return np.asarray(chosen, np.int64), max_hops


@dataclasses.dataclass(frozen=True)
class LandmarkSet:
    """A graph's ALT artifact: ``D`` the ``[L, N]`` f32 distance tensor
    (``D[l, v] = d(landmarks[l], v)``, +inf where unreached) on the device
    that solves with it, ``sym`` the symmetry verdict, ``max_hops`` the
    hop bound behind ``delta``, and ``generation`` the registry
    generation the set was built against (-1: unmanaged)."""
    landmarks: np.ndarray          # [L] int64 vertex ids
    D: torch.Tensor                # [L, N] f32 weighted distances
    strategy: str
    sym: bool
    max_hops: int
    generation: int = -1
    # a stale set survived an increase/remove-only edge delta: its old
    # distances are still admissible *lower* bounds on the new graph
    # (d_old <= d_new), but the reverse difference and the seeded d(s,t)
    # upper bound are not; alt_data drops to forward-only bounds by
    # reporting sym=0 (alt_seed_ub then returns +inf)
    stale: bool = False

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])

    @property
    def delta(self) -> float:
        """The float-safety slack factor (see the module docstring)."""
        return _EPS * (2.0 * self.max_hops + 64.0)

    @property
    def alt_data(self) -> AltData:
        """The operands a p2p solve takes, on ``D``'s device (``sym`` 0
        for a stale set)."""
        scalar = lambda x: torch.tensor(np.float32(x), device=self.D.device)
        return AltData(D=self.D, delta=scalar(self.delta),
                       sym=scalar(1.0 if (self.sym and not self.stale)
                                  else 0.0))


def save(lm: LandmarkSet, path) -> None:
    """Write ``lm`` to ``path`` (``.npz``, the reference's format).
    ``generation``/``stale`` are session state and are not written: a
    loaded set starts unmanaged (``generation=-1``) and fresh."""
    np.savez(path, landmarks=lm.landmarks, D=lm.D.cpu().numpy(),
             strategy=np.asarray(lm.strategy), sym=np.asarray(lm.sym),
             max_hops=np.asarray(lm.max_hops))


def load(path, device=None) -> LandmarkSet:
    """Read a set written by :func:`save` (or by the reference's), with
    ``D`` on ``device`` (default ``cuda``; pass ``"cpu"`` without a
    card)."""
    from .sssp import resolve_device
    with np.load(path, allow_pickle=False) as z:
        return LandmarkSet(
            landmarks=z["landmarks"].astype(np.int64),
            D=torch.from_numpy(np.asarray(z["D"], np.float32)).to(
                resolve_device(device)),
            strategy=str(z["strategy"][()]), sym=bool(z["sym"][()]),
            max_hops=int(z["max_hops"][()]))


def build_landmarks(g, n_landmarks: int = 8, strategy: str = "farthest", *,
                    device=None, backend="blocked", fused_rounds: int = 4,
                    layout=None) -> LandmarkSet:
    """Build a :class:`LandmarkSet` for ``g`` (a ``HostGraph`` or a
    ``DeviceGraph``) with one tree solve per landmark on ``device``
    (default ``cuda``), through ``backend`` with ``fused_rounds`` (the
    fused blocked path by default) on ``layout`` (built here if not
    given).  The reference runs the same solves batched; the tree solves
    are bitwise equal, so ``D`` is too."""
    from .graph import DeviceGraph
    from .sssp import prepare_layout, resolve_device, sssp
    if n_landmarks < 1:
        raise ValueError("n_landmarks must be >= 1")
    as_np = (lambda a: a.cpu().numpy()) if isinstance(g, DeviceGraph) \
        else np.asarray
    row_ptr = as_np(g.row_ptr).astype(np.int64)
    dst = as_np(g.dst).astype(np.int64)
    deg = as_np(g.deg).astype(np.int64)
    if deg.shape[0] == 0:
        raise ValueError("cannot build landmarks for an empty graph")
    landmarks, max_hops = select_landmarks(row_ptr, dst, deg, n_landmarks,
                                           strategy)
    dev = resolve_device(device)
    dg = g if isinstance(g, DeviceGraph) else g.to_device(dev)
    sym = _check_symmetric(dg.src, dg.dst, dg.w)
    if layout is None:
        layout = prepare_layout(dg, backend, device=dev)
    D = torch.stack([
        sssp(dg, int(lm), backend=backend, layout=layout, device=dev,
             fused_rounds=fused_rounds)[0] for lm in landmarks])
    return LandmarkSet(landmarks=landmarks, D=D, strategy=strategy,
                       sym=sym, max_hops=max_hops)
