"""Single-source shortest paths by Bellman-Ford rounds over the raw
undirected edge list, in plain PyTorch.

``distances`` is the reference: float64 sums of the float32 weights.
``control_tree`` is the same algorithm one precision lower than the
configuration's float32, in bfloat16 (every weight and every sum rounded
to bfloat16), with a parent per vertex: put in the program's place, the
comparison has to find it wrong.

Each round relaxes every edge in both directions, in chunks of
``chunk`` edges, with a scatter-min on the bit patterns of the
distances: a non-negative float orders as its bits do as a signed
integer, so the minimum needs no float atomics.  Rounds stop when one
changes nothing.
"""
import torch

CHUNK = 1 << 25
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _rounds(n, eu, ev, w, source, dtype, add, chunk):
    dist = torch.full((n,), float("inf"), dtype=dtype, device=eu.device)
    dist[source] = 0
    bits = dist.view(_BITS[dtype])
    for _ in range(n):
        before = dist.clone()
        for a, b in ((eu, ev), (ev, eu)):
            for lo in range(0, a.shape[0], chunk):
                hi = lo + chunk
                cand = add(dist[a[lo:hi]], w[lo:hi])
                bits.scatter_reduce_(0, b[lo:hi], cand.view(bits.dtype),
                                     "amin")
        if torch.equal(before, dist):
            return dist
    raise RuntimeError("Bellman-Ford did not settle in n rounds")


def distances(n: int, eu: torch.Tensor, ev: torch.Tensor, ew: torch.Tensor,
              source: int, chunk: int = CHUNK) -> torch.Tensor:
    """Shortest distances from ``source`` in float64 (``inf`` where
    unreached); ``eu``/``ev`` int64 endpoints, ``ew`` float32 weights."""
    return _rounds(n, eu, ev, ew.to(torch.float64), source, torch.float64,
                   torch.add, chunk)


def _bf16_add(d, w):
    return (d.to(torch.bfloat16) + w).to(torch.float32)


def control_tree(n: int, eu: torch.Tensor, ev: torch.Tensor,
                 ew: torch.Tensor, source: int, chunk: int = CHUNK):
    """``(dist, parent)`` of the bfloat16 control: distances as float32
    holding bfloat16 values, and for each reached vertex the smallest
    neighbour id whose bfloat16 sum gives its distance (the source its
    own parent, unreached vertices -1)."""
    w = ew.to(torch.bfloat16)
    dist = _rounds(n, eu, ev, w, source, torch.float32, _bf16_add, chunk)
    none = torch.iinfo(torch.int64).max
    parent = torch.full((n,), none, dtype=torch.int64, device=eu.device)
    for a, b in ((eu, ev), (ev, eu)):
        for lo in range(0, a.shape[0], chunk):
            hi = lo + chunk
            hit = _bf16_add(dist[a[lo:hi]], w[lo:hi]) == dist[b[lo:hi]]
            parent.scatter_reduce_(0, b[lo:hi],
                                   torch.where(hit, a[lo:hi], none), "amin")
    parent[parent == none] = -1
    parent[source] = source
    return dist, parent
