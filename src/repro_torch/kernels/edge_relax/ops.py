"""Wrappers of the edge_relax kernels.

:func:`relax_bucket` runs one relaxation round over a slab,
:func:`relax_fused` up to ``fused_rounds`` rounds in one call, and
:func:`relax_partials` one round over a shard's slabs for the sharded
engines.  All take the tensors where they lie.  CPU tensors go to the
plain versions in :mod:`.ref`; CUDA tensors go to the hand-written
kernels in ``csrc/edge_relax.cu``, ``csrc/edge_relax_fused.cu`` and
``csrc/edge_relax_partials.cu`` (built on first use), or the call raises.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import (FUSED_COUNTERS, INT_MAX, PARTIAL_COUNTERS,
                  edge_relax_fused_ref, edge_relax_partials_ref,
                  edge_relax_ref, schedule_tiles)

__all__ = ["relax_bucket", "relax_fused", "relax_partials",
           "edge_relax_ref", "edge_relax_fused_ref",
           "edge_relax_partials_ref", "schedule_tiles", "FUSED_COUNTERS",
           "PARTIAL_COUNTERS", "INT_MAX", "LAUNCHES"]


class _Counter:
    """Launches of the CUDA kernels: ``edge_relax`` counts one per
    :func:`relax_bucket` call on the card without ALT and
    ``edge_relax_alt`` one per call with it, ``edge_relax_fused`` and
    ``edge_relax_fused_alt`` the same for :func:`relax_fused`, and
    ``edge_relax_partials`` and ``edge_relax_partials_alt`` the same for
    :func:`relax_partials`; CPU calls never count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.edge_relax = 0
        self.edge_relax_alt = 0
        self.edge_relax_fused = 0
        self.edge_relax_fused_alt = 0
        self.edge_relax_partials = 0
        self.edge_relax_partials_alt = 0


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int64, _P, _P, _P, _P, _P, _P]


_FUSED_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   _P, _P, _P, _P, _P, _P, _P, _P]


_PARTIALS_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _P, _P,
                      _P, _P, _P, _P]


def _library(name="edge_relax", argtypes=_ARGTYPES):
    from .. import _build
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t) -> int | None:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _check_alt(names, tensors, shapes, dtypes, device):
    """Check optional ALT operands: all given, or none."""
    given = [t is not None for t in tensors]
    if any(given) and not all(given):
        raise ValueError(f"pass all of {', '.join(names)} or none")
    if all(given):
        for name, t, shape, dtype in zip(names, tensors, shapes, dtypes):
            _check(name, t, dtype, shape, device)
    return all(given)


def _edge_relax_cuda(dist, frontier, src, dst, w, tile_first, lb, ub,
                     alt_lb, prune_bound, *, tile_e: int, n_out: int):
    dev = dist.device
    e = src.shape[0]
    nt = tile_first.shape[0]
    if e != nt * tile_e or nt == 0:
        raise ValueError(f"slab of {e} slots is not {nt} tiles of {tile_e}")
    n_src = dist.shape[0]
    for name, t, dtype, shape in (
            ("dist", dist, torch.float32, (n_src,)),
            ("frontier", frontier, torch.bool, (n_src,)),
            ("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
            ("w", w, torch.float32, (e,)),
            ("tile_first", tile_first, torch.bool, (nt,)),
            ("lb", lb, torch.float32, ()), ("ub", ub, torch.float32, ())):
        _check(name, t, dtype, shape, dev)
    alt = _check_alt(("alt_lb", "prune_bound"), (alt_lb, prune_bound),
                     ((n_out,), ()), (torch.float32,) * 2, dev)
    fn = _library()
    sched = torch.empty(nt, dtype=torch.int32, device=dev)
    sched_n = torch.empty((), dtype=torch.int32, device=dev)
    keys = torch.empty(n_out, dtype=torch.int64, device=dev)
    vals = torch.empty(n_out, dtype=torch.float32, device=dev)
    wins = torch.empty(n_out, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dist.data_ptr(), frontier.data_ptr(), src.data_ptr(),
                 dst.data_ptr(), w.data_ptr(), tile_first.data_ptr(),
                 lb.data_ptr(), ub.data_ptr(), _ptr(alt_lb),
                 _ptr(prune_bound), nt, tile_e, n_out, sched.data_ptr(),
                 sched_n.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                 wins.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"edge_relax launch failed: cudaError {err}")
    if alt:
        LAUNCHES.edge_relax_alt += 1
    else:
        LAUNCHES.edge_relax += 1
    return vals, wins, sched_n


def relax_bucket(dist, frontier, src, dst, w, tile_first, lb, ub,
                 alt_lb=None, prune_bound=None, *, tile_e: int, n_out: int):
    """Relax a tile-aligned slab (or a concatenation of slabs) once.

    ``dist`` f32 / ``frontier`` bool ``[n_src]`` are indexed by ``src``;
    ``src``/``dst`` int32 and ``w`` f32 ``[NT * tile_e]`` (padding slots
    carry ``w=+inf``); ``tile_first`` bool ``[NT]``; ``lb``/``ub`` 0-d f32.
    With ``alt_lb`` (f32 ``[n_out]``) and ``prune_bound`` (0-d f32), the
    ALT cut: a candidate enters only if ``cand + alt_lb[dst] <=
    prune_bound``.  Returns ``(vals, winners, n_tiles)`` over ``n_out``
    destinations: the minimum candidate, the smallest source id achieving
    it (``(inf, INT_MAX)`` where none), and the number of tiles the
    frontier-compacted schedule keeps (0-d int32, on the device).
    """
    if dist.is_cuda:
        return _edge_relax_cuda(dist, frontier, src, dst, w, tile_first, lb,
                                ub, alt_lb, prune_bound, tile_e=tile_e,
                                n_out=n_out)
    if dist.device.type != "cpu":
        raise ValueError(f"edge_relax runs on CUDA or CPU, not {dist.device}")
    vals, wins = edge_relax_ref(dist, frontier, src, dst, w, lb, ub, alt_lb,
                                prune_bound, n_out=n_out)
    _, n_tiles = schedule_tiles(frontier, src, w, tile_first, tile_e)
    return vals, wins, n_tiles


def _edge_relax_fused_cuda(dist, parent, frontier, deg, src, dst, w,
                           tile_first, lb, ub, alt_lb, prune_ub, prune_infl,
                           prune_tgt, *, tile_e: int, fused_rounds: int):
    dev = dist.device
    e = src.shape[0]
    nt = tile_first.shape[0]
    if e != nt * tile_e or nt == 0:
        raise ValueError(f"slab of {e} slots is not {nt} tiles of {tile_e}")
    n_out = dist.shape[0]
    for name, t, dtype, shape in (
            ("dist", dist, torch.float32, (n_out,)),
            ("parent", parent, torch.int32, (n_out,)),
            ("frontier", frontier, torch.bool, (n_out,)),
            ("deg", deg, torch.int32, (n_out,)),
            ("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
            ("w", w, torch.float32, (e,)),
            ("tile_first", tile_first, torch.bool, (nt,)),
            ("lb", lb, torch.float32, ()), ("ub", ub, torch.float32, ())):
        _check(name, t, dtype, shape, dev)
    alt = _check_alt(("alt_lb", "prune_ub", "prune_infl", "prune_tgt"),
                     (alt_lb, prune_ub, prune_infl, prune_tgt),
                     ((n_out,), (), (), ()),
                     (torch.float32,) * 3 + (torch.int32,), dev)
    fn = _library("edge_relax_fused", _FUSED_ARGTYPES)
    empty = lambda size, dtype: torch.empty(size, dtype=dtype, device=dev)
    dist_out = empty(n_out, torch.float32)
    parent_out = empty(n_out, torch.int32)
    front_out = empty(n_out, torch.bool)
    counts = empty(8, torch.int32)
    keys = empty(n_out, torch.int64)
    sched = empty(nt, torch.int32)
    scalars = empty(3, torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dist.data_ptr(), parent.data_ptr(), frontier.data_ptr(),
                 deg.data_ptr(), src.data_ptr(), dst.data_ptr(),
                 w.data_ptr(), tile_first.data_ptr(), lb.data_ptr(),
                 ub.data_ptr(), _ptr(alt_lb), _ptr(prune_ub),
                 _ptr(prune_infl), _ptr(prune_tgt), nt, tile_e, n_out,
                 fused_rounds,
                 dist_out.data_ptr(), parent_out.data_ptr(),
                 front_out.data_ptr(), counts.data_ptr(), keys.data_ptr(),
                 sched.data_ptr(), scalars.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"edge_relax_fused launch failed: {_error(err)}")
    if alt:
        LAUNCHES.edge_relax_fused_alt += 1
    else:
        LAUNCHES.edge_relax_fused += 1
    return dist_out, parent_out, front_out, counts


def _error(code: int) -> str:
    """``cudaGetErrorName`` of a code the C launcher returned."""
    from .. import _build
    fn = _build.load("edge_relax_fused").edge_relax_fused_error_name
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return f"{fn(code).decode()} ({code})"


def relax_fused(dist, parent, frontier, deg, src, dst, w, tile_first, lb,
                ub, alt_lb=None, prune_ub=None, prune_infl=None,
                prune_tgt=None, *, tile_e: int, fused_rounds: int):
    """Up to ``fused_rounds`` relaxation rounds over a whole-graph slab in
    one call (one round while ``lb <= 0``; it stops after the first round
    that improves nothing).

    ``dist`` f32, ``parent`` i32, ``frontier`` bool, ``deg`` i32 span the
    padded vertex range ``[0, n_out)``; ``src``/``dst`` int32 and ``w``
    f32 ``[NT * tile_e]`` are the concatenated slabs with global ids
    (padding slots carry ``w=+inf``), ``tile_first`` bool ``[NT]``;
    ``lb``/``ub`` 0-d f32 on the device.  With ``alt_lb`` (f32
    ``[n_out]``), ``prune_ub``/``prune_infl`` (0-d f32) and ``prune_tgt``
    (0-d int32), the ALT cut with the bound ``min(prune_ub,
    dist[prune_tgt] * prune_infl)`` taken afresh each round.  Returns
    ``(dist, parent, frontier, counts)``: the state after the last
    executed round, in new tensors, and the int32 ``FUSED_COUNTERS``
    summed over those rounds.
    """
    if fused_rounds < 1:
        raise ValueError(f"fused_rounds must be >= 1, got {fused_rounds}")
    if dist.is_cuda:
        return _edge_relax_fused_cuda(dist, parent, frontier, deg, src, dst,
                                      w, tile_first, lb, ub, alt_lb,
                                      prune_ub, prune_infl, prune_tgt,
                                      tile_e=tile_e,
                                      fused_rounds=fused_rounds)
    if dist.device.type != "cpu":
        raise ValueError(f"edge_relax_fused runs on CUDA or CPU, not "
                         f"{dist.device}")
    return edge_relax_fused_ref(dist, parent, frontier, deg, src, dst, w,
                                tile_first, lb, ub, alt_lb, prune_ub,
                                prune_infl, prune_tgt, tile_e=tile_e,
                                fused_rounds=fused_rounds)


def _edge_relax_partials_cuda(dist_src, paths_src, parent_src, src, dst, w,
                              tile_first, lb, ub, alt_lb, prune_bound, *,
                              tile_e: int, n_out: int):
    dev = dist_src.device
    e = src.shape[0]
    nt = tile_first.shape[0]
    if e != nt * tile_e or nt == 0:
        raise ValueError(f"slab of {e} slots is not {nt} tiles of {tile_e}")
    n_src = dist_src.shape[0]
    for name, t, dtype, shape in (
            ("dist_src", dist_src, torch.float32, (n_src,)),
            ("paths_src", paths_src, torch.bool, (n_src,)),
            ("parent_src", parent_src, torch.int32, (n_src,)),
            ("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
            ("w", w, torch.float32, (e,)),
            ("tile_first", tile_first, torch.bool, (nt,)),
            ("lb", lb, torch.float32, ()), ("ub", ub, torch.float32, ())):
        _check(name, t, dtype, shape, dev)
    alt = _check_alt(("alt_lb", "prune_bound"), (alt_lb, prune_bound),
                     ((n_out,), ()), (torch.float32,) * 2, dev)
    fn = _library("edge_relax_partials", _PARTIALS_ARGTYPES)
    empty = lambda size, dtype: torch.empty(size, dtype=dtype, device=dev)
    sched = empty(nt, torch.int32)
    keys = empty(n_out, torch.int64)
    val = empty(n_out, torch.float32)
    win = empty(n_out, torch.int32)
    counts = empty(4, torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dist_src.data_ptr(), paths_src.data_ptr(),
                 parent_src.data_ptr(), src.data_ptr(), dst.data_ptr(),
                 w.data_ptr(), tile_first.data_ptr(), lb.data_ptr(),
                 ub.data_ptr(), _ptr(alt_lb), _ptr(prune_bound), nt, tile_e,
                 n_out, sched.data_ptr(), keys.data_ptr(), val.data_ptr(),
                 win.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"edge_relax_partials launch failed: cudaError "
                           f"{err}")
    if alt:
        LAUNCHES.edge_relax_partials_alt += 1
    else:
        LAUNCHES.edge_relax_partials += 1
    return val, win, counts


def relax_partials(dist_src, paths_src, parent_src, src, dst, w, tile_first,
                   lb, ub, alt_lb=None, prune_bound=None, *, tile_e: int,
                   n_out: int):
    """One relaxation round over all of a shard's slabs (the sharded
    engines' per-shard partials).

    ``dist_src`` f32, ``paths_src`` bool and ``parent_src`` i32 span the
    shard's local source range; ``src`` int32 (shard-local ids, indexing
    that range), ``dst`` int32 (global ids below ``n_out``) and ``w`` f32
    are the shard's slabs concatenated, ``[NT * tile_e]`` (padding slots
    carry ``w=+inf``); ``tile_first`` bool ``[NT]``; ``lb``/``ub`` 0-d
    f32.  With ``alt_lb`` (f32 ``[n_out]``) and ``prune_bound`` (0-d f32),
    the ALT cut: a candidate enters only if ``cand + alt_lb[dst] <=
    prune_bound``, and the cut ones not back along the parent edge count
    in ``n_pruned``.  Returns ``(val, win, counts)`` over ``n_out``
    destinations: the minimum kept candidate, the smallest shard-local
    source id achieving it (``(inf, INT_MAX)`` where none), and the int32
    ``PARTIAL_COUNTERS`` (on the device).
    """
    if dist_src.is_cuda:
        return _edge_relax_partials_cuda(
            dist_src, paths_src, parent_src, src, dst, w, tile_first, lb, ub,
            alt_lb, prune_bound, tile_e=tile_e, n_out=n_out)
    if dist_src.device.type != "cpu":
        raise ValueError(f"edge_relax_partials runs on CUDA or CPU, not "
                         f"{dist_src.device}")
    return edge_relax_partials_ref(dist_src, paths_src, parent_src, src, dst,
                                   w, tile_first, lb, ub, alt_lb,
                                   prune_bound, tile_e=tile_e, n_out=n_out)
