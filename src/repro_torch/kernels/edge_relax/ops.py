"""Wrappers of the edge_relax kernels.

:func:`relax_bucket` runs one relaxation round over a device's slabs (of
one state, or of several slots' states over the same slabs in one
launch), :func:`relax_partials` the same round over a shard's slabs for the
sharded engines (shard-local source ids), and :func:`relax_fused` up to
``fused_rounds`` rounds in one call.  All take the tensors where they
lie.  CPU tensors go to the plain versions in :mod:`.ref`; CUDA tensors
go to the hand-written kernels in ``csrc/edge_relax.cu`` (both one-round
entry points) and ``csrc/edge_relax_fused.cu`` (built on first use), or
the call raises.  There is no fallback from one to the other.

All three kernels schedule their tiles from the layout's vertex->tile
index (``index=``, a :class:`~repro_torch.core.graph.TileIndex`) and
keep scratch buffers between calls, cached per (device, tile count,
destination count, and slot count for a batched call) for the life of
the process: for the one-round kernels a flag word per tile and the
packed keys, which every call leaves cleared, and the schedule (a row of
each per slot); for the fused kernel the same plus the
touched list, two frontier lists, two planes of path marks and the round
scalars (:class:`_FusedScratch`), also left clean.  Calls on one device
must therefore be ordered on one stream.  A call may be captured in a
CUDA graph only after an eager call of the same sizes has made its
scratch; the graph then holds that scratch's addresses, which stay valid
because the cache never evicts (about 8 B a tile and 8 B a destination
per layout size for a one-round kernel, 8 B a tile and 22 B a
destination for the fused one) and drops an entry only when a launch on
it failed.  Each wrapper allocates only its outputs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .ref import (EMPTY_KEY, FUSED_COUNTERS, INT_MAX, PARTIAL_COUNTERS,
                  edge_relax_batch_ref, edge_relax_fused_ref,
                  edge_relax_partials_ref, edge_relax_ref, frontier_schedule,
                  schedule_tiles)

__all__ = ["relax_bucket", "relax_fused", "relax_partials",
           "edge_relax_ref", "edge_relax_batch_ref", "edge_relax_fused_ref",
           "edge_relax_partials_ref", "schedule_tiles", "frontier_schedule",
           "FUSED_COUNTERS", "PARTIAL_COUNTERS", "INT_MAX", "LAUNCHES"]


class _Counter:
    """Launches of the CUDA kernels: ``edge_relax`` counts one per
    :func:`relax_bucket` call of one state on the card without ALT and
    ``edge_relax_alt`` one per call with it, ``edge_relax_batch`` and
    ``edge_relax_batch_alt`` one per batched call (whatever its slot
    count), ``edge_relax_fused`` and
    ``edge_relax_fused_alt`` the same for :func:`relax_fused`, and
    ``edge_relax_partials`` and ``edge_relax_partials_alt`` the same for
    :func:`relax_partials`; CPU calls never count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.edge_relax = 0
        self.edge_relax_alt = 0
        self.edge_relax_batch = 0
        self.edge_relax_batch_alt = 0
        self.edge_relax_fused = 0
        self.edge_relax_fused_alt = 0
        self.edge_relax_partials = 0
        self.edge_relax_partials_alt = 0


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# edge_relax_launch and edge_relax_partials_launch
_ROUND_ARGTYPES = [_P] * 9 + [_I64] + [_P] * 4 + [_I64, _I64, ctypes.c_int,
                                                  _I64] + [_P] * 7
# edge_relax_batch_launch: the same, with the active list and its length
# after n_out
_BATCH_ARGTYPES = _ROUND_ARGTYPES[:18] + [_P, _I64] + _ROUND_ARGTYPES[18:]


# edge_relax_fused_launch
_FUSED_ARGTYPES = ([_P] * 11 + [_I64] + [_P] * 6
                   + [ctypes.c_int, _I64, ctypes.c_int] + [_P] * 12)


def _library(name, argtypes, source="edge_relax"):
    """The C entry point ``<name>_launch`` of the library built from
    ``csrc/<source>.cu``."""
    from .. import _build
    fn = getattr(_build.load(source), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# (device, tiles, destinations, slots) -> (flags, sched, keys): the
# one-round kernels' scratch, never evicted (see the module's docstring)
_SCRATCH: dict = {}


def _cached(cache: dict, key, what: str, make):
    """``cache[key]``, made by ``make()`` on first use.  A graph capture
    cannot make it: its buffers must outlive the capture."""
    bufs = cache.get(key)
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what} scratch of these sizes does not "
                               "exist yet: make one eager call before "
                               "capturing")
        bufs = cache[key] = make()
    return bufs


def _scratch(dev, nt: int, n_out: int, slots: int = 1):
    """The cached scratch of a one-round call over ``slots`` states (1
    for a one-state call): ``flags`` int32 ``[slots, nt + 1]`` (a word
    per tile, then the schedule's append counter; all 0), ``sched`` int32
    ``[slots, nt]`` and ``keys`` int64 ``[slots, n_out]`` (all
    ``EMPTY_KEY``).  Returns ``(cache key, buffers)``."""
    key = (dev, nt, n_out, slots)
    return key, _cached(_SCRATCH, key, "edge_relax", lambda: (
        torch.zeros(slots, nt + 1, dtype=torch.int32, device=dev),
        torch.empty(slots, nt, dtype=torch.int32, device=dev),
        torch.full((slots, n_out), EMPTY_KEY, dtype=torch.int64,
                   device=dev)))


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


def _relax_round_cuda(name, dist, paths, parent, src, dst, w, tile_first,
                      lb, ub, alt_lb, prune_bound, index, active=None, *,
                      tile_e: int, n_out: int):
    """Launch ``<name>_launch`` (``edge_relax`` or
    ``edge_relax_partials``): the same round, counted apart; with
    ``active`` (int32 slot ids) ``edge_relax_batch_launch`` over the
    slots of ``[S, n_src]`` states, counted once in ``<name>_batch``."""
    dev = dist.device
    e = src.shape[0]
    nt = tile_first.shape[0]
    if e != nt * tile_e or nt == 0:
        raise ValueError(f"slab of {e} slots is not {nt} tiles of {tile_e}")
    if index is None:
        raise ValueError(f"{name} on the card needs the layout's TileIndex "
                         "(index=)")
    vt_ptr, vt_tile, forced = index
    lead, n_src = tuple(dist.shape[:-1]), dist.shape[-1]
    extra = []
    if active is not None:
        n_active = active.shape[0]
        if not 1 <= n_active <= min(lead[0], 65535):
            raise ValueError(f"{n_active} active slots for {lead[0]} slots")
        _check("active", active, torch.int32, (n_active,), dev)
        extra, name = [active.data_ptr(), n_active], f"{name}_batch"
    for what, t, dtype, shape in (
            ("dist", dist, torch.float32, lead + (n_src,)),
            ("paths", paths, torch.bool, lead + (n_src,)),
            ("parent", parent, torch.int32, lead + (n_src,)),
            ("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
            ("w", w, torch.float32, (e,)),
            ("tile_first", tile_first, torch.bool, (nt,)),
            ("lb", lb, torch.float32, lead), ("ub", ub, torch.float32, lead),
            ("vt_ptr", vt_ptr, torch.int32, (n_src + 1,)),
            ("vt_tile", vt_tile, torch.int32, vt_tile.shape[:1]),
            ("forced", forced, torch.int32, forced.shape[:1])):
        _check(what, t, dtype, shape, dev)
    alt = _check_alt(("alt_lb", "prune_bound"), (alt_lb, prune_bound),
                     (lead + (n_out,), lead), (torch.float32,) * 2, dev)
    fn = _library(name, _BATCH_ARGTYPES if extra else _ROUND_ARGTYPES)
    key, (flags, sched, keys) = _scratch(dev, nt, n_out,
                                         lead[0] if extra else 1)
    empty = lambda size, dtype: torch.empty(size, dtype=dtype, device=dev)
    vals = empty(lead + (n_out,), torch.float32)
    wins = empty(lead + (n_out,), torch.int32)
    counts = empty(lead + (4,), torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dist.data_ptr(), paths.data_ptr(), parent.data_ptr(),
                 src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                 vt_ptr.data_ptr(), vt_tile.data_ptr(), forced.data_ptr(),
                 forced.shape[0], lb.data_ptr(), ub.data_ptr(),
                 _ptr(alt_lb), _ptr(prune_bound), n_src, nt, tile_e, n_out,
                 *extra, flags.data_ptr(), sched.data_ptr(), keys.data_ptr(),
                 vals.data_ptr(), wins.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        _SCRATCH.pop(key, None)        # a flag or key may be left set
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    counter = f"{name}_alt" if alt else name
    setattr(LAUNCHES, counter, getattr(LAUNCHES, counter) + 1)
    return vals, wins, counts


def _plain_round(name, dist, *args, tile_e: int, n_out: int):
    if dist.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU, not {dist.device}")
    return edge_relax_partials_ref(dist, *args, tile_e=tile_e, n_out=n_out)


def relax_bucket(dist, paths, parent, src, dst, w, tile_first, lb, ub,
                 alt_lb=None, prune_bound=None, *, tile_e: int, n_out: int,
                 index=None, active=None):
    """Relax a device's tile-aligned slabs (concatenated, global source
    ids) once.

    ``dist`` f32, ``paths`` bool (the leaf-pruned frontier) and
    ``parent`` i32 ``[n_src]`` are indexed by ``src``; ``src``/``dst``
    int32 and ``w`` f32 ``[NT * tile_e]`` (padding slots carry
    ``w=+inf``); ``tile_first`` bool ``[NT]``; ``lb``/``ub`` 0-d f32.
    With ``alt_lb`` (f32 ``[n_out]``) and ``prune_bound`` (0-d f32), the
    ALT cut: a candidate enters only if ``cand + alt_lb[dst] <=
    prune_bound``.  ``index`` is the slabs' :class:`TileIndex`, which
    the kernel schedules from (the plain version finds the same tiles
    with ``schedule_tiles``).  Returns ``(vals, winners, counts)`` over
    ``n_out`` destinations: the minimum kept candidate, the smallest
    source id achieving it (``(inf, INT_MAX)`` where none), and the int32
    ``PARTIAL_COUNTERS`` (``n_trav``, ``n_relax``, ``n_tiles``,
    ``n_pruned``; on the device) -- exactly what :func:`relax_partials`
    returns for a shard.

    Batched (``dist`` 2-D): ``dist``, ``paths``, ``parent`` are ``[S,
    n_src]``, ``lb``/``ub`` (and ``prune_bound``) ``[S]``, ``alt_lb``
    ``[S, n_out]``: S states over the same slabs, in one launch (counted
    once in ``edge_relax_batch`` or ``edge_relax_batch_alt``).
    ``active`` (int32, on the device; default every slot) lists the
    slots to relax; the results are ``[S, n_out]`` and ``[S, 4]``, each
    active slot's row what a one-state call on its row returns, and the
    rows of the other slots unspecified.
    """
    if dist.dim() == 2:
        if active is None:
            active = torch.arange(dist.shape[0], dtype=torch.int32,
                                  device=dist.device)
        if dist.is_cuda:
            return _relax_round_cuda("edge_relax", dist, paths, parent, src,
                                     dst, w, tile_first, lb, ub, alt_lb,
                                     prune_bound, index, active,
                                     tile_e=tile_e, n_out=n_out)
        if dist.device.type != "cpu":
            raise ValueError(f"edge_relax runs on CUDA or CPU, not "
                             f"{dist.device}")
        return edge_relax_batch_ref(dist, paths, parent, src, dst, w,
                                    tile_first, lb, ub, alt_lb, prune_bound,
                                    tile_e=tile_e, n_out=n_out,
                                    active=active)
    if active is not None:
        raise ValueError("active= lists slots of a batched (2-D) call")
    if dist.is_cuda:
        return _relax_round_cuda("edge_relax", dist, paths, parent, src, dst,
                                 w, tile_first, lb, ub, alt_lb, prune_bound,
                                 index, tile_e=tile_e, n_out=n_out)
    return _plain_round("edge_relax", dist, paths, parent, src, dst, w,
                        tile_first, lb, ub, alt_lb, prune_bound,
                        tile_e=tile_e, n_out=n_out)


class _FusedScratch(NamedTuple):
    """The fused kernel's scratch for one (device, tiles, destinations):
    ``keys`` int64 ``[n_out]`` (all ``EMPTY_KEY`` between calls),
    ``flags`` int32 ``[nt]`` (0), ``sched`` int32 ``[nt]``, ``touched``
    int32 ``[n_out]``, ``lists`` int32 ``[2, n_out]`` (the frontier
    lists), ``marks`` uint8 ``[2, n_out]`` (0) and ``scal`` int32 ``[8]``
    (the round scalars, 0)."""
    keys: torch.Tensor
    flags: torch.Tensor
    sched: torch.Tensor
    touched: torch.Tensor
    lists: torch.Tensor
    marks: torch.Tensor
    scal: torch.Tensor


# (device, tiles, destinations) -> _FusedScratch, never evicted (see the
# module's docstring)
_FUSED_SCRATCH: dict = {}


def _fused_scratch(dev, nt: int, n_out: int):
    """The cached scratch of a fused call; returns ``(cache key,
    _FusedScratch)``."""
    key = (dev, nt, n_out)
    i32 = dict(dtype=torch.int32, device=dev)

    def make():
        return _FusedScratch(
            keys=torch.full((n_out,), EMPTY_KEY, dtype=torch.int64,
                            device=dev),
            flags=torch.zeros(nt, **i32), sched=torch.empty(nt, **i32),
            touched=torch.empty(n_out, **i32),
            lists=torch.empty(2, n_out, **i32),
            marks=torch.zeros(2, n_out, dtype=torch.uint8, device=dev),
            scal=torch.zeros(8, **i32))
    return key, _cached(_FUSED_SCRATCH, key, "edge_relax_fused", make)


def _edge_relax_fused_cuda(dist, parent, frontier, deg, src, dst, w,
                           tile_first, lb, ub, alt_lb, prune_ub, prune_infl,
                           prune_tgt, index, *, tile_e: int,
                           fused_rounds: int):
    dev = dist.device
    e = src.shape[0]
    nt = tile_first.shape[0]
    if e != nt * tile_e or nt == 0:
        raise ValueError(f"slab of {e} slots is not {nt} tiles of {tile_e}")
    if index is None:
        raise ValueError("edge_relax_fused on the card needs the layout's "
                         "TileIndex (index=)")
    vt_ptr, vt_tile, forced = index
    n_out = dist.shape[0]
    for name, t, dtype, shape in (
            ("dist", dist, torch.float32, (n_out,)),
            ("parent", parent, torch.int32, (n_out,)),
            ("frontier", frontier, torch.bool, (n_out,)),
            ("deg", deg, torch.int32, (n_out,)),
            ("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
            ("w", w, torch.float32, (e,)),
            ("tile_first", tile_first, torch.bool, (nt,)),
            ("lb", lb, torch.float32, ()), ("ub", ub, torch.float32, ()),
            ("vt_ptr", vt_ptr, torch.int32, (n_out + 1,)),
            ("vt_tile", vt_tile, torch.int32, vt_tile.shape[:1]),
            ("forced", forced, torch.int32, forced.shape[:1])):
        _check(name, t, dtype, shape, dev)
    alt = _check_alt(("alt_lb", "prune_ub", "prune_infl", "prune_tgt"),
                     (alt_lb, prune_ub, prune_infl, prune_tgt),
                     ((n_out,), (), (), ()),
                     (torch.float32,) * 3 + (torch.int32,), dev)
    fn = _library("edge_relax_fused", _FUSED_ARGTYPES, "edge_relax_fused")
    key, s = _fused_scratch(dev, nt, n_out)
    empty = lambda size, dtype: torch.empty(size, dtype=dtype, device=dev)
    dist_out = empty(n_out, torch.float32)
    parent_out = empty(n_out, torch.int32)
    front_out = empty(n_out, torch.bool)
    counts = empty(8, torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dist.data_ptr(), parent.data_ptr(), frontier.data_ptr(),
                 deg.data_ptr(), src.data_ptr(), dst.data_ptr(),
                 w.data_ptr(), tile_first.data_ptr(), vt_ptr.data_ptr(),
                 vt_tile.data_ptr(), forced.data_ptr(), forced.shape[0],
                 lb.data_ptr(), ub.data_ptr(), _ptr(alt_lb),
                 _ptr(prune_ub), _ptr(prune_infl), _ptr(prune_tgt), tile_e,
                 n_out, fused_rounds, dist_out.data_ptr(),
                 parent_out.data_ptr(), front_out.data_ptr(),
                 counts.data_ptr(), *(b.data_ptr() for b in s), stream)
    if err != 0:
        _FUSED_SCRATCH.pop(key, None)  # a key, flag or mark may be left set
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
                prune_tgt=None, *, tile_e: int, fused_rounds: int,
                index=None):
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
    dist[prune_tgt] * prune_infl)`` taken afresh each round.  ``index``
    is the slab's :class:`TileIndex`, which the kernel schedules each
    round from (needed on the card; the plain version reads every slot).
    Returns ``(dist, parent, frontier, counts)``: the state after the
    last executed round, in new tensors, and the int32
    ``FUSED_COUNTERS`` summed over those rounds.
    """
    if fused_rounds < 1:
        raise ValueError(f"fused_rounds must be >= 1, got {fused_rounds}")
    if dist.is_cuda:
        return _edge_relax_fused_cuda(dist, parent, frontier, deg, src, dst,
                                      w, tile_first, lb, ub, alt_lb,
                                      prune_ub, prune_infl, prune_tgt,
                                      index, tile_e=tile_e,
                                      fused_rounds=fused_rounds)
    if dist.device.type != "cpu":
        raise ValueError(f"edge_relax_fused runs on CUDA or CPU, not "
                         f"{dist.device}")
    return edge_relax_fused_ref(dist, parent, frontier, deg, src, dst, w,
                                tile_first, lb, ub, alt_lb, prune_ub,
                                prune_infl, prune_tgt, tile_e=tile_e,
                                fused_rounds=fused_rounds)


def relax_partials(dist_src, paths_src, parent_src, src, dst, w, tile_first,
                   lb, ub, alt_lb=None, prune_bound=None, *, tile_e: int,
                   n_out: int, index=None):
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
    in ``n_pruned``.  ``index`` is the shard's :class:`TileIndex` over its
    local sources (needed on the card).  Returns ``(val, win, counts)``
    over ``n_out`` destinations: the minimum kept candidate, the smallest
    shard-local source id achieving it (``(inf, INT_MAX)`` where none),
    and the int32 ``PARTIAL_COUNTERS`` (on the device).
    """
    if dist_src.is_cuda:
        return _relax_round_cuda(
            "edge_relax_partials", dist_src, paths_src, parent_src, src, dst,
            w, tile_first, lb, ub, alt_lb, prune_bound, index, tile_e=tile_e,
            n_out=n_out)
    return _plain_round("edge_relax_partials", dist_src, paths_src,
                        parent_src, src, dst, w, tile_first, lb, ub, alt_lb,
                        prune_bound, tile_e=tile_e, n_out=n_out)
