"""Wrapper of the edge_relax kernel: one relaxation round over a slab.

:func:`relax_bucket` takes the tensors where they lie.  CPU tensors go to
the plain version in :mod:`.ref`; CUDA tensors go to the hand-written
kernel in ``csrc/edge_relax.cu`` (built on first use), or the call
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import INT_MAX, edge_relax_ref, schedule_tiles

__all__ = ["relax_bucket", "edge_relax_ref", "schedule_tiles", "INT_MAX",
           "LAUNCHES"]


class _Counter:
    """Launches of the CUDA kernel chain (one per :func:`relax_bucket`
    call on the card); CPU calls never count."""

    def __init__(self):
        self.edge_relax = 0

    def reset(self):
        self.edge_relax = 0


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int64, _P, _P, _P, _P, _P, _P]


def _library():
    from .. import _build
    lib = _build.load("edge_relax")
    fn = lib.edge_relax_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
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


def _edge_relax_cuda(dist, frontier, src, dst, w, tile_first, lb, ub, *,
                     tile_e: int, n_out: int):
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
                 lb.data_ptr(), ub.data_ptr(), nt, tile_e, n_out,
                 sched.data_ptr(), sched_n.data_ptr(), keys.data_ptr(),
                 vals.data_ptr(), wins.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"edge_relax launch failed: cudaError {err}")
    LAUNCHES.edge_relax += 1
    return vals, wins, sched_n


def relax_bucket(dist, frontier, src, dst, w, tile_first, lb, ub, *,
                 tile_e: int, n_out: int):
    """Relax a tile-aligned slab (or a concatenation of slabs) once.

    ``dist`` f32 / ``frontier`` bool ``[n_src]`` are indexed by ``src``;
    ``src``/``dst`` int32 and ``w`` f32 ``[NT * tile_e]`` (padding slots
    carry ``w=+inf``); ``tile_first`` bool ``[NT]``; ``lb``/``ub`` 0-d f32.
    Returns ``(vals, winners, n_tiles)`` over ``n_out`` destinations:
    the minimum in-window candidate, the smallest source id achieving it
    (``(inf, INT_MAX)`` where none), and the number of tiles the
    frontier-compacted schedule keeps (0-d int32, on the device).
    """
    if dist.is_cuda:
        return _edge_relax_cuda(dist, frontier, src, dst, w, tile_first, lb,
                                ub, tile_e=tile_e, n_out=n_out)
    if dist.device.type != "cpu":
        raise ValueError(f"edge_relax runs on CUDA or CPU, not {dist.device}")
    vals, wins = edge_relax_ref(dist, frontier, src, dst, w, lb, ub,
                                n_out=n_out)
    _, n_tiles = schedule_tiles(frontier, src, w, tile_first, tile_e)
    return vals, wins, n_tiles
