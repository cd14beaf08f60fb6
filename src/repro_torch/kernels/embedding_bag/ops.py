"""Wrapper of the embedding_bag kernel and its masked entry.

:func:`embedding_bag` and :func:`embedding_bag_masked` take the tensors
where they lie: CPU tensors go to the plain versions in :mod:`.ref`; CUDA
tensors go to the hand-written kernel in ``csrc/embedding_bag.cu`` (built
on first use), or the call raises.  There is no fallback from one to the
other.  Both paths check their inputs alike, so a call that the card
refuses is refused on the CPU too.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import MODES, embedding_bag_masked_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_masked", "embedding_bag_ref",
           "embedding_bag_masked_ref", "LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """Launches of the CUDA kernel, one per call on the card with at least
    one bag, by entry: ``embedding_bag`` (ids and weights) and
    ``embedding_bag_masked`` (ids and mask); CPU calls never count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.embedding_bag = 0
        self.embedding_bag_masked = 0


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/embedding_bag.cu``, with its entries'
    argument and result types set."""
    if lib.embedding_bag_launch.argtypes is None:
        for fn in (lib.embedding_bag_launch, lib.embedding_bag_masked_launch):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.embedding_bag_error_name.argtypes = [ctypes.c_int]
        lib.embedding_bag_error_name.restype = ctypes.c_char_p
    return lib


def _library():
    from .. import _build
    return bind(_build.load("embedding_bag"))


def _check_table_ids(table, ids, mode):
    """What both entries take: a row-contiguous f32 or bf16 table whose
    rows are whole 16-byte chunks and start 16-byte aligned, and int32 ids
    ``[B, L]`` on the table's device."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag takes a float32 or bfloat16 table, "
                        f"not {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, not {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids is on {ids.device}, the table on "
                         f"{table.device}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table [V, D] and ids [B, L] expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    vec = 16 // table.element_size()
    d = table.shape[1]
    if d == 0 or d % vec:
        raise ValueError(f"D = {d} is not a positive multiple of {vec}: "
                         f"{table.dtype} rows are read 16 bytes at a time")
    for name, x in (("table", table), ("ids", ids)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the table does not start 16-byte aligned")
    if not (table.is_cuda or table.device.type == "cpu"):
        raise ValueError(f"embedding_bag runs on CUDA or CPU, not "
                         f"{table.device}")


def _check_per_lookup(name, x, ids, dtype):
    """``x`` (weights or mask) is None or a contiguous ``dtype`` tensor of
    the ids' shape on their device."""
    if x is None:
        return
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {x.dtype}")
    if x.device != ids.device:
        raise ValueError(f"{name} is on {x.device}, the table on "
                         f"{ids.device}")
    if x.shape != ids.shape:
        raise ValueError(f"{name} {tuple(x.shape)} do not match ids "
                         f"{tuple(ids.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(table, ids, per_lookup, mode, entry: str):
    """One launch of the kernel's ``entry`` (``"embedding_bag"``, with the
    weights as ``per_lookup``, or ``"embedding_bag_masked"``, with the
    mask) on checked CUDA tensors, counted in :data:`LAUNCHES`; no launch
    for no bags."""
    b, l = ids.shape
    out = torch.empty((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if b == 0:
        return out
    lib = _library()
    fn = getattr(lib, f"{entry}_launch")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(_DTYPES[table.dtype], table.shape[0], table.shape[1], b, l,
                 table.data_ptr(), ids.data_ptr(),
                 None if per_lookup is None else per_lookup.data_ptr(),
                 out.data_ptr(), int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: "
                           f"{lib.embedding_bag_error_name(err).decode()} "
                           f"({err})")
    setattr(LAUNCHES, entry, getattr(LAUNCHES, entry) + 1)
    return out


def embedding_bag(table, ids, weights=None, *, mode: str = "sum"):
    """table ``[V, D]`` f32 or bf16; ids ``[B, L]`` int32; weights
    ``[B, L]`` f32 or None -> f32 ``[B, D]``: per bag, the sum of
    ``row(id) * weight`` over its L lookups in order, and for
    ``mode="mean"`` that sum over ``max(sum of weights, 1e-9)`` (no
    weights: all 1.0).  Ids in ``[-V, -1]`` wrap to ``id + V``; other ids
    outside ``[0, V)`` are clamped to ``[0, V-1]``, as the reference's
    Pallas kernel does in interpret mode."""
    _check_table_ids(table, ids, mode)
    _check_per_lookup("weights", weights, ids, torch.float32)
    if not table.is_cuda:
        return embedding_bag_ref(table, ids, weights, mode=mode)
    return _launch(table, ids, weights, mode, "embedding_bag")


def embedding_bag_masked(table, ids, mask=None, *, mode: str = "sum"):
    """table ``[V, D]`` f32 or bf16; ids ``[B, L]`` int32; mask ``[B, L]``
    bool or None (all masked in) -> f32 ``[B, D]``: per bag, the sum of the
    masked-in lookups' rows in lookup order, and for ``mode="mean"`` that
    sum over their count (``1e-9`` when there is none, so an empty bag is
    0).  A masked-out lookup adds nothing and is not read.  A masked-in id
    in ``[-V, -1]`` wraps to ``id + V``, and one outside ``[-V, V)`` makes
    its bag NaN, as ``jnp.take``'s NaN row does in the reference layer."""
    _check_table_ids(table, ids, mode)
    _check_per_lookup("mask", mask, ids, torch.bool)
    if not table.is_cuda:
        return embedding_bag_masked_ref(table, ids, mask, mode=mode)
    return _launch(table, ids, mask, mode, "embedding_bag_masked")
