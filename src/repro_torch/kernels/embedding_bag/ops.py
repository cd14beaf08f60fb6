"""Wrapper of the embedding_bag kernel.

:func:`embedding_bag` takes the tensors where they lie: CPU tensors go to
the plain version in :mod:`.ref`; CUDA tensors go to the hand-written
kernel in ``csrc/embedding_bag.cu`` (built on first use), or the call
raises.  There is no fallback from one to the other.  Both paths check
their inputs alike, so a call that the card refuses is refused on the CPU
too.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import MODES, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref", "LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """Launches of the CUDA kernel: one per :func:`embedding_bag` call on
    the card with at least one bag; CPU calls never count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.embedding_bag = 0


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P]


def _library():
    from .. import _build
    lib = _build.load("embedding_bag")
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.embedding_bag_error_name.argtypes = [ctypes.c_int]
        lib.embedding_bag_error_name.restype = ctypes.c_char_p
    return lib


def _check(table, ids, weights, mode):
    """What the kernel takes: a row-contiguous f32 or bf16 table whose rows
    are whole 16-byte chunks and start 16-byte aligned, int32 ids
    ``[B, L]``, f32 weights ``[B, L]`` or None, all on one device."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag takes a float32 or bfloat16 table, "
                        f"not {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, not {ids.dtype}")
    for name, x in (("ids", ids), ("weights", weights)):
        if x is not None and x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, the table on "
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
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"weights must be float32, not {weights.dtype}")
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} do not match "
                             f"ids {tuple(ids.shape)}")
    for name, x in (("table", table), ("ids", ids), ("weights", weights)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the table does not start 16-byte aligned")


def _embedding_bag_cuda(table, ids, weights, mode):
    b, l = ids.shape
    out = torch.empty((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.embedding_bag_launch(
            _DTYPES[table.dtype], table.shape[0], table.shape[1], b, l,
            table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: "
                           f"{lib.embedding_bag_error_name(err).decode()} "
                           f"({err})")
    LAUNCHES.embedding_bag += 1
    return out


def embedding_bag(table, ids, weights=None, *, mode: str = "sum"):
    """table ``[V, D]`` f32 or bf16; ids ``[B, L]`` int32; weights
    ``[B, L]`` f32 or None -> f32 ``[B, D]``: per bag, the sum of
    ``row(id) * weight`` over its L lookups in order, and for
    ``mode="mean"`` that sum over ``max(sum of weights, 1e-9)`` (no
    weights: all 1.0).  Ids in ``[-V, -1]`` wrap to ``id + V``; other ids
    outside ``[0, V)`` are clamped to ``[0, V-1]``, as the reference's
    Pallas kernel does in interpret mode."""
    _check(table, ids, weights, mode)
    if table.is_cuda:
        return _embedding_bag_cuda(table, ids, weights, mode)
    if table.device.type != "cpu":
        raise ValueError(f"embedding_bag runs on CUDA or CPU, not "
                         f"{table.device}")
    return embedding_bag_ref(table, ids, weights, mode=mode)
