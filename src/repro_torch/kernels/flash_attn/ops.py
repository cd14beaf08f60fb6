"""Wrappers of the flash_attention kernel.

:func:`flash_attention` keeps the reference kernel's ``[B, H, S, D]``
layout; :func:`flash_attention_pos` is the form the model path calls, on
its own layouts (q ``[B, S, KV, HG, D]``, one layer of the KV cache
``[B, T, KV, D]``) with per-query and per-key positions.  Both take the
tensors where they lie: CPU tensors go to the plain versions in
:mod:`.ref`; CUDA tensors go to the hand-written kernels in
``csrc/flash_attn.cu`` (built on first use), which read them in place
through their strides, or the call raises.  :func:`variant` names the
design a call gets from its type, head width and rows: ``"tc"`` (bf16
tensor cores, prefill), ``"split"`` (split-KV decode), ``"split_tc"``
(split-KV on the tensor cores, MQA decode) or ``"simt"`` (f32 on the
CUDA cores).  There is no fallback from one to another, nor
to the plain version.  The kernel has no backward: on the card a call
whose inputs require grad under grad mode raises (the plain version on
the CPU is differentiable torch code).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import (flash_attention_pos_ref, flash_attention_ref,
                  flash_attention_split_ref)

__all__ = ["flash_attention", "flash_attention_pos", "flash_attention_ref",
           "flash_attention_pos_ref", "flash_attention_split_ref",
           "variant", "split_count", "LAUNCHES", "HEAD_DIMS", "VARIANTS"]

HEAD_DIMS = (16, 32, 64, 128)       # the kernel's compiled head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# in the C launcher's numbering
VARIANTS = ("simt", "tc", "split", "split_tc")
TC_HEAD_DIMS = (64, 128)            # wgmma's N for O += P V
TC_MIN_ROWS = 64                    # one warpgroup's rows
SPLIT_MAX_ROWS = 8                  # S * HG of a decode call
SPLIT_MIN_KEYS = 128                # keys a split chunk holds at least
SPLIT_TC_MIN_KEYS = 64              # a split_tc chunk: whole 64-key tiles


def variant(dtype, d: int, rows: int) -> str:
    """The design that serves a call on the card: ``"split"`` for at most
    ``SPLIT_MAX_ROWS`` rows ``S * HG`` (decode); for bfloat16 with ``d``
    in ``TC_HEAD_DIMS``, ``"tc"`` from ``TC_MIN_ROWS`` rows (prefill on
    the tensor cores) and ``"split_tc"`` below (MQA decode: granite-34b's
    48 heads over one KV head); ``"simt"`` otherwise (float32 keeps its
    2e-5 tolerance there; D 16 and 32)."""
    if rows <= SPLIT_MAX_ROWS:
        return "split"
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tc" if rows >= TC_MIN_ROWS else "split_tc"
    return "simt"


def split_count(b: int, kv: int, t: int, sms: int,
                min_keys: int = SPLIT_MIN_KEYS) -> int:
    """Chunks of the key range for ``"split"`` (``"split_tc"`` passes
    ``SPLIT_TC_MIN_KEYS``): the most that keep the ``b * kv * n`` blocks
    within two per SM (two are resident at once, so the launch is one
    wave with no tail), each chunk at least ``min_keys`` keys of the
    ``t``, and at least one."""
    return max(1, min(2 * sms // max(1, b * kv), -(-t // min_keys)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Counter:
    """Launches on the card: ``flash_attention`` counts one per
    :func:`flash_attention` or :func:`flash_attention_pos` call, and
    ``flash_attention_<variant>`` the same calls by the design that
    served them; CPU calls never count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.flash_attention = 0
        for name in VARIANTS:
            setattr(self, f"flash_attention_{name}", 0)


LAUNCHES = _Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
             _I, ctypes.c_float, _P, _I, _P]


def _library():
    from .. import _build
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.flash_attn_error_name.argtypes = [ctypes.c_int]
        lib.flash_attn_error_name.restype = ctypes.c_char_p
    return lib


def _check_rows(name, t, elem):
    """k and v rows (and q's, in every design but ``"simt"``) are read 16
    bytes at a time: their start and row stride must be 16-byte aligned,
    their last dimension contiguous."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension is not contiguous")
    if t.data_ptr() % 16 or any((st * elem) % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name} is not 16-byte aligned in its rows")


def _positions(name, pos, shape, device):
    if pos is None:
        return None, (0, 0)
    if pos.device != device or pos.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 on {device}, got {pos.dtype} "
                        f"on {pos.device}")
    if tuple(pos.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(pos.shape)}, expected "
                         f"{tuple(shape)}")
    return pos, pos.stride()


def _refuse_grad(*tensors):
    """The kernel writes its output through a pointer, so autograd cannot
    see through it: a call that would need its gradient raises instead
    of training every weight but those behind attention."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention has no backward on the card: call it under "
            "torch.no_grad(), or train through the plain attention "
            "(transformer.loss_fn uses attn='plain')")


def _flash_cuda(q, k, v, q_pos, k_pos, out, causal, window, kind=None):
    """One launch on the card, of design ``kind`` (default
    :func:`variant`'s; a measurement may name another that takes the
    call).  Raises when grad mode is on and an input requires grad
    (:func:`_refuse_grad`)."""
    _refuse_grad(q, k, v)
    b, s, kv, hg, d = q.shape
    t = k.shape[1]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{q.dtype}")
    for name, x in (("k", k), ("v", v), ("out", out)):
        if x.device != dev or x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype} on {x.device}, q is "
                            f"{q.dtype} on {dev}")
    if tuple(k.shape) != (b, t, kv, d) or tuple(v.shape) != (b, t, kv, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if q.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError("q's and out's last dimension must be contiguous")
    elem = q.element_size()
    _check_rows("k", k, elem)
    _check_rows("v", v, elem)
    kind = kind or variant(q.dtype, d, s * hg)
    if kind not in VARIANTS:
        raise ValueError(f"no flash_attention design {kind!r}")
    if kind != "simt":
        _check_rows("q", q, elem)
    q_pos, qps = _positions("q_pos", q_pos, (b, s), dev)
    k_pos, kps = _positions("k_pos", k_pos, (b, t), dev)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4],
        *qps, *kps)
    n_split, scratch = 0, None
    if kind in ("split", "split_tc"):
        index = torch.cuda.current_device() if dev.index is None else \
            dev.index
        n_split = split_count(b, kv, t, _sm_count(index),
                              SPLIT_TC_MIN_KEYS if kind == "split_tc"
                              else SPLIT_MIN_KEYS)
        scratch = torch.empty(b * kv * n_split * s * hg * (d + 2),
                              dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attn_launch(
            VARIANTS.index(kind), _DTYPES[q.dtype], d, b, s, t, kv, hg,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), strides,
            int(bool(causal)), int(window), 1.0 / d ** 0.5,
            None if scratch is None else scratch.data_ptr(), n_split, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: "
                           f"{lib.flash_attn_error_name(err).decode()} "
                           f"({err})")
    LAUNCHES.flash_attention += 1
    name = f"flash_attention_{kind}"
    setattr(LAUNCHES, name, getattr(LAUNCHES, name) + 1)
    return out


def _cpu_or_raise(q, what):
    if q.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or CPU, not {q.device}")


def flash_attention_pos(q, k, v, q_pos=None, k_pos=None, *,
                        causal: bool = True, window: int = 0):
    """Attention of q ``[B, S, KV, HG, D]`` over k/v ``[B, T, KV, D]``
    with query positions ``q_pos`` ``[B, S]`` and key positions ``k_pos``
    ``[B, T]`` (int32; ``None`` means ``0..S-1`` / ``0..T-1``, which lets
    a causal block stop at its last visible key tile).  A key is visible
    iff its position is >= 0, and with ``causal`` <= the query's, and
    with ``window`` > the query's minus ``window``; a query with no
    visible key gives 0.  f32 inside; returns a new contiguous
    ``[B, S, KV, HG, D]`` tensor in q's dtype."""
    if q.is_cuda:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return _flash_cuda(q, k, v, q_pos, k_pos, out, causal, window)
    _cpu_or_raise(q, "flash_attention")
    return flash_attention_pos_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q ``[B, H, S, D]``; k, v ``[B, Hkv, T, D]`` -> ``[B, H, S, D]``
    (the reference kernel's layout; query head ``h`` uses KV head
    ``h // (H // Hkv)``).  On the card the kernel reads these layouts
    through their strides: no copy."""
    if q.is_cuda:
        b, h, s, d = q.shape
        h_kv = k.shape[1]
        if h % h_kv:
            raise ValueError(f"{h} query heads over {h_kv} KV heads")
        out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
        as5 = lambda x: x.unflatten(1, (h_kv, h // h_kv)).permute(0, 3, 1, 2,
                                                                  4)
        _flash_cuda(as5(q), k.transpose(1, 2), v.transpose(1, 2), None, None,
                    as5(out), causal, window)
        return out
    _cpu_or_raise(q, "flash_attention")
    return flash_attention_ref(q, k, v, causal=causal, window=window)
