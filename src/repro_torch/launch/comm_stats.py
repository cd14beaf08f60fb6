"""Collective statistics of a traced step: the port's counterpart of
``repro.launch.hlo_stats``.

The reference parses the collectives out of XLA's optimized per-device
HLO.  There is no HLO here: :class:`CommRecorder` is a
``TorchDispatchMode`` that records every collective the traced step
issues on this rank, functional (``_c10d_functional``, what DTensor
redistributes with, and its autograd twins) or not (``c10d``, what
``torch.distributed.all_reduce`` and the other in-place calls
dispatch).  A DTensor op is let through to DTensor first, so that the
collectives of its redistributions are seen as they are issued.  Each
record holds the reference's kind name, the input and
output bytes on this rank and the group size.

:func:`collective_bytes` turns records into the reference's dict:

  * ``per_op`` / ``counts`` by kind, ``total``: operand (input) bytes,
    the reference's definition;
  * ``ring_bytes``: the ring-algorithm bytes-on-link estimate per device
    (all-reduce 2x(g-1)/g of the input, all-gather (g-1)/g of the
    output, reduce-scatter / all-to-all (g-1)/g of the input, permute
    1x), the reference's formulas.

:func:`flops_of` counts this rank's FLOPs with ``torch.utils.
flop_counter``'s formulas over plain tensors only: a DTensor op is
counted once, at its local op.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all",
)

# op name (overload packet, without namespace) -> (kind, functional?)
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over."""
    import torch.distributed.distributed_c10d as c10d

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch._C.ScriptObject) and "ProcessGroup" in \
                a._type().qualified_name():      # c10d's boxed group
            return int(c10d.ProcessGroup.unbox(a).size())
    names = [a for a in args if isinstance(a, str)]
    if names:
        return int(c10d._resolve_process_group(names[-1]).size())
    return 1


def _record(func, args, kwargs, out):
    packet = func._overloadpacket
    ns, name = packet._qualified_op_name.split("::")
    if ns in ("_c10d_functional", "_c10d_functional_autograd") and \
            name in _FUNCTIONAL:
        kind = _FUNCTIONAL[name]
        return {"kind": kind, "in_bytes": _nbytes(args[0]),
                "out_bytes": _nbytes(out),
                "group": _group_size(func, args, kwargs)}
    if ns == "c10d" and name in _C10D:
        kind = _C10D[name]
        if name in ("allreduce_", "allreduce_coalesced_"):
            inp = outp = args[0]
        elif name in ("allgather_",):              # (outputs, inputs)
            outp, inp = args[0], args[1]
        else:                                      # (output(s), input(s))
            outp, inp = args[0], args[1]
        return {"kind": kind, "in_bytes": _nbytes(inp),
                "out_bytes": _nbytes(outp),
                "group": _group_size(func, args, kwargs)}
    return None


def _dtensor(types) -> bool:
    """Whether a dispatch has a DTensor among its arguments: the mode
    then lets DTensor run first, so that its local ops and collectives
    come back through the mode as plain ones (as ``CommDebugMode``
    does)."""
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _plain(types) -> bool:
    """Only plain tensors (not the fake tensors of DTensor's shape
    propagation, which compute nothing)."""
    return all(t in (torch.Tensor, torch.nn.Parameter) for t in types)


class CommRecorder(TorchDispatchMode):
    """Records each collective dispatched while active into
    ``self.records`` (kind, in_bytes, out_bytes, group)."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = _record(func, args, kwargs, out) if _plain(types) else None
        if rec is not None:
            self.records.append(rec)
        return out


def collective_bytes(records) -> dict:
    """The reference's ``hlo_stats.collective_bytes`` dict of ``records``
    (``CommRecorder.records``, or dicts of the same keys)."""
    per_op = defaultdict(int)
    counts = defaultdict(int)
    ring = 0.0
    for r in records:
        op, ob, rb, g = r["kind"], r["in_bytes"], r["out_bytes"], r["group"]
        per_op[op] += ob
        counts[op] += 1
        frac = (g - 1) / g if g > 1 else 0.0
        if op == "all-reduce":
            ring += 2 * ob * frac
        elif op == "all-gather":
            ring += rb * frac
        elif op in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
            ring += ob * frac
        elif op == "collective-permute":
            ring += ob
    return {"per_op": dict(per_op), "counts": dict(counts),
            "total": int(sum(per_op.values())), "ring_bytes": int(ring)}


class LocalFlops(TorchDispatchMode):
    """This rank's FLOPs: ``torch.utils.flop_counter``'s formula of each
    op on plain tensors (a DTensor op is counted at its local op)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._registry = FlopCounterMode().flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = self._registry.get(func._overloadpacket)
        if fn is not None and _plain(types):
            self.flops += int(fn(*args, **kwargs, out_val=out))
        return out


def flops_of(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops)`` with :class:`LocalFlops`."""
    with LocalFlops() as counter:
        out = fn(*args, **kwargs)
    return out, counter.flops
