"""What DTensor needs beyond its own rules to run the port's models on
a mesh: the counterpart of XLA's SPMD partitioner replicating what it
cannot partition.

:func:`replicate_fallback` is a context manager under which an operator
whose DTensor sharding propagation fails (it has no strategy, as
``torch.searchsorted``, or its strategy raises, as ``index_put``'s does
for some placements in some PyTorch versions) gets one that gathers
every DTensor input whole, runs the op on every rank and returns
replicated outputs; the context yields the set of the operators so
replicated, for the caller to report.  It also installs
:func:`_gather_handler` for ``torch.gather``: DTensor's own rule for a
gather along a sharded dim leaves a masked partial that a later select
cannot reduce (the cross-entropy's ``gather(...)[..., 0]``); here the
gathered dim is made whole first and the other dims keep their shards.
Both are DTensor's process-wide state: they are installed when the
outermost context opens and taken out, with DTensor's own strategies
and sharding cache restored, when it closes.
"""
from __future__ import annotations

import contextlib
import threading

import torch

aten = torch.ops.aten

_LOCK = threading.RLock()
_DEPTH = 0
_REPLICATED: set = set()
_UNDO: list = []


def _replicate_strategy(op):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    n_out = sum(1 for r in op._schema.returns
                if "Tensor" in str(r.type))

    def fn(*args, **kwargs):
        def place(a):
            if isinstance(a, DTensorSpec):
                return Replicate()
            if isinstance(a, (list, tuple)) and any(
                    isinstance(x, DTensorSpec) for x in a):
                return Replicate()
            return None
        return [([Replicate()] * max(n_out, 1), [place(a) for a in args])]
    return fn


def _gather_handler(op_call, args, kwargs):
    """``aten.gather(self, dim, index)`` on DTensors: ``self`` replicated
    along ``dim``, ``index`` redistributed to ``self``'s placements, the
    local gather, the output on those placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    self_, dim, index = args[:3]
    if not isinstance(self_, DTensor):
        self_ = DTensor.from_local(self_, index.device_mesh,
                                   [Replicate()] * index.device_mesh.ndim)
    dim = dim % self_.ndim
    places = [Replicate() if isinstance(p, Shard) and p.dim == dim
              or not isinstance(p, (Shard, Replicate)) else p
              for p in self_.placements]
    src = self_.redistribute(self_.device_mesh, places)
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, src.device_mesh,
                                   [Replicate()] * src.device_mesh.ndim)
    idx = index.redistribute(src.device_mesh, places)
    local = op_call(src.to_local(), dim, idx.to_local(), *args[3:],
                    **kwargs)
    return wrap(local, src.device_mesh, places, index.shape)


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _install():
    """Wrap the sharding propagator (both its cached and uncached entry)
    so that an operator whose propagation fails (no strategy, or a
    strategy that raises: DTensor's rules differ between PyTorch
    versions) gets :func:`_replicate_strategy` and is propagated again;
    and install :func:`_gather_handler`.  Returns the function that
    undoes both."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import register_sharding

    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    inner = prop.propagate_op_sharding_non_cached
    cached = prop.propagate_op_sharding
    handlers = dispatcher._custom_op_handlers
    saved = {}          # op -> (its strategy, its schema info) before

    def retry(op_schema, err):
        op = op_schema.op
        if op in saved or op in handlers:
            raise err
        saved[op] = (prop.op_strategy_funcs.get(op),
                     prop.op_to_schema_info.get(op))
        _REPLICATED.add(str(op))
        register_sharding(op)(_replicate_strategy(op))
        return inner(op_schema)

    def propagate(op_schema):
        try:
            return inner(op_schema)
        except Exception as e:  # noqa: BLE001 - replicated instead
            return retry(op_schema, e)

    def propagate_cached(op_schema):
        try:
            return cached(op_schema)
        except Exception as e:  # noqa: BLE001 - replicated instead
            return retry(op_schema, e)

    gather_before = handlers.get(aten.gather.default)

    def undo():
        prop.propagate_op_sharding_non_cached = inner
        prop.propagate_op_sharding = cached
        for op, (strategy, info) in saved.items():
            for table, old in ((prop.op_strategy_funcs, strategy),
                               (prop.op_to_schema_info, info)):
                if old is None:
                    table.pop(op, None)
                else:
                    table[op] = old
        # the Python and the C++ caches of sharding decisions
        getattr(cached, "cache_clear", lambda: None)()
        getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                lambda: None)()
        if gather_before is None:
            handlers.pop(aten.gather.default, None)
        else:
            handlers[aten.gather.default] = gather_before

    prop.propagate_op_sharding_non_cached = propagate
    prop.propagate_op_sharding = propagate_cached
    handlers[aten.gather.default] = _gather_handler
    return undo


@contextlib.contextmanager
def replicate_fallback():
    """Run DTensor code with the fallbacks above and plain tensors taken
    as replicated (``implicit_replication``).  Yields the set of the
    operators (names) replicated since the outermost context opened."""
    global _DEPTH
    from torch.distributed.tensor.experimental import implicit_replication

    with _LOCK:
        if _DEPTH == 0:
            _REPLICATED.clear()
            _UNDO.append(_install())
        _DEPTH += 1
    try:
        with implicit_replication():
            yield _REPLICATED
    finally:
        with _LOCK:
            _DEPTH -= 1
            if _DEPTH == 0:
                _UNDO.pop()()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor where
    ``torch.distributed`` is absent)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, placements):
    """``x`` redistributed to ``placements`` when it is a DTensor and
    ``placements`` is given (the reference's ``with_sharding_constraint``);
    otherwise ``x`` itself."""
    if placements is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, tuple(placements))


def wrap(local, mesh, placements, shape):
    """A DTensor of global ``shape`` over ``mesh`` whose local shard on
    this rank is ``local`` (contiguous strides)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def local_of(x):
    """The local tensor of a replicated-or-plain ``x``: a DTensor is made
    whole first."""
    if is_dtensor(x):
        return x.full_tensor()
    return x
