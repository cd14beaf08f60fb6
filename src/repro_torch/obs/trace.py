"""Per-round solve traces: a device-side ring and the host-side
``SolveTrace`` (port of ``repro.obs.trace``).

With ``EngineConfig(trace=True)`` the engines (single device, batched,
fused, the sharded v1 engine) append one record per loop iteration into
a fixed-capacity ring of device tensors (:class:`TraceBuf`), and the
facade copies it to the host once as a :class:`SolveTrace` on
``SolveResult.trace``.

* **Reads state only.**  A record is built from the loop state before
  and after an iteration, so ``dist``, ``parent`` and the metrics are
  bitwise the untraced solve's.
* **Exact counter deltas.**  A record holds the iteration's delta of
  every logical counter as int32: the sums of a trace's counter columns
  plus the engine's initial metrics (``n_extended`` starts at 1 for the
  source's pop) are the final ``SsspMetrics``
  (:meth:`SolveTrace.counter_sums`).
* **Fixed footprint, no host read.**  The ring holds ``capacity``
  records; record ``n`` lands at ``n % capacity`` through a device-side
  index, and ``SolveTrace.dropped`` reports the records overwritten.

One record covers one iteration of the solve loop: a relaxation round
(or one call of the fused kernel, up to ``fused_rounds`` rounds) and,
when the frontier emptied, the step transition and its pull phase
(``stepped == 1``).  The columns, their order and dtypes are the
reference's, so the two packages' records compare directly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "TRACE_COLUMNS", "TRACE_I32_COLUMNS", "TRACE_F32_COLUMNS",
    "TRACE_COUNTER_COLUMNS", "TraceBuf", "trace_init", "trace_append",
    "SolveTrace", "materialize_trace",
]

# int32 columns: loop position, frontier census, and the per-iteration
# deltas of every logical SsspMetrics counter (bitwise-exact sums).
TRACE_I32_COLUMNS = (
    "iter",           # loop iteration index this record describes
    "frontier",       # frontier size at the start of the iteration
    "stepped",        # 1 if this iteration ran the step transition
    "n_rounds",       # logical-counter deltas from here on
    "n_steps",
    "n_extended",
    "n_trav",
    "n_pull_trav",
    "n_relax",
    "n_updates",
    "n_pruned",
)

# float32 columns: the stepping window at the start of the iteration and
# the physical (layout/launch geometry) counter deltas, which are f32 in
# SsspMetrics already.
TRACE_F32_COLUMNS = (
    "lb", "ub", "st",
    "n_tiles_scanned", "n_tiles_dense", "n_invocations",
)

TRACE_COLUMNS = TRACE_I32_COLUMNS + TRACE_F32_COLUMNS

# Columns that are SsspMetrics counter deltas; summing each over the
# records of a trace that did not overflow and adding the engine's
# initial metrics (n_extended starts at 1 for the source pop, the rest
# at 0) gives the final SsspMetrics field exactly.
TRACE_COUNTER_COLUMNS = (
    "n_rounds", "n_steps", "n_extended", "n_trav", "n_pull_trav",
    "n_relax", "n_updates", "n_pruned", "n_tiles_scanned",
    "n_tiles_dense", "n_invocations",
)


class TraceBuf(NamedTuple):
    """The device ring: two column planes plus a write count.

    ``n`` counts the records ever written; record ``n`` goes to row
    ``n % capacity``, so an overflow drops the oldest records.  A batched
    solve stacks one ring per slot: ``[S, capacity, cols]`` planes and an
    ``[S]`` count.  :func:`trace_append` writes the tensors in place.
    """
    idata: torch.Tensor   # [(S,) capacity, len(TRACE_I32_COLUMNS)] int32
    fdata: torch.Tensor   # [(S,) capacity, len(TRACE_F32_COLUMNS)] float32
    n: torch.Tensor       # [(S,)] int32


def trace_init(capacity: int, device=None, slots: int | None = None
               ) -> TraceBuf:
    """A fresh empty ring of ``capacity`` records on ``device`` (one per
    slot with ``slots``)."""
    if capacity <= 0:
        raise ValueError(f"trace capacity must be >= 1, got {capacity}")
    lead = () if slots is None else (int(slots),)
    return TraceBuf(
        idata=torch.zeros(*lead, capacity, len(TRACE_I32_COLUMNS),
                          dtype=torch.int32, device=device),
        fdata=torch.zeros(*lead, capacity, len(TRACE_F32_COLUMNS),
                          dtype=torch.float32, device=device),
        n=torch.zeros(lead, dtype=torch.int32, device=device))


def trace_append(buf: TraceBuf, ivals: dict, fvals: dict,
                 rows: torch.Tensor | None = None) -> TraceBuf:
    """Append one record; the keys must cover every column.  The values
    are tensors on the ring's device (a Python number would cost a copy
    that waits for the stream): 0-d for one ring, ``[S]`` for a stacked
    one, of which only the slots in ``rows`` (int64 ids) are written."""
    irow = torch.stack([torch.as_tensor(ivals[c]).to(torch.int32)
                        for c in TRACE_I32_COLUMNS], dim=-1)
    frow = torch.stack([torch.as_tensor(fvals[c]).to(torch.float32)
                        for c in TRACE_F32_COLUMNS], dim=-1)
    cap = buf.idata.shape[-2]
    if rows is None:
        pos = torch.remainder(buf.n, cap).to(torch.int64).reshape(1)
        buf.idata.index_copy_(0, pos, irow.reshape(1, -1))
        buf.fdata.index_copy_(0, pos, frow.reshape(1, -1))
        buf.n.add_(1)
        return buf
    pos = torch.remainder(buf.n[rows], cap).to(torch.int64)
    buf.idata[rows, pos] = irow[rows]
    buf.fdata[rows, pos] = frow[rows]
    buf.n.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
    return buf


@dataclasses.dataclass(frozen=True)
class SolveTrace:
    """Host-side view of one solve's per-round records (oldest first).

    ``columns`` maps every :data:`TRACE_COLUMNS` name to a 1-D numpy
    array of length :attr:`n_records`.  ``n_recorded`` counts records the
    engine *wrote* (>= ``n_records`` iff the ring overflowed).
    """
    columns: dict
    n_recorded: int
    capacity: int

    @property
    def n_records(self) -> int:
        """Records retained in the ring (== n_recorded unless overflowed)."""
        return min(self.n_recorded, self.capacity)

    @property
    def dropped(self) -> int:
        """Oldest records lost to ring overflow."""
        return max(0, self.n_recorded - self.capacity)

    def __len__(self) -> int:
        return self.n_records

    def records(self) -> list:
        """The trace as a list of per-round dicts (oldest first)."""
        return [{c: self.columns[c][i].item() for c in TRACE_COLUMNS}
                for i in range(self.n_records)]

    def counter_sums(self) -> dict:
        """Summed per-round counter deltas (exact int64 / float64 sums).

        For a trace that did not overflow, ``initial + counter_sums() ==
        final`` holds bitwise per logical ``SsspMetrics`` field, where
        *initial* is the engine's metric init (``n_extended = 1`` for the
        source pop, everything else 0).
        """
        out = {}
        for c in TRACE_COUNTER_COLUMNS:
            col = self.columns[c]
            if col.dtype.kind == "i":
                out[c] = int(col.astype(np.int64).sum())
            else:
                out[c] = float(col.astype(np.float64).sum())
        return out

    def summary(self) -> dict:
        """Small host-side digest (for logs / demo output)."""
        fr = self.columns["frontier"]
        return {
            "n_records": self.n_records,
            "dropped": self.dropped,
            "n_steps": int(self.columns["stepped"].sum()),
            "max_frontier": int(fr.max()) if len(fr) else 0,
            "mean_frontier": float(fr.mean()) if len(fr) else 0.0,
            **self.counter_sums(),
        }


def _materialize_one(idata, fdata, n) -> SolveTrace:
    cap = idata.shape[0]
    n = int(n)
    kept = min(n, cap)
    # unroll the ring: the oldest retained record sits at n % cap when
    # the ring overflowed, else at 0
    start = n % cap if n > cap else 0
    order = (np.arange(kept) + start) % cap
    cols = {}
    for j, c in enumerate(TRACE_I32_COLUMNS):
        cols[c] = idata[order, j]
    for j, c in enumerate(TRACE_F32_COLUMNS):
        cols[c] = fdata[order, j]
    return SolveTrace(columns=cols, n_recorded=n, capacity=cap)


def materialize_trace(buf: TraceBuf):
    """Device ring -> host ``SolveTrace`` (a list of them for a stacked
    ``[S, cap, cols]`` ring, one per slot), with one copy of each plane."""
    idata, fdata, n = (t.cpu().numpy() for t in buf)
    if idata.ndim == 2:
        return _materialize_one(idata, fdata, n)
    return [_materialize_one(idata[i], fdata[i], n[i])
            for i in range(idata.shape[0])]
