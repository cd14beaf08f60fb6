"""Async admission layer: thread-safe query queue -> batched engine runs
(port of ``repro.serve.scheduler``).

Producers call :meth:`QueryScheduler.submit` from any thread and get a
``concurrent.futures.Future`` resolving to a
:class:`~repro_torch.serve.queries.QueryResult`.  A batch step (driven
either synchronously via :meth:`step`/:meth:`drain` or by the background
worker started with :meth:`start`) then

1. **expires** tickets whose deadline passed (``DeadlineExceeded`` on the
   future) — deadline-aware admission;
2. orders the queue by ``(priority desc, deadline, FIFO seq)`` and picks
   the head-of-line ticket — priority-aware admission;
3. restricts an ``admit_window`` of queue-front tickets to the head's
   batch-compatibility key ``(gid, goal kind)`` (one engine and goal per
   batch), then fills the remaining slots with the window tickets whose
   **estimated stepping cost** is nearest the head's, so a batch is not
   dominated by one long-running outlier's rounds.  The estimate
   is the engine's ``batch_hint`` — landmark-BFS eccentricity blended
   (EMA) with *measured* per-source round counts this scheduler feeds
   back after every batch;
4. pads free slots by repeating slot 0 (the reference's static batch
   shape; padded results are discarded, never surfaced) and runs one
   batched ``sssp_batch`` goal query.

**Device affinity.**  A scheduler constructed with ``device=`` (a
``torch.device``) asks the registry for engines placed on that device;
the router (:mod:`repro_torch.serve.router`) runs one such scheduler per
device entry, and two entries may name one card.  Each scheduler thread
launches on its card's current stream (the default stream), so the
kernels' cached scratch sees one call at a time
(``kernels/edge_relax/ops.py``).

**Load shedding.**  With ``max_pending`` set, :meth:`submit` rejects at
submit time with :class:`QueueFull` once that many tickets queue
(counted in ``stats()["rejected"]``) instead of only expiring deadlines
after admission — bounded queues are what keep overload from turning
into unbounded latency.

**Double buffering.**  ``run_batch`` returns tensors on the device (its
solve loop reads a flag tensor an iteration, so most of it has run by
then); the background worker dispatches batch *k+1* before copying
batch *k*'s results to the host and finalizing them (path
reconstruction, result shaping, future callbacks), as the reference
does.

The head of line is always admitted, so priority/FIFO progress is
starvation-free; the cost-hint grouping only chooses its *companions*.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from .queries import ExecutionPlan, Query, _host, finalize, plan
from .registry import GraphRegistry
from ..obs.metrics import MetricsRegistry

__all__ = ["DeadlineExceeded", "QueueFull", "QueryScheduler"]


class DeadlineExceeded(Exception):
    """Raised on a query future whose deadline passed before admission."""


class QueueFull(Exception):
    """Raised by ``submit`` when the bounded admission queue is full."""


@dataclasses.dataclass
class _Ticket:
    seq: int
    query: Query
    plan: ExecutionPlan
    priority: int
    deadline: Optional[float]         # absolute monotonic time or None
    future: Future
    t_submit: float

    def sort_key(self):
        return (-self.priority,
                self.deadline if self.deadline is not None else float("inf"),
                self.seq)


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-not-finalized batch (the double buffer slot)."""
    batch: List[_Ticket]
    eng: object
    sources: np.ndarray               # real (unpadded) ticket sources
    dist: object                      # device tensors
    parent: object
    metrics: object


class QueryScheduler:
    """Thread-safe admission queue over a :class:`GraphRegistry`."""

    def __init__(self, registry: GraphRegistry, *, max_batch: int = 8,
                 backend: Optional[str] = None,
                 admit_window: Optional[int] = None,
                 ecc_batching: bool = True,
                 device=None, name: Optional[str] = None,
                 max_pending: Optional[int] = None,
                 feedback: bool = True, feedback_gamma: float = 0.25,
                 clock=time.monotonic,
                 metrics: Optional[MetricsRegistry] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if admit_window is None:
            admit_window = 4 * max_batch
        if admit_window < 1:
            raise ValueError("admit_window must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.registry = registry
        self.max_batch = max_batch
        self.backend = backend
        self.admit_window = admit_window
        self.ecc_batching = ecc_batching
        self.device = device
        self.name = name if name is not None else (
            "default" if device is None
            else f"dev{getattr(device, 'id', device)}")
        self.max_pending = max_pending
        self.feedback = feedback
        self.feedback_gamma = feedback_gamma
        # every deadline/latency read goes through the injectable clock
        # (monotonic seconds), so expiry/histogram tests run on fake time
        self._clock = clock
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: List[_Ticket] = []
        self._seq = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        self._inflight_n = 0
        # serving counters (the benchmark's occupancy/throughput inputs)
        # live in the shared MetricsRegistry — one series per scheduler
        # name; the legacy attributes below read through to them
        self.metrics = metrics if metrics is not None else registry.metrics
        lbl = {"scheduler": self.name}
        self._c_batches = self.metrics.counter(
            "sssp_scheduler_batches_total", "fused batches executed", lbl)
        self._c_done = self.metrics.counter(
            "sssp_scheduler_queries_done_total", "queries resolved", lbl)
        self._c_expired = self.metrics.counter(
            "sssp_scheduler_expired_total",
            "queries expired before admission", lbl)
        self._c_rejected = self.metrics.counter(
            "sssp_scheduler_rejected_total",
            "queries rejected at submit (queue full)", lbl)
        self._g_pending = self.metrics.gauge(
            "sssp_scheduler_pending", "tickets queued", lbl)
        self._g_inflight = self.metrics.gauge(
            "sssp_scheduler_inflight", "tickets dispatched, unfinalized",
            lbl)
        self._h_latency = self.metrics.histogram(
            "sssp_query_latency_seconds",
            "submit-to-result latency per query", lbl)

    # legacy counter attributes read through to the metrics registry
    @property
    def n_batches(self) -> int:
        return self._c_batches.value

    @property
    def n_done(self) -> int:
        return self._c_done.value

    @property
    def n_expired(self) -> int:
        return self._c_expired.value

    @property
    def n_rejected(self) -> int:
        return self._c_rejected.value

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------

    def submit(self, query: Query, *, priority: int = 0,
               deadline_s: Optional[float] = None,
               _now: Optional[float] = None) -> Future:
        """Enqueue a query; higher ``priority`` is served first (FIFO
        within a priority level), ``deadline_s`` seconds from now bounds
        its queueing time.  Raises :class:`QueueFull` (and counts the
        rejection) when a bounded queue is at ``max_pending``.
        ``_now`` overrides the scheduler clock for this one call (tests);
        construct with ``clock=`` to fake time everywhere."""
        now = self._clock() if _now is None else _now
        fut: Future = Future()
        with self._work:
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self._c_rejected.inc()
                raise QueueFull(
                    f"admission queue full ({self.max_pending} pending) "
                    f"on scheduler {self.name!r}; query {query} rejected")
            self._seq += 1
            self._pending.append(_Ticket(
                seq=self._seq, query=query, plan=plan(query),
                priority=priority,
                deadline=None if deadline_s is None else now + deadline_s,
                future=fut, t_submit=now))
            self._g_pending.set(len(self._pending))
            self._work.notify()
        return fut

    def outstanding(self) -> int:
        """Queued + dispatched-but-unfinished tickets.  (The router keeps
        its own per-submit load counters so routing never takes scheduler
        locks; this is the introspection equivalent.)"""
        with self._lock:
            return len(self._pending) + self._inflight_n

    # ------------------------------------------------------------------
    # batch formation + execution
    # ------------------------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        live = []
        for t in self._pending:
            if t.deadline is not None and now > t.deadline:
                self._c_expired.inc()
                try:
                    t.future.set_exception(DeadlineExceeded(
                        f"query {t.query} missed its deadline by "
                        f"{now - t.deadline:.3f}s in the queue"))
                except Exception:   # racing producer-side cancel() is fine
                    pass
            else:
                live.append(t)
        self._pending = live

    def _select_locked(self) -> List[_Ticket]:
        """Pick one batch (head-of-line + cost-nearest companions)."""
        self._pending.sort(key=_Ticket.sort_key)
        window = self._pending[:self.admit_window]
        head = window[0]
        group = [t for t in window if t.plan.key == head.plan.key]
        if len(group) > self.max_batch:
            companions = group[1:]
            # peek never builds: a cold engine here would run the build
            # under the scheduler lock, stalling every producer.  On a
            # cold entry this batch gets FIFO companions; _dispatch builds
            # the engine outside the lock, so later batches cost-sort.
            eng = self.registry.peek(head.plan.gid, self.backend,
                                     device=self.device)
            if eng is not None and self.ecc_batching and self.max_batch > 1:
                try:
                    # peek only: the landmark BFS behind batch_hint must
                    # not run under this lock (_dispatch pre-pays it off
                    # the lock; until then companions stay FIFO)
                    hint = eng.peek_batch_hint()
                    if hint is not None:
                        ref = hint[head.query.source]
                        companions.sort(
                            key=lambda t: (abs(hint[t.query.source] - ref),
                                           t.seq))
                except Exception:
                    # fall back to FIFO companions; _dispatch will surface
                    # any per-ticket problem on its future
                    pass
            # the head is always admitted (no grouping starvation); the
            # hint only chooses its companion slots
            group = [head] + companions[:self.max_batch - 1]
        taken = set(id(t) for t in group)
        self._pending = [t for t in self._pending if id(t) not in taken]
        return group

    def step(self, _now: Optional[float] = None) -> bool:
        """Admit, execute and finalize one batch synchronously; returns
        whether work was done."""
        did, inflight = self._dispatch_one(_now)
        if inflight is not None:
            self._finalize(inflight)
        return did

    def _dispatch_one(self, _now: Optional[float] = None
                      ) -> Tuple[bool, Optional[_Inflight]]:
        """Admit one batch and dispatch it to the device (non-blocking)."""
        with self._lock:
            self._expire_locked(self._clock() if _now is None else _now)
            if not self._pending:
                self._g_pending.set(len(self._pending))
                return False, None
            batch = self._select_locked()
            self._g_pending.set(len(self._pending))
        batch = [t for t in batch if t.future.set_running_or_notify_cancel()]
        if not batch:
            return True, None   # all cancelled — the queue made progress
        return True, self._dispatch(batch)

    def _dispatch(self, batch: List[_Ticket]) -> Optional[_Inflight]:
        head = batch[0]
        try:
            # registry is internally locked with per-key build futures; a
            # cold build here happens outside the scheduler lock, so
            # producers (and other gids' batches) keep moving
            eng = self.registry.engine(head.plan.gid, self.backend,
                                       device=self.device)
            if self.ecc_batching and self.max_batch > 1:
                try:
                    eng.batch_hint   # pre-pay the landmark BFS off-lock
                except Exception:
                    pass             # grouping falls back to FIFO
            # out-of-range vertex ids must fail loudly here, before they
            # index the engine's tensors
            batch = [t for t in batch if _check_vertices(t, eng.n)]
            if not batch:
                return None
            head = batch[0]
            pad = self.max_batch - len(batch)
            # repeat slot 0 in free slots: static shape, results discarded
            plans = [t.plan for t in batch] + [head.plan] * pad
            sources = np.array([t.query.source for t in batch] +
                               [head.query.source] * pad, np.int32)
            dist, parent, metrics = eng.run_batch(
                sources, goal=head.plan.goal,
                goal_params=[p.goal_param for p in plans])
        except Exception as exc:     # engine failure fails the whole batch
            for t in batch:
                t.future.set_exception(exc)
            return None              # futures carry the error; keep serving
        with self._lock:
            self._inflight_n += len(batch)
            self._g_inflight.set(self._inflight_n)
        return _Inflight(batch=batch, eng=eng,
                         sources=sources[:len(batch)],
                         dist=dist, parent=parent, metrics=metrics)

    def _finalize(self, inflight: _Inflight) -> None:
        """Force one dispatched batch to the host and resolve its futures
        (the host half of the double buffer)."""
        batch, eng = inflight.batch, inflight.eng
        try:
            dist = _host(inflight.dist)            # waits for the device
            parent = _host(inflight.parent)
            metrics = type(inflight.metrics)(*map(_host, inflight.metrics))
        except Exception as exc:
            for t in batch:
                t.future.set_exception(exc)
            with self._lock:
                self._inflight_n -= len(batch)
                self._g_inflight.set(self._inflight_n)
            return
        if self.feedback:
            try:
                # measured rounds -> engine batch hints (EMA); padding
                # slots are excluded (sources holds real tickets only)
                eng.record_rounds(inflight.sources,
                                  metrics.n_rounds[:len(batch)],
                                  gamma=self.feedback_gamma)
            except Exception:
                pass                 # a hint failure must not fail results
        now = self._clock()
        for slot, t in enumerate(batch):
            res = finalize(t.query, eng.deg, dist[slot], parent[slot],
                           _slot_tree(metrics, slot))
            res.latency_s = now - t.t_submit
            res.served_by = self.name
            self._h_latency.observe(res.latency_s)
            t.future.set_result(res)
        with self._lock:
            self._c_batches.inc()
            self._c_done.inc(len(batch))
            self._inflight_n -= len(batch)
            self._g_inflight.set(self._inflight_n)

    def drain(self, max_steps: int = 10_000) -> int:
        """Synchronously run batches until the queue empties."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps

    # ------------------------------------------------------------------
    # background worker (double-buffered)
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Serve the queue from a daemon thread until :meth:`stop`.

        The worker keeps one batch in flight while finalizing the
        previous one: dispatch *k+1*, then force + finalize *k* — so
        host-side result shaping overlaps device compute.
        """
        if self._worker is not None:
            return
        self._stop = False

        def loop():
            inflight: Optional[_Inflight] = None
            while True:
                with self._work:
                    while (not self._pending and not self._stop
                           and inflight is None):
                        self._work.wait(timeout=0.1)
                    stop = self._stop
                nxt = None
                if not stop:
                    _, nxt = self._dispatch_one()
                if inflight is not None:
                    self._finalize(inflight)
                inflight = nxt
                if stop and inflight is None:
                    return

        self._worker = threading.Thread(
            target=loop, name=f"query-scheduler-{self.name}", daemon=True)
        self._worker.start()

    def stop(self, cancel_pending: bool = False) -> None:
        """Stop the worker thread (finalizing any in-flight batch).
        Still-queued tickets stay pending (a later
        :meth:`drain`/:meth:`start` serves them) unless
        ``cancel_pending`` — then their futures are cancelled so no
        caller blocks forever on an abandoned query."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if cancel_pending:
            with self._lock:
                dropped, self._pending = self._pending, []
            for t in dropped:
                t.future.cancel()

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """The legacy per-scheduler dict; every value is read from the
        shared :class:`~repro_torch.obs.metrics.MetricsRegistry` series, so
        this and ``metrics.snapshot()`` can never disagree."""
        with self._lock:
            n_batches, n_done = self.n_batches, self.n_done
            occ = (n_done / (n_batches * self.max_batch)
                   if n_batches else 0.0)
            return {"name": self.name, "n_batches": n_batches,
                    "n_done": n_done, "n_expired": self.n_expired,
                    "rejected": self.n_rejected, "occupancy": occ,
                    "pending": len(self._pending),
                    "inflight": self._inflight_n,
                    "registry": self.registry.stats.as_dict()}


def _slot_tree(metrics, slot: int):
    """Index one slot out of stacked metrics (an ``SsspMetrics`` of
    ``[S]`` leaves)."""
    return type(metrics)(*(x[slot] for x in metrics))


def _check_vertices(t: _Ticket, n: int) -> bool:
    """Fail a ticket whose vertex ids don't exist in its graph."""
    q = t.query
    for label, v in (("source", q.source), ("target", q.target)):
        if v is not None and not 0 <= v < n:
            t.future.set_exception(ValueError(
                f"{label} {v} out of range for graph {q.gid!r} (n={n})"))
            return False
    return True
