"""Multi-device serving plane: a router over per-device schedulers
(port of ``repro.serve.router``).

::

                         QueryRouter.submit(query)
                                   |
                 placement (stickiness) + least-outstanding-work
                 /                 |                  \\
        QueryScheduler(dev0) QueryScheduler(dev1) ... QueryScheduler(devP-1)
                 |                 |                  |
          GraphEngine@dev0   GraphEngine@dev1   GraphEngine@devP-1
                                   |
            sharded-tier gids ->  "mesh" QueryScheduler -> ShardedGraphEngine

* **Placement + stickiness**: the first query for a graph places it on
  the least-loaded device entry (fewest outstanding tickets, ties broken
  by fewest placed graphs); later queries stick to it, so its engine
  cache and batch hints stay warm.  A graph replicated on several
  entries routes each query to its least-outstanding replica.
* **Hot-graph replication**: when one entry's outstanding depth
  dominates the pool (``replicate_factor`` x the mean of the others, and
  at least ``replicate_min_depth``), its hottest graph is replicated onto
  the least-loaded entry; the registry builds the replica engine there on
  first use.
* **Replica decay**: routed traffic is accounted in windows of
  ``decay_window`` placed queries; a replica whose share of its graph's
  window traffic stays at ``<= decay_share`` for ``decay_windows``
  consecutive windows leaves the placement (the largest-share replica
  never does).
* **Engine tiers**: sharded-tier gids bypass placement and go to the
  ``"mesh"`` scheduler, whose batches run on the gid's
  :class:`~repro_torch.serve.registry.ShardedGraphEngine` over the world
  process group (rank 0 serves; the other ranks run
  :meth:`GraphRegistry.follow`).

``devices`` are ``torch.device`` entries (default: every visible CUDA
card; none visible raises, the CPU is never picked).  An entry may repeat
a device: two schedulers then share one card and one engine per graph,
each thread launching on the card's current stream, which the kernels'
wrappers make safe (``kernels/edge_relax/ops.py``).  Each scheduler
double-buffers (see :mod:`repro_torch.serve.scheduler`).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..core.config import EngineConfig, resolve_devices
from ..obs.metrics import MetricsRegistry
from .queries import Query
from .registry import GraphRegistry
from .scheduler import QueryScheduler

__all__ = ["QueryRouter"]


class QueryRouter:
    """Route queries across a pool of per-device :class:`QueryScheduler` s.

    ``devices`` defaults to every visible CUDA device (one scheduler
    each; with none visible this raises, it never picks the CPU);
    an explicit list of ``torch.device`` entries may repeat a device,
    which is how the logic is tested on one card or on the CPU.  All other
    knobs are forwarded to the per-device schedulers (``max_pending``
    bounds *each* device queue — total admission capacity is
    ``P * max_pending``).

    ``config`` accepts an :class:`~repro_torch.core.config.EngineConfig` in
    place of the loose serving kwargs (``max_batch`` / ``max_pending`` /
    ``ecc_batching``, and ``devices`` when the config pins them) — the
    :class:`repro_torch.api.Solver` routed tier's path.

    ``decay_window``/``decay_share``/``decay_windows`` control replica
    decay (see module docstring); ``decay_window=0`` disables it.
    ``decay_min_traffic`` gates decay on a graph's absolute window
    traffic (a gid below it keeps its placement), and replicas
    pre-placed by :meth:`plan_placement` are exempt from decay until
    their forecast traffic actually arrives.
    """

    def __init__(self, registry: GraphRegistry, *, devices=None,
                 config: Optional[EngineConfig] = None,
                 max_batch: Optional[int] = None,
                 backend: Optional[str] = None,
                 admit_window: Optional[int] = None,
                 ecc_batching: Optional[bool] = None,
                 max_pending: Optional[int] = None,
                 feedback: bool = True,
                 replicate_factor: float = 4.0,
                 replicate_min_depth: int = 16,
                 decay_window: int = 256,
                 decay_share: float = 0.05,
                 decay_windows: int = 3,
                 decay_min_traffic: int = 1,
                 clock=time.monotonic,
                 metrics: Optional[MetricsRegistry] = None):
        user_config = config is not None
        config = EngineConfig.from_loose(
            config, "router", max_batch=max_batch, backend=backend,
            max_pending=max_pending, ecc_batching=ecc_batching)
        max_batch = config.max_batch
        max_pending = config.max_pending
        ecc_batching = config.ecc_batching
        if user_config:
            # the registry already carries the config's backend as its
            # default; the router-level override stays unset so lookups
            # defer to it
            backend = None
            if devices is None:
                devices = resolve_devices(config.devices)
        devices = ([torch.device(d) if not isinstance(d, int)
                    else torch.device("cuda", d) for d in devices]
                   if devices is not None
                   else [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())])
        if not devices:
            raise ValueError("need at least one device: no CUDA device is "
                             "visible; pass devices= to serve on others")
        if replicate_factor < 1.0:
            raise ValueError("replicate_factor must be >= 1")
        if decay_window < 0 or decay_windows < 1 or decay_share < 0 \
                or decay_min_traffic < 0:
            raise ValueError("decay_window must be >= 0, decay_windows "
                             ">= 1, decay_share >= 0, decay_min_traffic "
                             ">= 0")
        self.registry = registry
        self.devices = devices
        self.backend = backend
        self.max_batch = max_batch
        self.replicate_factor = replicate_factor
        self.replicate_min_depth = replicate_min_depth
        # one metrics registry for the whole plane: the router, every
        # per-device scheduler, and the graph registry all write to it,
        # so a single snapshot/exposition covers every layer
        self.metrics = metrics if metrics is not None else registry.metrics
        kw = dict(max_batch=max_batch, backend=backend,
                  admit_window=admit_window, ecc_batching=ecc_batching,
                  max_pending=max_pending, feedback=feedback,
                  clock=clock, metrics=self.metrics)
        self.schedulers = [
            QueryScheduler(registry, device=d, name=f"dev{i}", **kw)
            for i, d in enumerate(devices)]
        # sharded-tier engines span the whole mesh; one scheduler drives
        # them so per-device queues stay device-sized
        self.mesh_scheduler = QueryScheduler(registry, device=None,
                                             name="mesh", **kw)
        self._lock = threading.Lock()
        self._placement: Dict[str, List[int]] = {}
        self._load = [0] * len(self.schedulers)      # outstanding tickets
        self._n_placed = [0] * len(self.schedulers)  # graphs placed
        self._gid_load: Dict[Tuple[int, str], int] = {}
        self._mesh_gids: set = set()                 # sharded gids served
        # replica decay accounting (per routing window)
        self.decay_window = decay_window
        self.decay_share = decay_share
        self.decay_windows = decay_windows
        self.decay_min_traffic = decay_min_traffic
        self._window_routed = 0
        self._window_traffic: Dict[Tuple[int, str], int] = {}
        self._cold_streak: Dict[Tuple[int, str], int] = {}
        # capacity-planned replicas (plan_placement): protected from
        # share-based decay until they have carried real traffic
        self._planned: set = set()
        self._c_routed = self.metrics.counter(
            "sssp_router_routed_total", help="Queries routed")
        self._c_replications = self.metrics.counter(
            "sssp_router_replications_total",
            help="Hot-graph replications onto an extra device")
        self._c_rebuilds = self.metrics.counter(
            "sssp_router_rebuilds_total",
            help="Replica engines rebuilt after a spec re-register")
        self._c_decays = self.metrics.counter(
            "sssp_router_decays_total",
            help="Cold replicas removed from a graph's placement")
        # replica consistency: a re-register() drops the cached engines,
        # but an already-placed replica would otherwise serve its next
        # query from a cold build; rebuild every replica eagerly instead
        registry.add_invalidation_listener(self._rebuild_replicas)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    # legacy counter attributes: read-throughs of the metrics series
    @property
    def n_routed(self) -> int:
        return self._c_routed.value

    @property
    def n_replications(self) -> int:
        return self._c_replications.value

    @property
    def n_rebuilds(self) -> int:
        return self._c_rebuilds.value

    @property
    def n_decays(self) -> int:
        return self._c_decays.value

    def _all_schedulers(self):
        return self.schedulers + [self.mesh_scheduler]

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _route_locked(self, gid: str) -> int:
        placed = self._placement.get(gid)
        if not placed:
            idx = min(range(len(self.schedulers)),
                      key=lambda i: (self._load[i], self._n_placed[i], i))
            self._placement[gid] = [idx]
            self._n_placed[idx] += 1
            return idx
        if len(placed) == 1:
            return placed[0]
        return min(placed, key=lambda i: (self._load[i], i))

    def _done(self, idx: int, gid: str) -> None:
        with self._lock:
            self._load[idx] = max(self._load[idx] - 1, 0)
            key = (idx, gid)
            left = self._gid_load.get(key, 0) - 1
            if left > 0:
                self._gid_load[key] = left
            else:
                self._gid_load.pop(key, None)

    def _maybe_replicate_locked(self) -> None:
        """Replicate the hottest graph off a dominating device."""
        if len(self.schedulers) < 2:
            return
        hot = max(range(len(self._load)), key=lambda i: self._load[i])
        depth = self._load[hot]
        if depth < self.replicate_min_depth:
            return
        others = [l for i, l in enumerate(self._load) if i != hot]
        if depth < self.replicate_factor * (sum(others) / len(others) + 1.0):
            return
        gids = [(c, g) for (i, g), c in self._gid_load.items() if i == hot]
        if not gids:
            return
        gid = max(gids)[1]
        cold = min(range(len(self._load)),
                   key=lambda i: (self._load[i], self._n_placed[i], i))
        placed = self._placement.setdefault(gid, [])
        if cold == hot or cold in placed:
            return
        placed.append(cold)
        self._n_placed[cold] += 1
        self._c_replications.inc()

    def _maybe_decay_locked(self) -> None:
        """Close one routing window; shrink placements of replicas whose
        traffic share stayed ~0 for ``decay_windows`` consecutive windows
        (the teardown counterpart of :meth:`_maybe_replicate_locked`)."""
        if not self.decay_window \
                or self._window_routed < self.decay_window:
            return
        gid_totals: Dict[str, int] = {}
        for (_, gid), c in self._window_traffic.items():
            gid_totals[gid] = gid_totals.get(gid, 0) + c
        for gid, placed in self._placement.items():
            total = gid_totals.get(gid, 0)
            if len(placed) < 2 or total < max(1, self.decay_min_traffic):
                # nothing to shrink / a cold or below-threshold gid keeps
                # its placement (decay reacts to *skew*, not absence)
                for i in placed:
                    self._cold_streak.pop((i, gid), None)
                continue
            shares = {i: self._window_traffic.get((i, gid), 0) / total
                      for i in placed}
            # the replica carrying the largest share survives always
            keep = max(placed, key=lambda i: (shares[i], -i))
            for i in list(placed):
                key = (i, gid)
                if key in self._planned:
                    # capacity-planned replica: forecast traffic hasn't
                    # arrived yet — protected until it carries a real
                    # share, then it competes like any other replica
                    if shares[i] > self.decay_share:
                        self._planned.discard(key)
                    self._cold_streak.pop(key, None)
                    continue
                if i != keep and shares[i] <= self.decay_share:
                    streak = self._cold_streak.get(key, 0) + 1
                    if streak >= self.decay_windows:
                        placed.remove(i)
                        self._n_placed[i] = max(self._n_placed[i] - 1, 0)
                        self._cold_streak.pop(key, None)
                        self._c_decays.inc()
                    else:
                        self._cold_streak[key] = streak
                else:
                    self._cold_streak.pop(key, None)
        self._window_traffic = {}
        self._window_routed = 0

    def _rebuild_replicas(self, gid: str, generation: int) -> None:
        """Registry invalidation hook: rebuild every placed replica of
        ``gid`` (and a served sharded-tier engine) at the new generation.

        Runs in the re-registering thread; each build goes through the
        registry's per-key build futures, so queries racing the rebuild
        simply share it instead of serving a second cold build.

        Streaming edits never reach this hook:
        :meth:`GraphRegistry.apply_delta` patches every cached engine in
        place — per-device replicas included, each under its existing
        ``(gid, backend, device)`` cache key — without bumping the
        generation or firing listeners.  One host-side patch serves all
        N placements; ``n_rebuilds`` stays flat across deltas (the
        rebuild-per-replica path is reserved for full re-registers).
        """
        try:
            tier = self.registry.tier(gid)
        except KeyError:
            return
        if tier == "sharded":
            with self._lock:
                served = gid in self._mesh_gids
            if served:
                self.registry.engine(gid, self.backend)
                self._c_rebuilds.inc()
            return
        with self._lock:
            idxs = list(self._placement.get(gid, ()))
        seen = set()
        for idx in idxs:
            dev = self.devices[idx]
            dev_key = str(dev)
            if dev_key in seen:     # duplicated devices share one engine
                continue
            seen.add(dev_key)
            self.registry.engine(gid, self.backend, device=dev)
            self._c_rebuilds.inc()

    def plan_placement(self, weights: Dict[str, float]) -> Dict[str, list]:
        """Pre-place graphs with replica counts proportional to expected
        load (capacity planning from historical/forecast traffic shares).

        Each gid gets ``max(1, round(P * weight / total))`` replicas
        (capped at P), assigned hottest-first onto the devices hosting
        the fewest graphs.  Combine with :meth:`warmup` so every replica
        engine is built + compiled before traffic; the dynamic
        replication path then only handles *unforecast* shifts.  Returns
        ``{gid: [scheduler names]}``.
        """
        total = float(sum(weights.values()))
        if total <= 0:
            raise ValueError("weights must sum to > 0")
        n_sch = len(self.schedulers)
        with self._lock:
            for gid, wt in sorted(weights.items(), key=lambda kv: -kv[1]):
                if self.registry.tier(gid) == "sharded":
                    continue          # spans the mesh already
                n_rep = max(1, min(n_sch, round(n_sch * wt / total)))
                placed = self._placement.setdefault(gid, [])
                while len(placed) < n_rep:
                    free = [i for i in range(n_sch) if i not in placed]
                    if not free:
                        break
                    idx = min(free, key=lambda i: (self._n_placed[i], i))
                    placed.append(idx)
                    self._n_placed[idx] += 1
                # the plan endorses this placement: protect it from
                # share-based decay until its forecast traffic shows up
                self._planned.update((i, gid) for i in placed)
            return {gid: [self.schedulers[i].name for i in idxs]
                    for gid, idxs in self._placement.items()}

    def submit(self, query: Query, *, priority: int = 0,
               deadline_s: Optional[float] = None):
        """Route and enqueue one query; returns the scheduler future.

        Raises :class:`~repro_torch.serve.scheduler.QueueFull` when the target
        device's bounded queue is full (load shedding is per device —
        sticky traffic must not hide one hot device behind idle ones).
        """
        gid = query.gid
        try:
            tier = self.registry.tier(gid)
        except KeyError:
            # unknown gid: route to the least-loaded scheduler *without*
            # creating placement state (the engine lookup fails the future
            # loudly; phantom gids must not skew placement tie-breaking)
            with self._lock:
                idx = min(range(len(self.schedulers)),
                          key=lambda i: (self._load[i], i))
            self._c_routed.inc()
            return self.schedulers[idx].submit(query, priority=priority,
                                               deadline_s=deadline_s)
        if tier == "sharded":
            fut = self.mesh_scheduler.submit(query, priority=priority,
                                             deadline_s=deadline_s)
            self._c_routed.inc()
            with self._lock:
                self._mesh_gids.add(gid)
            return fut
        with self._lock:
            idx = self._route_locked(gid)
        fut = self.schedulers[idx].submit(query, priority=priority,
                                          deadline_s=deadline_s)
        self._c_routed.inc()
        with self._lock:
            self._load[idx] += 1
            self._gid_load[(idx, gid)] = \
                self._gid_load.get((idx, gid), 0) + 1
            self._window_routed += 1
            self._window_traffic[(idx, gid)] = \
                self._window_traffic.get((idx, gid), 0) + 1
            self._maybe_replicate_locked()
            self._maybe_decay_locked()
        # outside the router lock: a done future runs the callback inline
        fut.add_done_callback(lambda _f, i=idx, g=gid: self._done(i, g))
        return fut

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Start one background worker per device (plus the mesh one)."""
        for sch in self._all_schedulers():
            sch.start()

    def stop(self, cancel_pending: bool = False) -> None:
        for sch in self._all_schedulers():
            sch.stop(cancel_pending=cancel_pending)

    def drain(self, max_steps: int = 10_000) -> int:
        """Synchronously round-robin the pool until every queue empties
        (single-threaded alternative to :meth:`start`)."""
        steps = 0
        progress = True
        while progress and steps < max_steps:
            progress = False
            for sch in self._all_schedulers():
                if steps >= max_steps:
                    break
                if sch.step():
                    steps += 1
                    progress = True
        return steps

    # ------------------------------------------------------------------
    # warmup + stats
    # ------------------------------------------------------------------

    def warmup(self, gids=None, *, kinds=("tree",), batch_sizes=None):
        """Pre-place graphs and pre-pay their builds before traffic.

        Each single-tier gid is placed (becoming its sticky device) and
        its engine built there, with one batch per kind, via
        :meth:`GraphRegistry.warmup`; sharded-tier gids warm on the mesh.
        ``batch_sizes`` defaults to this router's ``max_batch``, the
        width traffic runs at (the kernels' scratch of that size).
        Returns the registry warmup rows with the serving scheduler
        attached.
        """
        if batch_sizes is None:
            batch_sizes = (self.max_batch,)
        if isinstance(gids, str):
            gids = [gids]
        gids = list(self.registry.gids) if gids is None else list(gids)
        rows = []
        for gid in gids:
            if self.registry.tier(gid) == "sharded":
                with self._lock:
                    self._mesh_gids.add(gid)
                rs = self.registry.warmup([gid], backend=self.backend,
                                          kinds=kinds,
                                          batch_sizes=batch_sizes)
                for r in rs:
                    r["scheduler"] = self.mesh_scheduler.name
                rows.extend(rs)
                continue
            with self._lock:
                self._route_locked(gid)      # place if unplaced
                idxs = list(self._placement[gid])
            for idx in idxs:                 # warm every replica device
                rs = self.registry.warmup([gid], backend=self.backend,
                                          device=self.devices[idx],
                                          kinds=kinds,
                                          batch_sizes=batch_sizes)
                for r in rs:
                    r["scheduler"] = self.schedulers[idx].name
                rows.extend(rs)
        return rows

    def stats(self) -> dict:
        per = [sch.stats() for sch in self._all_schedulers()]
        n_batches = sum(s["n_batches"] for s in per)
        n_done = sum(s["n_done"] for s in per)
        with self._lock:
            placement = {gid: [self.schedulers[i].name for i in idxs]
                         for gid, idxs in self._placement.items()}
            return {
                "n_devices": self.n_devices,
                "n_routed": self.n_routed,
                "n_replications": self.n_replications,
                "n_rebuilds": self.n_rebuilds,
                "n_decays": self.n_decays,
                "n_batches": n_batches,
                "n_done": n_done,
                "n_expired": sum(s["n_expired"] for s in per),
                "rejected": sum(s["rejected"] for s in per),
                "pending": sum(s["pending"] for s in per),
                "occupancy": (n_done / (n_batches * self.max_batch)
                              if n_batches else 0.0),
                "placement": placement,
                "schedulers": per,
                "registry": self.registry.stats.as_dict(),
            }
