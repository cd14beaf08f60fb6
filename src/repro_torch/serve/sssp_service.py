"""Single-graph SSSP endpoint: a thin wrapper over the serving plane
(port of ``repro.serve.sssp_service``).

``SsspService`` registers its one graph in a
:class:`~repro_torch.serve.registry.GraphRegistry` and drives a
synchronous :class:`~repro_torch.serve.scheduler.QueryScheduler` step
per ``step()`` call, on ``device`` (default: the config's first pinned
device, else the current card); with ``devices=`` it fronts a
:class:`~repro_torch.serve.router.QueryRouter` over those devices
instead.  It admits FIFO requests of any goal kind: mixed kinds batch as
plan-compatible sub-batches, one batch per kind.  A graph at or above
``shard_threshold_n``/``_m`` is served by the sharded tier (a
:class:`~repro_torch.serve.registry.ShardedGraphEngine`, which needs a
process group); ``g`` is then None.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import EngineConfig, resolve_devices
from ..core.graph import DeviceGraph, HostGraph
from ..obs.export import to_prometheus, write_jsonl_snapshot
from .queries import Query
from .registry import GraphRegistry
from .router import QueryRouter
from .scheduler import QueryScheduler

_GID = "default"


@dataclasses.dataclass
class SsspRequest:
    """One shortest-path query against the service's graph.

    ``kind`` defaults to the full-tree query; p2p / bounded / knear
    requests carry their goal parameter and may be freely mixed in one
    submission wave: the scheduler forms plan-compatible sub-batches (one
    batch per goal kind), so a mixed queue costs extra batch steps, never
    an error."""
    rid: int
    source: int
    kind: str = "tree"
    target: Optional[int] = None           # p2p
    bound: Optional[float] = None          # bounded
    k: Optional[int] = None                # knear
    dist: Optional[np.ndarray] = None      # filled on completion
    parent: Optional[np.ndarray] = None
    metrics: Optional[dict] = None
    distance: Optional[float] = None       # p2p: dist[target]
    path: Optional[list] = None            # p2p: source..target ids
    nearest: Optional[list] = None         # knear: [(vertex, dist)]
    error: Optional[Exception] = None      # set instead, on failure

    @property
    def done(self) -> bool:
        return self.dist is not None


class SsspService:
    """Continuous request batching over a fixed graph.

    ``submit()`` enqueues requests; each ``step()`` admits up to
    ``max_batch`` of them (FIFO), runs one batched SSSP and retires the
    whole batch.  Free slots are padded (repeating slot 0), as in the
    reference; padded results are discarded by the scheduler and never
    reach a request.
    """

    def __init__(self, g, *, config: Optional[EngineConfig] = None,
                 max_batch: Optional[int] = None,
                 backend: Optional[str] = None,
                 alpha: Optional[float] = None,
                 beta: Optional[float] = None, devices=None,
                 shard_threshold_n: Optional[int] = None,
                 shard_threshold_m: Optional[int] = None,
                 shard_backend: Optional[str] = None,
                 clock=time.monotonic, tuned=None, device=None,
                 **backend_opts):
        if not isinstance(g, (HostGraph, DeviceGraph)):
            raise TypeError(f"expected HostGraph/DeviceGraph, got {type(g)}")
        user_config = config is not None
        # one option surface: config= XOR the loose kwargs (from_loose is
        # the shared sentinel gate)
        config = EngineConfig.from_loose(
            config, "service",
            # the loose default IS an explicit choice: the sharded tier
            # stays on segment_min unless asked (an unset shard_backend
            # would let effective_shard_backend derive "blocked" from a
            # blocked single-device backend)
            defaults={"shard_backend": "segment_min"},
            max_batch=max_batch, backend=backend, alpha=alpha, beta=beta,
            shard_threshold_n=shard_threshold_n,
            shard_threshold_m=shard_threshold_m,
            shard_backend=shard_backend, **backend_opts)
        max_batch = config.max_batch
        if user_config and devices is None:
            devices = resolve_devices(config.devices)
        self.config = config
        devices = list(devices) if devices is not None else None
        # at least one engine slot per (graph, device) replica; a
        # user-given config that sizes the cache larger (replica churn
        # headroom) is honored rather than silently shrunk
        capacity = 1 if devices is None else len(devices) + 1
        if user_config:
            capacity = max(capacity, config.registry_capacity)
        # tuned= (a repro_torch.tune.TunedStore or a path) lets the
        # registry overlay per-graph offline-tuned perf fields at build;
        # device= places the synchronous facade's engine
        self.registry = GraphRegistry(capacity=capacity, config=config,
                                      tuned=tuned, device=device)
        self.registry.register(_GID, g)
        if devices is None:
            # FIFO facade: no eccentricity reordering, no priorities
            self.router = None
            self.scheduler = QueryScheduler(self.registry,
                                            max_batch=max_batch,
                                            max_pending=config.max_pending,
                                            ecc_batching=False,
                                            clock=clock)
        else:
            self.router = QueryRouter(self.registry, devices=devices,
                                      max_batch=max_batch,
                                      max_pending=config.max_pending,
                                      ecc_batching=False,
                                      clock=clock)
            self.scheduler = None
        self.max_batch = max_batch
        self.n = int(g.n)
        if self.router is None:
            # the sync facade serves from the default-placement engine;
            # building it here keeps first-step latency out of step()
            self.g = getattr(self.registry.engine(_GID), "g", None)
        else:
            # router placement decides the serving devices — don't build
            # an unused default-placement engine just to expose .g
            self.g = None
        self._inflight: List[Tuple[SsspRequest, object]] = []

    @property
    def queue(self) -> list:
        """Requests submitted but not yet completed (compat shim)."""
        return [r for r, f in self._inflight if not f.done()]

    @property
    def n_batches(self) -> int:
        if self.router is not None:
            return self.router.stats()["n_batches"]
        return self.scheduler.n_batches

    def submit(self, req: SsspRequest) -> SsspRequest:
        q = Query(gid=_GID, source=int(req.source), kind=req.kind,
                  target=req.target, bound=req.bound, k=req.k)
        fut = (self.router.submit(q) if self.router is not None
               else self.scheduler.submit(q))
        self._inflight.append((req, fut))
        return req

    def _collect(self) -> None:
        remaining = []
        for req, fut in self._inflight:
            if not fut.done():
                remaining.append((req, fut))
            elif fut.exception() is not None:
                # a failed request must not wedge collection of the rest
                req.error = fut.exception()
            else:
                res = fut.result()
                req.dist = res.dist
                req.parent = res.parent
                req.metrics = res.metrics
                req.distance = res.distance
                req.path = res.path
                req.nearest = res.nearest
        self._inflight = remaining

    def step(self) -> bool:
        """Admit pending requests and run one batch; returns whether
        any work was done."""
        if self.router is not None:
            did = self.router.drain(max_steps=1) > 0
        else:
            did = self.scheduler.step()
        self._collect()
        return did

    def run(self, max_steps: int = 10_000) -> int:
        """Drain the queue; returns the number of batch steps executed."""
        if self.router is not None:
            steps = self.router.drain(max_steps)
        else:
            steps = self.scheduler.drain(max_steps)
        self._collect()
        return steps

    def apply_delta(self, edits) -> dict:
        """Apply an :class:`~repro_torch.delta.EdgeDelta` to the service's
        graph in place (see :meth:`GraphRegistry.apply_delta`): layouts are
        patched rather than rebuilt, cached tree states repaired, and —
        routed — every placed replica receives the patched engine without
        a rebuild.  Returns the registry's report dict.  ``self.g`` (the
        sync facade's exposed device graph) is refreshed to the patched
        engine's graph."""
        report = self.registry.apply_delta(_GID, edits)
        if self.router is None and self.g is not None:
            self.g = getattr(self.registry.engine(_GID), "g", None)
        self.n = int(report["host"].n)
        return report

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def metrics(self):
        """The serving plane's one
        :class:`~repro_torch.obs.metrics.MetricsRegistry`: the registry,
        every scheduler, and the router (when routed) all write their
        series here."""
        return self.registry.metrics

    def metrics_snapshot(self) -> dict:
        """One consistent ``{series_name: entry}`` snapshot covering the
        engine registry, the scheduler(s), and (routed) the router —
        counters/gauges as ``{"type", "value"}``, latency histograms with
        cumulative buckets, count/sum, and interpolated p50/p90/p99."""
        return self.metrics.snapshot()

    def metrics_exposition(self) -> str:
        """The snapshot in Prometheus text exposition format
        (``# HELP``/``# TYPE`` + samples; histograms expand to
        ``_bucket{le=...}``/``_sum``/``_count`` series)."""
        return to_prometheus(self.metrics_snapshot())

    def dump_metrics_jsonl(self, path, **meta) -> dict:
        """Append one timestamped JSONL line holding the full snapshot to
        ``path`` (plus any ``meta`` fields, e.g. a run id); returns the
        snapshot that was written."""
        snap = self.metrics_snapshot()
        write_jsonl_snapshot(snap, path, meta=meta or None)
        return snap
