"""Multi-graph registry: cached device layouts + engines, LRU-evicted
(port of ``repro.serve.registry``).

Serving heterogeneous traffic means holding several preprocessed graphs
at once, each with a device-resident
:class:`~repro_torch.core.graph.DeviceGraph`, one relaxation-backend
layout (a ``BlockedGraph`` with its vertex->tile index, or the edge list
itself) and the host-side serving state (the degree array, eccentricity
hints for batch formation).  Those are the expensive, re-buildable
artifacts, so the registry separates

* the **spec**: how to (re)build a graph, registered once per ``gid``
  and kept (a ``HostGraph``, a ``DeviceGraph`` or a zero-argument
  factory returning one);
* the **engine cache**: at most ``capacity`` built engines, keyed by
  ``(gid, backend, placement)``, recycled LRU.

Placement is the serving plane's device axis: the same graph can be
built once per ``torch.device`` (the router replicates hot graphs), each
engine's graph and layout built on its device, so its batches run there
without copies.  A lookup without a device places the engine on the
registry's ``device`` (default: the config's first pinned device, else
the current card; there is no fallback to the CPU).

**Engine tiers.**  Graphs at or above the registry's vertex/edge shard
thresholds (or registered with ``tier="sharded"``) are served by a
:class:`ShardedGraphEngine`: the graph block-partitioned over the ranks
of the ``torch.distributed`` world group, one shard a rank, and every
batch one :func:`~repro_torch.core.distributed.sssp_distributed_batch`
call (v2 by default).  That call is SPMD: every rank makes it.  The
serving plane runs on rank 0, so rank 0 broadcasts a header before each
sharded batch (the gid, backend, sources, goal and goal parameters) and
before each sharded ``apply_delta`` (the edits); every other rank builds
a registry with the same config and the same registered graphs and runs
:meth:`GraphRegistry.follow`, which makes the same call for each header
until rank 0 calls :meth:`GraphRegistry.stop_followers`.  At world size
1 (one card) there is no follower and no header.  The single tier needs
no group.

**Concurrency.**  Lookups of built engines take only a short lock.  A
cold build publishes a per-key future and builds *outside* the lock:
concurrent lookups of the same key wait on that future (no duplicate
builds), lookups of other keys proceed at once.  Scheduler threads that
share a card run their solves on that card's current stream; the
kernels' wrappers serialize their scratch per entry
(``kernels/edge_relax/ops.py``).

:meth:`GraphRegistry.warmup` pre-pays builds and one eager batch per
(graph, kind, batch width), which makes the kernels' cached scratch of
those sizes before traffic arrives.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import os
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as tdist

from ..core import landmarks as landmarks_mod
from ..core import relax
from ..core.config import (ConfigError, EngineConfig,
                           _canonical_shard_backend, resolve_devices)
from ..core.distributed import (_device_for, device_shard, shard_blocked,
                                shard_graph, sssp_distributed_batch)
from ..core.graph import DeviceGraph, HostGraph, TileIndex
from ..core.landmarks import LandmarkSet, build_landmarks, hop_bfs
from ..core.sssp import GOALS, repair_relax, resolve_device, sssp_batch
from ..delta import (patch_blocked_with, patch_host, patch_sharded_with,
                     repair_state)
from ..obs import profiling
from ..obs.metrics import MetricsRegistry
from .queries import _host

__all__ = ["GraphEngine", "ShardedGraphEngine", "GraphRegistry",
           "RegistryStats", "estimate_eccentricity"]

# one sharded header and the collectives that follow it at a time; a
# sharded engine's graph is read and patched under it
_PLANE_LOCK = threading.RLock()


def _announce(header: tuple) -> None:
    """Rank 0's header to the followers (nothing at world size 1)."""
    if tdist.get_world_size() > 1:
        tdist.broadcast_object_list([header], src=0)


def _receive() -> tuple:
    box = [None]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


class _StrongRef:
    """weakref.WeakMethod-shaped holder for callables that aren't bound
    methods (plain functions, lambdas)."""

    def __init__(self, cb):
        self._cb = cb

    def __call__(self):
        return self._cb


def _device_key(dev: torch.device) -> str:
    """One name per device: ``cuda`` without an index is the current
    card."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_graph(g) -> HostGraph:
    """The host form of a Host/DeviceGraph spec."""
    if isinstance(g, HostGraph):
        return g
    i32 = lambda t: _host(t).astype(np.int32)
    return HostGraph(n=int(g.n), src=i32(g.src), dst=i32(g.dst),
                     w=_host(g.w), row_ptr=i32(g.row_ptr), deg=i32(g.deg),
                     rtow=_host(g.rtow), max_w=float(_host(g.max_w)))


def _clone_layout(bg):
    """A blocked layout with tensors of its own: ``patch_blocked_with``
    writes the tensors it is given, and a batch in flight on the old
    engine keeps reading the old ones."""
    return dataclasses.replace(
        bg, **{f: getattr(bg, f).clone() for f in (
            "src", "dst", "w", "tile_dst", "tile_first", "bucket_nonempty",
            "deg")}, index=TileIndex(*(t.clone() for t in bg.index)))


def _placed(lm: Optional[LandmarkSet], dev: torch.device):
    """``lm`` with its distance matrix on ``dev``."""
    if lm is None or lm.D.device == dev:
        return lm
    return dataclasses.replace(lm, D=lm.D.to(dev))


def estimate_eccentricity(hg, n_landmarks: int = 4,
                          landmarks=None) -> np.ndarray:
    """Per-vertex eccentricity estimate, in hops (host-side, O(k(N + M))).

    One hop-BFS from a landmark ``L_i`` gives hop distances ``h_i(v)``;
    with ``H_i = ecc(L_i)``, the triangle inequality bounds ``ecc(v) <=
    H_i + h_i(v)``, so the estimate is the **max over the
    ``n_landmarks`` highest-degree landmarks** of each per-landmark
    estimate, over the landmarks that reach the vertex.  Vertices no
    landmark reaches share the worst bucket (``2 * H_i + 1``).  The
    *ordering* is what batch formation needs: sources estimated far run
    more stepping rounds.  ``landmarks`` overrides the vantage points
    with explicit vertex ids (an engine's ALT landmark set).
    """
    n = int(hg.n)
    if n == 0:
        return np.zeros(0, np.float32)
    row_ptr = _host(hg.row_ptr).astype(np.int64)
    dst = _host(hg.dst).astype(np.int64)
    if landmarks is None:
        if n_landmarks < 1:
            raise ValueError("n_landmarks must be >= 1")
        deg = _host(hg.deg)
        # k distinct max-degree landmarks, ties broken by id (stable)
        landmarks = np.argsort(-deg, kind="stable")[:min(n_landmarks, n)]
    else:
        landmarks = np.asarray(landmarks, np.int64)
        if landmarks.size < 1:
            raise ValueError("landmarks must be non-empty")
    ecc = np.full(n, -1, np.int64)
    worst = 1
    for lm in landmarks:
        hop = hop_bfs(row_ptr, dst, n, int(lm))
        h_max = int(hop.max())
        ecc = np.where(hop >= 0, np.maximum(ecc, h_max + hop), ecc)
        worst = max(worst, 2 * h_max + 1)
    return np.where(ecc >= 0, ecc, worst).astype(np.float32)


GraphSpec = Union[HostGraph, DeviceGraph, Callable[[], HostGraph]]


class _EngineBase:
    """Shared serving state: eccentricity hints + measured-rounds feedback.

    ``batch_hint`` is what batch formation reads.  It starts as the
    landmark-BFS eccentricity estimate and is EMA-blended with measured
    per-source round counts (:meth:`record_rounds`, fed back by the
    scheduler after every batch).  Grouping only needs a consistent
    ordering, so the two scales (hops, rounds) may mix.
    """

    def __init__(self):
        self._ecc_hint: Optional[np.ndarray] = None
        self._batch_hint: Optional[np.ndarray] = None
        self._hint_lock = threading.Lock()
        self.generation = 0     # registry spec generation (stamped on build)
        self.landmarks: Optional[LandmarkSet] = None   # ALT artifact

    @property
    def ecc_hint(self) -> np.ndarray:
        """Lazy landmark-BFS eccentricity estimates (only ecc-aware batch
        formation reads them); an engine with an ALT landmark set reuses
        its landmarks as the BFS vantage points."""
        if self._ecc_hint is None:
            lm = (self.landmarks.landmarks
                  if self.landmarks is not None else None)
            self._ecc_hint = estimate_eccentricity(self.host, landmarks=lm)
        return self._ecc_hint

    @property
    def batch_hint(self) -> np.ndarray:
        """Feedback-blended per-vertex stepping-cost estimate; equal to
        ``ecc_hint`` until rounds are fed back."""
        if self._batch_hint is None:
            with self._hint_lock:
                if self._batch_hint is None:
                    self._batch_hint = self.ecc_hint.astype(np.float32,
                                                            copy=True)
        return self._batch_hint

    def peek_batch_hint(self) -> Optional[np.ndarray]:
        """``batch_hint`` only if available without running the landmark
        BFS (None otherwise): safe to call under a scheduler lock."""
        if self._batch_hint is None and self._ecc_hint is None:
            return None
        return self.batch_hint

    def record_rounds(self, sources, rounds, gamma: float = 0.25) -> None:
        """EMA-blend measured per-source round counts into ``batch_hint``."""
        sources = np.asarray(sources, np.int64)
        rounds = np.asarray(rounds, np.float32)
        if sources.size == 0:
            return
        hint = self.batch_hint
        with self._hint_lock:
            hint[sources] = (1.0 - gamma) * hint[sources] + gamma * rounds


class GraphEngine(_EngineBase):
    """One built (graph, backend) serving entry: the single-device tier.

    Owns the device graph and the backend layout, both built on
    ``device`` (default ``cuda``), the host-side degree array and the
    batch-formation hints; ``run_batch`` runs one batched goal query
    through :func:`~repro_torch.core.sssp.sssp_batch` (on ``blocked``:
    one ``edge_relax`` launch over the active slots a round, or the
    fused kernel with ``fused_rounds``).
    """

    tier = "single"

    def __init__(self, gid: str, hg, backend: str,
                 alpha: float, beta: float, device=None,
                 max_iters: int = 1_000_000, fused_rounds: int = 0,
                 policy: str = "static", landmarks=None,
                 p2p_mode: str = "unidirectional", **backend_opts):
        super().__init__()
        self.gid = gid
        self.host = hg
        self.device = resolve_device(device)
        self.max_iters = max_iters
        self.fused_rounds = fused_rounds
        self.policy = policy
        self.p2p_mode = p2p_mode
        self.g: DeviceGraph = _host_graph(hg).to_device(self.device)
        self.landmarks = _placed(landmarks, self.device)
        self.backend = relax.get_backend(backend)
        with profiling.annotate(f"repro:prepare_layout:{self.backend.name}"):
            self.layout = self.backend.prepare(self.g, **backend_opts)
        self.alpha = alpha
        self.beta = beta
        # hoisted once: per-slot metric normalization reads this every batch
        self.deg = _host(hg.deg)
        self.n = int(self.deg.shape[0])

    def run_batch(self, sources, goal: str = "tree", goal_params=None):
        """One batch; returns ``(dist, parent, metrics)`` with a leading
        slot axis, tensors on the engine's device."""
        alt = {}
        if goal == "p2p" and self.landmarks is not None:
            alt["landmarks"] = self.landmarks
            if self.p2p_mode == "bidirectional":
                alt["p2p_mode"] = self.p2p_mode
                alt["use_alt"] = True
        return sssp_batch(
            self.g, np.asarray(sources, np.int64).tolist(),
            backend=self.backend, layout=self.layout, alpha=self.alpha,
            beta=self.beta, max_iters=self.max_iters,
            fused_rounds=self.fused_rounds or None,
            policy=None if self.policy == "static" else self.policy,
            goal=goal, goal_params=goal_params, device=self.device, **alt)


class _Shards(NamedTuple):
    """A sharded engine's graph, swapped whole by a delta: the host
    shards, their stacked blocked layout (or None) and this rank's
    shard on its device."""
    sg: object
    blocked: Optional[tuple]
    shard: object


class ShardedGraphEngine(_EngineBase):
    """The sharded serving tier: one graph over the ranks of the world
    process group, one shard a rank.

    The graph is block-partitioned with
    :func:`~repro_torch.core.distributed.shard_graph` and, on
    ``blocked``, bucketed once here with
    :func:`~repro_torch.core.distributed.shard_blocked`; each batch runs
    :func:`~repro_torch.core.distributed.sssp_distributed_batch` (the
    sources one after another) with the same goal semantics as the
    single tier, and the padding vertices are cut off.  ``devices`` (one
    per rank) places this rank's shard; default: its card,
    ``cuda:<local rank>``.  On rank 0 :meth:`run_batch` broadcasts the
    batch's header first when the world has other ranks, which run the
    same call from :meth:`GraphRegistry.follow`.  This rank's shard
    crosses to its device once, at build (and after each delta), not once
    a batch.  The graph is read by every batch and patched by
    :meth:`patch` under the plane lock.
    """

    tier = "sharded"

    def __init__(self, gid: str, hg, alpha: float, beta: float,
                 devices=None, version: str = "v2", fused_rounds: int = 0,
                 backend: str = "segment_min", capacity: int = 0,
                 max_iters: int = 1_000_000, policy: str = "static",
                 landmarks=None, **blocked_opts):
        super().__init__()
        if not tdist.is_initialized():
            raise RuntimeError(
                "the sharded tier needs a process group: call "
                "torch.distributed.init_process_group first (one rank a "
                "shard; world size 1 on one card)")
        self.gid = gid
        self.host = _host_graph(hg)
        self.deg = _host(self.host.deg)
        self.n = int(self.deg.shape[0])
        self.alpha = alpha
        self.beta = beta
        self.version = version
        self.fused_rounds = fused_rounds
        self.policy = policy
        self.capacity = capacity
        self.max_iters = max_iters
        self.backend = _canonical_shard_backend(backend)
        self.rank, self.world = tdist.get_rank(), tdist.get_world_size()
        if devices is not None and len(devices) != self.world:
            raise ConfigError(f"the sharded tier spans {self.world} "
                              f"rank(s); got {len(devices)} device(s)")
        self.device = (torch.device(devices[self.rank]) if devices
                       else _device_for(None))
        with profiling.annotate(f"repro:prepare_layout:sharded:{gid}"):
            sg = shard_graph(self.host, self.world)
            blocked = None
            if self.backend == "blocked":
                blocked = shard_blocked(sg, device=self.device,
                                        **blocked_opts)
            self._shards = self._placed_shards(sg, blocked)
        self.landmarks = _placed(landmarks, self.device)

    def _placed_shards(self, sg, blocked) -> _Shards:
        return _Shards(sg, blocked,
                       device_shard(sg, blocked, device=self.device))

    @property
    def sg(self):
        """The graph's :class:`~repro_torch.core.distributed.ShardedGraph`."""
        return self._shards.sg

    @property
    def blocked(self):
        """The stacked blocked layout (None on ``segment_min``)."""
        return self._shards.blocked

    def run_batch(self, sources, goal: str = "tree", goal_params=None):
        """Same contract as :meth:`GraphEngine.run_batch` (leading slot
        axis, tensors on this rank's device); rank 0 only when the world
        has other ranks."""
        sources = np.asarray(sources, np.int64).tolist()
        gp = None if goal_params is None else list(goal_params)
        if self.rank != 0:
            raise RuntimeError("rank 0 drives the sharded tier; the other "
                               "ranks run GraphRegistry.follow()")
        with _PLANE_LOCK:
            _announce(("batch", self.gid, self.backend, sources, goal, gp))
            return self.solve(sources, goal, gp)

    def solve(self, sources, goal: str = "tree", goal_params=None):
        """The batch itself, which every rank runs (SPMD), under the
        plane lock: a delta waits for it and it for a delta."""
        with _PLANE_LOCK:
            shards = self._shards
            lm = self.landmarks if goal == "p2p" else None
            dist, parent, metrics = sssp_distributed_batch(
                shards.sg, sources, version=self.version,
                fused_rounds=self.fused_rounds,
                capacity=self.capacity or None, max_iters=self.max_iters,
                alpha=self.alpha, beta=self.beta,
                policy=None if self.policy == "static" else self.policy,
                goal=goal, goal_params=goal_params, backend=self.backend,
                shard=shards.shard, landmarks=lm, device=self.device)
        return dist[:, :self.n], parent[:, :self.n], metrics

    def patch(self, new_host, applied, landmarks) -> None:
        """Apply a delta in place, under the plane lock: the shards'
        slabs patched from the one host patch, the stacked blocked layout
        (uniform tile padding over every shard) bucketed again, this
        rank's shard placed again, and the graph swapped in one
        assignment, so that no batch sees part of it."""
        with _PLANE_LOCK:
            sg = patch_sharded_with(self.sg, new_host, applied)
            blocked = None
            if self.blocked is not None:
                meta = self.blocked[1]
                blocked = shard_blocked(sg, block_v=meta.block_v,
                                        tile_e=meta.tile_e)
            self._shards = self._placed_shards(sg, blocked)
            self.host, self.deg = new_host, np.asarray(new_host.deg)
            self.landmarks = landmarks


class RegistryStats:
    """Counter-backed registry stats: every field is a live read-through
    of a :class:`~repro_torch.obs.metrics.MetricsRegistry` counter
    (``sssp_registry_<field>_total``)."""

    FIELDS = ("hits", "misses", "builds", "evictions", "build_waits")

    _HELP = {
        "hits": "Engine-cache lookups served from the cache",
        "misses": "Engine-cache lookups that required a build",
        "builds": "Engines built (cold or rebuild after re-register)",
        "evictions": "Engines dropped by LRU capacity pressure",
        "build_waits": "Lookups that waited on another thread's build",
    }

    def __init__(self, metrics):
        self._counters = {
            f: metrics.counter(f"sssp_registry_{f}_total", help=self._HELP[f])
            for f in self.FIELDS}

    def inc(self, field: str, amount: int = 1) -> None:
        self._counters[field].inc(amount)

    def __getattr__(self, name):
        if name in RegistryStats.FIELDS:
            return self._counters[name].value
        raise AttributeError(name)

    def as_dict(self) -> dict:
        vals = {f: self._counters[f].value for f in self.FIELDS}
        total = vals["hits"] + vals["misses"]
        return {**vals,
                "hit_rate": vals["hits"] / total if total else 1.0}


class GraphRegistry:
    """LRU cache of serving engines over registered graph specs.

    Thread-safe: the LRU state is guarded by a short internal lock, and
    cold builds run outside it behind per-key futures (see the module
    docstring).  ``shard_threshold_n`` / ``shard_threshold_m`` select the
    tier as in the reference: a graph at or above either is served by a
    :class:`ShardedGraphEngine` over the world group (``shard_devices``:
    one device per rank; default: each rank's card).  ``device`` places
    the single-tier engines of device-less lookups.

    **Generations.**  Every :meth:`register` bumps the gid's generation;
    engines record the generation they were built from, and invalidation
    listeners (:meth:`add_invalidation_listener`) fire after each
    re-register so a router can rebuild placed replicas eagerly.
    """

    def __init__(self, capacity: Optional[int] = None, *,
                 config: Optional[EngineConfig] = None,
                 backend: Optional[str] = None,
                 alpha: Optional[float] = None, beta: Optional[float] = None,
                 shard_threshold_n: Optional[int] = None,
                 shard_threshold_m: Optional[int] = None,
                 shard_devices=None, shard_version: Optional[str] = None,
                 shard_backend: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tuned=None, landmark_dir=None,
                 result_cache_capacity: int = 8, device=None,
                 **backend_opts):
        # one option surface: config= XOR the loose kwargs (capacity and
        # device size and place this cache, they are not engine options)
        config = EngineConfig.from_loose(
            config, "registry",
            defaults={"shard_backend": "segment_min"},
            backend=backend, alpha=alpha, beta=beta,
            shard_threshold_n=shard_threshold_n,
            shard_threshold_m=shard_threshold_m,
            shard_version=shard_version, shard_backend=shard_backend,
            devices=shard_devices, **backend_opts)
        config.validate_serving()
        if capacity is None:
            capacity = config.registry_capacity
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.config = config
        self.default_backend = relax.get_backend(config.backend).name
        self.alpha = config.alpha
        self.beta = config.beta
        # the layout geometry a blocked engine is built with
        self.backend_opts = {name: getattr(config, name)
                             for name in ("block_v", "tile_e")
                             if getattr(config, name) is not None}
        self.shard_threshold_n = config.shard_threshold_n
        self.shard_threshold_m = config.shard_threshold_m
        pinned = resolve_devices(config.devices)
        self.shard_devices = tuple(pinned) if pinned else None
        if device is None and pinned:
            device = pinned[0]
        # where device-less lookups build (None: the current card)
        self.device = None if device is None else torch.device(device)
        self.shard_version = config.shard_version
        self.shard_backend = config.effective_shard_backend
        self.fused_rounds = config.fused_rounds
        self.shard_capacity = config.compact_capacity
        self.max_iters = config.max_iters
        self._lock = threading.RLock()
        self._specs: Dict[str, GraphSpec] = {}
        self._tiers: Dict[str, str] = {}
        self._gens: Dict[str, int] = {}
        self._listeners: list = []
        self._engines: "collections.OrderedDict[tuple, object]" \
            = collections.OrderedDict()
        self._building: Dict[tuple, Future] = {}
        # per-gid ALT landmark sets, built once per (gid, generation,
        # params) and shared by every engine of the gid
        self._landmark_sets: Dict[str, LandmarkSet] = {}
        # the one metrics registry of the serving plane (schedulers and
        # routers built on this registry default to it)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = RegistryStats(self.metrics)
        # offline-tuned per-gid configs (repro_torch.tune): a TunedStore
        # or a path to one, consulted at engine build
        if tuned is not None and not hasattr(tuned, "apply"):
            from ..tune.store import TunedStore
            tuned = TunedStore(tuned)
        self.tuned = tuned
        self._tuned_builds = self.metrics.counter(
            "sssp_registry_tuned_builds_total",
            help="Engines built with a TunedStore override applied")
        # on-disk LandmarkSet cache keyed by gid + graph fingerprint +
        # build params (the reference's file names and format)
        self._landmark_dir = (os.fspath(landmark_dir)
                              if landmark_dir is not None else None)
        self._lm_disk = {
            op: self.metrics.counter(
                f"sssp_landmarks_disk_{op}_total",
                help=f"LandmarkSet disk-cache {op}")
            for op in ("loads", "saves")}
        # streaming deltas: per-gid cumulative directed-edit fraction,
        # whether every delta so far was increase/remove-only, and a
        # bounded per-gid cache of full-tree states apply_delta repairs
        if result_cache_capacity < 1:
            raise ValueError("result_cache_capacity must be >= 1")
        self.result_cache_capacity = result_cache_capacity
        self._delta_frac: Dict[str, float] = {}
        self._delta_safe: Dict[str, bool] = {}
        self._result_cache: Dict[str, "collections.OrderedDict"] = {}
        self._delta_counters = {
            name: self.metrics.counter(f"sssp_delta_{name}_total", help=h)
            for name, h in (
                ("applied", "Edge-delta batches applied"),
                ("edges", "Directed edge edits applied"),
                ("layout_patches", "Cached engines patched in place"),
                ("repaired", "Cached solve states incrementally repaired"),
                ("reseeded", "Frontier vertices re-seeded by repairs"),
                ("landmarks_kept",
                 "LandmarkSets kept (stale) within the staleness budget"),
                ("landmarks_dropped",
                 "LandmarkSets dropped by deltas beyond the budget"),
            )}

    # ------------------------------------------------------------------
    # specs + tiers
    # ------------------------------------------------------------------

    def _missing(self, gid: str) -> KeyError:
        return KeyError(f"graph {gid!r} is not registered "
                        f"(have: {sorted(self._specs)})")

    def register(self, gid: str, graph: GraphSpec, *,
                 tier: Optional[str] = None) -> None:
        """Register (or replace) a graph spec; drops any cached engines
        built from the previous spec.  ``tier`` forces ``"single"`` or
        ``"sharded"``; default auto-selects by the shard thresholds
        (factory specs default to ``"single"``)."""
        if not (isinstance(graph, (HostGraph, DeviceGraph))
                or callable(graph)):
            raise TypeError(
                f"expected HostGraph/DeviceGraph or factory for {gid!r}, "
                f"got {type(graph)}")
        if tier not in (None, "single", "sharded"):
            raise ValueError(f"tier must be 'single' or 'sharded', "
                             f"got {tier!r}")
        if tier is None:
            tier = "single"
            if isinstance(graph, (HostGraph, DeviceGraph)):
                n, m = int(graph.n), int(graph.m)
                if ((self.shard_threshold_n is not None
                     and n >= self.shard_threshold_n)
                        or (self.shard_threshold_m is not None
                            and m >= self.shard_threshold_m)):
                    tier = "sharded"
        with self._lock:
            replaced = gid in self._specs
            self._specs[gid] = graph
            self._tiers[gid] = tier
            self._gens[gid] = gen = self._gens.get(gid, 0) + 1
            for key in [k for k in self._engines if k[0] == gid]:
                del self._engines[key]
            # the replaced spec's artifacts: landmarks, the delta ledger,
            # the repairable result cache, and in-flight builds (their
            # owners resolve only their own waiters; the spec guard in
            # engine() keeps their product out of the cache)
            self._landmark_sets.pop(gid, None)
            self._delta_frac.pop(gid, None)
            self._delta_safe.pop(gid, None)
            self._result_cache.pop(gid, None)
            for key in [k for k in self._building if k[0] == gid]:
                del self._building[key]
            listeners = []
            if replaced:
                live = []
                for ref in self._listeners:
                    cb = ref()
                    if cb is not None:       # drop dead (collected) owners
                        live.append(ref)
                        listeners.append(cb)
                self._listeners = live
        # outside the lock: listeners rebuild engines (re-entering the
        # registry); only re-registrations notify
        for cb in listeners:
            cb(gid, gen)

    def generation(self, gid: str) -> int:
        """Spec generation of ``gid`` (bumped by every :meth:`register`)."""
        with self._lock:
            if gid not in self._gens:
                raise self._missing(gid)
            return self._gens[gid]

    def add_invalidation_listener(self, cb) -> None:
        """Call ``cb(gid, generation)`` after every re-``register`` of an
        existing gid (in the registering thread, outside the lock).
        Bound methods are held weakly (a dropped router unhooks itself);
        plain functions and lambdas strongly."""
        try:
            ref = weakref.WeakMethod(cb)
        except TypeError:
            ref = _StrongRef(cb)
        with self._lock:
            self._listeners.append(ref)

    def tier(self, gid: str) -> str:
        """The engine tier (``"single"``/``"sharded"``) serving ``gid``."""
        with self._lock:
            if gid not in self._tiers:
                raise self._missing(gid)
            return self._tiers[gid]

    @property
    def gids(self) -> tuple:
        with self._lock:
            return tuple(self._specs)

    def cached_keys(self) -> tuple:
        """Currently built (gid, backend, placement) keys, LRU -> MRU."""
        with self._lock:
            return tuple(self._engines)

    # ------------------------------------------------------------------
    # engine lookup / build
    # ------------------------------------------------------------------

    def _resolve(self, gid: str, backend, device):
        with self._lock:      # RLock: atomic with a caller's locked section
            if self._tiers.get(gid) == "sharded":
                sb = (self.shard_backend if backend is None
                      else _canonical_shard_backend(backend))
                return (gid, sb, "sharded"), None
        backend = (relax.get_backend(backend).name if backend is not None
                   else self.default_backend)
        if device is None:
            return (gid, backend, None), None
        device = (torch.device("cuda", device) if isinstance(device, int)
                  else torch.device(device))
        return (gid, backend, ("dev", _device_key(device))), device

    def peek(self, gid: str, backend: Optional[str] = None,
             device=None):
        """The cached engine or None: never builds, never waits, never
        touches LRU order or hit/miss stats."""
        key, _ = self._resolve(gid, backend, device)
        with self._lock:
            return self._engines.get(key)

    def engine(self, gid: str, backend: Optional[str] = None, device=None):
        """Get-or-build the engine for ``(gid, backend, device)``.

        ``device`` (a ``torch.device``, a name or a CUDA index) places a
        single-tier engine; None places it on the registry's ``device``.
        Sharded-tier gids ignore ``device``: their one engine spans the
        world group.  Marks the entry MRU.
        """
        with self._lock:
            key, dev = self._resolve(gid, backend, device)
            if gid not in self._specs:
                raise self._missing(gid)
            eng = self._engines.get(key)
            if eng is not None:
                self.stats.inc("hits")
                self._engines.move_to_end(key)
                return eng
            self.stats.inc("misses")
            fut = self._building.get(key)
            owner = fut is None
            if owner:
                fut = Future()
                self._building[key] = fut
                spec = self._specs[gid]
                tier = self._tiers[gid]
                gen = self._gens[gid]
            else:
                self.stats.inc("build_waits")
        if not owner:
            return fut.result()
        try:
            eng = self._build(gid, spec, key[1], dev, tier)
            eng.generation = gen
        except BaseException as exc:
            with self._lock:
                if self._building.get(key) is fut:
                    del self._building[key]
            fut.set_exception(exc)
            raise
        with self._lock:
            if self._building.get(key) is fut:
                del self._building[key]
            self.stats.inc("builds")
            if self._specs.get(gid) is spec:     # not re-registered mid-build
                self._engines[key] = eng
                self._engines.move_to_end(key)
                while len(self._engines) > self.capacity:
                    self._engines.popitem(last=False)
                    self.stats.inc("evictions")
        fut.set_result(eng)
        return eng

    # ------------------------------------------------------------------
    # ALT landmark sets
    # ------------------------------------------------------------------

    def landmark_set(self, gid: str, hg=None, *,
                     n_landmarks: Optional[int] = None,
                     strategy: Optional[str] = None,
                     engine: Optional[GraphEngine] = None) -> LandmarkSet:
        """Get-or-build the gid's ALT :class:`LandmarkSet`.

        Validated on every lookup against the spec generation and the
        build parameters; otherwise every engine of the gid shares one
        ``[L, N]`` build.  ``hg`` avoids re-invoking a factory spec.  A
        build runs on ``engine``'s device through its backend and layout
        (default: a fresh blocked layout on the registry's device);
        with ``landmark_dir`` a set is loaded from or saved to disk.
        """
        if n_landmarks is None:
            n_landmarks = self.config.n_landmarks
        if strategy is None:
            strategy = self.config.landmark_strategy
        with self._lock:
            if gid not in self._specs:
                raise self._missing(gid)
            gen = self._gens[gid]
            spec = self._specs[gid]
            lm = self._landmark_sets.get(gid)
            if (lm is not None and lm.generation == gen
                    and (lm.n_landmarks, lm.strategy)
                    == (min(n_landmarks, int(lm.D.shape[1])), strategy)):
                return lm
        # build outside the lock (one tree solve per landmark)
        if hg is None:
            hg = spec() if callable(spec) else spec
        dev = engine.device if engine is not None else self.device
        path = self._landmark_path(gid, hg, n_landmarks, strategy)
        if path is not None and os.path.exists(path):
            # the file name's fingerprint matched: built for this graph
            lm = dataclasses.replace(landmarks_mod.load(path, device=dev),
                                     generation=gen)
            self._lm_disk["loads"].inc()
        else:
            opts = {}
            if engine is not None:
                blocked = engine.backend.name == "blocked_pallas"
                opts = dict(backend=engine.backend, layout=engine.layout,
                            fused_rounds=engine.fused_rounds if blocked
                            else 0)
            with profiling.annotate(f"repro:landmark_build:{gid}"):
                lm = dataclasses.replace(
                    build_landmarks(engine.g if engine is not None else hg,
                                    n_landmarks, strategy, device=dev,
                                    **opts), generation=gen)
            if path is not None:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                landmarks_mod.save(lm, path)
                self._lm_disk["saves"].inc()
        with self._lock:
            if self._gens.get(gid) == gen:      # not re-registered mid-build
                self._landmark_sets[gid] = lm
        return lm

    def _landmark_path(self, gid, hg, n_landmarks, strategy):
        """Disk-cache path of a gid's LandmarkSet (None without
        ``landmark_dir``), keyed by graph fingerprint + build params, the
        reference's name: a patched graph never matches an old file."""
        if self._landmark_dir is None:
            return None
        from ..tune.store import graph_fingerprint
        safe_gid = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in gid)
        k = min(int(n_landmarks), int(hg.n))
        return os.path.join(
            self._landmark_dir,
            f"landmarks_{safe_gid}_{graph_fingerprint(hg)}"
            f"_{k}_{strategy}.npz")

    def _build(self, gid, spec, backend, device, tier):
        with profiling.annotate(f"repro:engine_build:{gid}:{tier}"):
            return self._build_inner(gid, spec, backend, device, tier)

    def _build_inner(self, gid, spec, backend, device, tier):
        hg = spec() if callable(spec) else spec
        # per-gid tuned overlay: only the perf fields move (TUNED_FIELDS);
        # a stale fingerprint or an overlay this config cannot carry
        # falls back inside TunedStore.apply
        cfg = self.config
        if self.tuned is not None:
            # a graph inside its delta staleness budget keeps its overlay
            with self._lock:
                frac = self._delta_frac.get(gid, 0.0)
            stale_ok = 0.0 < frac <= self.config.delta_staleness_budget
            tuned_cfg = self.tuned.apply(gid, hg, cfg, n=int(hg.n),
                                         m=int(hg.m), allow_stale=stale_ok)
            if tuned_cfg != cfg:
                cfg = tuned_cfg
                self._tuned_builds.inc()
        backend_opts = dict(self.backend_opts)
        is_blocked = backend == "blocked" if tier == "sharded" \
            else relax.get_backend(backend).name == "blocked_pallas"
        if is_blocked:
            for nm in ("block_v", "tile_e"):
                v = getattr(cfg, nm)
                if v is None:
                    backend_opts.pop(nm, None)
                else:
                    backend_opts[nm] = v
        if tier == "sharded":
            # the landmark set is built once on the registry's device and
            # replicated on every rank
            lm = None
            if cfg.use_alt:
                lm = self.landmark_set(gid, hg, n_landmarks=cfg.n_landmarks,
                                       strategy=cfg.landmark_strategy)
            return ShardedGraphEngine(
                gid, hg, cfg.alpha, cfg.beta, devices=self.shard_devices,
                version=self.shard_version, fused_rounds=cfg.fused_rounds,
                capacity=cfg.compact_capacity, max_iters=self.max_iters,
                backend=backend, policy=cfg.policy, landmarks=lm,
                **backend_opts)
        if not is_blocked:
            backend_opts = {}
        # fused_rounds is a blocked-kernel knob on the single-device tier;
        # a per-lookup segment_min backend must not inherit it
        eng = GraphEngine(gid, hg, backend, cfg.alpha, cfg.beta,
                          device=device if device is not None
                          else self.device, max_iters=self.max_iters,
                          fused_rounds=cfg.fused_rounds if is_blocked else 0,
                          policy=cfg.policy, p2p_mode=cfg.p2p_mode,
                          **backend_opts)
        if cfg.use_alt:
            eng.landmarks = _placed(self.landmark_set(
                gid, hg, n_landmarks=cfg.n_landmarks,
                strategy=cfg.landmark_strategy, engine=eng), eng.device)
        return eng

    def evict(self, gid: str, backend: Optional[str] = None,
              device=None) -> bool:
        """Drop a cached engine (the spec stays registered)."""
        key, _ = self._resolve(gid, backend, device)
        with self._lock:
            return self._engines.pop(key, None) is not None

    # ------------------------------------------------------------------
    # streaming deltas (repro_torch.delta): patch + repair, not rebuild
    # ------------------------------------------------------------------

    def delta_frac(self, gid: str) -> float:
        """Cumulative directed-edit fraction (edits / m) since the gid's
        last :meth:`register`."""
        with self._lock:
            return self._delta_frac.get(gid, 0.0)

    def cache_result(self, gid: str, source: int, dist, parent) -> None:
        """Cache a **full-tree** solve state (numpy copies) for delta
        repair; LRU per gid, at most ``result_cache_capacity`` sources.
        Tree goals only: an early-exit state has tentative entries that a
        repair would relax toward the full tree."""
        dist = _host(dist).astype(np.float32, copy=True)
        parent = _host(parent).astype(np.int32, copy=True)
        with self._lock:
            if gid not in self._specs:
                raise self._missing(gid)
            cache = self._result_cache.setdefault(
                gid, collections.OrderedDict())
            cache[int(source)] = (dist, parent)
            cache.move_to_end(int(source))
            while len(cache) > self.result_cache_capacity:
                cache.popitem(last=False)

    def cached_result(self, gid: str, source: int):
        """``(dist, parent)`` numpy arrays for a cached tree solve, or
        ``None``; marks the entry MRU."""
        with self._lock:
            cache = self._result_cache.get(gid)
            if cache is None or int(source) not in cache:
                return None
            cache.move_to_end(int(source))
            return cache[int(source)]

    def apply_delta(self, gid: str, edits) -> dict:
        """Apply an :class:`~repro_torch.delta.EdgeDelta` to ``gid`` in
        place.

        One host-side patch (:func:`~repro_torch.delta.patch_host`) is
        shared by every cached engine of the gid: each single-tier engine
        gets a patched copy (blocked layouts through
        :func:`~repro_torch.delta.patch_blocked_with` on a clone, equal
        to a rebuild, vertex->tile index included), so a batch in flight
        on the old engine keeps its tensors; a sharded engine is patched
        in place (:meth:`ShardedGraphEngine.patch`).  Cached tree states
        (:meth:`cache_result`) are repaired with
        :func:`~repro_torch.core.sssp.repair_relax` on a patched blocked
        engine's layout, with its fused rounds, where the gid has one
        (else on a patched engine's graph, or the new graph on the
        registry's device, through ``segment_min``): dist bitwise a
        from-scratch solve's, parent too wherever paths do not tie
        exactly in f32.  The generation is not bumped and listeners do
        not fire; landmark sets and tuned overlays follow
        ``config.delta_staleness_budget`` as in the reference.  On rank 0
        of a larger world a sharded gid's edits go to the followers first
        (:meth:`follow`), which apply them to their own registries.  A
        sharded gid's delta holds the plane lock from that announcement
        to the swap, so no batch runs in between, on any rank.
        Returns the reference's report dict.
        """
        with self._lock:
            if gid not in self._specs:
                raise self._missing(gid)
            if self._tiers[gid] != "sharded":
                return self._apply_delta(gid, edits)
            with _PLANE_LOCK:
                if tdist.is_initialized() and tdist.get_rank() == 0:
                    _announce(("delta", gid, edits))
                return self._apply_delta(gid, edits)

    def _apply_delta(self, gid: str, edits) -> dict:
        """:meth:`apply_delta`'s work, under the registry's lock."""
        spec = self._specs[gid]
        if callable(spec):
            spec = spec()
        old_host = _host_graph(spec)
        with profiling.annotate(f"repro:apply_delta:{gid}"):
            new_host, applied = patch_host(old_host, edits)
            self._specs[gid] = new_host
            for key in [k for k in self._building if k[0] == gid]:
                del self._building[key]
            frac = (self._delta_frac.get(gid, 0.0)
                    + applied.n_edits / max(old_host.m, 1))
            self._delta_frac[gid] = frac
            safe = self._delta_safe.get(gid, True) and applied.safe_stale
            self._delta_safe[gid] = safe
            keep_lm = safe and frac <= self.config.delta_staleness_budget
            lm = self._landmark_sets.get(gid)
            if lm is not None:
                if keep_lm:
                    self._landmark_sets[gid] = dataclasses.replace(
                        lm, stale=True)
                    self._delta_counters["landmarks_kept"].inc()
                else:
                    self._landmark_sets.pop(gid, None)
                    self._delta_counters["landmarks_dropped"].inc()
            patched = []
            for key in [k for k in self._engines if k[0] == gid]:
                eng = self._patch_engine(self._engines[key], old_host,
                                         new_host, applied, keep_lm)
                self._engines[key] = eng    # same key: LRU position kept
                patched.append(eng)
            n_repaired = 0
            cache = self._result_cache.get(gid)
            if cache:
                layout, backend, fused = self._repair_layout(patched,
                                                             new_host)
                put = lambda a: torch.from_numpy(a).to(layout.w.device)
                for source in list(cache):
                    dist, parent = cache[source]
                    d_i, p_i, f0, st = repair_state(new_host, dist,
                                                    parent, applied)
                    d2, p2, _ = repair_relax(
                        layout, put(d_i), put(p_i), put(f0),
                        backend=backend, max_iters=self.max_iters,
                        fused_rounds=fused)
                    cache[source] = (_host(d2), _host(p2))
                    self._delta_counters["reseeded"].inc(st.n_seeds)
                    n_repaired += 1
                self._delta_counters["repaired"].inc(n_repaired)
            self._delta_counters["applied"].inc()
            self._delta_counters["edges"].inc(applied.n_edits)
            self._delta_counters["layout_patches"].inc(len(patched))
        return {"gid": gid, "n_edits": applied.n_edits,
                "engines_patched": len(patched),
                "results_repaired": n_repaired, "delta_frac": frac,
                "landmarks": ("stale" if lm is not None and keep_lm
                              else "dropped" if lm is not None else "none"),
                "host": new_host, "applied": applied}

    def _repair_layout(self, patched, new_host):
        """``(layout, backend, fused_rounds)`` to repair cached trees on:
        a patched single-tier blocked engine's layout and fused rounds if
        the gid has one, else a patched single-tier engine's graph, else
        the new graph on the registry's device (both on
        ``segment_min``)."""
        single = [eng for eng in patched if eng.tier == "single"]
        for eng in single:
            if eng.backend.name == "blocked_pallas":
                return eng.layout, eng.backend, eng.fused_rounds
        g = (single[0].g if single
             else new_host.to_device(resolve_device(self.device)))
        return g, "segment_min", 0

    def _patch_engine(self, eng, old_host, new_host, applied, keep_lm):
        """The patched engine.  A single-tier engine is copied (shallow):
        new graph and layout tensors on its device, the hint state
        shared; the original object is left untouched for any batch
        already running on it.  A sharded engine is patched in place
        under the plane lock, which its batches hold: a scheduler worker
        that holds the engine then solves on the patched graph, as the
        followers do."""
        lm = eng.landmarks
        if lm is not None:
            lm = dataclasses.replace(lm, stale=True) if keep_lm else None
        if eng.tier == "sharded":
            eng.patch(new_host, applied, lm)
            return eng
        eng = copy.copy(eng)
        eng.host = new_host
        eng.deg = np.asarray(new_host.deg)
        eng.landmarks = lm
        eng.g = new_host.to_device(eng.device)
        if eng.backend.name == "blocked_pallas":
            eng.layout = patch_blocked_with(_clone_layout(eng.layout),
                                            old_host, new_host, applied)
        else:
            eng.layout = eng.backend.prepare(eng.g)
        return eng

    # ------------------------------------------------------------------
    # the sharded tier's followers
    # ------------------------------------------------------------------

    def follow(self) -> int:
        """Serve rank 0's sharded tier from this rank (every rank but 0 of
        the world group runs it, on a registry with the same config and
        the same registered graphs): take each header rank 0 broadcasts
        and make the same call (a batch on the gid's sharded engine,
        built here on first use, or an ``apply_delta``) until
        :meth:`stop_followers`.  Returns the number of headers served."""
        if tdist.get_rank() == 0:
            raise RuntimeError("rank 0 drives the sharded tier; follow() "
                               "runs on the other ranks")
        served = 0
        while True:
            header = _receive()
            if header[0] == "stop":
                return served
            if header[0] == "batch":
                _, gid, backend, sources, goal, goal_params = header
                self.engine(gid, backend).solve(sources, goal, goal_params)
            else:
                _, gid, edits = header
                self.apply_delta(gid, edits)
            served += 1

    def stop_followers(self) -> None:
        """Release the other ranks from :meth:`follow` (rank 0)."""
        with _PLANE_LOCK:
            _announce(("stop",))

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def warmup(self, gids=None, *, backend: Optional[str] = None,
               device=None, kinds=("tree",), batch_sizes=(1,)):
        """Pre-pay engine builds and one eager batch per (gid, kind,
        batch size), which makes the kernels' cached scratch of those
        sizes (pass the scheduler's ``max_batch``).  Returns one row per
        batch with ``build_s`` (attributed to the gid's first row) and
        ``compile_s``, the batch's synchronized seconds (the reference's
        name: there is no jit compile here)."""
        if isinstance(gids, str):
            gids = [gids]
        gids = list(self.gids) if gids is None else list(gids)
        for kind in kinds:
            if kind not in GOALS:
                raise ValueError(f"unknown warmup kind {kind!r}; "
                                 f"expected one of {GOALS}")
        rows = []
        for gid in gids:
            t0 = time.perf_counter()
            eng = self.engine(gid, backend, device=device)
            build_s = time.perf_counter() - t0
            src = int(np.argmax(eng.deg))       # a vertex with edges
            for kind in kinds:
                for bs in batch_sizes:
                    bs = int(bs)
                    gp = {"tree": None, "p2p": [src] * bs,
                          "bounded": [0.0] * bs, "knear": [1] * bs}[kind]
                    t0 = time.perf_counter()
                    eng.run_batch([src] * bs, goal=kind, goal_params=gp)
                    _sync(eng.device)
                    rows.append({"gid": gid, "tier": eng.tier, "kind": kind,
                                 "batch": bs, "build_s": build_s,
                                 "compile_s": time.perf_counter() - t0})
                    build_s = 0.0               # attribute the build once
        return rows
