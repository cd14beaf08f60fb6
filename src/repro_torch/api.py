"""Unified solver facade: ``Solver.open(graph, config).solve(spec)`` (port
of ``repro.api``: the single, sharded and routed tiers).

A :class:`Solver` session owns what one graph needs on its tier,
resolved once from an :class:`~repro_torch.core.config.EngineConfig`:
on the single tier the device graph, the backend's layout and the ALT
landmark set; on the sharded tier the graph's shards and, on
``blocked``, their layout, with this rank's shard kept on its device (a
:class:`~repro_torch.core.distributed.DeviceShard`); on the routed tier a
:class:`~repro_torch.serve.registry.GraphRegistry` and a
:class:`~repro_torch.serve.router.QueryRouter` over per-device
schedulers.  Every query is a declarative :class:`SolveSpec` (goal kind
+ sources + goal parameters + batch shape) and every solve returns one
:class:`SolveResult`.

::

    from repro_torch.api import EngineConfig, SolveSpec, Solver

    solver = Solver.open(graph, EngineConfig(backend="blocked"))
    res = solver.solve(SolveSpec.p2p(src, dst))       # early-exit query
    res.distance(), res.paths()                       # lazy shaping
    batch = solver.solve(SolveSpec.tree([s0, s1, s2]))  # one batched loop

On the single tier a scalar spec runs :func:`~repro_torch.core.sssp.sssp`,
a batched one :func:`~repro_torch.core.sssp.sssp_batch`, whose slots are
bitwise the scalar solves.  On the routed tier every slot is a query
submitted to the router, batched by the schedulers with the other
queries in flight, and the answers are the finalized per-query ones
(each kind's settled entries, tentative values masked), as served
traffic sees them; ``submit`` returns a ``Future`` and starts the
router's workers, and ``apply_delta`` patches the served graph in place.
The session runs on ``cuda`` (the config's pinned devices, else the
visible cards) unless opened with ``device="cpu"``.  With
``EngineConfig(trace=True)`` every single-tier result carries ``trace``:
a :class:`~repro_torch.obs.trace.SolveTrace`, or one per slot of a
batch.  ``tuned=`` (a :class:`~repro_torch.tune.TunedStore` or its path)
overlays the store's tuned fields for ``gid``.

On the sharded tier (``EngineConfig(tier="sharded")``) a scalar spec
runs :func:`~repro_torch.core.distributed.sssp_distributed` and a batched
one :func:`~repro_torch.core.distributed.sssp_distributed_batch`, at the
config's ``shard_version`` (v2 by default), over the ranks of the
``torch.distributed`` world group, one shard a rank.  That tier is SPMD:
every rank opens the session and solves the same specs (at world size 1,
one card, that is the one process), and the session raises without an
initialised group.  Its answers are the single tier's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .core import relax
from .core.config import (ConfigError, EngineConfig, ResolvedEngine,
                          as_resolved, resolve_devices)
from .core.graph import BlockedGraph, DeviceGraph, HostGraph
from .core.sssp import (GOALS, SsspMetrics, normalized_metrics,
                        resolve_device, sssp, sssp_batch)
from .obs import profiling
from .obs.trace import materialize_trace
from .serve.queries import Query, _host, reconstruct_path

__all__ = ["EngineConfig", "ConfigError", "SolveSpec", "SolveResult",
           "Solver"]

def _as_id_tuple(v) -> Tuple[int, ...]:
    return tuple(int(x) for x in v)


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """One declarative shortest-path computation.

    ``kind`` is one of :data:`repro_torch.core.sssp.GOALS` (``tree`` /
    ``p2p`` / ``bounded`` / ``knear``); ``sources`` is a vertex id (one
    computation) or a sequence of ids (one batch: the result gains a
    leading slot axis).  The goal parameter (``target`` / ``bound`` /
    ``k``) may be a scalar (shared by every slot) or a per-source
    sequence.  Specs are frozen and validate on construction; graph-size
    bounds are checked by the solver.
    """

    sources: Union[int, Tuple[int, ...]]
    kind: str = "tree"
    target: Union[int, Tuple[int, ...], None] = None    # p2p
    bound: Union[float, Tuple[float, ...], None] = None  # bounded
    k: Union[int, Tuple[int, ...], None] = None          # knear

    def __post_init__(self):
        if self.kind not in GOALS:
            raise ValueError(f"unknown solve kind {self.kind!r}; expected "
                             f"one of {GOALS}")
        if np.ndim(self.sources) != 0:
            object.__setattr__(self, "sources", _as_id_tuple(self.sources))
            if not self.sources:
                raise ValueError("sources must be non-empty")
        else:
            object.__setattr__(self, "sources", int(self.sources))
        for name, cast in (("target", int), ("bound", float), ("k", int)):
            v = getattr(self, name)
            if v is not None:
                v = (tuple(cast(x) for x in v) if np.ndim(v) != 0
                     else cast(v))
                object.__setattr__(self, name, v)
        need = {"tree": None, "p2p": "target", "bounded": "bound",
                "knear": "k"}[self.kind]
        for name in ("target", "bound", "k"):
            v = getattr(self, name)
            if name != need and v is not None:
                raise ValueError(f"{name} is not a parameter of "
                                 f"{self.kind!r} specs")
        if need is not None and getattr(self, need) is None:
            raise ValueError(f"{self.kind!r} specs require {need}")
        srcs = self.sources if self.batched else (self.sources,)
        if any(s < 0 for s in srcs):
            raise ValueError("vertex ids must be non-negative")
        param = getattr(self, need) if need else None
        if isinstance(param, tuple):
            if not self.batched or len(param) != len(self.sources):
                raise ValueError(
                    f"per-source {need} needs one value per source "
                    f"(got {len(param)} for sources={self.sources!r})")
        if self.kind == "p2p":
            tg = param if isinstance(param, tuple) else (param,)
            if any(t < 0 for t in tg):
                raise ValueError("vertex ids must be non-negative")
        if self.kind == "knear":
            ks = param if isinstance(param, tuple) else (param,)
            if any(x < 1 for x in ks):
                raise ValueError("k must be >= 1")
        if self.kind == "bounded":
            bs = param if isinstance(param, tuple) else (param,)
            if any(b < 0 for b in bs):
                raise ValueError("bound must be >= 0")

    # -- convenience constructors ---------------------------------------

    @classmethod
    def tree(cls, sources) -> "SolveSpec":
        """Full shortest-path tree(s) from ``sources``."""
        return cls(sources=sources, kind="tree")

    @classmethod
    def p2p(cls, sources, target) -> "SolveSpec":
        """Point-to-point: early exit once ``target`` settles."""
        return cls(sources=sources, kind="p2p", target=target)

    @classmethod
    def bounded(cls, sources, bound) -> "SolveSpec":
        """Distance-bounded: every vertex within ``bound``."""
        return cls(sources=sources, kind="bounded", bound=bound)

    @classmethod
    def knear(cls, sources, k) -> "SolveSpec":
        """k-nearest vertices to each source."""
        return cls(sources=sources, kind="knear", k=k)

    # -- lowering helpers -----------------------------------------------

    @property
    def batched(self) -> bool:
        return isinstance(self.sources, tuple)

    @property
    def n_slots(self) -> int:
        return len(self.sources) if self.batched else 1

    @property
    def goal_param(self):
        """The spec's goal parameter, kind-agnostic (None for tree)."""
        return {"tree": None, "p2p": self.target, "bounded": self.bound,
                "knear": self.k}[self.kind]

    def slot_params(self) -> Optional[list]:
        """Per-slot goal parameters (scalar broadcast over the batch)."""
        p = self.goal_param
        if p is None:
            return None
        if isinstance(p, tuple):
            return list(p)
        return [p] * self.n_slots

    def check_bounds(self, n: int) -> None:
        """Reject out-of-range vertex ids against a concrete graph size."""
        srcs = self.sources if self.batched else (self.sources,)
        bad = [s for s in srcs if not 0 <= s < n]
        if bad:
            raise ValueError(f"source(s) {bad} out of range for graph "
                             f"with n={n}")
        if self.kind == "p2p":
            tg = self.target if isinstance(self.target, tuple) \
                else (self.target,)
            bad = [t for t in tg if not 0 <= t < n]
            if bad:
                raise ValueError(f"target(s) {bad} out of range for graph "
                                 f"with n={n}")


@dataclasses.dataclass
class SolveResult:
    """The one result type every solve returns.

    ``dist``/``parent`` are ``[N]`` (single spec) or ``[S, N]`` (batch
    spec) tensors on the session's device (numpy arrays on the routed
    tier); ``metrics`` is the engine's
    :class:`~repro_torch.core.sssp.SsspMetrics` (0-d or ``[S]`` leaves),
    and on the routed tier the per-query normalized metric dict (a list
    of them for a batch spec).
    Iterating the result unpacks ``(dist, parent, metrics)``.  Shaping is
    lazy: :meth:`paths`, :meth:`distance`, :meth:`nearest` and
    :meth:`normalized` copy to the host only what they read, and accept
    torch tensors or numpy arrays in the fields.
    """

    spec: SolveSpec
    dist: Any
    parent: Any
    metrics: Any
    deg: np.ndarray
    tier: str
    served_by: Optional[Any] = None     # routed: per-slot scheduler names
    trace: Optional[Any] = None         # SolveTrace | list[SolveTrace]

    def __iter__(self):
        return iter((self.dist, self.parent, self.metrics))

    @property
    def batched(self) -> bool:
        return self.spec.batched

    def _slot(self, arr, slot: Optional[int]) -> np.ndarray:
        if not self.batched:
            return _host(arr)
        if slot is None:
            raise ValueError("batched result: pass slot=")
        return _host(arr[slot])

    def block_until_ready(self) -> "SolveResult":
        """Wait for the device work behind ``dist``."""
        if isinstance(self.dist, torch.Tensor) and self.dist.is_cuda:
            torch.cuda.synchronize(self.dist.device)
        return self

    # -- lazy shaping ----------------------------------------------------

    def distance(self, target=None, *, slot: Optional[int] = None) -> float:
        """Distance to ``target`` (defaults to a p2p spec's target)."""
        if target is None:
            t = self.spec.target
            if t is None:
                raise ValueError("no target: pass one or use a p2p spec")
            if isinstance(t, tuple):
                if slot is None:
                    raise ValueError("batched result: pass slot=")
                t = t[slot]
            target = t
        return float(self._slot(self.dist, slot)[int(target)])

    def paths(self, targets=None, *, slot: Optional[int] = None):
        """Lazily reconstruct source->target path(s) from ``parent``.

        ``targets`` defaults to a p2p spec's target(s).  Returns one
        vertex-id list (or ``None`` if unreachable); for a batch spec
        with no ``slot``, one list per slot (each slot's own target).
        """
        if self.batched and slot is None:
            t = targets if targets is not None else self.spec.target
            if t is None:
                raise ValueError("no targets: pass them or use a p2p spec")
            ts = list(t) if np.ndim(t) != 0 else [t] * self.spec.n_slots
            if len(ts) != self.spec.n_slots:
                raise ValueError(f"{len(ts)} targets for "
                                 f"{self.spec.n_slots} slots")
            return [self.paths(ts[i], slot=i)
                    for i in range(self.spec.n_slots)]
        if targets is None:
            t = self.spec.target
            if t is None:
                raise ValueError("no target: pass one or use a p2p spec")
            targets = t[slot] if isinstance(t, tuple) else t
        src = self.spec.sources[slot] if self.batched else self.spec.sources
        return reconstruct_path(self._slot(self.parent, slot), int(src),
                                int(targets))

    def nearest(self, *, slot: Optional[int] = None) -> list:
        """A knear spec's ``[(vertex, dist)]`` list, ascending."""
        if self.spec.kind != "knear":
            raise ValueError("nearest() needs a knear spec")
        if self.batched and slot is None:
            raise ValueError("batched result: pass slot=")
        k = self.spec.k
        if isinstance(k, tuple):
            k = k[slot]
        d = self._slot(self.dist, slot)
        src = self.spec.sources[slot] if self.batched else self.spec.sources
        finite = np.flatnonzero(np.isfinite(d))
        order = finite[np.argsort(d[finite], kind="stable")]
        order = order[order != int(src)][:int(k)]
        return [(int(v), float(d[v])) for v in order]

    def normalized(self, *, slot: Optional[int] = None) -> dict:
        """Paper §4 normalized metrics for one computation."""
        if isinstance(self.metrics, dict):
            return self.metrics
        if isinstance(self.metrics, list):        # routed batch
            if slot is None:
                raise ValueError("batched result: pass slot=")
            return self.metrics[slot]
        m = self.metrics
        if self.batched:
            if slot is None:
                raise ValueError("batched result: pass slot=")
            m = SsspMetrics(*(x[slot] for x in m))
        return normalized_metrics(self.deg, self._slot(self.dist, slot), m)


class Solver:
    """One opened solving session over one graph, on the single, the
    sharded or the routed tier.

    Build with :meth:`open`; the session owns the resolved engine
    (:class:`~repro_torch.core.config.ResolvedEngine`) and its tier's
    state (single: the device graph, the backend's layout and, with
    ``use_alt``, the landmark set; sharded: the shards, their blocked
    layout and the landmark set; routed: the registry and the router),
    so repeated :meth:`solve` calls amortize every preprocessing step.
    Usable as a context manager (``close`` stops the routed tier's
    workers).
    """

    def __init__(self, graph, resolved: ResolvedEngine, *, layout=None,
                 gid: str = "default", device=None, tuned=None):
        self.resolved = resolved
        self.config = resolved.config
        self.tier = resolved.tier
        self.gid = gid
        self._tuned = tuned
        self._host = graph
        self.deg = _host(graph.deg)
        self.n = int(self.deg.shape[0])
        self._closed = False
        if self.tier == "single":
            self._open_single(graph, layout, device)
            return
        if layout is not None:
            raise ConfigError(f"the {self.tier} tier builds its own "
                              f"layouts; drop layout=")
        if self.tier == "routed":
            self._open_routed(graph, device)
        else:
            self._open_sharded(graph, device)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def open(cls, graph, config: Optional[EngineConfig] = None, *,
             layout=None, gid: str = "default", tuned=None,
             device=None) -> "Solver":
        """Open a solver session on ``graph``.

        ``graph`` is a :class:`~repro_torch.core.graph.HostGraph` or
        :class:`~repro_torch.core.graph.DeviceGraph`; ``config`` an
        :class:`EngineConfig` (default: single-device ``segment_min``).
        ``layout`` reuses a prebuilt single-tier layout (validated
        against the config and the graph here).  ``device`` places the
        session (default: the config's pinned devices, else ``cuda``;
        ``"cpu"`` runs the plain versions of the kernels); on the routed
        tier it is the one device its router serves on, on the sharded
        tier this rank's device (default: the config's pinned device of
        this rank, else ``cuda:<local rank>``).

        ``tuned`` is a :class:`~repro_torch.tune.TunedStore` (or a path
        to one): the store's tuned fields for ``gid``
        (:data:`~repro_torch.tune.TUNED_FIELDS`) are overlaid onto
        ``config`` before resolution on the single tier, and handed to
        the routed tier's registry, which overlays them per graph.  A
        missing or stale entry leaves ``config`` as it is.
        """
        if not isinstance(graph, (HostGraph, DeviceGraph)):
            raise TypeError(f"expected HostGraph or DeviceGraph, got "
                            f"{type(graph)}")
        if config is None:
            config = EngineConfig()
        if tuned is not None and not hasattr(tuned, "apply"):
            from .tune.store import TunedStore
            tuned = TunedStore(tuned)
        n, m = int(graph.n), int(graph.m)
        resolved = as_resolved(config, n=n, m=m)
        if tuned is not None and resolved.tier != "routed":
            tuned_cfg = tuned.apply(gid, graph, config, n=n, m=m)
            if tuned_cfg != config:
                resolved = as_resolved(tuned_cfg, n=n, m=m)
        return cls(graph, resolved, layout=layout, gid=gid, device=device,
                   tuned=tuned)

    def _open_single(self, graph, layout, device):
        r = self.resolved
        if device is None and r.devices is not None:
            device = resolve_devices(r.devices)[0]
        dev = resolve_device(device)
        if isinstance(graph, HostGraph):
            dg = graph.to_device(dev)
        elif graph.device == dev or (graph.device.type == dev.type
                                     and dev.index is None):
            dg = graph
        else:
            dg = DeviceGraph(*(t.to(dev) for t in graph))
        self._device = dg.device
        self._dg = dg
        self._backend = relax.get_backend(r.backend)
        if layout is not None:
            self._check_layout(layout)
            self._layout = layout
        else:
            with profiling.annotate(f"repro:engine_build:{r.backend}"):
                self._layout = self._backend.prepare(dg, **r.layout_opts())
        self._build_landmarks(dg)

    def _build_landmarks(self, g) -> None:
        """With ``use_alt`` the landmark set is built once at open, with
        the session's backend and layout, and threaded into every p2p
        solve."""
        self._landmarks = None
        if self.resolved.use_alt:
            from .core.landmarks import build_landmarks
            with profiling.annotate("repro:landmark_build"):
                self._landmarks = build_landmarks(
                    g, self.resolved.n_landmarks,
                    self.resolved.landmark_strategy, device=self._device,
                    backend=self._backend,
                    fused_rounds=self.resolved.fused_rounds,
                    layout=self._layout)

    def _check_layout(self, layout) -> None:
        """A foreign layout must match the configured backend, cover the
        whole graph and lie on the session's device."""
        r = self.resolved
        if r.backend == "blocked_pallas":
            if not isinstance(layout, BlockedGraph):
                raise ConfigError(
                    f"backend 'blocked_pallas' needs a BlockedGraph "
                    f"layout (build_blocked); got {type(layout).__name__}")
            if layout.n != self.n or layout.n_blocks != layout.n_dst_blocks \
                    or layout.n_pad < self.n:
                raise ConfigError(
                    f"blocked layout does not cover this graph: layout "
                    f"n={layout.n} n_pad={layout.n_pad} "
                    f"blocks={layout.n_blocks}/{layout.n_dst_blocks} vs "
                    f"graph n={self.n} (shard slices and foreign layouts "
                    f"are rejected)")
            if r.tile_e is not None and layout.tile_e != r.tile_e:
                raise ConfigError(f"layout tile_e={layout.tile_e} != "
                                  f"config tile_e={r.tile_e}")
            if r.block_v is not None and layout.block_v != r.block_v:
                raise ConfigError(f"layout block_v={layout.block_v} != "
                                  f"config block_v={r.block_v}")
            where = layout.src.device
        elif isinstance(layout, BlockedGraph):
            raise ConfigError(f"backend {r.backend!r} cannot consume a "
                              f"BlockedGraph layout")
        else:
            # segment_min's layout IS the edge list: a foreign graph's
            # DeviceGraph would answer over the wrong edges
            if not isinstance(layout, DeviceGraph):
                raise ConfigError(
                    f"backend {r.backend!r} layout must be the graph's "
                    f"DeviceGraph edge list; got {type(layout).__name__}")
            max_w = np.float32(_host(layout.max_w))
            if (layout.n != self.n or layout.m != int(self._host.m)
                    or max_w != np.float32(_host(self._host.max_w))):
                raise ConfigError(
                    f"layout does not match this graph (layout n={layout.n}"
                    f" m={layout.m} max_w={float(max_w):.6g} vs "
                    f"n={self.n} m={int(self._host.m)} "
                    f"max_w={float(_host(self._host.max_w)):.6g})")
            where = layout.device
        if where != self._device:
            raise ConfigError(f"layout is on {where}, the session on "
                              f"{self._device}")

    def _open_sharded(self, graph, device):
        import torch.distributed as tdist
        from .core.distributed import (_device_for, device_shard,
                                       shard_blocked, shard_graph)
        from .serve.registry import _host_graph
        r = self.resolved
        if not tdist.is_initialized():
            raise RuntimeError(
                "the sharded tier needs a process group: call "
                "torch.distributed.init_process_group first (one rank a "
                "shard; world size 1 on one card)")
        world, rank = tdist.get_world_size(), tdist.get_rank()
        pinned = r.resolve_devices()
        if device is None and pinned is not None:
            if len(pinned) != world:
                raise ConfigError(f"config pins {len(pinned)} device(s) "
                                  f"for a world of {world} rank(s)")
            device = pinned[rank]
        self._device = _device_for(device)
        with profiling.annotate("repro:engine_build:sharded"):
            self._sg = shard_graph(_host_graph(graph), world)
            blocked = None
            if r.shard_backend == "blocked":
                blocked = shard_blocked(self._sg, device=self._device,
                                        **r.blocked_opts())
            # this rank's shard on its device, kept for every solve
            self._shard = device_shard(self._sg, blocked,
                                       device=self._device)
        # the landmark set: one build on this rank's device, the same on
        # every rank
        self._landmarks = None
        if r.use_alt:
            from .core.landmarks import build_landmarks
            with profiling.annotate("repro:landmark_build"):
                self._landmarks = build_landmarks(
                    graph, r.n_landmarks, r.landmark_strategy,
                    device=self._device)

    def _open_routed(self, graph, device):
        from .serve.registry import GraphRegistry
        from .serve.router import QueryRouter
        devices = ([resolve_device(device)] if device is not None
                   else self.resolved.resolve_devices())
        self._registry = GraphRegistry(
            config=self.config, tuned=self._tuned,
            device=devices[0] if devices else None)
        self._registry.register(self.gid, graph)
        self._router = QueryRouter(self._registry, devices=devices,
                                   config=self.config)
        self._router_started = False      # submit() starts workers lazily

    # ------------------------------------------------------------------
    # solving
    # ------------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("solver is closed")

    def solve(self, spec: SolveSpec) -> SolveResult:
        """Run one declarative computation; returns a :class:`SolveResult`."""
        self._check_open()
        if not isinstance(spec, SolveSpec):
            raise TypeError(f"expected SolveSpec, got {type(spec)}")
        spec.check_bounds(self.n)
        if self.tier == "routed":
            return self._solve_routed(spec)
        return self._solve_local(spec)

    def solve_many(self, specs) -> list:
        """Solve several specs (mixed goal kinds welcome): one
        :class:`SolveResult` per input spec, in order.

        The specs are grouped by goal kind; all slots of one kind run as
        one batched call (:func:`~repro_torch.core.sssp.sssp_batch`, or
        :func:`~repro_torch.core.distributed.sssp_distributed_batch` on the
        sharded tier), and each spec's rows are sliced back out of its
        group's result.  The routed tier solves each spec in turn (its
        schedulers group the queries themselves).
        """
        specs = list(specs)
        for spec in specs:
            if not isinstance(spec, SolveSpec):
                raise TypeError(f"expected SolveSpec, got {type(spec)}")
        self._check_open()
        for spec in specs:
            spec.check_bounds(self.n)
        if len(specs) <= 1 or self.tier == "routed":
            return [self.solve(s) for s in specs]
        groups: dict = {}
        for i, spec in enumerate(specs):
            groups.setdefault(spec.kind, []).append(i)
        results: list = [None] * len(specs)
        for kind, idxs in groups.items():
            srcs: list = []
            params: list = []
            slots: list = []                  # [start, stop) per spec
            for i in idxs:
                s = specs[i]
                start = len(srcs)
                srcs.extend(s.sources if s.batched else (s.sources,))
                p = s.slot_params()
                params.extend(p if p is not None else [])
                slots.append((start, len(srcs)))
            merged = SolveSpec(
                sources=tuple(srcs), kind=kind,
                **({} if kind == "tree" else
                   {{"p2p": "target", "bounded": "bound",
                     "knear": "k"}[kind]: tuple(params)}))
            out = self._solve_local(merged)
            for i, (lo, hi) in zip(idxs, slots):
                spec = specs[i]
                sl = slice(lo, hi) if spec.batched else lo
                results[i] = SolveResult(
                    spec=spec, dist=out.dist[sl], parent=out.parent[sl],
                    metrics=SsspMetrics(*(x[sl] for x in out.metrics)),
                    deg=self.deg, tier=self.tier,
                    trace=None if out.trace is None else out.trace[sl])
        return results

    def _goal_args(self, spec: SolveSpec) -> dict:
        if spec.batched:
            return {"goal": spec.kind, "goal_params": spec.slot_params()}
        return {"goal": spec.kind, "goal_param": spec.goal_param}

    def _solve_local(self, spec: SolveSpec) -> SolveResult:
        """One spec on the single or the sharded tier, in one call."""
        srcs = list(spec.sources) if spec.batched else spec.sources
        if self.tier == "single":
            fn = sssp_batch if spec.batched else sssp
            out = fn(self._dg, srcs, config=self.resolved,
                     layout=self._layout, landmarks=self._landmarks,
                     device=self._device, **self._goal_args(spec))
        else:
            from .core.distributed import (sssp_distributed,
                                           sssp_distributed_batch)
            fn = sssp_distributed_batch if spec.batched else sssp_distributed
            out = fn(self._sg, srcs, config=self.resolved,
                     shard=self._shard, landmarks=self._landmarks,
                     device=self._device, **self._goal_args(spec))
            # padding vertices never leave the facade
            out = (out[0][..., :self.n], out[1][..., :self.n], *out[2:])
        # a traced config returns the device ring too: one copy to the host
        trace = materialize_trace(out[3]) if self.resolved.trace_cap > 0 \
            else None
        return SolveResult(spec=spec, dist=out[0], parent=out[1],
                           metrics=out[2], deg=self.deg, tier=self.tier,
                           trace=trace)

    def _route(self, spec: SolveSpec) -> list:
        """Submit one query per slot of ``spec`` to the router; returns
        their futures in slot order."""
        params = spec.slot_params()
        srcs = spec.sources if spec.batched else (spec.sources,)
        name = {"p2p": "target", "bounded": "bound", "knear": "k"}
        futs = []
        for i, s in enumerate(srcs):
            kw = {name[spec.kind]: params[i]} if spec.kind in name else {}
            futs.append(self._router.submit(
                Query(gid=self.gid, source=int(s), kind=spec.kind, **kw)))
        return futs

    def _routed_result(self, spec: SolveSpec, results) -> SolveResult:
        """Stack the per-query answers of ``spec``'s slots."""
        if spec.batched:
            dist = np.stack([r.dist for r in results])
            parent = np.stack([r.parent for r in results])
            metrics = [r.metrics for r in results]
            served = [r.served_by for r in results]
        else:
            (r,) = results
            dist, parent, metrics, served = (r.dist, r.parent, r.metrics,
                                             r.served_by)
        return SolveResult(spec=spec, dist=dist, parent=parent,
                           metrics=metrics, deg=self.deg, tier=self.tier,
                           served_by=served)

    def _solve_routed(self, spec: SolveSpec) -> SolveResult:
        futs = self._route(spec)
        self._router.drain()
        return self._routed_result(spec, [f.result(timeout=600)
                                          for f in futs])

    def submit(self, spec: SolveSpec) -> Future:
        """Submit a spec asynchronously; returns a
        :class:`concurrent.futures.Future` resolving to the
        :class:`SolveResult` (or to the first slot's exception).

        Routed tier only: the first ``submit`` starts the router's
        background workers (one thread per device entry plus the mesh
        scheduler), and every slot is enqueued without a synchronous
        drain; slots of one spec may land in different batches, even on
        different devices.  ``solve()`` remains the synchronous path.
        """
        self._check_open()
        if not isinstance(spec, SolveSpec):
            raise TypeError(f"expected SolveSpec, got {type(spec)}")
        if self.tier != "routed":
            raise ConfigError(
                f"submit() needs the routed tier (async serving plane); "
                f"this session resolved tier={self.tier!r} — open with "
                f"tier='routed' or use solve()")
        spec.check_bounds(self.n)
        if not self._router_started:
            self._router.start()          # idempotent on live schedulers
            self._router_started = True
        futs = self._route(spec)
        agg: Future = Future()
        agg.set_running_or_notify_cancel()
        remaining = [len(futs)]
        lock = threading.Lock()

        def one_done(f):
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if agg.done():
                return
            if f.cancelled() or f.exception() is not None:
                agg.set_exception(f.exception() if not f.cancelled()
                                  else RuntimeError(f"query of {spec} was "
                                                    "cancelled"))
                return
            if last:
                try:
                    agg.set_result(self._routed_result(
                        spec, [x.result() for x in futs]))
                except BaseException as e:      # never leave agg pending
                    if not agg.done():
                        agg.set_exception(e)

        for f in futs:
            f.add_done_callback(one_done)
        return agg

    def apply_delta(self, edits) -> dict:
        """Apply an :class:`~repro_torch.delta.EdgeDelta` to the session's
        graph in place (routed tier): delegates to
        :meth:`~repro_torch.serve.registry.GraphRegistry.apply_delta`
        (cached engines patched, not rebuilt; placed replicas reused;
        cached tree states repaired), and queries submitted afterwards
        serve the patched graph.  A single-tier session owns immutable
        prebuilt state and raises ``ConfigError``, as the reference's
        does (patch with :mod:`repro_torch.delta` and repair, or
        reopen)."""
        self._check_open()
        if self.tier != "routed":
            raise ConfigError(
                f"apply_delta() needs the routed tier; tier={self.tier!r} "
                f"sessions own immutable prebuilt layouts — use "
                f"repro_torch.delta.patch_blocked/patch_sharded/repair, or "
                f"reopen the session on the patched graph")
        report = self._registry.apply_delta(self.gid, edits)
        self._host = report["host"]
        self.deg = np.asarray(report["host"].deg)
        return report

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    @property
    def device_graph(self):
        """The single tier's device-resident graph (None on the other
        tiers)."""
        return getattr(self, "_dg", None)

    @property
    def landmarks(self):
        """The single or sharded tier's ALT landmark set (``use_alt``
        configs), or None; the routed tier's sets live in its registry
        (:meth:`~repro_torch.serve.registry.GraphRegistry.landmark_set`)."""
        return getattr(self, "_landmarks", None)

    @property
    def router(self):
        """The routed tier's :class:`~repro_torch.serve.router.QueryRouter`
        (serving stats, placement, warmup); None on the single tier."""
        return getattr(self, "_router", None)

    @property
    def registry(self):
        """The routed tier's registry; None on the single tier."""
        return getattr(self, "_registry", None)

    def warmup(self, kinds=("tree",), batch_sizes=None) -> list:
        """One solve per kind and batch size, from the max-degree vertex,
        so that later solves do not carry the first use of each kernel
        (the routed tier delegates to its router, at ``max_batch``)."""
        if self.tier == "routed":
            return self._router.warmup(
                kinds=kinds,
                batch_sizes=batch_sizes or (self.resolved.max_batch,))
        src = int(np.argmax(self.deg))
        rows = []
        for kind in kinds:
            for bs in (batch_sizes or (1,)):
                srcs = [src] * int(bs) if int(bs) > 1 else src
                spec = {"tree": SolveSpec.tree(srcs),
                        "p2p": SolveSpec.p2p(srcs, src),
                        "bounded": SolveSpec.bounded(srcs, 0.0),
                        "knear": SolveSpec.knear(srcs, 1)}[kind]
                self.solve(spec).block_until_ready()
                rows.append({"kind": kind, "batch": int(bs),
                             "tier": self.tier})
        return rows

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.router is not None:
            self._router.stop(cancel_pending=True)

    def __enter__(self) -> "Solver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Solver(tier={self.tier!r}, "
                f"backend={self.resolved.backend!r}, n={self.n}, "
                f"gid={self.gid!r})")
