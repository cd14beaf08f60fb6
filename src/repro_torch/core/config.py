"""Declarative engine configuration (port of ``repro.core.config``).

One frozen :class:`EngineConfig` value carries every backend, tier,
placement and heuristic option; :meth:`EngineConfig.resolve` turns it
into the concrete :class:`ResolvedEngine` a solver session uses, and
fails with :class:`ConfigError` on any contradictory combination before
a layout is built.

* ``EngineConfig(...)`` validates context-free invariants (known names,
  positive sizes), so a bad config fails where it is written;
* ``resolve(n=..., m=..., n_devices=...)`` validates contextual ones
  (tier/backend conflicts, threshold-driven auto-tiering, device counts).

The fields, their defaults and every error message are the reference's,
so configs compare equal across the two packages.  Three fields mean
something else here:

* ``devices`` holds CUDA device indices (or ``torch.device`` objects);
  an index ``i`` resolves to ``torch.device("cuda", i)``, range-checked
  against ``torch.cuda.device_count()``.
* ``interpret`` (the reference's Pallas interpret switch) selects
  nothing: the tensors' device picks the hand-written kernel (CUDA) or
  its plain version (CPU).
* ``use_kernel=False`` (the reference's switch to its plain path) raises
  :class:`ConfigError`: the port has no plain path on the card.

:class:`FacadeDeprecationWarning` marks the legacy ``sssp_*`` wrapper
entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ConfigError", "FacadeDeprecationWarning", "EngineConfig",
           "ResolvedEngine", "TIERS", "SHARD_VERSIONS", "STEP_POLICIES",
           "P2P_MODES", "LANDMARK_STRATEGIES", "resolve_devices",
           "as_resolved"]

TIERS = ("auto", "single", "sharded", "routed")
SHARD_VERSIONS = ("v1", "v2", "v3")
# stepping-policy names (kept in sync with core.stepping.POLICIES)
STEP_POLICIES = ("static", "adaptive")
# p2p search directions (kept in sync with core.sssp)
P2P_MODES = ("unidirectional", "bidirectional")
# landmark selection strategies (kept in sync with core.landmarks)
LANDMARK_STRATEGIES = ("farthest", "max_degree")

# single-device relax-backend names whose sharded twin is the blocked
# per-shard layout
_BLOCKED_NAMES = ("blocked", "blocked_pallas")


class ConfigError(ValueError):
    """A contradictory or unresolvable :class:`EngineConfig`."""


class FacadeDeprecationWarning(DeprecationWarning):
    """Emitted by the legacy ``sssp_*`` wrapper shims (use the
    :mod:`repro_torch.api` facade instead)."""


def _canonical_backend(name) -> str:
    """Resolve a relax-backend name/alias/object to its canonical name."""
    from . import relax
    try:
        return relax.get_backend(name).name
    except ValueError as exc:
        raise ConfigError(str(exc)) from None


def _canonical_shard_backend(name) -> str:
    """Resolve a backend name to the distributed engines' backend axis."""
    canon = _canonical_backend(name) if name not in ("segment_min",
                                                     "blocked") else name
    return "blocked" if canon in _BLOCKED_NAMES else canon


def _visible_devices() -> int:
    """CUDA devices visible to this process; a host without a card counts
    its CPU as one device, so that configs resolve in CPU runs."""
    import torch
    return torch.cuda.device_count() or 1


def resolve_devices(devices):
    """Concrete ``torch.device`` list for a config's ``devices`` field.

    An integer ``i`` is ``torch.device("cuda", i)``, range-checked against
    the visible cards (a bad index raises :class:`ConfigError` here, not
    mid-build); ``torch.device`` objects and device strings pass through;
    ``None`` stays ``None``."""
    if devices is None:
        return None
    import torch
    n_cards = torch.cuda.device_count()
    out = []
    for d in devices:
        if isinstance(d, int):
            if not 0 <= d < n_cards:
                raise ConfigError(f"device index {d} out of range for "
                                  f"{n_cards} visible device(s)")
            out.append(torch.device("cuda", d))
        else:
            out.append(torch.device(d))
    return out


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Declarative solver/serving configuration (frozen, hashable).

    Fields (the reference's, with its defaults):

    * ``backend`` — single-device relaxation backend (``segment_min`` or
      ``blocked_pallas``, alias ``blocked``).
    * ``tier`` — ``"single"``, ``"sharded"``, ``"routed"`` or ``"auto"``
      (single vs sharded from ``shard_threshold_n``/``_m``).  The port's
      facade runs the single tier.
    * ``devices`` — explicit placement (CUDA indices or ``torch.device``).
    * ``alpha``/``beta``/``max_iters``/``policy`` — the stepping knobs;
      ``policy="adaptive"`` adapts ``alpha``/``beta`` and a window
      multiplier at each step (:mod:`.stepping`), with the same
      dist/parent.
    * ``shard_backend``/``shard_version``/``fused_rounds``/
      ``compact_capacity``/``shard_threshold_*`` — engine variants;
      ``fused_rounds`` on the single tier runs the fused kernel.
    * ``block_v``/``tile_e`` — blocked layout geometry;
      ``use_kernel``/``interpret`` — kept for equality with the
      reference (see the module docstring).
    * ``max_batch``/``registry_capacity``/``max_pending``/
      ``ecc_batching``/``delta_staleness_budget`` — serving plane and
      deltas; ``trace``/``trace_capacity`` — per-round traces.
    * ``use_alt``/``n_landmarks``/``landmark_strategy``/``p2p_mode`` —
      ALT landmark pruning of p2p queries and the search direction.
    """

    backend: str = "segment_min"
    tier: str = "auto"
    devices: Optional[Tuple] = None
    alpha: float = 3.0
    beta: float = 0.9
    policy: str = "static"
    max_iters: int = 1_000_000
    # sharded tier
    shard_backend: Optional[str] = None
    shard_version: str = "v2"
    fused_rounds: int = 0
    compact_capacity: int = 0
    shard_threshold_n: Optional[int] = None
    shard_threshold_m: Optional[int] = None
    # blocked layout geometry
    block_v: Optional[int] = None
    tile_e: Optional[int] = None
    use_kernel: Optional[bool] = None
    interpret: bool = True
    # serving plane
    max_batch: int = 8
    registry_capacity: int = 4
    max_pending: Optional[int] = None
    ecc_batching: bool = True
    # streaming deltas: edit fraction before landmark/tuned reuse stops
    delta_staleness_budget: float = 0.05
    # observability: per-round solve traces
    trace: bool = False
    trace_capacity: int = 256
    # goal-directed p2p: ALT landmark lower bounds + search direction
    use_alt: bool = False
    n_landmarks: int = 8
    landmark_strategy: str = "farthest"
    p2p_mode: str = "unidirectional"

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ConfigError(f"unknown tier {self.tier!r}; expected one "
                              f"of {TIERS}")
        if self.policy not in STEP_POLICIES:
            raise ConfigError(f"unknown policy {self.policy!r}; expected "
                              f"one of {STEP_POLICIES}")
        if self.shard_version not in SHARD_VERSIONS:
            raise ConfigError(f"unknown shard_version "
                              f"{self.shard_version!r}; expected one of "
                              f"{SHARD_VERSIONS}")
        _canonical_backend(self.backend)        # fail on unknown names now
        if self.shard_backend is not None:
            sb = _canonical_shard_backend(self.shard_backend)
            if sb not in ("segment_min", "blocked"):
                raise ConfigError(f"unknown shard_backend "
                                  f"{self.shard_backend!r}")
        if self.devices is not None:
            object.__setattr__(self, "devices", tuple(self.devices))
            if not self.devices:
                raise ConfigError("devices, when given, must be non-empty")
        for name in ("alpha", "beta"):
            if getattr(self, name) <= 0:
                raise ConfigError(f"{name} must be > 0")
        for name in ("max_iters", "max_batch", "registry_capacity"):
            if getattr(self, name) < 1:
                raise ConfigError(f"{name} must be >= 1")
        for name in ("fused_rounds", "compact_capacity"):
            if getattr(self, name) < 0:
                raise ConfigError(f"{name} must be >= 0")
        for name in ("shard_threshold_n", "shard_threshold_m", "block_v",
                     "tile_e", "max_pending"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ConfigError(f"{name} must be >= 1 (or None)")
        if self.trace_capacity < 1:
            raise ConfigError("trace_capacity must be >= 1")
        if not 0.0 <= self.delta_staleness_budget <= 1.0:
            raise ConfigError("delta_staleness_budget must be in [0, 1]")
        if self.p2p_mode not in P2P_MODES:
            raise ConfigError(f"unknown p2p_mode {self.p2p_mode!r}; "
                              f"expected one of {P2P_MODES}")
        if self.landmark_strategy not in LANDMARK_STRATEGIES:
            raise ConfigError(
                f"unknown landmark_strategy {self.landmark_strategy!r}; "
                f"expected one of {LANDMARK_STRATEGIES}")
        if self.n_landmarks < 1:
            raise ConfigError("n_landmarks must be >= 1")
        if self.p2p_mode == "bidirectional":
            if not self.use_alt:
                raise ConfigError("p2p_mode='bidirectional' needs "
                                  "use_alt=True (the meet bound prunes "
                                  "through the ALT lower-bound machinery)")
            if self.policy != "static":
                raise ConfigError("p2p_mode='bidirectional' supports only "
                                  "policy='static'")
            if self.trace:
                raise ConfigError("p2p_mode='bidirectional' does not "
                                  "record per-round solve traces; drop "
                                  "trace=True")
        if self.use_kernel is False:
            raise ConfigError(
                "use_kernel=False selects the reference's plain relaxation "
                "path; the port has none on the card (the tensors' device "
                "picks the kernel or, on the CPU, its plain version)")

    # ------------------------------------------------------------------
    # loose-kwarg adoption
    # ------------------------------------------------------------------

    @classmethod
    def from_loose(cls, config, what: str, *, defaults=None, **loose
                   ) -> "EngineConfig":
        """The one config-XOR-loose-kwargs gate for every entry point.

        ``None`` is the unset sentinel of every loose kwarg.  With
        ``config`` given, every loose kwarg must be unset, or this raises
        ``ConfigError("pass <what> options through config=, not alongside
        it")``; the config passes through.  Without it, the set loose
        kwargs are layered over ``defaults`` into a fresh
        :class:`EngineConfig`; keys that are not config fields raise
        ``TypeError``.  Relax-backend objects are canonicalized to their
        registry name.
        """
        set_ = {k: v for k, v in loose.items() if v is not None}
        if config is not None:
            if set_:
                raise ConfigError(f"pass {what} options through config=, "
                                  f"not alongside it")
            return config
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(set_) - fields)
        if unknown:
            raise TypeError(f"unknown {what} options {unknown}")
        merged = dict(defaults or {})
        merged.update(set_)
        for key in ("backend", "shard_backend"):
            v = merged.get(key)
            if v is not None and not isinstance(v, str):
                merged[key] = _canonical_backend(v)
        return cls(**merged)

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------

    @property
    def effective_shard_backend(self) -> str:
        """The sharded tier's backend: explicit, else derived from
        ``backend`` (``blocked_pallas`` maps to ``blocked``)."""
        if self.shard_backend is not None:
            return _canonical_shard_backend(self.shard_backend)
        return _canonical_shard_backend(self.backend)

    @property
    def has_thresholds(self) -> bool:
        return (self.shard_threshold_n is not None
                or self.shard_threshold_m is not None)

    def _auto_tier(self, n: Optional[int], m: Optional[int]) -> str:
        if not self.has_thresholds:
            return "single"
        if n is None and m is None:
            raise ConfigError(
                "tier='auto' with shard thresholds needs the graph size "
                "(resolve(n=..., m=...)) to pick single vs sharded")
        if (self.shard_threshold_n is not None and n is not None
                and n >= self.shard_threshold_n):
            return "sharded"
        if (self.shard_threshold_m is not None and m is not None
                and m >= self.shard_threshold_m):
            return "sharded"
        return "single"

    def validate_serving(self) -> "EngineConfig":
        """Contextual checks for the serving plane: only combinations
        invalid under every possible per-graph lookup are rejected."""
        if self.compact_capacity and self.shard_version != "v3":
            raise ConfigError(
                "compact_capacity selects v3's compact exchange; set "
                "shard_version='v3' (or drop compact_capacity)")
        return self

    def resolve(self, *, n: Optional[int] = None, m: Optional[int] = None,
                n_devices: Optional[int] = None) -> "ResolvedEngine":
        """Resolve the declarative config against a graph/host context.

        ``n``/``m`` are the graph's vertex/edge counts (needed by
        ``tier="auto"`` thresholds); ``n_devices`` is the visible device
        count (default: the visible cards, 1 on a host without one, or
        ``len(devices)`` when the config pins devices).  Raises
        :class:`ConfigError` on any conflicting combination.
        """
        backend = _canonical_backend(self.backend)
        shard_backend = self.effective_shard_backend

        tier = self.tier
        if tier == "auto":
            tier = self._auto_tier(n, m)
        elif self.has_thresholds and tier != "routed":
            raise ConfigError(
                f"shard_threshold_n/_m only apply to tier='auto' or "
                f"'routed' (explicit tier {self.tier!r} already decided)")

        # sharded-only options are dead weight on a necessarily single
        # engine; auto with thresholds holds them for the graphs that
        # cross the threshold
        never_sharded = self.tier == "single" or not self.has_thresholds
        if tier == "single" and never_sharded:
            if self.shard_backend is not None:
                raise ConfigError(
                    "shard_backend is set but the engine can only "
                    "resolve to the single-device tier; drop it, set "
                    "tier='sharded', or add shard thresholds")
            if self.fused_rounds and backend not in _BLOCKED_NAMES:
                raise ConfigError(
                    "fused_rounds on the single-device tier needs a "
                    "blocked backend (the multi-round fused relaxation "
                    "megakernel); on segment_min it is a sharded-tier "
                    "option (bucket-fusion waves between exchanges)")
            if self.compact_capacity:
                raise ConfigError("compact_capacity is a sharded-tier "
                                  "option (v3's compact exchange)")
        if tier == "single" and never_sharded and self.devices is not None \
                and len(self.devices) > 1:
            raise ConfigError(
                f"the single tier runs on one device; got "
                f"{len(self.devices)} (set tier='sharded' or 'routed')")
        self.validate_serving()
        if tier == "routed" and self.trace:
            raise ConfigError(
                "trace records per-round solve traces on the single/"
                "sharded tiers; the routed serving plane reports "
                "aggregate metrics through its MetricsRegistry instead "
                "(see repro.obs)")
        if tier == "sharded" and backend != "segment_min" \
                and self.shard_backend is not None \
                and shard_backend != _canonical_shard_backend(backend):
            raise ConfigError(
                f"backend={self.backend!r} and shard_backend="
                f"{self.shard_backend!r} disagree for tier='sharded'; "
                f"set one of them")
        if tier == "sharded" and self.p2p_mode == "bidirectional":
            raise ConfigError(
                "p2p_mode='bidirectional' runs on the single-device tier "
                "(the alternating forward/backward windows share one "
                "resident dist pair); use unidirectional ALT pruning on "
                "the sharded tier")
        blocked_anywhere = (backend in _BLOCKED_NAMES
                            or shard_backend == "blocked")
        if not blocked_anywhere:
            for name in ("block_v", "tile_e", "use_kernel"):
                if getattr(self, name) is not None:
                    raise ConfigError(
                        f"{name} is blocked-layout geometry but no blocked "
                        f"backend is selected (backend={backend!r}, "
                        f"shard_backend={shard_backend!r})")

        devices = self.devices
        if devices is not None:
            resolve_devices(devices)     # range-check int indices now
            if n_devices is not None and len(devices) != n_devices:
                raise ConfigError(
                    f"config pins {len(devices)} device(s) but the "
                    f"context provides {n_devices}")
            n_devices = len(devices)
        elif n_devices is None:
            n_devices = _visible_devices()
        if n_devices < 1:
            raise ConfigError("need at least one device")

        return ResolvedEngine(
            tier=tier, backend=backend, shard_backend=shard_backend,
            devices=devices, n_shards=(len(devices) if devices is not None
                                       else n_devices),
            alpha=self.alpha, beta=self.beta, policy=self.policy,
            max_iters=self.max_iters,
            shard_version=self.shard_version,
            fused_rounds=self.fused_rounds,
            compact_capacity=self.compact_capacity,
            shard_threshold_n=self.shard_threshold_n,
            shard_threshold_m=self.shard_threshold_m,
            block_v=self.block_v, tile_e=self.tile_e,
            use_kernel=self.use_kernel, interpret=self.interpret,
            max_batch=self.max_batch,
            registry_capacity=self.registry_capacity,
            max_pending=self.max_pending, ecc_batching=self.ecc_batching,
            trace=self.trace, trace_capacity=self.trace_capacity,
            use_alt=self.use_alt, n_landmarks=self.n_landmarks,
            landmark_strategy=self.landmark_strategy,
            p2p_mode=self.p2p_mode,
            config=self)


@dataclasses.dataclass(frozen=True)
class ResolvedEngine:
    """The concrete engine an :class:`EngineConfig` resolved to: ``tier``
    is never ``"auto"``, backend names are canonical, ``n_shards`` is the
    width the sharded tier would span.  Produced only by
    :meth:`EngineConfig.resolve`; accepted as ``config=`` by the engine
    entry points."""

    tier: str
    backend: str
    shard_backend: str
    devices: Optional[Tuple]
    n_shards: int
    alpha: float
    beta: float
    policy: str
    max_iters: int
    shard_version: str
    fused_rounds: int
    compact_capacity: int
    shard_threshold_n: Optional[int]
    shard_threshold_m: Optional[int]
    block_v: Optional[int]
    tile_e: Optional[int]
    use_kernel: Optional[bool]
    interpret: bool
    max_batch: int
    registry_capacity: int
    max_pending: Optional[int]
    ecc_batching: bool
    trace: bool
    trace_capacity: int
    use_alt: bool
    n_landmarks: int
    landmark_strategy: str
    p2p_mode: str
    config: EngineConfig

    @property
    def trace_cap(self) -> int:
        """The engine-level trace knob: ring capacity, 0 = tracing off."""
        return self.trace_capacity if self.trace else 0

    def require(self, *tiers: str) -> "ResolvedEngine":
        if self.tier not in tiers:
            raise ConfigError(f"engine resolved to tier {self.tier!r}; "
                              f"this entry point needs {tiers}")
        return self

    def resolve_devices(self):
        """Pinned devices as ``torch.device`` objects (or None)."""
        return resolve_devices(self.devices)

    def layout_opts(self) -> dict:
        """Geometry kwargs of the blocked layout (only set fields):
        ``block_v`` and ``tile_e``.  ``use_kernel``/``interpret`` select
        nothing in the port and are not passed on."""
        return {name: getattr(self, name) for name in ("block_v", "tile_e")
                if getattr(self, name) is not None}

    def blocked_opts(self) -> dict:
        """Geometry kwargs of the sharded tier's per-shard layout."""
        return self.layout_opts()


def as_resolved(config, *, n=None, m=None, n_devices=None) -> ResolvedEngine:
    """Accept an :class:`EngineConfig` or an already-resolved engine."""
    if isinstance(config, ResolvedEngine):
        return config
    if isinstance(config, EngineConfig):
        return config.resolve(n=n, m=m, n_devices=n_devices)
    raise ConfigError(f"expected EngineConfig or ResolvedEngine, got "
                      f"{type(config)}")
