"""Persisted tuning winners: a JSON store keyed by gid + graph fingerprint
(port of ``repro.tune.store``).

One tune is worth amortizing across many queries, so winners outlive the
process: :class:`TunedStore` writes a small JSON file mapping ``gid ->
(fingerprint, config, objectives)``.  The file format and the
fingerprint are the reference's, byte for byte, so a store written by
either package is read and applied by the other.  Lookups recompute the
graph's fingerprint: an entry whose graph changed since it was tuned is
*stale* and returns ``None`` (the caller keeps its default config).

Only the perf-relevant fields (:data:`TUNED_FIELDS`) are overlaid by
:meth:`TunedStore.apply`; placement and serving knobs (devices, tier,
thresholds, batch sizes) always come from the live config.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Optional

import numpy as np

from ..core.config import ConfigError, EngineConfig
from ..serve.queries import _host

__all__ = ["TUNED_FIELDS", "TunedStore", "graph_fingerprint"]

#: EngineConfig fields the tuner searches and the store overlays.
TUNED_FIELDS = ("alpha", "beta", "policy", "fused_rounds",
                "compact_capacity", "block_v", "tile_e")

_STORE_VERSION = 1


def graph_fingerprint(g, config: Optional[EngineConfig] = None) -> str:
    """Cheap content fingerprint of a Host/DeviceGraph.

    Hashes the structural shape (n, directed slot count), the degree
    histogram and the weight-quantile LUT (``rtow``), the reference's
    digest for the same graph whether ``g`` is the host form or a
    ``DeviceGraph`` on any device.  With ``config`` carrying
    ``use_alt=True`` the landmark-set parameters (``n_landmarks``,
    ``landmark_strategy``, ``p2p_mode``) are folded in, so a winner tuned
    under ALT reads as stale when served without it; ALT-off configs
    leave the hash unchanged.
    """
    deg = _host(g.deg)
    rtow = _host(g.rtow).astype(np.float32)
    h = hashlib.sha256()
    h.update(np.asarray([deg.shape[0], int(g.m)], np.int64).tobytes())
    h.update(np.bincount(np.clip(deg, 0, 255), minlength=256)
             .astype(np.int64).tobytes())
    h.update(rtow.tobytes())
    if config is not None and getattr(config, "use_alt", False):
        h.update(repr(("alt", int(config.n_landmarks),
                       str(config.landmark_strategy),
                       str(config.p2p_mode))).encode())
    return h.hexdigest()[:16]


def _config_to_json(config: EngineConfig) -> dict:
    """Serializable field dict; ``devices`` is placement, not a tuning
    result (``torch.device`` objects do not serialize): always dropped."""
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config) if f.name != "devices"}


class TunedStore:
    """JSON-backed map ``gid -> tuned EngineConfig`` with staleness checks.

    Thread-safe; writes are atomic (tmp + rename) so a crashed tuner
    never leaves a half-written store behind, and a corrupt or unreadable
    file degrades to an empty store rather than breaking serving.
    """

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        self._data = None

    # -- persistence ---------------------------------------------------

    def _load_locked(self) -> dict:
        if self._data is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if not isinstance(data, dict) or "entries" not in data:
                    raise ValueError("not a TunedStore file")
            except (OSError, ValueError):
                data = {"version": _STORE_VERSION, "entries": {}}
            self._data = data
        return self._data

    def _save_locked(self) -> None:
        tmp = f"{self.path}.tmp"
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- API -----------------------------------------------------------

    def put(self, gid: str, graph, config: EngineConfig, *,
            objective: Optional[float] = None,
            baseline: Optional[float] = None, meta: Optional[dict] = None
            ) -> None:
        """Record ``config`` as the winner for ``(gid, graph)``; the
        stored fingerprint folds the winner's own landmark-set
        parameters (see :func:`graph_fingerprint`)."""
        entry = {
            "fingerprint": graph_fingerprint(graph, config),
            "config": _config_to_json(config),
        }
        if objective is not None:
            entry["objective"] = float(objective)
        if baseline is not None:
            entry["baseline"] = float(baseline)
        if meta:
            entry["meta"] = dict(meta)
        with self._lock:
            self._load_locked()["entries"][gid] = entry
            self._save_locked()

    def get(self, gid: str, graph=None,
            config: Optional[EngineConfig] = None, *,
            allow_stale: bool = False) -> Optional[EngineConfig]:
        """The tuned config for ``gid``, or ``None``.

        With ``graph`` given, the stored fingerprint must match the
        graph's current one (with ``config``'s landmark-set parameters);
        a stale entry returns ``None``.  An entry whose stored config no
        longer constructs also returns ``None``.  ``allow_stale`` skips
        the fingerprint check (a graph within its delta staleness budget
        keeps its perf-only overlay).
        """
        with self._lock:
            entry = self._load_locked()["entries"].get(gid)
        if entry is None:
            return None
        if not allow_stale and graph is not None and \
                entry["fingerprint"] != graph_fingerprint(graph, config):
            return None
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        kwargs = {k: v for k, v in entry["config"].items() if k in known}
        try:
            return EngineConfig(**kwargs)
        except ConfigError:
            return None

    def entry(self, gid: str) -> Optional[dict]:
        """The raw stored entry (fingerprint/config/objectives)."""
        with self._lock:
            e = self._load_locked()["entries"].get(gid)
        return json.loads(json.dumps(e)) if e is not None else None

    def gids(self) -> list:
        with self._lock:
            return sorted(self._load_locked()["entries"])

    def invalidate(self, gid: str) -> bool:
        """Drop ``gid``'s entry; returns whether one existed."""
        with self._lock:
            existed = self._load_locked()["entries"].pop(gid, None) is not None
            if existed:
                self._save_locked()
        return existed

    def apply(self, gid: str, graph, config: EngineConfig, *,
              n: Optional[int] = None, m: Optional[int] = None,
              allow_stale: bool = False) -> EngineConfig:
        """Overlay the tuned perf fields onto ``config`` (fresh lookup).

        Only :data:`TUNED_FIELDS` move.  The overlay is validated
        (construction always; ``resolve`` when ``n``/``m`` are given); an
        overlay the target config cannot carry falls back to the
        params-only overlay, then to ``config`` itself, rather than
        failing the build.  ``allow_stale`` forwards to :meth:`get`.
        """
        tuned = self.get(gid, graph, config, allow_stale=allow_stale)
        if tuned is None:
            return config
        full = {f: getattr(tuned, f) for f in TUNED_FIELDS}
        params_only = {f: full[f] for f in ("alpha", "beta", "policy")}
        for overlay in (full, params_only):
            try:
                cand = dataclasses.replace(config, **overlay)
                if n is not None or m is not None:
                    cand.resolve(n=n, m=m)
                return cand
            except ConfigError:
                continue
        return config
