"""Exporters: Prometheus text exposition, JSONL snapshots, Perfetto traces
(port of ``repro.obs.export``; the same text, dicts and files).

Three consumers, three formats, all derived from the same two sources of
truth (a :meth:`MetricsRegistry.snapshot` dict and a
:class:`~repro_torch.obs.trace.SolveTrace`):

* :func:`to_prometheus` — the Prometheus/OpenMetrics text exposition
  (``# HELP`` / ``# TYPE`` headers, ``_bucket``/``_sum``/``_count``
  histogram series) for scrape endpoints;
* :func:`write_jsonl_snapshot` — append-only JSONL dumps for offline
  perf-trajectory analysis (one snapshot per line);
* :func:`trace_to_perfetto` — a Chrome-trace (Perfetto JSON) view of a
  solve trace: a ``solve`` span over ``step`` (stepping-window) spans
  over ``round`` spans with per-round counters attached as args.

:func:`parse_prometheus` is a deliberately strict mini-parser used by
tests and the CI smoke step to prove the exposition is well-formed —
it is not a general Prometheus client.
"""
from __future__ import annotations

import json
import math
import re
import time

from .trace import SolveTrace, TRACE_COLUMNS

__all__ = [
    "to_prometheus", "parse_prometheus", "write_jsonl_snapshot",
    "trace_to_perfetto", "write_perfetto",
]

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?\s+"
    r"(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf|NaN))$")


def _fmt(v) -> str:
    """Prometheus sample-value formatting (+Inf / NaN spelled out)."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict, extra: dict = None) -> str:
    merged = dict(labels or {})
    merged.update(extra or {})
    if not merged:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def to_prometheus(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` as text exposition."""
    by_name: dict = {}
    for full_name, entry in snapshot.items():
        base = full_name.split("{", 1)[0]
        by_name.setdefault(base, []).append(entry)
    lines = []
    for base in sorted(by_name):
        series = by_name[base]
        kind = series[0]["type"]
        help_text = next((s.get("help") for s in series if s.get("help")),
                         None)
        if help_text:
            lines.append(f"# HELP {base} {help_text}")
        lines.append(f"# TYPE {base} {kind}")
        for entry in series:
            labels = entry.get("labels", {})
            if kind == "histogram":
                # bucket keys are canonical bound strings ("0.1", "+Inf");
                # order by numeric value, not lexically
                for bound in sorted(entry["buckets"],
                                    key=lambda k: float(k.replace("Inf",
                                                                  "inf"))):
                    lines.append(
                        f"{base}_bucket{_labels_str(labels, {'le': bound})} "
                        f"{entry['buckets'][bound]}")
                lines.append(f"{base}_sum{_labels_str(labels)} "
                             f"{_fmt(entry['sum'])}")
                lines.append(f"{base}_count{_labels_str(labels)} "
                             f"{entry['count']}")
            else:
                lines.append(f"{base}{_labels_str(labels)} "
                             f"{_fmt(entry['value'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Strictly parse a text exposition back into ``{sample_name: value}``.

    Raises ``ValueError`` on any malformed line; histogram invariants
    (cumulative ``_bucket`` counts ending at ``_count``) are checked by
    the tests on top of this.
    """
    samples: dict = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            if not (line.startswith("# HELP ") or line.startswith("# TYPE ")):
                raise ValueError(f"line {lineno}: bad comment {raw!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample {raw!r}")
        key = m.group("name") + (m.group("labels") or "")
        if key in samples:
            raise ValueError(f"line {lineno}: duplicate sample {key!r}")
        samples[key] = float(m.group("value").replace("Inf", "inf"))
    return samples


def write_jsonl_snapshot(snapshot: dict, path, meta: dict = None) -> None:
    """Append one ``{"ts", ..., "metrics"}`` JSON line to ``path``."""
    record = {"ts": time.time(), **(meta or {}), "metrics": snapshot}
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


# ---------------------------------------------------------------------------
# Perfetto / Chrome-trace export
# ---------------------------------------------------------------------------

# Track (tid) layout inside the exported process: one lane per nesting
# level so the solve -> step -> round -> invocation hierarchy renders as
# stacked tracks even in viewers that don't nest same-tid spans.
_TID_SOLVE, _TID_STEP, _TID_ROUND, _TID_INVOKE = 0, 1, 2, 3


def trace_to_perfetto(trace: SolveTrace, name: str = "solve",
                      pid: int = 0) -> dict:
    """A :class:`SolveTrace` as a Chrome-trace (Perfetto-loadable) dict.

    Solve traces carry no wall-clock — rounds execute inside one
    solve loop on the device — so the timeline uses *logical work time*:
    each round span lasts ``max(n_trav + n_pull_trav + n_relax, 1)``
    microseconds.  Span widths are therefore proportional to relaxation
    work, which is exactly the view the stepping-policy analysis needs
    (a mis-sized window shows up as one giant round span).
    """
    cols = trace.columns
    events = [
        {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
         "args": {"name": lane}}
        for tid, lane in ((_TID_SOLVE, "solve"), (_TID_STEP, "steps"),
                          (_TID_ROUND, "rounds"),
                          (_TID_INVOKE, "invocations"))
    ]
    t = 0
    step_idx, step_t0 = 0, 0
    for i in range(trace.n_records):
        rec = {c: cols[c][i].item() for c in TRACE_COLUMNS}
        work = int(rec["n_trav"] + rec["n_pull_trav"] + rec["n_relax"])
        dur = max(work, 1)
        rounds = int(rec["n_rounds"])
        rname = (f"round {int(rec['iter'])}" if rounds <= 1
                 else f"rounds x{rounds} (iter {int(rec['iter'])})")
        events.append({
            "ph": "X", "pid": pid, "tid": _TID_ROUND, "name": rname,
            "ts": t, "dur": dur, "cat": "round", "args": rec,
        })
        if rec["n_invocations"] > 0:
            events.append({
                "ph": "X", "pid": pid, "tid": _TID_INVOKE,
                "name": f"invoke x{int(rec['n_invocations'])}",
                "ts": t, "dur": dur, "cat": "invocation",
                "args": {"n_tiles_scanned": rec["n_tiles_scanned"],
                         "n_tiles_dense": rec["n_tiles_dense"]},
            })
        t += dur
        if rec["stepped"]:
            events.append({
                "ph": "X", "pid": pid, "tid": _TID_STEP,
                "name": f"step {step_idx} [lb={rec['lb']:.4g}, "
                        f"ub={rec['ub']:.4g})",
                "ts": step_t0, "dur": t - step_t0, "cat": "step",
                "args": {"lb": rec["lb"], "ub": rec["ub"],
                         "st": rec["st"],
                         "frontier_at_entry": int(rec["frontier"])},
            })
            step_idx, step_t0 = step_idx + 1, t
    if t > step_t0:     # records after the last transition (or none ran)
        events.append({
            "ph": "X", "pid": pid, "tid": _TID_STEP,
            "name": f"step {step_idx}", "ts": step_t0, "dur": t - step_t0,
            "cat": "step", "args": {},
        })
    events.append({
        "ph": "X", "pid": pid, "tid": _TID_SOLVE, "name": name,
        "ts": 0, "dur": max(t, 1), "cat": "solve",
        "args": trace.summary(),
    })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"time_unit": "logical work (1us ~= 1 relaxation)",
                          "n_records": trace.n_records,
                          "dropped": trace.dropped}}


def write_perfetto(trace: SolveTrace, path, name: str = "solve") -> None:
    """Dump :func:`trace_to_perfetto` JSON to ``path``."""
    with open(path, "w") as f:
        json.dump(trace_to_perfetto(trace, name=name), f)
