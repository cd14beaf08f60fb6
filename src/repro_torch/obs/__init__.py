"""Observability plane: solve traces, serving metrics, exporters (port
of ``repro.obs``).

* :mod:`repro_torch.obs.trace`: opt-in per-round solve traces
  (``EngineConfig(trace=True)``), a ring of device tensors copied to the
  host once as :class:`SolveTrace`;
* :mod:`repro_torch.obs.metrics`: the thread-safe
  :class:`MetricsRegistry` (counters, gauges, latency histograms);
* :mod:`repro_torch.obs.export`: Prometheus text exposition, JSONL
  snapshots and the Perfetto (Chrome-trace) solve-trace exporter;
* :mod:`repro_torch.obs.profiling`: ``torch.profiler`` ranges around
  layout builds and dispatch.

The package imports nothing from ``repro_torch.core`` or
``repro_torch.serve``, so every layer can depend on it without cycles.
"""
from .trace import (TRACE_COLUMNS, TRACE_COUNTER_COLUMNS, SolveTrace,
                    TraceBuf, materialize_trace, trace_append, trace_init)
from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .export import (parse_prometheus, to_prometheus, trace_to_perfetto,
                     write_jsonl_snapshot, write_perfetto)
from .profiling import PROFILER_AVAILABLE, annotate

__all__ = [
    "TRACE_COLUMNS", "TRACE_COUNTER_COLUMNS", "SolveTrace", "TraceBuf",
    "materialize_trace", "trace_append", "trace_init",
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry",
    "parse_prometheus", "to_prometheus", "trace_to_perfetto",
    "write_jsonl_snapshot", "write_perfetto",
    "PROFILER_AVAILABLE", "annotate",
]
