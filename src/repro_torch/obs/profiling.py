"""``torch.profiler`` ranges around the engines' dispatch points (port of
``repro.obs.profiling``).

:func:`annotate` wraps a host-side phase (a layout build, a solve's or a
repair's dispatch, a landmark build) in
``torch.profiler.record_function``, so that it shows as a named range in
a ``torch.profiler`` capture beside the kernels it launched; outside a
capture the range costs a few microseconds.  Where the profiler is
missing it degrades to a ``nullcontext``: a range must never break a
solve.  The names are the reference's (``repro:sssp_dispatch``,
``repro:repair_dispatch``, ``repro:prepare_layout:<backend>``, ...).
"""
from __future__ import annotations

import contextlib

__all__ = ["annotate", "PROFILER_AVAILABLE"]

try:
    from torch.profiler import record_function as _record_function
    PROFILER_AVAILABLE = True
except Exception:                                   # pragma: no cover
    _record_function = None
    PROFILER_AVAILABLE = False


def annotate(name: str):
    """Context manager naming the enclosed host-side phase for profilers."""
    if _record_function is None:                    # pragma: no cover
        return contextlib.nullcontext()
    return _record_function(name)
