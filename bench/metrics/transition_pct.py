"""``transition_pct``: the step transition's share of the traced window
(``core/sssp.py::_transition`` with ``core/stepping.py``,
``traversal.py`` and ``stats.py``): the seconds of its spans, from the
call's first launch to its last kernel's end.  Moves ``sssp_gteps``."""


def read(t):
    return 100.0 * t.spans["transition"] / t.window_s
