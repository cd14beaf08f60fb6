"""``relax_call_pct``: the relaxation call's share of the traced window
(``core/sssp.py::_relax_round`` over ``core/relax.py``'s
``_blocked_relax`` / ``_blocked_relax_slots``): the seconds of its spans.
Moves ``sssp_gteps``."""


def read(t):
    return 100.0 * t.spans["relax_call"] / t.window_s
