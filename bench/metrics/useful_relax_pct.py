"""``useful_relax_pct``: relaxation attempts that improved a distance,
``n_updates / n_relax`` over the window's solves (the stepping
heuristics' waste: the paper's "almost negligible repeated
relaxations").  Moves ``sssp_gteps``."""


def read(t):
    n = t.counters["n_relax"]
    return 100.0 * t.counters["n_updates"] / n if n else None
