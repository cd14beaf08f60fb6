"""``layout_build_s``: seconds of the port's layout build
(``core/graph.py::build_blocked``, called by ``Solver.open``), host clock
ending in a synchronize.  Moves ``setup_s``."""


def read(t):
    return t.setup.get("layout_build_s")
