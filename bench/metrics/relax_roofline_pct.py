"""``relax_roofline_pct``: the relaxation kernels' share of their
roofline: the least bytes of the window's relaxation rounds
(``_work.relax_bytes`` of the rounds' ``n_relax``, ``n_extended`` and
``n_updates``) over the card's memory bandwidth, against the device time
of the operations launched inside ``kernels/edge_relax/ops.py::
relax_bucket`` (``torch.profiler``).  Moves ``sssp_gteps``."""
from bench.metrics import _work


def read(t):
    secs, bw = t.device.get("relax_kernel_s"), t.peaks.get("hbm_bytes_per_s")
    if not secs or not bw:
        return None
    c = t.counters
    need = _work.relax_bytes(c["round_n_relax"], c["round_n_extended"],
                             c["round_n_updates"])
    return 100.0 * need / bw / secs
