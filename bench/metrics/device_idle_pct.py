"""``device_idle_pct``: the share of the traced window in which no
operation ran on the card (``torch.profiler``'s device events).  Moves
``sssp_gteps``."""


def read(t):
    busy = t.device.get("busy_s")
    return 100.0 * (1.0 - busy / t.window_s) if busy else None
