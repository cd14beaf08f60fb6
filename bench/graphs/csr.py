"""The paper's preprocessing (§4.1) in torch on the card: a frozen copy of
what ``repro_torch.core.graph.build_csr`` computes on the host.

Both directions of every undirected edge are stored; each vertex's slots
are sorted by weight ascending, ties kept in input order (the order of
``[eu, ev]`` then ``[ev, eu]``); ``rtow`` is the ``RATIO_NUM``-point
quantile table of the stored weights, interpolated linearly in float64
between order statistics (``numpy.quantile``'s default method), then
rounded to float32.  ``torch.quantile`` refuses inputs over 2^24
elements, so the table is worked out here from one sort.
"""
from typing import NamedTuple

import numpy as np
import torch

RATIO_NUM = 4096          # paper §4.1: RATIO_NUM = 2^12


class CsrArrays(NamedTuple):
    """The fields of the port's ``DeviceGraph``, in its order and dtypes."""
    src: torch.Tensor       # [2m] int64
    dst: torch.Tensor       # [2m] int64
    w: torch.Tensor         # [2m] float32, ascending within each row
    row_ptr: torch.Tensor   # [n + 1] int64
    deg: torch.Tensor       # [n] int32
    rtow: torch.Tensor      # [RATIO_NUM] float32
    max_w: torch.Tensor     # 0-d float32
    n_edges2: torch.Tensor  # 0-d int32


def quantile_table(w_sorted: torch.Tensor, copies: int = 1,
                   ratio_num: int = RATIO_NUM) -> np.ndarray:
    """``RtoW[x]``, the ``x / (ratio_num - 1)`` quantile of a multiset in
    which every value of the ascending ``w_sorted`` appears ``copies``
    times: float64 linear interpolation between the two neighbouring
    order statistics, rounded to float32."""
    count = int(w_sorted.shape[0]) * copies
    if count == 0:
        return np.zeros(ratio_num, np.float32)
    q = np.linspace(0.0, 1.0, ratio_num)
    virtual = (count - 1) * q
    prev = np.floor(virtual)
    gamma = virtual - prev
    lo = np.minimum(prev, count - 1).astype(np.int64)
    hi = np.minimum(prev + 1, count - 1).astype(np.int64)
    idx = torch.from_numpy(np.stack([lo, hi]) // copies).to(w_sorted.device)
    a, b = w_sorted[idx].to(torch.float64).cpu().numpy()
    diff = b - a
    out = a + diff * gamma
    upper = gamma >= 0.5
    out[upper] = (b - diff * (1 - gamma))[upper]
    return out.astype(np.float32)


def build(n: int, eu: torch.Tensor, ev: torch.Tensor,
          ew: torch.Tensor) -> CsrArrays:
    """The preprocessed CSR of the undirected edge list ``(eu, ev, ew)``
    (int64, int64, float32 tensors on one device)."""
    if n >= 2 ** 31:
        raise ValueError("vertex ids must fit 31 bits")
    dev = ew.device
    s = torch.cat([eu, ev])
    # one stable sort by (source, weight): a positive float32's bits
    # order as the float does
    key = (s << 32) | ew.view(torch.int32).to(torch.int64).repeat(2)
    del s
    key, order = torch.sort(key, stable=True)
    src = key >> 32
    del key
    dst = torch.cat([ev, eu])[order]
    w = ew.repeat(2)[order]
    del order
    deg = torch.bincount(src, minlength=n).to(torch.int32)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    rtow = quantile_table(torch.sort(ew).values, copies=2)
    m2 = int(src.shape[0])
    max_w = w.max() if m2 else torch.zeros((), device=dev)
    return CsrArrays(
        src=src, dst=dst, w=w, row_ptr=row_ptr, deg=deg,
        rtow=torch.from_numpy(rtow).to(dev), max_w=max_w.to(torch.float32),
        n_edges2=torch.tensor(m2, dtype=torch.int32, device=dev))
