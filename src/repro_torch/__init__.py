"""PyTorch/CUDA port of the EIC heuristic SSSP engine (``repro``).

The package mirrors ``repro``'s module tree and names.  It imports torch
and numpy, never jax and never ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from .core.graph import BlockedGraph, DeviceGraph, HostGraph, build_csr
from .core.sssp import sssp

__all__ = ["sssp", "build_csr", "HostGraph", "DeviceGraph", "BlockedGraph"]
