"""PyTorch/CUDA port of the EIC heuristic SSSP engine (``repro``).

The package mirrors ``repro``'s module tree and names.  It imports torch
and numpy, never jax and never ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The facade:
``Solver.open(graph, EngineConfig(...)).solve(SolveSpec...)``.
"""
from .api import SolveResult, SolveSpec, Solver
from .core.config import ConfigError, EngineConfig
from .core.graph import BlockedGraph, DeviceGraph, HostGraph, build_csr
from .core.sssp import sssp, sssp_batch

__all__ = ["Solver", "SolveSpec", "SolveResult", "EngineConfig",
           "ConfigError", "sssp", "sssp_batch", "build_csr", "HostGraph",
           "DeviceGraph", "BlockedGraph"]
