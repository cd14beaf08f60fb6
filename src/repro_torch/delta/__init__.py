"""Streaming graph updates: edge deltas, layout patching and incremental
SSSP repair (port of ``repro.delta``).

A small edit batch should cost its blast radius, not a rebuild and a
recompute.  ``EdgeDelta`` describes the batch; ``patch_host`` /
``patch_blocked`` / ``patch_sharded`` patch each layout (equal to a
from-scratch rebuild); ``repair_state`` + ``repair`` (or
``repro_torch.core.distributed.repair_distributed``, v1) re-relax only
from the vertices the delta touches, bitwise a from-scratch solve.
"""
from .edits import (AppliedDelta, EdgeDelta, KIND_ADD, KIND_DECREASE,
                    KIND_INCREASE, KIND_REMOVE, KIND_SAME)
from .patch import (patch_blocked, patch_blocked_with, patch_host,
                    patch_sharded, patch_sharded_with)
from .repair import RepairStats, repair, repair_state

__all__ = [
    "AppliedDelta", "EdgeDelta",
    "KIND_ADD", "KIND_DECREASE", "KIND_INCREASE", "KIND_REMOVE",
    "KIND_SAME",
    "patch_blocked", "patch_blocked_with", "patch_host", "patch_sharded",
    "patch_sharded_with",
    "RepairStats", "repair", "repair_state",
]
