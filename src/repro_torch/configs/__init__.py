"""Architecture registry of the port: one module per architecture, as in
``repro.configs``.

Every ported module exposes ``FAMILY``, ``make_config(**kw)`` (the full
configuration), ``SHAPES`` and ``smoke_config()`` (a reduced config of the
same family for CPU tests), and, as the reference's, ``MICROBATCHES``
(gradient-accumulation steps by train shape) and, for the MoE LMs,
``PREFILL_CHUNKS``; the GNN modules also ``MODEL`` (the module of
``repro_torch.models.gnn`` that runs it).  Every architecture is
ported: the five LMs, qwen3-0.6b-swa, the four GNNs and MIND; :func:`get`
raises for an unknown name.  :func:`all_cells` and ``SKIPPED`` are the
reference's (``launch/cells.py`` builds each cell).
"""
from __future__ import annotations

import importlib

ARCHS = [
    # LM family (5)
    "deepseek-moe-16b",
    "granite-moe-3b-a800m",
    "qwen3-0.6b",
    "phi4-mini-3.8b",
    "granite-34b",
    # GNN (4)
    "dimenet",
    "gatedgcn",
    "pna",
    "gin-tu",
    # recsys (1)
    "mind",
]

BONUS_ARCHS = ["qwen3-0.6b-swa"]  # sub-quadratic variant for long_500k

PORTED = tuple(ARCHS + BONUS_ARCHS)


def _modname(arch: str) -> str:
    return __name__ + "." + arch.replace("-", "_").replace(".", "_")


def get(arch: str):
    if arch not in PORTED:
        raise NotImplementedError(f"architecture {arch!r} is unknown; "
                                  "ported: " + ", ".join(PORTED))
    return importlib.import_module(_modname(arch))


def all_cells(include_bonus: bool = False):
    """Yield every assigned (arch, shape) cell (skips noted in SKIPPED)."""
    for arch in ARCHS + (BONUS_ARCHS if include_bonus else []):
        mod = get(arch)
        for shape in mod.SHAPES:
            if shape in getattr(mod, "SKIP_SHAPES", {}):
                continue
            yield arch, shape


SKIPPED = {
    # long_500k needs sub-quadratic attention; all five assigned LM archs
    # are full (GQA) attention -> skipped per the assignment.  The bonus
    # qwen3-0.6b-swa config runs the cell.
    ("deepseek-moe-16b", "long_500k"): "full attention",
    ("granite-moe-3b-a800m", "long_500k"): "full attention",
    ("qwen3-0.6b", "long_500k"): "full attention",
    ("phi4-mini-3.8b", "long_500k"): "full attention",
    ("granite-34b", "long_500k"): "full attention",
}
