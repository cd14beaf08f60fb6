"""Checkpoint and restore in the reference's on-disk layout, the port's
copy of ``repro.train.checkpoint``.

Layout (one directory per step, renamed into place when complete):

    <dir>/step_00000123/
        manifest.json      {"step", "meta", "shards": 1, "leaves":
                            {name: {file, shape, dtype}}}
        <name>.npy         one file per leaf

A leaf's name is its path in the tree as the reference names it (dict
keys, ``[i]`` for a sequence position, joined by ``.``: ``[0].layers.wq``
for a ``(params, opt_state)`` tuple).  bfloat16 leaves are stored as
their exact float32 values with ``"bfloat16"`` in the manifest (numpy
has no bfloat16).  A checkpoint written by either package restores in
the other.  :func:`restore` with a target tree places each leaf on the
target leaf's device and in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import flatten_with_path, path_str, unflatten


def _host(x):
    """``(array, dtype name)`` of a leaf: a copy on the host, bf16 as
    f32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    arr = np.array(x)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any, meta: Optional[dict] = None,
         blocking: bool = True):
    """Write a checkpoint of ``tree`` at ``step``; returns the final path
    (``blocking=False``: the path and the writer thread, the leaves
    already copied to the host)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    host = [(path_str(p), *_host(x)) for p, x in flatten_with_path(tree)]

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "meta": meta or {}, "shards": 1,
                    "leaves": {}}
        for name, arr, dt in host:
            fn = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dt}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return final
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return final, t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None,
            target_tree: Any = None):
    """Load a checkpoint (the latest when ``step`` is None).

    Without ``target_tree``: ``({name: numpy array}, manifest)``, bf16
    leaves as float32.  With it: ``(tree, manifest)``, the leaves arranged
    into ``target_tree``'s structure by name, each a tensor on its target
    leaf's device in its dtype (a bf16 leaf restores bit for bit)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {name: np.load(os.path.join(path, info["file"]))
               for name, info in manifest["leaves"].items()}
    if target_tree is None:
        return by_name, manifest
    out = []
    for p, ref in flatten_with_path(target_tree):
        name = path_str(p)
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = by_name[name]
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(ref.shape)}")
        out.append(torch.from_numpy(np.array(arr, order="C")).to(
            device=ref.device, dtype=ref.dtype))
    return unflatten(target_tree, out), manifest
