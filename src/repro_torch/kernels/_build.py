"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/<name>/csrc/*.cu`` file becomes one shared library with a
plain C interface, compiled for Hopper (``sm_90a``) into
``build/repro_torch_kernels/`` at the repository root on first use.  The
file name carries a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.  :func:`build_all`
starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: a CPU-only installation imports the
package without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}
# one build and load at a time: host threads that launch kernels (the
# serving plane's schedulers) may reach their first call together
_load_lock = threading.Lock()


def sources() -> dict:
    """``{library name: source path}`` for every CUDA source of the port."""
    return {p.stem: p for p in sorted(_KERNELS.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, in
    parallel; returns ``{name: library path}``.  Raises with ``nvcc``'s
    output if any compile fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _target(srcs[name])
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _target(srcs[name]) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib
