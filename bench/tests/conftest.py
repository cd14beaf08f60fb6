"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository root.  The repository root (for ``bench``) and ``src`` (for
the port) go on the import path."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def small_root(tmp_path: Path, scale: int = 9) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``bench/``) in
    ``tmp_path`` whose configurations are cut to ``scale``."""
    import json
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (tmp_path / "bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["scale"] = scale
        f.write_text(json.dumps(cfg))
    return tmp_path
