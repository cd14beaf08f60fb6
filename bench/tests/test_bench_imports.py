"""What the benchmark may import and read: no ``jax``, ``jaxlib``,
``flax`` or ``repro`` anywhere under ``bench/`` (the top-level name
compared whole, so ``repro_torch`` passes), nothing of ``benchmarks/`` or
``chip_smoke.py``, and no ``repro_torch`` in the reference."""
import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in (ROOT / "bench").rglob("*.py")
               if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports (absolute ones)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    assert not imported(path) & FORBIDDEN
    assert "chip_smoke" not in imported(path)
    if "tests" not in path.parts:          # these tests name them
        text = path.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_the_whole_comparison_is_plain_torch():
    files = sorted((ROOT / "bench" / "reference").glob("*.py"))
    assert set().union(*map(imported, files)) <= {"torch", "numpy", "bench"}
    for p in files:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench"):
                assert node.module.startswith("bench.reference"), p


def test_the_top_level_name_is_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.api\nfrom repro_torch import Solver\n")
    assert imported(p) == {"repro_torch"}
    p.write_text("import repro.core\n")
    assert imported(p) & FORBIDDEN == {"repro"}


def test_a_fresh_process_loads_no_jax():
    """Every module under ``bench/`` and the port's entry points, loaded
    in a process of their own, bring in none of the forbidden names."""
    paths = [str(p) for p in FILES if "tests" not in p.parts]
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from bench.spec import load_module\n"
        f"for i, p in enumerate({paths!r}):\n"
        "    load_module(Path(p), f'probe_{i}')\n"
        "import repro_torch.api\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN
