"""The port stands alone: ``import repro_torch`` and CPU solves (single
device, fused, sharded v1) load neither jax nor the reference package,
``chip_smoke.py`` and the card-side tests import neither, entry points
need ``cuda`` unless told ``device="cpu"``, and a CPU tensor never counts
as a kernel launch."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import json, os, sys, tempfile
import torch.distributed as tdist
import repro_torch
from repro_torch.core.distributed import shard_graph, sssp_distributed
from repro_torch.core.sssp import sssp
from repro_torch.data.generators import kronecker
from repro_torch.kernels.edge_relax.ops import LAUNCHES
g = kronecker(7, 4, seed=1)
d, p, m = sssp(g, 0, backend="blocked", device="cpu", block_v=64, tile_e=64)
d4, _, _ = sssp(g, 0, backend="blocked", device="cpu", block_v=64, tile_e=64,
                fused_rounds=4)
with tempfile.TemporaryDirectory() as tmp:
    tdist.init_process_group("gloo", rank=0, world_size=1,
                             store=tdist.FileStore(os.path.join(tmp, "s"), 1))
    dv, _, _ = sssp_distributed(shard_graph(g, 1), 0, version="v1",
                                backend="blocked", block_v=64, tile_e=64,
                                device="cpu")
    tdist.destroy_process_group()
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded,
                  "launches": LAUNCHES.edge_relax + LAUNCHES.edge_relax_fused
                  + LAUNCHES.edge_relax_partials,
                  "reached": int(d.isfinite().sum()),
                  "fused_same": bool(d4.equal(d)),
                  "v1_same": bool(dv[:g.n].equal(d))}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["launches"] == 0           # CPU tensors: the plain version
    assert res["reached"] > 1 and res["fused_same"] and res["v1_same"]


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda.py"])
def test_card_side_files_import_no_jax(path):
    # the machine with the card has no jax: these files run there
    tree = ast.parse((SRC.parent / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(names)
    assert "repro_torch" in roots


def test_entry_point_needs_a_card_unless_told_cpu():
    from repro_torch.core.graph import build_csr
    from repro_torch.core.sssp import sssp
    g = build_csr(3, [0, 1], [1, 2], [1.0, 2.0])
    if torch.cuda.is_available():
        dist, _, _ = sssp(g, 0)
        assert dist.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sssp(g, 0)
    dist, _, _ = sssp(g, 0, device="cpu")
    assert dist.tolist() == [0.0, 1.0, 3.0]
