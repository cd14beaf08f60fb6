"""The port stands alone: ``import repro_torch``, CPU solves (single
device, fused, sharded v1, ALT p2p with a landmark build, bidirectional),
CPU serving of the LM and the recsys path (embedding layer, MIND) load
neither jax nor the reference package,
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
from repro_torch import convert
from repro_torch.core.distributed import shard_graph, sssp_distributed
from repro_torch.core.landmarks import build_landmarks
from repro_torch.core.sssp import sssp
from repro_torch.data.generators import kronecker
from repro_torch.kernels.edge_relax.ops import LAUNCHES
from repro_torch.serve.queries import reconstruct_path
g = kronecker(7, 4, seed=1)
d, p, m = sssp(g, 0, backend="blocked", device="cpu", block_v=64, tile_e=64)
d4, _, _ = sssp(g, 0, backend="blocked", device="cpu", block_v=64, tile_e=64,
                fused_rounds=4)
lm = build_landmarks(g, 4, device="cpu")
t = int(d.argmax())
paths = []
for kw in (dict(), dict(fused_rounds=4), dict(p2p_mode="bidirectional")):
    da, pa, _ = sssp(g, 0, backend="blocked", device="cpu", block_v=64,
                     tile_e=64, goal="p2p", goal_param=t, landmarks=lm, **kw)
    paths.append((float(da[t]), reconstruct_path(pa.numpy(), 0, t)))
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
                  + LAUNCHES.edge_relax_partials + LAUNCHES.edge_relax_alt
                  + LAUNCHES.edge_relax_fused_alt,
                  "p2p_same": all(x == (float(d[t]), reconstruct_path(
                      p.numpy(), 0, t)) for x in paths),
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
    assert res["p2p_same"]


_LM_PROBE = """
import json, sys
import numpy as np
import torch
from repro_torch import configs, convert
from repro_torch.kernels.flash_attn import ops
from repro_torch.launch import serve
from repro_torch.models import layers, transformer as T
from repro_torch.serve.engine import Request, ServeEngine
tokens = {}
for arch in ("qwen3-0.6b", "qwen3-0.6b-swa"):
    cfg = configs.get(arch).smoke_config()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    for attn in ("flash", "plain"):
        eng = ServeEngine(cfg, params, max_batch=2, s_cache=32,
                          prompt_pad=8, attn=attn)
        reqs = [Request(rid=i, prompt=np.arange(3 + 5 * i, dtype=np.int32),
                        max_new=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        tokens[arch + "/" + attn] = [r.out for r in reqs]
serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"])
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "launches": ops.LAUNCHES.flash_attention,
                  "tokens": tokens}))
"""


def test_lm_serving_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _LM_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["launches"] == 0           # CPU tensors: the plain version
    for name, outs in res["tokens"].items():
        assert [len(o) for o in outs] == [4, 4, 4], name


_RECSYS_PROBE = """
import json, sys
import numpy as np
import torch
from repro_torch import configs, convert
from repro_torch.data.synthetic import RecsysStream
from repro_torch.kernels.embedding_bag import ops
from repro_torch.models.recsys import embedding, mind
cfg = configs.get("mind").smoke_config()
params = mind.init_params(cfg, torch.Generator().manual_seed(0))
b = RecsysStream(cfg.n_items, cfg.hist_len, seed=0).batch(0, 8)
table = params["item_embed"]
hist, m = torch.from_numpy(b["hist"]), torch.from_numpy(b["hist_mask"])
pooled = [embedding.embedding_bag_batched(table, hist, m, mode=mode)
          for mode in ("sum", "mean")]
ragged = embedding.embedding_bag(table, hist.reshape(-1),
                                 torch.arange(80) // 10, 8)
u = mind.serve_interests(cfg, params, b)
s = mind.retrieval_scores(cfg, params, u[0], np.arange(100, dtype=np.int32))
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "launches": ops.LAUNCHES.embedding_bag,
                  "finite": all(bool(t.isfinite().all()) for t in
                                (*pooled, ragged, u, s)),
                  "shapes": [list(t.shape) for t in (*pooled, u, s)]}))
"""


def test_recsys_path_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _RECSYS_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["launches"] == 0           # CPU tensors: the plain version
    assert res["finite"]
    assert res["shapes"] == [[8, 16], [8, 16], [8, 4, 16], [100]]


def test_unported_architectures_raise():
    from repro_torch import configs
    assert configs.get("qwen3-0.6b").make_config().n_layers == 28
    assert configs.get("mind").make_config().n_items == 10_000_000
    for arch in ("deepseek-moe-16b", "granite-34b", "gatedgcn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            configs.get(arch)
    with pytest.raises(NotImplementedError, match="unknown"):
        configs.get("llama-7b")


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda.py",
                                  "tools/edge_relax_ablation.py",
                                  "tools/embedding_bag_grid.py",
                                  "src/repro_torch/api.py",
                                  "src/repro_torch/core/config.py",
                                  "src/repro_torch/serve/queries.py"])
def test_card_side_files_import_no_jax(path):
    # the machine with the card has no jax: these files run there (a
    # relative import inside the package is an import of repro_torch)
    tree = ast.parse((SRC.parent / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level:
            names.add("repro_torch")
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


def test_serve_launcher_needs_a_card_unless_told_cpu(capsys):
    from repro_torch.launch import serve
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--requests", "1", "--max-new", "2"])
    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "3"])
    assert "served 2 requests (6 tokens)" in capsys.readouterr().out
