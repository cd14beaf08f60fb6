"""The port stands alone: ``import repro_torch``, CPU solves (single
device, fused, sharded v1, ALT p2p with a landmark build, bidirectional,
a delta's patch and repair, a traced solve),
CPU serving of the LM and the recsys path (embedding layer, MIND), and
CPU training (LM, MIND and GNN steps, checkpoints, the launcher, the
anchor features) load neither jax nor the reference package,
``chip_smoke.py`` and the card-side tests import neither, entry points
need ``cuda`` unless told ``device="cpu"``, and a CPU tensor never counts
as a kernel launch."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
from repro_torch import delta, obs
new_host, applied = delta.patch_host(g, delta.EdgeDelta(
    add=[(0, g.n - 1, 0.25)]))
dr, _, _, _ = delta.repair(new_host.to_device("cpu"), new_host, d, p,
                           applied)
*_, buf = sssp(new_host, 0, device="cpu", trace=True)
text = obs.to_prometheus(obs.MetricsRegistry().snapshot())
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded,
                  "repaired": bool(dr.equal(sssp(new_host, 0,
                                                 device="cpu")[0])),
                  "traced": obs.materialize_trace(buf).n_records > 0,
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
    assert res["repaired"] and res["traced"]


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
    # every architecture is ported: all ten (and the swa variant) resolve,
    # and an unknown name still raises
    from repro_torch import configs
    assert configs.get("qwen3-0.6b").make_config().n_layers == 28
    assert configs.get("mind").make_config().n_items == 10_000_000
    for arch in configs.ARCHS + configs.BONUS_ARCHS:
        mod = configs.get(arch)
        assert mod.FAMILY in ("lm", "gnn", "recsys"), arch
        assert mod.smoke_config() is not None
    widths = {arch: configs.get(arch).make_config() for arch in
              ("gin-tu", "gatedgcn", "pna", "dimenet")}
    assert (widths["gin-tu"].n_layers, widths["gin-tu"].d_hidden) == (5, 64)
    assert (widths["gatedgcn"].n_layers, widths["gatedgcn"].d_hidden) == \
        (16, 70)
    assert (widths["pna"].n_layers, widths["pna"].d_hidden) == (4, 75)
    assert (widths["dimenet"].n_blocks, widths["dimenet"].d_hidden) == \
        (6, 128)
    assert len(configs.ARCHS) == 10
    with pytest.raises(NotImplementedError, match="unknown"):
        configs.get("llama-7b")


_STANDALONE = ("src/repro_torch/delta/edits.py",
               "src/repro_torch/launch/mesh.py",
               "src/repro_torch/launch/comm_stats.py",
               "src/repro_torch/parallel/__init__.py",
               "src/repro_torch/parallel/dtensor_ops.py",
               "src/repro_torch/data/sampler.py",
               "src/repro_torch/data/triplets.py",
               "src/repro_torch/data/synthetic.py",
               "src/repro_torch/core/f32math.py",
               "src/repro_torch/configs/gnn_common.py",
               "src/repro_torch/configs/__init__.py",
               "src/repro_torch/models/gnn/__init__.py",
               "src/repro_torch/train/tree.py",
               "src/repro_torch/tune/objective.py",
               "src/repro_torch/obs/trace.py",
               "src/repro_torch/obs/metrics.py",
               "src/repro_torch/obs/profiling.py")


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda.py",
                                  "tools/edge_relax_ablation.py",
                                  "tools/embedding_bag_grid.py",
                                  "tools/serving_phase.py",
                                  "tools/lm_phases.py",
                                  "src/repro_torch/api.py",
                                  "src/repro_torch/core/config.py",
                                  "src/repro_torch/serve/queries.py",
                                  "src/repro_torch/delta/__init__.py",
                                  "src/repro_torch/delta/edits.py",
                                  "src/repro_torch/delta/patch.py",
                                  "src/repro_torch/delta/repair.py",
                                  "src/repro_torch/obs/__init__.py",
                                  "src/repro_torch/obs/trace.py",
                                  "src/repro_torch/obs/metrics.py",
                                  "src/repro_torch/obs/export.py",
                                  "src/repro_torch/obs/profiling.py",
                                  "src/repro_torch/tune/__init__.py",
                                  "src/repro_torch/tune/objective.py",
                                  "src/repro_torch/tune/search.py",
                                  "src/repro_torch/tune/store.py",
                                  "src/repro_torch/serve/registry.py",
                                  "src/repro_torch/serve/scheduler.py",
                                  "src/repro_torch/serve/router.py",
                                  "src/repro_torch/serve/sssp_service.py",
                                  "src/repro_torch/kernels/edge_relax/"
                                  "ops.py",
                                  "src/repro_torch/models/transformer.py",
                                  "src/repro_torch/train/optimizer.py",
                                  "src/repro_torch/train/loop.py",
                                  "src/repro_torch/train/checkpoint.py",
                                  "src/repro_torch/train/failure.py",
                                  "src/repro_torch/train/tree.py",
                                  "src/repro_torch/launch/train.py",
                                  "src/repro_torch/data/synthetic.py",
                                  "src/repro_torch/data/generators.py",
                                  "src/repro_torch/data/triplets.py",
                                  "src/repro_torch/core/f32math.py",
                                  "src/repro_torch/convert.py",
                                  "src/repro_torch/configs/__init__.py",
                                  "src/repro_torch/configs/gnn_common.py",
               "src/repro_torch/configs/__init__.py",
               "src/repro_torch/models/gnn/__init__.py",
                                  "src/repro_torch/configs/gin_tu.py",
                                  "src/repro_torch/configs/gatedgcn.py",
                                  "src/repro_torch/configs/pna.py",
                                  "src/repro_torch/configs/dimenet.py",
                                  "src/repro_torch/models/gnn/__init__.py",
                                  "src/repro_torch/models/gnn/common.py",
                                  "src/repro_torch/models/gnn/"
                                  "sharded_ops.py",
                                  "src/repro_torch/models/gnn/gin.py",
                                  "src/repro_torch/models/gnn/gatedgcn.py",
                                  "src/repro_torch/models/gnn/pna.py",
                                  "src/repro_torch/models/gnn/dimenet.py",
                                  "src/repro_torch/models/gnn/anchors.py",
                                  "tools/gnn_phase.py",
                                  "tools/tooling_phase.py",
                                  "src/repro_torch/core/baselines.py",
                                  "src/repro_torch/data/weights.py",
                                  "src/repro_torch/data/traffic.py",
                                  "src/repro_torch/data/sampler.py",
                                  "examples/torch/quickstart.py",
                                  "examples/torch/serving_demo.py",
                                  "examples/torch/serve_lm.py",
                                  "examples/torch/train_lm.py",
                                  "examples/torch/gnn_sssp_features.py",
                                  "tools/dryrun_phase.py",
                                  "src/repro_torch/launch/mesh.py",
                                  "src/repro_torch/launch/cells.py",
                                  "src/repro_torch/launch/dryrun.py",
                                  "src/repro_torch/launch/comm_stats.py",
                                  "src/repro_torch/parallel/__init__.py",
                                  "src/repro_torch/parallel/sharding.py",
                                  "src/repro_torch/parallel/compress.py",
                                  "src/repro_torch/parallel/"
                                  "dtensor_ops.py",
                                  "src/repro_torch/configs/lm_common.py"])
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
    # modules that keep their own copy of a reference module import
    # nothing of the package
    assert "repro_torch" in roots or path in _STANDALONE, path


_TRAIN_PROBE = """
import json, sys, tempfile
import numpy as np
import torch
from repro_torch import configs
from repro_torch.data.synthetic import LMTokenStream, RecsysStream
from repro_torch.kernels.flash_attn import ops
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.recsys import mind
from repro_torch.train import checkpoint, failure, loop, optimizer
losses = {}
with tempfile.TemporaryDirectory() as tmp:
    for arch in ("deepseek-moe-16b", "granite-34b"):
        cfg = configs.get(arch).smoke_config()
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1)
        state = (params, optimizer.adamw_init(params, ocfg))
        stream = LMTokenStream(cfg.vocab)
        (p, o), last, _ = failure.run_restartable(
            loop.make_lm_train_step(cfg, ocfg, microbatches=2),
            lambda i: {"tokens": stream.batch(i, 4, 16)}, state, n_steps=2,
            ckpt_dir=tmp + "/" + arch, ckpt_every=1, log_fn=lambda m: None)
        back, _ = checkpoint.restore(tmp + "/" + arch, target_tree=(p, o))
        losses[arch] = bool(all(torch.equal(a, b) for a, b in zip(
            back[0]["layers"].values(), p["layers"].values())))
    cfg = configs.get("mind").smoke_config()
    params = mind.init_params(cfg, torch.Generator().manual_seed(0))
    ocfg = optimizer.AdamWConfig(master_weights=False)
    _, _, m = loop.make_mind_train_step(cfg, ocfg)(
        params, optimizer.adamw_init(params, ocfg),
        RecsysStream(cfg.n_items, cfg.hist_len).batch(0, 8))
    losses["mind"] = bool(torch.isfinite(m["loss"]))
    train.main(["--arch", "granite-moe-3b-a800m", "--steps", "2",
                "--device", "cpu", "--ckpt-dir", tmp + "/launch"])
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "launches": ops.LAUNCHES.flash_attention,
                  "ok": losses}))
"""


def test_training_imports_no_jax_and_no_reference():
    """Train steps of a MoE and a dense LM (microbatches, the restartable
    loop, checkpoints) and of MIND, and the training launcher, load
    neither jax nor the reference package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["launches"] == 0
    assert res["ok"] == {"deepseek-moe-16b": True, "granite-34b": True,
                         "mind": True}


_GNN_PROBE = """
import json, sys
import numpy as np
import torch
from repro_torch import configs
from repro_torch.data.generators import kronecker, molecule_batch
from repro_torch.data.synthetic import gnn_node_classification
from repro_torch.data.triplets import build_triplets
from repro_torch.kernels.edge_relax.ops import LAUNCHES
from repro_torch.models.gnn import dimenet, gatedgcn, gin, pna
from repro_torch.models.gnn.anchors import anchor_distance_features
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train import loop, optimizer
g = gnn_node_classification(40, 100, 8, 4, seed=0, with_pos=True)
kj, ji, mk = build_triplets(g["senders"], g["receivers"], 4)
gb = GraphBatch(edge_feat=None, graph_ids=np.zeros(40, np.int32),
                triplet_kj=kj, triplet_ji=ji, triplet_mask=mk, **g)
losses = {}
for arch, mod in (("gin-tu", gin), ("gatedgcn", gatedgcn), ("pna", pna),
                  ("dimenet", dimenet)):
    cfg = configs.get(arch).make_config(d_in=8, n_classes=4,
                                        graph_level=False, remat=True)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0))
    ocfg = optimizer.AdamWConfig(master_weights=False)
    _, _, m = loop.make_gnn_train_step(mod.forward, cfg, ocfg)(
        params, optimizer.adamw_init(params, ocfg), gb)
    losses[arch] = float(m["loss"])
mb = molecule_batch(6, 8, 2)
feats, anchors = anchor_distance_features(kronecker(7, 4, seed=1), 4,
                                          device="cpu")
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "losses": losses,
                  "feats": list(feats.shape), "launches": LAUNCHES.edge_relax
                  + LAUNCHES.edge_relax_batch}))
"""


def test_gnn_training_imports_no_jax_and_no_reference():
    """A train step of each GNN at full width (remat on), the GNN data
    functions and the anchor features load neither jax nor the
    reference package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _GNN_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["launches"] == 0
    assert sorted(res["losses"]) == ["dimenet", "gatedgcn", "gin-tu", "pna"]
    assert all(np.isfinite(v) for v in res["losses"].values())
    assert res["feats"] == [128, 4]


_SERVING_PROBE = """
import json, sys, tempfile
from repro_torch.api import EngineConfig, SolveSpec, Solver
from repro_torch.data.generators import kronecker
from repro_torch.delta import EdgeDelta
from repro_torch.serve.sssp_service import SsspRequest, SsspService
from repro_torch.tune import TunedStore, tune
g = kronecker(7, 4, seed=1)
with tempfile.TemporaryDirectory() as tmp:
    store = TunedStore(tmp + "/tuned.json")
    res = tune(g, budget=3, restarts=0, n_sources=1, store=store,
               device="cpu")
    with Solver.open(g, EngineConfig(tier="routed", devices=("cpu",) * 2,
                                     backend="blocked", use_alt=True),
                     tuned=store) as s:
        r = s.submit(SolveSpec.p2p([0, 3], [5, 9])).result(timeout=120)
        s.apply_delta(EdgeDelta(add=[(0, g.n - 1, 0.5)]))
        after = s.solve(SolveSpec.tree(0))
svc = SsspService(g, max_batch=2, device="cpu")
svc.submit(SsspRequest(rid=0, source=1))
svc.run()
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "evals": res.n_evals,
                  "served": sorted(set(r.served_by)),
                  "after": float(after.dist[g.n - 1])}))
"""


def test_serving_plane_and_tuner_import_no_jax():
    """A tune, a routed session over two CPU entries (submit, a delta,
    a solve) and the service load neither jax nor the reference."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _SERVING_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["evals"] >= 2
    assert res["after"] <= 0.5 and res["served"]


_WORKLOAD_PROBE = """
import json, sys
import numpy as np
from repro_torch.core.baselines import bellman_ford, delta_stepping
from repro_torch.data.generators import kronecker
from repro_torch.data.sampler import NeighborSampler, flat_subgraph
from repro_torch.data.traffic import make_traffic
from repro_torch.data.weights import make_variant
g = kronecker(8, 8, seed=1)
var = make_variant(g, power=4)
dg = var.to_device("cpu")
bf = bellman_ford(dg, 0)[0]
ds = delta_stepping(dg, 0, 0.5 * var.max_w)[0]
items = make_traffic({"a": g, "b": var}, 16, seed=0, rate_qps=10.0)
batch = NeighborSampler(g.row_ptr.astype(np.int64), g.dst, (4, 3)).sample(
    np.arange(8))
sub = flat_subgraph(batch, 64, 128)
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "same": bool((bf == ds).all()),
                  "items": len(items), "edges": int(sub[2].sum())}))
"""


def test_workload_side_imports_no_jax_and_no_reference():
    """The baselines, the weight variants, the traffic and the sampler
    load neither jax nor the reference."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _WORKLOAD_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["same"]
    assert res["items"] == 16 and res["edges"] > 0


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


_DRYRUN_PROBE = """
import json, sys
from repro_torch import configs
from repro_torch.launch import cells, comm_stats, dryrun, mesh
from repro_torch.parallel import compress, sharding
dryrun.start_fake_group(4)
m = mesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
fn, args, meta, out = cells.build_cell("gin-tu", "molecule", m, smoke=True)
_, records, flops, _, _ = dryrun.trace_cell(fn, args, out)
art = dryrun.run_sssp("single", 8, 4, "v3", "blocked", device="cpu",
                      out_dir=sys.argv[1], world=4)
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loaded": loaded, "flops": flops, "ok": art["ok"],
                  "records": len(records), "cells": len(list(
                      configs.all_cells()))}))
"""


def test_dryrun_imports_no_jax_and_no_reference(tmp_path):
    """The many-device tooling (mesh, rules, compression, cells, the
    dry-run) loads neither jax nor the reference."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _DRYRUN_PROBE,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["ok"] and res["cells"] == 35
    assert res["flops"] > 0 and res["records"] > 0
