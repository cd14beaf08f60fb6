"""The harness on the CPU at a small scale: lookup by name, a throwaway
configuration, mix and metric added as files alone, the exits of the
command, the faults that must make ``correct`` false, and the counts of
work worked out by hand."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench import run, spec
from bench.metrics import _work
from bench.trace import TraceData
from conftest import ROOT, small_root

CELLS = ("kron22-tree", "urand22-tree", "kron22-batch8")
CPU = torch.device("cpu")


def _run(root, cell, trace=False, seconds=0.3, seed=2 ** 31 + 3):
    return run.run_cell(spec.load_cell(cell, root), seed, seconds, trace,
                        CPU, t0=time.perf_counter())


def test_cells_find_their_files_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert callable(spec.generator(cell))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert {m["moves"] for m in cell.per_layer} <= names
        for m in cell.per_layer:
            assert callable(spec.reader(cell, m["name"]))
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tmp_path, cell, trace):
    out = _run(small_root(tmp_path), cell, trace)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in (spec.load_cell(cell).per_layer if trace
                                 else spec.load_cell(cell).end_to_end)}
    # the CPU has no device trace: those readers find nothing
    missing = {m for m in names if m.startswith(
        ("relax_roofline_pct", "device_idle_pct"))} if trace else set()
    assert set(out["metrics"]) == names - missing


def test_new_files_alone_add_a_cell(tmp_path):
    """A configuration, a mix and a per-layer metric added as new files
    and entries run with no change to the harness."""
    root = small_root(tmp_path)
    cfg = json.loads((root / "bench/configs/gap-urand-s22.json").read_text())
    cfg.update(name="tiny-urand", scale=8, degree=8)
    (root / "bench/configs/tiny-urand.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "bench/traffic/tree-batch8.json").read_text())
    mix.update(sources_per_spec=2)
    (root / "bench/traffic/tree-batch2.json").write_text(json.dumps(mix))
    (root / "bench/metrics/trees_per_s.py").write_text(
        "def read(t):\n    return t.trees / t.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="tiny-urand",
                                 file="bench/configs/tiny-urand.json"))
    bench["workloads"].append({"name": "tiny-batch2", "config": "tiny-urand",
                               "traffic": "tree-batch2", "chips": 1,
                               "why": "a throwaway cell"})
    gteps = next(m for m in bench["end_to_end"]
                 if m["name"] == "sssp_gteps.batch")
    gteps["workloads"].append("tiny-batch2")
    bench["per_layer"].append({"name": "trees_per_s", "unit": "trees/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "solve loop",
                               "moves": "sssp_gteps.batch",
                               "workloads": ["tiny-batch2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = _run(root, "tiny-batch2", trace=True)
    assert traced["correct"] and traced["metrics"]["trees_per_s"]["value"] > 0
    assert traced["checks"]["trees_judged"]["value"] == 2
    plain = _run(root, "tiny-batch2")
    assert plain["correct"]
    assert plain["metrics"]["sssp_gteps.batch"]["value"] > 0
    # the throwaway metric is this cell's alone
    assert "trees_per_s" not in _run(root, "urand22-tree", trace=True)[
        "metrics"]


def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "kron22-tree",
         "--seed", "1", "--seconds", "1", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_command_without_a_card_prints_no_result(card_absent):
    done = _command(ROOT)
    assert done.returncode != 0 and not done.stdout.strip()
    assert "CUDA device" in done.stderr


def test_command_without_the_port_prints_no_result(tmp_path):
    (tmp_path / "bench").mkdir()
    for p in (ROOT / "bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dest = tmp_path / p.relative_to(ROOT)
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes(
        (ROOT / "BENCHMARK.json").read_bytes())
    done = _command(tmp_path)
    assert done.returncode != 0 and not done.stdout.strip()
    assert "port is missing" in done.stderr


def test_command_refuses_an_unknown_cell():
    done = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 2 and not done.stdout.strip()


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["repro_torch", "repro_torch.api", "jaxtyping", "torch"]
    assert run.loaded_forbidden(mods) == []
    assert run.loaded_forbidden(mods + ["repro.core", "jax.numpy"]) == \
        ["jax", "repro"]


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


# -- faults that the comparison must catch (one chip: no exchange) --------

def _initial(dist, parent, sources):
    """The state a solve starts from: the sources at 0, all else unreached."""
    dist, parent = dist.clone(), parent.clone()
    rows = dist.reshape(len(sources), -1), parent.reshape(len(sources), -1)
    for i, s in enumerate(sources):
        rows[0][i].fill_(float("inf"))
        rows[0][i][s] = 0.0
        rows[1][i].fill_(-1)
        rows[1][i][s] = s
    return dist, parent


def _fault(name, fn, batched):
    def unchanged(g, src, **kw):
        d, p, m = fn(g, src, **kw)
        return (*_initial(d, p, list(src) if batched else [src]), m)

    def half_batch(g, src, **kw):
        d, p, m = fn(g, src, **kw)
        keep = len(src) // 2
        d[keep:], p[keep:] = _initial(d[keep:], p[keep:], list(src)[keep:])
        return d, p, m

    def altered(g, src, **kw):
        d, p, m = fn(g, src, **kw)
        for row in d.reshape(-1, d.shape[-1]):
            v = int(torch.where(torch.isfinite(row), row, 0).argmax())
            row[v] = row[v] * 1.001
        return d, p, m
    return {"unchanged": unchanged, "half_batch": half_batch,
            "altered": altered}[name]


FAULTS = [("kron22-tree", "unchanged"), ("urand22-tree", "unchanged"),
          ("kron22-batch8", "unchanged"), ("kron22-batch8", "half_batch"),
          ("kron22-tree", "altered"), ("urand22-tree", "altered"),
          ("kron22-batch8", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    """The timed path broken underneath the facade: the solve's state left
    as it started, half of a batch left out, an answer altered where it
    is produced.  Each run must come out not correct."""
    import repro_torch.api as api
    monkeypatch.setattr(api, "sssp", _fault(fault, api.sssp, False))
    monkeypatch.setattr(api, "sssp_batch",
                        _fault(fault, api.sssp_batch, True))
    out = _run(small_root(tmp_path), cell)
    assert not out["correct"] and out["failed"] > 0


# -- the counts of work, by hand ------------------------------------------

def test_relax_bytes_by_hand():
    # 10 attempts read dst and w (8 B), 3 extended paths read a source
    # distance (4 B), 4 improvements write dist and parent (8 B)
    assert _work.relax_bytes(10, 3, 4) == 10 * 8 + 3 * 4 + 4 * 8 == 124


def test_tree_edges_by_hand():
    """Vertices 0-1-2 form a triangle with the edge 0-1 twice; 3-4 is a
    component of its own.  A tree from 0 reaches 0, 1, 2: four input
    edges (the duplicate counts, as Graph500 counts input tuples)."""
    from bench.graphs import csr
    from repro_torch import DeviceGraph, EngineConfig, SolveSpec, Solver
    eu = torch.tensor([0, 0, 1, 0, 3])
    ev = torch.tensor([1, 1, 2, 2, 4])
    ew = torch.tensor([0.5, 0.75, 0.25, 1.0, 0.5])
    arrays = csr.build(5, eu, ev, ew)
    assert arrays.deg.tolist() == [3, 3, 2, 1, 1]
    solver = Solver.open(DeviceGraph(*arrays),
                         EngineConfig(backend="blocked", tier="single"),
                         device="cpu")
    dist = solver.solve(SolveSpec.tree(0)).dist
    assert dist.tolist()[:3] == [0.0, 0.5, 0.75]
    assert _work.tree_edges(dist, arrays.deg) == 4
    assert int(_work.reached_degree(dist, arrays.deg)) == 8
    far = solver.solve(SolveSpec.tree(3)).dist
    assert _work.tree_edges(far, arrays.deg) == 1


def _trace(**over):
    base = dict(window_s=2.0, trees=4,
                spans={"transition": 1.5, "relax_call": 0.25},
                counters={"round_n_relax": 1e9, "round_n_extended": 1e8,
                          "round_n_updates": 2e8, "n_relax": 4e9,
                          "n_updates": 1e8, "host_syncs": 200.0,
                          "launches": 180},
                setup={"layout_build_s": 12.5},
                device={"busy_s": 1.5, "relax_kernel_s": 0.1},
                peaks={"hbm_bytes_per_s": 3.35e12})
    base.update(over)
    return TraceData(**base)


def _read(name, t):
    return spec.reader(spec.load_cell("kron22-tree"), name)(t)


def test_readers_by_hand():
    t = _trace()
    # (8e9 + 0.4e9 + 1.6e9) B at 3.35e12 B/s over 0.1 s of kernels
    assert _read("relax_roofline_pct", t) == pytest.approx(
        100 * 1.0e10 / 3.35e12 / 0.1)
    assert _read("transition_pct", t) == 75.0
    assert _read("relax_call_pct", t) == 12.5
    assert _read("useful_relax_pct", t) == 2.5
    assert _read("host_syncs_per_tree", t) == 50.0
    assert _read("launches_per_tree", t) == 45.0
    assert _read("device_idle_pct", t) == 25.0
    assert _read("layout_build_s", t) == 12.5


def test_readers_that_find_nothing_return_nothing():
    t = _trace(device={}, peaks={}, setup={})
    for name in ("relax_roofline_pct", "device_idle_pct", "layout_build_s"):
        assert _read(name, t) is None


@pytest.mark.cuda
def test_one_run_on_the_card(card):
    """The command at the cell's own size, briefly, on the card."""
    done = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "kron22-tree",
         "--seed", "5", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
