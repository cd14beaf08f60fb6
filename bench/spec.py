"""Find what a cell of ``BENCHMARK.json`` names, by name.

A cell names a configuration (``configs[].file``, a JSON file under
``bench/configs/``) and a traffic mix (``bench/traffic/<mix>.json``); the
configuration names its graph generator (``bench/graphs/<generator>.py``);
every per-layer metric has its reader (``bench/metrics/<metric>.py``).
Nothing here lists them: a new configuration, mix or metric is a new
file and a new entry.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""
    name: str
    chips: int
    config: dict             # the configuration's file, parsed
    traffic: dict            # the traffic mix's file, parsed
    end_to_end: tuple        # the end-to-end metric entries this cell reports
    per_layer: tuple         # the per-layer metric entries this cell reports
    root: Path


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module of its own (not imported by
    package name, so that a file name may hold ``.`` or ``-``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (a metric without a
    ``workloads`` list is reported by every cell)."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``KeyError`` if the
    file has none of that name."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if reports(m, name)),
                root=root)


def generator(cell: Cell):
    """The ``generate(cfg, gen, device)`` of the configuration's graph
    family."""
    name = cell.config["generator"]
    return load_module(cell.root / "bench" / "graphs" / f"{name}.py",
                       f"bench_graph_{name}").generate


def reader(cell: Cell, metric: str):
    """The ``read(trace)`` function of a per-layer metric."""
    return load_module(cell.root / "bench" / "metrics" / f"{metric}.py",
                       f"bench_metric_{metric}").read
