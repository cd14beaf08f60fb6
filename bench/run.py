"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (counted in ``setup_s``, from the
start of this process to the first timed spec): the graph drawn on the
card from ``--seed`` (``bench/graphs``), the harness's own CSR on the card
(``bench/graphs/csr.py``) handed to the port as its ``DeviceGraph``,
``Solver.open`` (the port's layout build), and one warm-up spec of the
cell's own shape.  The window then runs the mix's specs in a closed loop,
each ending in a synchronize, until ``--seconds`` have passed; it ends at
the end of the last spec that started within them.  After it: the peak
memory is read, the port's state freed, and the reference
(``bench/reference``) judges a sample of the window's trees drawn from the
seed.  With ``--trace 1`` the window's first ``TRACED_SECONDS`` run under
``torch.profiler`` with the wrappers of ``bench/trace.py``, and the line
holds the per-layer metrics (each read by ``bench/metrics/<metric>.py``)
and ``breakdown``.

The last lines of standard error give each compared number beside its
limit; the last line of standard output is the JSON result.  No card, too
few cards or no port: exit 1 and no result.  ``jax``, ``jaxlib``,
``flax`` or ``repro`` loaded once the window has closed: exit 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def _number(x: float) -> float:
    """A JSON number: an infinite or undefined gap prints as 1e308."""
    return x if math.isfinite(x) else 1e308


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """One run of ``cell`` (a :class:`bench.spec.Cell`) on ``device``;
    returns the result object.  ``t0`` is the process's start on the
    host clock."""
    import torch
    from repro_torch import DeviceGraph, EngineConfig, Solver

    from bench import peaks, spec, traffic
    from bench import trace as tr
    from bench.graphs import csr
    from bench.metrics import _work
    from bench.reference import judge, sssp

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = [("imports", time.perf_counter())]

    def mark(part):
        sync()
        marks.append((part, time.perf_counter()))

    tracer = tr.Tracer(device) if trace else None
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    el = spec.generator(cell)(cell.config, gen, device)
    mark("generate")
    arrays = csr.build(el.n, el.eu, el.ev, el.ew)
    mark("csr")
    # the raw edge list stays on the host for the reference
    raw = (el.eu.to(torch.int32).cpu(), el.ev.to(torch.int32).cpu(),
           el.ew.cpu())
    del el
    deg = arrays.deg.to(torch.int64)      # the harness's own degrees
    warm, timed = traffic.plan(cell.traffic, arrays.deg, gen)
    graph = DeviceGraph(*arrays)
    del arrays
    mark("raw_copy_and_plan")
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    solver = Solver.open(graph, EngineConfig(**cell.config["engine"]),
                         device=device)
    mark("open")
    for sources in warm:
        solver.solve(traffic.solve_spec(sources))
    mark("warm_up")

    sample = traffic.Sample(int(cell.traffic["check_specs"]), seed)
    reached = torch.zeros((), dtype=torch.int64, device=device)
    n_specs = n_trees = 0
    spec_ends = []
    start = tracer.open_window() if tracer else time.perf_counter()
    while True:
        if n_specs == len(timed):
            raise RuntimeError("the window used up its sources")
        sources = timed[n_specs]
        with tracer.spec() if tracer else contextlib.nullcontext():
            res = solver.solve(traffic.solve_spec(sources))
            dist = res.dist.reshape(len(sources), -1)
            for row in dist:
                reached += _work.reached_degree(row, deg)
            if tracer:
                tracer.count(res.metrics, len(sources))
            sync()
        sample.offer((sources, dist, res.parent.reshape(dist.shape)))
        n_specs += 1
        n_trees += len(sources)
        end = time.perf_counter()
        spec_ends.append(end)
        last = end - start >= seconds
        if tracer:
            tracer.after_spec(end, last)
        if last:
            break
    window_s = end - start
    setup_s = start - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    edges = int(reached) // 2

    # the port's state goes before the reference runs
    kept = [(s, d.cpu(), p.cpu()) for s, d, p in sample.kept]
    del solver, graph, res, dist, sample, deg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": n_trees, "failed": 0}
    log = {}
    if tracer:
        table = peaks.peaks(torch.cuda.get_device_name(device)) \
            if cuda else None
        t, found, log = tracer.data(table or {})
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a metric split by kind of cell (``sssp_gteps.batch``) is the
        # quantity its name has before the dot
        e2e = {"sssp_gteps": edges / window_s / 1e9,
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}

    # the reference judges the sample, on the device, one tree at a time
    ref_start = time.perf_counter()
    eu, ev = (x.to(device, torch.int64) for x in raw[:2])
    ew = raw[2].to(device)
    worst = {k: 0.0 for k in judge.LIMITS}
    for sources, dists, parents in kept:
        for s, d, p in zip(sources, dists, parents):
            ref = sssp.distances(d.shape[0], eu, ev, ew, s)
            got = judge.judge(d, p, ref, s, eu, ev, ew)
            result["failed"] += not judge.passes(got)
            worst = {k: max(worst[k], v) for k, v in got.items()}
    due = min(int(cell.traffic["check_specs"]) * int(
        cell.traffic["sources_per_spec"]), n_trees)
    judged = sum(len(s) for s, _, _ in kept)
    result["correct"] = judged == due and result["failed"] == 0 \
        and judge.passes(worst)
    result["metrics"] = metrics
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": 1, "memory_peak_bytes": max(setup_peak, peak),
                   "power_limit_w": peaks.power_limit_w() if cuda else None}
    if tracer:
        device_info.update(busy_s=found.get("busy_s", 0.0),
                           window_s=t.window_s)
        result["breakdown"] = {k: found[k] for k in ("device_ops",
                                                      "idle_gaps")
                               if k in found}
    result["device"] = device_info
    steps = sorted(b - a for a, b in zip([start] + spec_ends, spec_ends))
    result["log"] = dict(
        setup_parts_s={p: b - a for (_, a), (p, b) in
                       zip([("start", t0)] + marks[:-1], marks)},
        spec_s={"n": len(steps), "min": steps[0],
                "median": steps[len(steps) // 2], "max": steps[-1]},
        reference_s=time.perf_counter() - ref_start, **log)
    result["checks"] = dict(
        {k: {"value": _number(v), "limit": judge.LIMITS[k]}
         for k, v in worst.items()},
        trees_judged={"value": judged, "limit": due})
    return result


def loaded_forbidden(modules=None) -> list:
    """The names of ``FORBIDDEN`` among ``modules`` (default: the modules
    this process has loaded), by whole top-level name: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and the
    port's sources on the import path."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(root / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import spec
    try:
        cell = spec.load_cell(args.workload, ROOT)
    except (KeyError, OSError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    _environment(ROOT)
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"bench: the port is missing: {exc}", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    print(f"bench: {json.dumps(result.pop('log'))}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
