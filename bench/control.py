"""The control of the comparison that decides ``correct``.

    python3 -m bench.control --workload <cell> --seeds 11 12 13 [--program]

For each seed: the cell's graph and sources as a run with that seed draws
them (``bench/run.py``), then, for as many trees as a run judges, the
reference's float64 distances and the bfloat16 control
(``bench/reference/sssp.py::control_tree``) put in the program's place
and judged by ``bench/reference/judge.py``.  The control has to fail.
``--program`` also solves the same trees with the port and judges them
(its readings set the lower end of each limit).  One JSON line a seed.
Runs on the card; a run's own windows never run the control.
"""
import argparse
import json
import sys

from bench.run import ROOT, _environment


def readings(cell, seed: int, device, program: bool = False) -> dict:
    """The worst ``judge`` numbers over the trees a run with ``seed``
    would judge first: the control's, and the program's with
    ``program``."""
    import torch

    from bench import spec, traffic
    from bench.graphs import csr
    from bench.reference import judge, sssp

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    el = spec.generator(cell)(cell.config, gen, device)
    arrays = csr.build(el.n, el.eu, el.ev, el.ew)
    _, timed = traffic.plan(cell.traffic, arrays.deg, gen)
    specs = timed[:int(cell.traffic["check_specs"])]
    got = {}
    if program:
        from repro_torch import DeviceGraph, EngineConfig, Solver
        solver = Solver.open(DeviceGraph(*arrays),
                             EngineConfig(**cell.config["engine"]),
                             device=device)
        outs = []
        for sources in specs:
            res = solver.solve(traffic.solve_spec(sources))
            outs.append((res.dist.reshape(len(sources), -1).cpu(),
                         res.parent.reshape(len(sources), -1).cpu()))
        del solver, res
    del arrays
    worst = {"control": {k: 0.0 for k in judge.LIMITS},
             "program": {k: 0.0 for k in judge.LIMITS}}
    for i, sources in enumerate(specs):
        for j, s in enumerate(sources):
            ref = sssp.distances(el.n, el.eu, el.ev, el.ew, s)
            sides = {"control": sssp.control_tree(el.n, el.eu, el.ev,
                                                  el.ew, s)}
            if program:
                sides["program"] = (outs[i][0][j], outs[i][1][j])
            for side, (d, p) in sides.items():
                nums = judge.judge(d, p, ref, s, el.eu, el.ev, el.ew)
                worst[side] = {k: max(worst[side][k], v)
                               for k, v in nums.items()}
    got["control"] = worst["control"]
    if program:
        got["program"] = worst["program"]
    got["trees"] = sum(len(s) for s in specs)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    from bench import spec
    cell = spec.load_cell(args.workload, ROOT)
    _environment(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        out = readings(cell, seed, torch.device("cuda", 0), args.program)
        print(json.dumps(dict(workload=cell.name, seed=seed, **out)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
