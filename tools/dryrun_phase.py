"""``chip_smoke.py``'s phase 4f, the many-device tooling on the card, and
the phase alone:

    python3 tools/dryrun_phase.py [--cells N]

a. In this process, over an NCCL process group of world size 1
   (``chip_smoke.init_group``): ``parallel.compress.compressed_psum``
   and ``compressed_tree_psum`` against ``quantize``/``dequantize``
   (bitwise: with one rank the mean is the dequantized payload), and the
   four sharded GNN ops (``models/gnn/sharded_ops.py``) with a one-rank
   ``shard_ctx`` on a ``cuda`` device mesh against their ``ctx=None``
   forms, forward and gradient: gather, max and min bitwise, sums within
   1e-6 relative (the card's ``index_add`` adds in no fixed order), as
   ``tests/test_torch_gnn_sharded.py`` holds them on the CPU.
b. Two subprocesses, started together (the dry-run needs a ``"fake"``
   default group, which cannot share this process with the NCCL one):
   ``python -m repro_torch.launch.dryrun --sssp --sssp-version all
   --backend blocked --mesh both`` on the card (rank 0's shard of gr26:
   262,144 vertices and 8,388,608 edges at 256 ranks, 131,072 and
   4,194,304 at 512; one warm-up and one timed iteration, a round and a
   transition, of v1, v2 and v3, the round through
   ``edge_relax_partials``, then held bitwise against the plain
   ``segment_min`` round: every exchanged key of all 2^26 destinations
   and the round's state), and ``--mesh single --cell ...`` tracing
   ``CELLS`` on ``meta``.  Both exit codes must be 0; ``[dryrun]`` lines
   give each artifact's collective bytes by kind, rank 0's round and
   transition in device ms, ``n_relax``, the keys compared and the
   trace seconds.

The phase returns its numbers (the last line alone, as JSON), with
``edge_relax_partials``' launches in the subprocess, which join that
row's in the ``kernels`` line.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("qwen3-0.6b/train_4k", "gin-tu/full_graph_sm", "mind/train_batch")
# inside the smoke, one cell: the phase took 67.8 s with all three
# (qwen3 9.6 s and MIND 2.9 s of tracing; NVIDIA H100 80GB HBM3, 700.00
# W), past its budget of about 45 s
SMOKE_CELLS = ("gin-tu/full_graph_sm",)
SUBPROCESS_TIMEOUT_S = 300
SUM_RTOL = 1e-6


def _log(*a):
    print(*a, flush=True)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                    b.view(torch.int32) if b.dtype == torch.float32 else b))


def compress_check(device) -> dict:
    """``compressed_psum`` over the one-rank group against the payload
    dequantized, bitwise, with and without an error term; the tree form
    leaf by leaf."""
    from repro_torch.parallel.compress import (compressed_psum,
                                               compressed_tree_psum,
                                               dequantize, quantize)
    gen = torch.Generator(device=device).manual_seed(0)
    g = torch.randn(1 << 20, generator=gen, device=device) * 0.1
    e = torch.randn(1 << 20, generator=gen, device=device) * 1e-3
    out = {}
    for name, err in (("no error", None), ("error feedback", e)):
        mean, new_err = compressed_psum(g, None, err)
        x = g if err is None else g + err
        q, s = quantize(x)
        deq = dequantize(q, s)
        ok = _same(mean, deq) and _same(new_err, x - deq)
        if not ok:
            raise AssertionError(f"compressed_psum ({name}) differs from "
                                 "its one-rank value")
        out[name] = {"elements": g.numel(), "bitwise": ok}
    tree = {"w": g[:4096].reshape(64, 64), "b": [g[:100], e[:7]]}
    mean, errs = compressed_tree_psum(tree)
    for (key, leaf), got in ((("w", tree["w"]), mean["w"]),
                             (("b0", tree["b"][0]), mean["b"][0]),
                             (("b1", tree["b"][1]), mean["b"][1])):
        q, s = quantize(leaf)
        if not _same(got, dequantize(q, s)):
            raise AssertionError(f"compressed_tree_psum leaf {key} differs")
    out["tree"] = {"leaves": 3, "bitwise": True}
    return out


def gnn_ops_check(device) -> dict:
    """The four sharded GNN ops on a one-rank ``cuda`` mesh against
    ``ctx=None``, forward and the gradient of ``sum(out * W)``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models.gnn import sharded_ops as so

    mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("data",))
    ctx = (mesh, ("data",))
    gen = torch.Generator(device=device).manual_seed(1)
    n, m, f = 2708, 21112, 64                    # full_graph_sm's sizes
    table = torch.randn(n, f, generator=gen, device=device)
    vals = torch.randn(m, f, generator=gen, device=device)
    idx = torch.randint(0, n - 8, (m,), generator=gen, device=device)
    w_m = torch.randn(m, f, generator=gen, device=device)
    w_n = torch.randn(n, f, generator=gen, device=device)
    dt = lambda t: DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
    fns = {"gather0": so.gather0, "scatter_sum0": so.scatter_sum0,
           "scatter_max0": so.scatter_max0, "scatter_min0": so.scatter_min0}
    out = {}
    for name, fn in fns.items():
        src = table if name == "gather0" else vals
        w = w_m if name == "gather0" else w_n
        extra = () if name == "gather0" else (n,)
        a = src.clone().requires_grad_()
        got = fn(ctx, dt(a), dt(idx), *extra)
        (got.to_local() * w).sum().backward()
        b = src.clone().requires_grad_()
        want = fn(None, b, idx, *extra)
        (want * w).sum().backward()
        got = got.to_local().detach()
        exact = name != "scatter_sum0"
        exact_grad = name in ("scatter_max0", "scatter_min0")
        err = float((got - want.detach()).abs().nan_to_num().max())
        g_err = float((a.grad - b.grad).abs().max())
        scale = float(want.detach()[torch.isfinite(want)].abs().max())
        ok = _same(got, want.detach()) if exact else \
            err <= SUM_RTOL * scale
        # a gather's gradient, and a segment sum's, add rows
        ok_g = _same(a.grad, b.grad) if exact_grad else \
            g_err <= SUM_RTOL * float(b.grad.abs().max())
        if not (ok and ok_g):
            raise AssertionError(f"{name}: forward err {err!r}, gradient "
                                 f"err {g_err!r}")
        out[name] = {"max_abs_err": err, "grad_max_abs_err": g_err,
                     "bitwise": exact, "grad_bitwise": exact_grad}
    return out


def in_process(device) -> dict:
    import torch.distributed as tdist
    import chip_smoke as cs
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store_dir:
        cs.init_group(store_dir)
        try:
            t1 = time.perf_counter()
            comp = compress_check(device)
            t2 = time.perf_counter()
            gnn = gnn_ops_check(device)
            t3 = time.perf_counter()
        finally:
            tdist.destroy_process_group()
    secs = time.perf_counter() - t0
    _log(f"[dryrun] in process: group {t1 - t0:.2f} s, compression "
         f"{t2 - t1:.2f} s, sharded GNN ops {t3 - t2:.2f} s")
    _log(f"[dryrun] compressed_psum over NCCL (world 1): {comp}")
    _log(f"[dryrun] sharded GNN ops over NCCL (world 1): {gnn}")
    return {"compress": comp, "gnn_ops": gnn, "in_process_s": secs}


def dryrun_subprocess(cells=CELLS) -> dict:
    """The dry-run's two subprocesses, started together: the SSSP
    iteration on the card on both meshes, and ``cells`` traced on
    ``meta`` on the single-pod mesh; their artifacts, summed launches
    and seconds."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force"]
    with tempfile.TemporaryDirectory() as out_dir:
        cmds = {"sssp": ["--sssp", "--sssp-version", "all", "--backend",
                         "blocked", "--mesh", "both"],
                "cells": ["--mesh", "single"] + [
                    a for c in cells for a in ("--cell", c)]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            base + ["--out", str(Path(out_dir) / k)] + v, env=env,
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for k, v in cmds.items() if k != "cells" or cells}
        outs = {}
        try:
            for k, proc in procs.items():
                outs[k] = proc.communicate(timeout=max(
                    SUBPROCESS_TIMEOUT_S - (time.perf_counter() - t0), 1))
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs = time.perf_counter() - t0
        for k, (stdout, stderr) in outs.items():
            for line in stdout.splitlines():
                if line.startswith(("[ok]", "[FAIL]", "===")):
                    _log(f"[dryrun] {line}")
            if procs[k].returncode != 0:
                raise RuntimeError(f"the dry-run ({k}) exited "
                                   f"{procs[k].returncode}: {stdout[-2000:]}"
                                   f"{stderr[-3000:]}")
        arts = {}
        for mesh_dir in sorted(Path(out_dir).glob("*/*")):
            for f in sorted(mesh_dir.glob("*.json")):
                arts[f"{mesh_dir.name}/{f.stem}"] = json.loads(f.read_text())
    sssp, traced, launches = {}, {}, 0
    for key, art in arts.items():
        if not art.get("ok"):
            raise RuntimeError(f"{key}: {art.get('error')}")
        c = art["collectives"]
        if "rank0" in art:
            r0 = art["rank0"]
            launches += r0["edge_relax_partials_launches"]
            sssp[key] = {"world": art["world"], "block": r0["block"],
                         "edges": r0["edges"], "n_relax": r0["n_relax"],
                         "launches": r0["edge_relax_partials_launches"],
                         "keys_vs_plain": r0["keys_vs_plain"],
                         "round_ms": art["device_s"]["round"] * 1e3,
                         "transition_ms": art["device_s"]["transition"]
                         * 1e3,
                         "bytes_by_kind": c["per_op"],
                         "round_bytes_by_kind":
                             art["collectives_round"]["per_op"],
                         "counts": c["counts"], "ring_bytes":
                             c["ring_bytes"]}
            _log(f"[dryrun] {key}: rank 0 block {r0['block']} edges "
                 f"{r0['edges']} n_relax {r0['n_relax']} round "
                 f"{sssp[key]['round_ms']:.3f} ms transition "
                 f"{sssp[key]['transition_ms']:.3f} ms (device) bytes/iter "
                 f"{c['per_op']} launches "
                 f"{r0['edge_relax_partials_launches']}, "
                 f"{r0['keys_vs_plain']} exchanged keys bitwise the plain "
                 "round's")
        else:
            traced[key] = {"flops_per_device": art["cost"]["flops"],
                           "arg_bytes_per_device":
                               art["arg_bytes_per_device"],
                           "bytes_by_kind": c["per_op"],
                           "counts": c["counts"],
                           "trace_s": art["timing"]["trace_s"]}
            _log(f"[dryrun] {key}: traced in {art['timing']['trace_s']} s, "
                 f"flops/device {art['cost']['flops']:.4e}, bytes by kind "
                 f"{c['per_op']}")
    if not sssp or any(s["n_relax"] <= 0 for s in sssp.values()):
        raise RuntimeError("the SSSP dry-run relaxed no edge on rank 0")
    if any(s["keys_vs_plain"] <= 0 for s in sssp.values()):
        raise RuntimeError("a blocked round was not held against the "
                           "plain round")
    return {"sssp": sssp, "cells": traced, "launches": launches,
            "subprocess_s": secs}


def dryrun_phase(device, cells=CELLS) -> dict:
    t0 = time.perf_counter()
    out = in_process(device)
    out.update(dryrun_subprocess(cells))
    out["phase_seconds"] = time.perf_counter() - t0
    _log(f"[dryrun] phase 4f: {out['phase_seconds']:.1f} s (in process "
         f"{out['in_process_s']:.1f} s, subprocess "
         f"{out['subprocess_s']:.1f} s), edge_relax_partials launches "
         f"{out['launches']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=len(CELLS),
                    help="how many of CELLS to trace (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.build_all()
    out = dryrun_phase(device, CELLS[:args.cells])
    print(json.dumps({"dryrun": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
