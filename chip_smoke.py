"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (a checkout of another commit, e.g. ``git archive`` of
the parent unpacked into an ignored directory) also times that checkout's
``edge_relax``, ``edge_relax_partials``, ``edge_relax_fused`` and
``embedding_bag`` kernels, and its embedding layer, on the same inputs as
this tree's, in turns (parent, this, this, parent).  Run with no argument, the script needs one card and nothing
else.

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit; build every CUDA kernel from
   the sources in this checkout (one ``nvcc`` per source, in parallel).
   Then phase 5's profiled passes (:func:`recsys_profiled`): run late,
   after the other phases, the embedding layer's pass came back with an
   empty trace.
2. Kernels vs plain versions on seeded random slabs: ``edge_relax``
   (empty buckets, an all-padding slab, ``lb <= 0``, forced ties; each
   call made twice; ``vals``, ``wins`` and the four counters bitwise
   equal, the scheduled-tile count also equal to ``schedule_tiles``') and
   ``edge_relax_fused`` (ties, ``lb <= 0``, ``fused_rounds`` 1, 4 and 8,
   a call that stops after its first round, then 40 seeded cases over
   geometries and round caps; each kernel call made twice, scheduled
   from the layout's vertex->tile index; ``dist``, ``parent``,
   ``frontier`` and the eight counters bitwise equal), and
   ``flash_attention`` on seeded cases in float32 (at 2e-5) and bfloat16
   (at 2e-2), each call launching once, of the design ``ops.variant``
   names ("tc" bf16 tensor cores, "split" split-KV decode, "simt" CUDA
   cores): S not a multiple of a tile, GQA groups 1, 2, 8 and 16, D 64
   and 128, causal, non-causal and windowed masks; prefill calls at S = T
   of 64, 200, 2048 and 3072 with qwen3-0.6b's 8 KV heads of 2 and D =
   128, and S = 130 with groups of 8 at D = 64; a chunk of queries at
   positions 300..369 over keys at 0..T-1 and -1 padded; decode calls
   over a cache slice with keys at 0..T-1, -1 padded or at ring-buffer
   positions, slots past the cache and below T - 1, with and without a
   window.  Then the ALT branches of
   ``edge_relax`` and ``edge_relax_fused`` (``alt_lb`` with +inf entries;
   prune bounds of +inf, below every candidate, at a tie and in between;
   fused targets reached before and within the call, so that the bound
   tightens between rounds; then 20 seeded cases of each; each call made
   twice; ``vals``, ``wins``, ``dist``, ``parent``, ``frontier`` and the
   counters bitwise equal).
3. Main path, under an NCCL process group of world size 1 (a FileStore
   in a temporary directory, destroyed at the end): a full
   shortest-path-tree solve from the max-degree source of
   ``kronecker(20, 16, seed=1)`` and of ``road_grid(1024, seed=5)``, on
   the blocked backend (the ``edge_relax`` kernel), on the blocked
   backend with ``fused_rounds=4`` (the ``edge_relax_fused`` kernel) and
   on ``segment_min`` (plain torch).  ``dist``/``parent`` must be bitwise
   equal and the logical counters equal across the three, each kernel
   must have launched in its own solve, the fused solve must not launch
   ``edge_relax`` and, on the road graph, must make at most half the
   unfused solve's invocations, and ``dist`` must match scipy's float64
   Dijkstra at ``rtol=1e-4, atol=1e-5``.
   Then point-to-point queries with ALT landmark pruning:
   ``"farthest"`` landmarks (8 on kronecker, 4 on road_grid: a cut of
   depth, the road build being one 23 s tree solve a landmark on an
   H100) are
   built on the card with the fused blocked path (the build time is
   printed), and 2 seeded
   (source, target) pairs, the target reachable from the source, are
   each solved five ways: p2p without landmarks on ``blocked``; with
   landmarks on ``blocked`` (``edge_relax``'s ALT branch), on ``blocked``
   with ``fused_rounds=4`` (``edge_relax_fused``'s ALT branch),
   bidirectionally on ``blocked``, and on ``segment_min`` (plain).
   ``dist[t]`` and the reconstructed path must be bitwise equal across
   the five, ``dist[t]`` must equal the tree solve's (same source) or
   scipy Dijkstra's at ``rtol=1e-4``, the three unidirectional ALT solves
   must have equal logical counters, some candidate must be pruned on
   each graph, each ALT solve must launch its ALT kernel and the unpruned
   one none.  Then a ``bounded`` and a ``knear`` solve on kronecker,
   whose settled entries must equal the tree solve's.  Then
   ``edge_relax_partials`` against its plain version on every shard of a
   P = 4 shard layout of the kronecker graph at a mid-solve window of
   that solve, and on 30 seeded random layouts (P from 1 to 4,
   geometries, windows, ties; each call twice; ``val``, ``win`` and the
   four counters bitwise equal).  Then the sharded v1 engine on
   kronecker(20,16) and road_grid(1024) (``sssp_distributed``, one rank),
   on ``blocked`` (the ``edge_relax_partials`` kernel, which must
   launch, with no launch of the other two) and on ``segment_min``: both
   bitwise equal to the single-device blocked solve, with equal logical
   counters, and matching Dijkstra.  Then queries on the v1 engine:
   both kronecker pairs of the p2p phase and road_grid's pair 2 with its
   landmark sets, on ``blocked`` (``edge_relax_partials``' ALT branch,
   which must launch, with no other kernel) and on ``segment_min``:
   ``dist[t]`` and the path bitwise the unpruned single-device query's,
   ``n_relax`` and ``n_pruned`` the single-device ALT query's, some
   candidate pruned on each graph; a ``bounded`` and a ``knear`` query
   on kronecker, settled entries equal to the tree solve's.  Then that
   ALT branch against its plain version on every shard of the P = 4
   kronecker layout at the middle kernel call of the first kronecker v1
   ALT query, and on 20 seeded random layouts with prune bounds of +inf,
   below every candidate, at a tie and in between (each call twice;
   ``val``, ``win`` and the four counters bitwise equal).  Cuts: scale
   20, as the paper's
   graphs are scale 26-27 (its road network has 24M vertices), and the
   numpy generator needs about a minute at scale 20 and about four times
   that per step of scale, which the run's time limit does not hold.
3c. The facade (``repro_torch.api``: ``Solver``, ``SolveSpec``,
   ``sssp_batch`` underneath), on the graphs and layouts above.  First
   ``edge_relax`` over slots against its plain version on 20 seeded
   random slabs (1, 3 and 8 slots, with and without ALT, each over every
   slot, every other slot and the last alone; each call twice; every
   active slot's ``vals``, ``wins`` and four counters bitwise).  On
   kronecker(20,16), ``Solver.open(g, EngineConfig(backend="blocked",
   use_alt=True))`` (its landmark distances bitwise the p2p phase's):
   a ``SolveSpec.tree`` of 8 sources (the max-degree one and 7 seeded),
   each slot bitwise the single solve from its source with equal
   logical counters and matching Dijkstra, with exactly one
   ``edge_relax_batch`` launch per iteration and no one-state launch; a
   batched ALT ``p2p`` spec over the p2p phase's 2 pairs and 2 seeded
   ones, ``dist[t]`` and paths bitwise the unpruned queries', some
   candidate pruned, ``edge_relax_batch_alt`` launched; batched
   ``bounded`` and ``knear`` specs with per-slot parameters, settled
   entries equal to the tree slots'; ``solve_many`` over mixed kinds,
   each result its own ``solve``; the tree spec with
   ``fused_rounds=4`` (the fused kernel slot by slot), bitwise the
   unfused batch.  Then an ``EngineConfig(policy="adaptive")`` tree
   solve on kronecker: dist bitwise the static solve's, parents too but
   where both are exact f32 ties, matching Dijkstra; the same for
   a road_grid(1024) ``bounded`` query (the 5th percentile of its tree's
   distances) under the adaptive policy against the static one (the
   adaptive road tree solve took 105 s on an H100, more than this phase
   has), then
   on road_grid(1024) a batched ``knear`` spec (4 seeded sources, k =
   1,000), each slot bitwise its single solve.  The batched kernel is
   then held against its plain version again at the middle call of the
   batched tree and p2p specs.
4. The language-model serving path (qwen3-0.6b at full width, weights
   drawn on the card from a ``torch.Generator`` seeded with 0):
   ``ServeEngine(max_batch=8, s_cache=4096, prompt_pad=256)`` in
   bfloat16 answers 12 requests of 32 new tokens (prompt lengths drawn
   by numpy seed 0 in [256, 3072]; 12 requests for 8 slots, so slots
   are refilled): every request must get 32 tokens, every logit be
   finite, every prefill launch be the "tc" design and every decode
   launch "split" (launches counted by design), and no plain attention
   run (``_sdpa_dense``, ``_sdpa_blockwise``, ``_sdpa_decode`` are
   counted).  Then one 2048-token prefill and one 8-slot decode step
   timed and profiled (device time by kernel; every profiled pass, here
   and in phase 5, fails if its trace holds no CUDA kernel).  Then the
   whole path in
   float32 (TF32 off), a
   2048-token prefill and 16 teacher-forced decode steps, once through
   the kernel and once through the plain attention: the logits must
   agree within 1e-4 of their largest magnitude (two f32 evaluations
   that differ only in the attention's summation order); top-1
   agreement is printed, and the same comparison in bfloat16 is printed
   as a measured gap.
5. The recsys serving path (MIND at its published size: a 10^7 x 64
   float32 item table drawn on the card from a ``torch.Generator`` seeded
   with 0, batches from ``RecsysStream(10^7, 50, seed=0)`` at step 0 for
   the ``serve_p99`` (512 users) and ``serve_bulk`` (262,144) shapes).
   First both entries of ``embedding_bag`` against their plain
   versions, bitwise, each case through the wrapper twice: the weighted
   entry on the reference
   kernel test's 12 shapes x modes x weights, L = 1, a bag of zero
   weights under mean, ids -1, -V, V and 2V (wrapped or clamped), a
   bfloat16 table and both serve batches (``bag_inputs``' ids and
   weights) over the full table; the masked entry on Zipf ids under
   random masks (L from 0 to 200, D from 16 to 512, f32 and bf16; a
   masked-in id outside ``[-V, V)``, wrapping ids, masked-out ids outside
   it, an all-masked bag; B up to 6,000, which takes the direct path),
   a table whose rows 0 and 7 hold inf and NaN,
   no mask, and both serve batches' raw ids and mask.  Then the embedding
   layer: ``embedding_bag_batched`` over the full table at both shapes,
   sum and mean, a serve_p99 batch with ids injected outside ``[-V, V)``,
   and the serve_p99 batch with inf and NaN written into row 0 (restored
   after); each call must launch the masked entry once, the weighted
   entry never and never a plain version (counted), equal the masked
   entry's plain version on the card bit for bit (on the finite table
   also the weighted entry over ``bag_inputs``, the parent's layer), give
   NaN bags exactly where the reference's ``jnp.take`` would, and with
   the non-finite row 0 inf and NaN only in the two columns of the bags
   that look row 0 up masked in.  Then MIND: ``serve_interests`` at
   both shapes and ``retrieval_scores`` of user 0 over 10^6 candidate
   ids (numpy seed 1); every output finite, every interest's norm below
   1, and the first 64 users' interests and first 65,536 scores within
   1e-5 (relative, and of the largest magnitude) of the same functions
   on the CPU, in float32 with TF32 off.  The profiled pass of the layer
   at serve_bulk fails if it launches more than one kernel.
6. Numbers: one JSON ``kernels`` line (kernel, plain-version and
   library-call times from CUDA events, the bound, launches on the main
   path; ``edge_relax`` and ``edge_relax_partials``, with and without
   ALT, per graph by :func:`graph_ms` (device time, the row's ``ms``) and
   eager (the host's launch cost included), beside the library yardstick
   that computes the whole output (:func:`library_round`) and the parent
   design's scatter-only figure, the bound as the kernel reads (the
   row's ``bound_ms``), the same with 12 B per scheduled slot and the
   parent design's bound (:func:`bound_bytes`), and with ``--parent``
   the parent design's times on the same inputs; the
   ``[layout]`` lines give the vertex->tile index's build seconds; the
   ALT rows at the middle kernel call of the first p2p pair's
   ALT query, unfused and fused, captured by solving that query again,
   with their launches over the p2p queries; ``edge_relax_partials``'
   ALT row at the middle call of each graph's first v1 ALT query,
   captured in that query, with its launches over the v1 queries;
   ``edge_relax_batch`` and ``edge_relax_batch[alt]`` at the middle call
   of phase 3c's batched tree and p2p specs (8 and 4 slots): graph
   replay and eager, beside the same slots as one-state calls, the plain
   version, one ``scatter_reduce_`` over all slots' keys and the bound
   (:func:`batch_bound_bytes`: the slab read once for all slots), with
   their launches per batched solve; ``[facade]`` lines with each
   batched spec's seconds beside the single solves' and the adaptive
   solves' steps, rounds and seconds beside the static ones;
   ``edge_relax_fused`` at the tree window and its ALT branch at the
   middle call of the fused ALT query, by :func:`graph_ms` and eager,
   with the parent design's times under ``--parent``, the bound as the
   kernel reads (:func:`fused_bytes`) and the old count), each
   solve's and query's
   seconds, rounds, iterations (one host sync each), kernel invocations,
   and the seconds its step transitions and relaxation calls took (CUDA
   events around each call, :class:`PhaseTimes`), ``[time]`` lines with
   the seconds since the start at the end of each phase, the serving
   path's time to first token per
   request, prefill tokens/s, and decode ms per step and tokens/s, and
   ``flash_attention``'s device times (CUDA-graph replay) at the qwen3
   prefill calls (S = T of 256, 1024, 2048 and 3072) and decode calls (8
   slots at positions 2048 and 4095 of 4096): kernel, plain version,
   ``scaled_dot_product_attention``, the kernel called eagerly, and at S
   = 2048 the CUDA-core design on the same call, beside its bound, with
   TFLOP/s or GB/s, the bound's share and the design; ``embedding_bag``'s
   two entries at both serve shapes in sum and mean (:func:`measure_bag`:
   graph replay and eager, with ``--parent`` the parent's design on the
   same inputs in turns, the plain version,
   ``torch.nn.functional.embedding_bag`` by graph replay) beside the
   byte bound, which charges each distinct row once, the kernel against
   copies with one path at every batch and with bulk staging
   (``[embedding_bag design]`` lines, :func:`bag_designs`), the layer's
   profiled pass again late in the run (a probe: an empty trace is
   printed, not failed), and MIND's
   ``serve_interests`` and ``retrieval_scores`` milliseconds, users/s and
   candidates/s (``[recsys]`` lines).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside the repository, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core rate
KRON = dict(scale=20, edge_factor=16, seed=1)
ROAD = dict(side=1024, seed=5)
FUSED_ROUNDS = 4


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def mark(phase: str):
    """A ``[time]`` line: seconds since the script started, at the end of
    ``phase``."""
    log(f"[time] {phase}: done at {time.perf_counter() - T0:.1f} s")


class HostTimes:
    """Host-clock seconds of the named functions of ``module`` while the
    context is open (the landmark build's selection and symmetry check)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.s = dict.fromkeys(names, 0.0)

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._timed(n, fn))
        return self

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s[name] += time.perf_counter() - t
        return timed

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    return a.view(torch.int32).equal(b.view(torch.int32))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events,
    after two warm-up calls)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version on random slabs
# ---------------------------------------------------------------------------

def _slab_case(rng, n, m, *, block_v, tile_e, ties, lb0, device):
    from repro_torch.core.graph import build_blocked, build_csr
    if m:
        u = rng.integers(0, n // 2 + 1, m)          # upper half: no edges
        v = rng.integers(0, n, m)
        keep = u != v
        w = (rng.integers(1, 4, keep.sum()).astype(np.float64) if ties
             else rng.random(keep.sum()) + 1e-3)
        g = build_csr(n, u[keep], v[keep], w)
    else:
        g = build_csr(n, np.zeros(0), np.zeros(0), np.zeros(0))
    bg = build_blocked(g, block_v=block_v, tile_e=tile_e, device=device)
    dist = (rng.integers(0, 6, bg.n_out) if ties
            else rng.random(bg.n_out) * 3).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.2] = np.inf
    frontier = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, bg.n_out, bg.n_out),
                      -1).astype(np.int32)
    lb, ub = (0.0, np.inf) if lb0 else (1.0, 4.0)
    t = lambda a: torch.from_numpy(a).to(device)
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    return (t(dist), t(frontier), t(parent), bg.src, bg.dst, bg.w,
            bg.tile_first, f32(lb), f32(ub)), dict(
                tile_e=bg.tile_e, n_out=bg.n_out, index=bg.index), bg


def round_pair(args, kw, what, fn="relax_bucket"):
    """A one-round kernel (``ops.relax_bucket`` or ``ops.relax_partials``,
    called twice to catch races) against the plain version on one layout:
    ``vals``, ``wins`` and the four counters (the third the scheduled-tile
    count, held against ``schedule_tiles``) bitwise.  Returns the kernel's
    and the plain version's outputs."""
    from repro_torch.kernels.edge_relax import ops, ref
    plain_kw = {k: v for k, v in kw.items() if k != "index"}
    want = ref.edge_relax_partials_ref(*args, **plain_kw)
    _, pn = ref.schedule_tiles(args[1], args[3], args[5], args[6],
                               kw["tile_e"])
    for _ in range(2):
        out = getattr(ops, fn)(*args, **kw)
        if not (bitwise_equal(out[0], want[0]) and out[1].equal(want[1])
                and out[2].equal(want[2]) and int(out[2][2]) == int(pn)):
            raise AssertionError(
                f"{fn} {what}: kernel {out[2].tolist()} and plain version "
                f"{want[2].tolist()} (schedule_tiles: {int(pn)} tiles) "
                "disagree")
    return out, want


def kernel_vs_plain(device, seed: int = 0) -> int:
    """Random slabs through the kernel and the plain version; returns the
    number of cases, raises on the first disagreement."""
    rng = np.random.default_rng(seed)
    cases = [dict(n=1000, m=6000, block_v=128, tile_e=128, ties=False,
                  lb0=False),
             dict(n=1000, m=6000, block_v=128, tile_e=128, ties=True,
                  lb0=False),
             dict(n=700, m=3000, block_v=256, tile_e=64, ties=True,
                  lb0=True),
             dict(n=300, m=0, block_v=128, tile_e=128, ties=False,
                  lb0=True),
             dict(n=5000, m=40000, block_v=1024, tile_e=256, ties=False,
                  lb0=True)]
    for i, case in enumerate(cases):
        args, kw, _ = _slab_case(rng, device=device, **case)
        round_pair(args, kw, f"case {i} {case}")
    return len(cases)


def fused_vs_plain(device, seed: int = 1, n_random: int = 40) -> int:
    """Slabs through the fused kernel (twice, to catch races) and its
    plain version: the named cases, then ``n_random`` seeded ones over
    geometries, windows and round caps.  Returns the number of cases,
    raises on the first disagreement."""
    from repro_torch.kernels.edge_relax import ops, ref
    rng = np.random.default_rng(seed)
    cases = [dict(n=1000, m=6000, block_v=128, tile_e=128, ties=False,
                  lb0=False, rounds=4),
             dict(n=1000, m=6000, block_v=128, tile_e=128, ties=True,
                  lb0=False, rounds=8),
             dict(n=700, m=3000, block_v=256, tile_e=64, ties=True,
                  lb0=True, rounds=4),
             dict(n=5000, m=40000, block_v=1024, tile_e=256, ties=False,
                  lb0=False, rounds=1),
             dict(n=5000, m=40000, block_v=5120, tile_e=256, ties=True,
                  lb0=False, rounds=8),
             dict(n=300, m=2000, block_v=128, tile_e=128, ties=False,
                  lb0=False, rounds=4, stop=True)]
    for _ in range(n_random):
        n = int(rng.integers(64, 20000))
        cases.append(dict(
            n=n, m=int(rng.integers(0, 8 * n)),
            block_v=int(rng.choice([64, 1024, -(-n // 256) * 256])),
            tile_e=int(rng.choice([32, 64, 256, 512])),
            ties=bool(rng.random() < 0.5), lb0=bool(rng.random() < 0.2),
            rounds=int(rng.choice([1, 2, 4, 8, 16]))))
    names = list(ops.FUSED_COUNTERS)
    for i, case in enumerate(cases):
        rounds, stop = case.pop("rounds"), case.pop("stop", False)
        (dist, front, *_, lb, ub), _, bg = _slab_case(rng, device=device,
                                                       **case)
        if stop:                 # nothing to relax: one round, then exit
            front = torch.zeros_like(front)
        n_out = bg.n_out
        parent = torch.from_numpy(np.where(
            np.isfinite(dist.cpu().numpy()), rng.integers(0, n_out, n_out),
            -1).astype(np.int32)).to(device)
        args = (dist, parent, front, bg.deg, bg.src, bg.dst, bg.w,
                bg.tile_first, lb, ub)
        kw = dict(tile_e=bg.tile_e, fused_rounds=rounds)
        want = ref.edge_relax_fused_ref(*args, **kw)
        for _ in range(2):
            out = ops.relax_fused(*args, **kw, index=bg.index)
            same = bitwise_equal(out[0], want[0]) and all(
                a.equal(b) for a, b in zip(out[1:], want[1:]))
            if not same or (stop and int(out[3][names.index("n_exec")])
                            != 1):
                raise AssertionError(
                    f"edge_relax_fused case {i} {case} rounds={rounds}: "
                    f"kernel {out[3].tolist()} and plain version "
                    f"{want[3].tolist()} disagree")
    return len(cases)


def _alt_lb(rng, n_out, n, device, *, ties):
    """A per-vertex ALT bound over ``n_out`` destinations: quarters (so
    sums of integer weights meet the bound exactly) or uniform values,
    +inf on 15% of the vertices and on the padding."""
    lb = (rng.integers(0, 8, n_out) / 4 if ties
          else rng.random(n_out) * 2).astype(np.float32)
    lb[(rng.random(n_out) < 0.15) | (np.arange(n_out) >= n)] = np.inf
    return torch.from_numpy(lb).to(device)


ALT_BOUNDS = (("mid", 2.0), ("inf", np.inf), ("below-all", 0.0),
              ("ties", 3.0))


def alt_vs_plain(device, seed: int = 4, n_random: int = 20) -> int:
    """The ALT branches of ``edge_relax`` and ``edge_relax_fused`` against
    their plain versions on seeded random slabs, each kernel call made
    twice: ``alt_lb`` with +inf entries, a prune bound of +inf (nothing
    cut), one below every candidate (everything cut), ties at exactly the
    bound (``<=`` keeps them) and, for the fused kernel, a target that is
    reached within the call so that the bound tightens between rounds;
    then ``n_random`` seeded cases of each.  ``vals``, ``wins``, ``dist``,
    ``parent``, ``frontier`` and the counters must be bitwise equal.
    Returns the number of cases, raises on the first disagreement."""
    from repro_torch.kernels.edge_relax import ops, ref
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    cases = [dict(n=1000, m=6000, block_v=128, tile_e=128, ties=True,
                  lb0=False, bound=b) for _, b in ALT_BOUNDS]
    cases += [dict(n=5000, m=40000, block_v=1024, tile_e=256, ties=False,
                   lb0=False, bound=2.5),
              dict(n=700, m=3000, block_v=256, tile_e=64, ties=True,
                   lb0=True, bound=3.0)]
    for _ in range(n_random):
        n = int(rng.integers(64, 20000))
        cases.append(dict(
            n=n, m=int(rng.integers(0, 8 * n)),
            block_v=int(rng.choice([64, 1024, -(-n // 256) * 256])),
            tile_e=int(rng.choice([32, 64, 256, 512])),
            ties=bool(rng.random() < 0.5), lb0=bool(rng.random() < 0.2),
            bound=float(rng.choice([0.0, 1.5, 3.0, 4.5, np.inf]))))
    checked = 0
    for i, case in enumerate(cases):
        bound = case.pop("bound")
        args, kw, bg = _slab_case(rng, device=device, **case)
        alt = (_alt_lb(rng, bg.n_out, case["n"], device, ties=case["ties"]),
               f32(bound))
        round_pair(args + alt, kw, f"[alt] case {i} {case} bound={bound}")
        checked += 1
    names = list(ops.FUSED_COUNTERS)
    cases = [dict(n=1000, m=6000, block_v=128, tile_e=128, ties=True,
                  lb0=False, rounds=4, ub=b, tgt="reached")
             for _, b in ALT_BOUNDS]
    cases += [dict(n=1000, m=6000, block_v=128, tile_e=128, ties=False,
                   lb0=False, rounds=8, ub=np.inf, tgt="unreached"),
              dict(n=5000, m=40000, block_v=5120, tile_e=256, ties=True,
                   lb0=False, rounds=8, ub=np.inf, tgt="unreached")]
    for _ in range(n_random):
        n = int(rng.integers(64, 20000))
        cases.append(dict(
            n=n, m=int(rng.integers(0, 8 * n)),
            block_v=int(rng.choice([64, 1024, -(-n // 256) * 256])),
            tile_e=int(rng.choice([32, 64, 256, 512])),
            ties=bool(rng.random() < 0.5), lb0=bool(rng.random() < 0.2),
            rounds=int(rng.choice([1, 2, 4, 8, 16])),
            ub=float(rng.choice([0.0, 2.0, 4.0, np.inf])),
            tgt=str(rng.choice(["reached", "unreached"]))))
    tightened = 0
    for i, case in enumerate(cases):
        rounds, prune_ub, tgt_kind = (case.pop(k) for k in
                                      ("rounds", "ub", "tgt"))
        (dist, front, *_, lb, ub), _, bg = _slab_case(rng, device=device,
                                                       **case)
        n, n_out = case["n"], bg.n_out
        d_host = dist.cpu().numpy()
        parent = torch.from_numpy(np.where(
            np.isfinite(d_host), rng.integers(0, n_out, n_out),
            -1).astype(np.int32)).to(device)
        pool = np.where(np.isfinite(d_host[:n]) if tgt_kind == "reached"
                        else np.isinf(d_host[:n]))[0]
        tgt = int(rng.choice(pool)) if pool.size else 0
        alt = (_alt_lb(rng, n_out, n, device, ties=case["ties"]),
               f32(prune_ub), f32(1.0 + 4.0 * 2.0 ** -24 * 100),
               torch.tensor(tgt, dtype=torch.int32, device=device))
        args = (dist, parent, front, bg.deg, bg.src, bg.dst, bg.w,
                bg.tile_first, lb, ub, *alt)
        kw = dict(tile_e=bg.tile_e, fused_rounds=rounds)
        want = ref.edge_relax_fused_ref(*args, **kw)
        for _ in range(2):
            out = ops.relax_fused(*args, **kw, index=bg.index)
            if not (bitwise_equal(out[0], want[0])
                    and all(a.equal(b) for a, b in zip(out[1:], want[1:]))):
                raise AssertionError(
                    f"edge_relax_fused[alt] case {i} {case} rounds={rounds} "
                    f"prune_ub={prune_ub} target {tgt_kind}: kernel "
                    f"{out[3].tolist()} and plain version "
                    f"{want[3].tolist()} disagree")
        cnt = dict(zip(names, out[3].tolist()))
        tightened += (tgt_kind == "unreached" and bool(
            torch.isfinite(out[0][tgt])) and cnt["n_exec"] > 1)
        checked += 1
    if not tightened:
        raise AssertionError("no fused ALT case reached its target within "
                             "the call: the bound never tightened")
    return checked


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def scipy_dist(g, source: int) -> np.ndarray:
    """float64 Dijkstra (scipy) over the minimum weight of each arc."""
    return scipy_dists(g, [source])[0]


def scipy_dists(g, sources) -> np.ndarray:
    """:func:`scipy_dist` from each of ``sources``, the matrix built once."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    key = g.src.astype(np.int64) * g.n + g.dst
    order = np.lexsort((g.w, key))
    first = np.ones(order.size, bool)
    first[1:] = key[order][1:] != key[order][:-1]
    sel = order[first]
    a = csr_matrix((g.w[sel].astype(np.float64), (g.src[sel], g.dst[sel])),
                   shape=(g.n, g.n))
    return dijkstra(a, directed=True, indices=list(sources))


class PhaseTimes:
    """CUDA events around the parts of one solve, wrapped while the
    context is open: ``core/sssp.py``'s ``_solve_loop`` (the whole loop,
    so the solve's seconds less it are its set-up), ``_transition``,
    ``_relax_round`` and ``_fused_relax_rounds``, and
    ``core/distributed.py``'s ``_v1_relax_round`` and its two
    collectives, ``_merge_partials`` (the MIN of packed keys) and
    ``_sum`` (the counters), which run inside the relaxation calls and
    transitions.  The events are recorded on the stream with no
    synchronize, so the solve keeps its own host reads; a span runs from
    the call's first launch to its last, the host's launch gaps
    included, since the loop's host read leaves the stream idle when the
    call begins."""
    TARGETS = (("core.sssp", "_solve_loop"),
               ("core.sssp", "_transition"),
               ("core.sssp", "_relax_round"),
               ("core.sssp", "_fused_relax_rounds"),
               ("core.distributed", "_v1_relax_round"),
               ("core.distributed", "_merge_partials"),
               ("core.distributed", "_sum"))

    def __enter__(self):
        self.saved = []
        self.spans = {name: [] for _, name in self.TARGETS}
        for mod_name, name in self.TARGETS:
            mod = importlib.import_module(f"repro_torch.{mod_name}")
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._timed(fn, self.spans[name]))
        return self

    @staticmethod
    def _timed(fn, spans):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def seconds(self) -> dict:
        """Calls and summed seconds per wrapped function (after a
        synchronize)."""
        return {name.strip("_"): dict(
            calls=len(spans),
            s=sum(a.elapsed_time(b) for a, b in spans) / 1e3)
            for name, spans in self.spans.items() if spans}


def solve(g, source, backend, device, *, sharded=False, **opts):
    """One timed solve; returns ``(dist, parent, metrics, seconds,
    phases)`` with ``phases`` from :class:`PhaseTimes`.  ``sharded``
    solves the :class:`ShardedGraph` ``g`` with the v1 engine over the
    world process group."""
    mod = importlib.import_module(
        f"repro_torch.core.{'distributed' if sharded else 'sssp'}")
    entry = mod.sssp_distributed if sharded else mod.sssp
    if sharded:
        opts["version"] = "v1"
    with PhaseTimes() as phases:
        sync(device)
        t0 = time.perf_counter()
        dist, parent, metrics = entry(g, source, backend=backend,
                                      device=device, **opts)
        sync(device)
        secs = time.perf_counter() - t0
    return dist, parent, metrics, secs, phases.seconds()


def check_against_dijkstra(ref, dist):
    d = dist.cpu().numpy()
    np.testing.assert_allclose(np.where(np.isfinite(d), d, -1.0),
                               np.where(np.isfinite(ref), ref, -1.0),
                               rtol=1e-4, atol=1e-5)


def warm_up(device):
    """One small solve per backend and engine, so that the timed solves do
    not carry the process's first use of each CUDA kernel or of NCCL."""
    from repro_torch.core.distributed import shard_graph
    from repro_torch.data.generators import kronecker
    g = kronecker(10, 8, seed=0)
    for backend, opts in (("blocked", {}), ("blocked", dict(fused_rounds=4)),
                          ("segment_min", {})):
        solve(g, int(np.argmax(g.deg)), backend, device, **opts)
    for backend in ("blocked", "segment_min"):
        solve(shard_graph(g, 1), int(np.argmax(g.deg)), backend, device,
              sharded=True)
    from repro_torch.core.sssp import sssp_batch
    sssp_batch(g, [int(np.argmax(g.deg)), 0], backend="blocked",
               device=device)


class IndexSeconds:
    """Host seconds spent building vertex->tile indexes
    (``core/graph.py::tile_index``, which ``_bucket`` calls) while the
    context is open: the layout build's own index, timed where it is
    made."""

    def __enter__(self):
        from repro_torch.core import graph
        self.real, self.s = graph.tile_index, 0.0

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.real(*args, **kw)
            self.s += time.perf_counter() - t0
            return out
        graph.tile_index = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import graph
        graph.tile_index = self.real


def main_path(graphs, device):
    """Three solves per graph; returns per-graph results.  The launch
    counters are zeroed just before each kernel's solve and read just
    after it."""
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    out = {}
    for name, hg in graphs:
        dg = hg.to_device(device)
        source = int(np.argmax(hg.deg))
        t0 = time.perf_counter()
        with IndexSeconds() as index_s:
            bg = build_blocked(dg)      # the geometry derived for the card
        layout_s = time.perf_counter() - t0
        slots = bg.src.shape[0]
        log(f"[layout] {name}: block_v={bg.block_v} tile_e={bg.tile_e} "
            f"padded slots={slots} over m={hg.m} "
            f"(blow-up {slots / max(hg.m, 1):.4f}x) in {layout_s:.2f} s, "
            f"of which the vertex->tile index {index_s.s:.2f} s "
            f"({bg.index.vt_tile.shape[0]} entries)")
        LAUNCHES.reset()
        kd, kp, km, ks, kt = solve(dg, source, "blocked", device,
                                   layout=bg)
        launches = LAUNCHES.edge_relax
        LAUNCHES.reset()
        fd, fp, fm, fs, ft = solve(dg, source, "blocked", device,
                                   layout=bg, fused_rounds=FUSED_ROUNDS)
        fused_launches = LAUNCHES.edge_relax_fused
        stray = LAUNCHES.edge_relax
        pd, pp, pm, ps, pt = solve(dg, source, "segment_min", device)
        kmd, fmd, pmd = metrics_dict(km), metrics_dict(fm), metrics_dict(pm)
        for what, d, p, md in (("blocked", kd, kp, kmd),
                               ("fused", fd, fp, fmd)):
            if not (bitwise_equal(d, pd) and p.equal(pp)):
                raise AssertionError(f"{name}: {what} and segment_min "
                                     "differ")
            bad = [f for f in LOGICAL_METRIC_FIELDS if md[f] != pmd[f]]
            if bad:
                raise AssertionError(f"{name}: {what} logical counters "
                                     f"differ from segment_min: {bad}")
        if launches <= 0:
            raise AssertionError(f"{name}: the edge_relax kernel never ran")
        if fused_launches <= 0 or stray:
            raise AssertionError(
                f"{name}: the fused solve launched edge_relax_fused "
                f"{fused_launches} times and edge_relax {stray} times")
        if name.startswith("road") and 2 * fmd["n_invocations"] > \
                kmd["n_invocations"]:
            raise AssertionError(
                f"{name}: the fused solve made {fmd['n_invocations']} "
                f"invocations, more than half of {kmd['n_invocations']}")
        ref = scipy_dist(hg, source)
        check_against_dijkstra(ref, kd)
        check_against_dijkstra(ref, fd)
        reached = int(np.isfinite(kd.cpu().numpy()).sum())
        solves = [("blocked", ks, kmd, launches, kt),
                  ("fused", fs, fmd, fused_launches, ft),
                  ("segment_min", ps, pmd, None, pt)]
        for what, secs, md, n_launch, phases in solves:
            spans = " ".join(f"{k}={v['calls']}x/{v['s']!r}s"
                             for k, v in phases.items())
            log(f"[solve] {name} {what}: source={source} {secs!r} s, "
                f"rounds={md['n_rounds']} steps={md['n_steps']} "
                f"iterations={int(md['n_host_syncs'])} "
                f"host_syncs={int(md['n_host_syncs'])} "
                f"invocations={int(md['n_invocations'])} "
                f"launches={n_launch} "
                f"tiles_scanned={int(md['n_tiles_scanned'])} "
                f"reached={reached} {spans}")
        out[name] = dict(host=hg, source=source, dijkstra=ref, graph=dg,
                         layout=bg, dist=kd, parent=kp,
                         launches=launches, fused_launches=fused_launches,
                         solve_s=ks, fused_solve_s=fs, plain_solve_s=ps,
                         phases=kt, fused_phases=ft, plain_phases=pt,
                         metrics=kmd, fused_metrics=fmd)
    return out


# ---------------------------------------------------------------------------
# phase 3b: point-to-point queries with ALT landmark pruning
# ---------------------------------------------------------------------------

N_PAIRS = 2
# landmarks per graph: road_grid's build is one fused tree solve of about
# 23 s a landmark on an H100, and its first four farthest landmarks (the
# corners) are those of the eight
N_LANDMARKS = {"kronecker(20,16)": 8, "road_grid(1024)": 4}
# name, backend, options, the ALT launch counter the solve must move
P2P_SOLVES = (("unpruned", "blocked", {}, None),
              ("alt", "blocked", {}, "edge_relax_alt"),
              ("alt fused", "blocked", dict(fused_rounds=FUSED_ROUNDS),
               "edge_relax_fused_alt"),
              ("alt bidirectional", "blocked",
               dict(p2p_mode="bidirectional"), "edge_relax_alt"),
              ("alt segment_min", "segment_min", {}, None))
ALT_SOLVES = ("alt", "alt fused", "alt segment_min")


def pick_pairs(hg, n_pairs: int, seed: int):
    """``n_pairs`` (source, target) pairs from a numpy generator seeded
    with ``seed``: both endpoints non-isolated, the target reachable from
    the source (hop BFS), as ``tests/test_alt_p2p.py::pick_pair`` picks
    them."""
    from repro_torch.core.landmarks import hop_bfs
    rng = np.random.default_rng(seed)
    nz = np.where(hg.deg > 0)[0]
    row_ptr, dst = hg.row_ptr.astype(np.int64), hg.dst.astype(np.int64)
    pairs = []
    while len(pairs) < n_pairs:
        s = int(rng.choice(nz))
        reach = np.where(hop_bfs(row_ptr, dst, hg.n, s) > 0)[0]
        if reach.size:
            pairs.append((s, int(rng.choice(reach))))
    return pairs


def p2p_path(results, device):
    """Landmarks built on the card for each graph (the fused blocked path),
    then ``N_PAIRS`` seeded pairs each solved five ways (``P2P_SOLVES``),
    the launch counters zeroed just before each solve and read just after;
    then one ``bounded`` and one ``knear`` solve on kronecker.  Returns
    per-graph numbers."""
    from repro_torch.core import landmarks
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.serve.queries import reconstruct_path
    out = {}
    for gi, (name, res) in enumerate(results.items()):
        hg, dg, bg = res["host"], res["graph"], res["layout"]
        sync(device)
        t0 = time.perf_counter()
        with HostTimes(landmarks, ("select_landmarks", "_check_symmetric")
                       ) as host:
            lm = landmarks.build_landmarks(
                dg, N_LANDMARKS[name], "farthest", device=device, layout=bg,
                fused_rounds=FUSED_ROUNDS)
        sync(device)
        build_s = time.perf_counter() - t0
        log(f"[landmarks] {name}: {N_LANDMARKS[name]} farthest landmarks "
            f"{lm.landmarks.tolist()} (hop bound {lm.max_hops}, symmetric "
            f"{lm.sym}) built on the card with fused_rounds={FUSED_ROUNDS} "
            f"in {build_s!r} s: host selection (hop BFS) "
            f"{host.s['select_landmarks']!r} s, symmetry check (sorts on "
            f"the card) {host.s['_check_symmetric']!r} s, the rest (copies, "
            f"{N_LANDMARKS[name]} tree solves)")
        pairs = pick_pairs(hg, N_PAIRS, seed=10 + gi)
        queries, pruned, exact = [], 0, {}
        for s, t in pairs:
            solves = {}
            for what, backend, opts, counter in P2P_SOLVES:
                kw = dict(opts, goal="p2p", goal_param=t)
                if what != "unpruned":
                    kw["landmarks"] = lm
                if backend == "blocked":
                    kw["layout"] = bg
                LAUNCHES.reset()
                d, p, m, secs, phases = solve(dg, s, backend, device, **kw)
                alt_launches = (LAUNCHES.edge_relax_alt,
                                LAUNCHES.edge_relax_fused_alt)
                if counter is None and any(alt_launches) or (
                        counter and getattr(LAUNCHES, counter) <= 0):
                    raise AssertionError(
                        f"{name} ({s}, {t}) {what}: ALT kernel launches "
                        f"(edge_relax, edge_relax_fused) {alt_launches}, "
                        f"expected {counter or 'none'}")
                solves[what] = dict(
                    dist_t=d[t:t + 1].clone(),
                    path=reconstruct_path(p.cpu().numpy(), s, t),
                    metrics=metrics_dict(m), seconds=secs, phases=phases,
                    launches=getattr(LAUNCHES, counter) if counter else 0)
            base = solves["unpruned"]
            exact[s, t] = base["dist_t"], base["path"]
            for what, r in solves.items():
                if not (bitwise_equal(r["dist_t"], base["dist_t"])
                        and r["path"] == base["path"]):
                    raise AssertionError(
                        f"{name} ({s}, {t}) {what}: d(s,t) "
                        f"{float(r['dist_t'])!r} or its path differs from "
                        f"the unpruned solve's {float(base['dist_t'])!r}")
            for what in ALT_SOLVES[1:]:
                bad = [f for f in LOGICAL_METRIC_FIELDS
                       if solves[what]["metrics"][f]
                       != solves["alt"]["metrics"][f]]
                if bad:
                    raise AssertionError(f"{name} ({s}, {t}) {what}: logical "
                                         f"counters differ from alt: {bad}")
            d_t = float(base["dist_t"])
            if s == res["source"]:
                if not bitwise_equal(base["dist_t"], res["dist"][t:t + 1]):
                    raise AssertionError(f"{name} ({s}, {t}): d(s,t) differs "
                                         "from the tree solve's")
            else:
                want = float(scipy_dist(hg, s)[t])
                if not np.isclose(d_t, want, rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"{name} ({s}, {t}): d(s,t) {d_t!r} "
                                         f"against Dijkstra's {want!r}")
            pruned += sum(solves[w]["metrics"]["n_pruned"]
                          for w in ALT_SOLVES + ("alt bidirectional",))
            relax0 = base["metrics"]["n_relax"]
            for what, r in solves.items():
                md = r["metrics"]
                r["relax_ratio"] = md["n_relax"] / max(relax0, 1)
                log(f"[p2p] {name} ({s} -> {t}) {what}: {r['seconds']!r} s, "
                    f"d={d_t!r}, path of {len(base['path'])} vertices, "
                    f"rounds={md['n_rounds']} steps={md['n_steps']} "
                    f"iterations={int(md['n_host_syncs'])} "
                    f"n_relax={md['n_relax']} n_pruned={md['n_pruned']} "
                    f"relax ratio={r['relax_ratio']!r} "
                    f"ALT launches={r['launches']} " + " ".join(
                        f"{k}={v['calls']}x/{v['s']!r}s"
                        for k, v in r["phases"].items()))
            queries.append(dict(
                source=s, target=t, d=d_t, hops=len(base["path"]) - 1,
                solves={w: dict(seconds=r["seconds"], launches=r["launches"],
                                relax_ratio=r["relax_ratio"],
                                phases=r["phases"],
                                **{k: r["metrics"][k] for k in (
                                    "n_rounds", "n_steps", "n_relax",
                                    "n_pruned", "n_host_syncs")})
                        for w, r in solves.items()}))
        if pruned <= 0:
            raise AssertionError(f"{name}: no ALT solve pruned a candidate")
        out[name] = dict(landmarks=lm, build_s=build_s,
                         select_s=host.s["select_landmarks"],
                         symmetry_s=host.s["_check_symmetric"],
                         queries=queries, pruned=pruned, exact=exact)
        mark(f"p2p {name}")
    out["goals"] = goal_solves(results["kronecker(20,16)"], device)
    return out


def settled_as_tree(goal, gp, d, p, dist, parent) -> bool:
    """Whether a ``bounded`` or ``knear`` query's settled entries (``d``,
    ``p``) equal the tree solve's (``dist``, ``parent``): every vertex
    within the bound, or the k + 1 smallest distances."""
    if goal == "bounded":
        keep = dist <= gp
        return bitwise_equal(d[keep], dist[keep]) and p[keep].equal(
            parent[keep])
    near = lambda x: torch.sort(x).values[:gp + 1]
    return bitwise_equal(near(d), near(dist))


def goal_solves(res, device):
    """One ``bounded`` (the 40th percentile of the tree's distances) and
    one ``knear`` (k = 1000) solve from the tree solve's source on
    ``blocked``: their settled entries must equal the tree solve's."""
    from repro_torch.core.sssp import metrics_dict
    dist, parent = res["dist"], res["parent"]
    finite = dist[torch.isfinite(dist)]
    bound = float(np.float32(torch.quantile(finite.double(), 0.4).item()))
    k = 1000
    out = {}
    for goal, gp in (("bounded", bound), ("knear", k)):
        d, p, m, secs, _ = solve(res["graph"], res["source"], "blocked",
                                 device, layout=res["layout"], goal=goal,
                                 goal_param=gp)
        ok = settled_as_tree(goal, gp, d, p, dist, parent)
        md = metrics_dict(m)
        log(f"[goal] kronecker(20,16) {goal}={gp!r}: {secs!r} s, "
            f"rounds={md['n_rounds']} steps={md['n_steps']} "
            f"iterations={int(md['n_host_syncs'])} "
            f"settled={int((d < float('inf')).sum())}")
        if not ok:
            raise AssertionError(f"kronecker(20,16) {goal}={gp!r}: settled "
                                 "entries differ from the tree solve's")
        out[goal] = dict(param=gp, seconds=secs, n_rounds=md["n_rounds"],
                         n_steps=md["n_steps"])
    return out


# ---------------------------------------------------------------------------
# phase 4: numbers
# ---------------------------------------------------------------------------

def window_inputs(res, device):
    """A mid-solve round of the main path's layout: the window
    [median dist, median + maxW) with the push band below it as frontier
    (the shape of a typical step), on the solved distances and parents.
    Returns ``relax_bucket``'s arguments and keywords."""
    from repro_torch.core.relax import leaf_pruned
    dg, bg, dist = res["graph"], res["layout"], res["dist"]
    finite = dist[torch.isfinite(dist)]
    lb = finite.median()
    ub = lb + dg.max_w
    band = (dist >= lb - dg.max_w) & (dist < ub)
    pad = bg.n_out - dg.n
    grow = lambda x, v: torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                                 device=device)])
    dist_p = grow(dist, float("inf"))
    paths = leaf_pruned(grow(band, False), dist_p, bg.deg)
    return (dist_p, paths, grow(res["parent"], -1), bg.src, bg.dst, bg.w,
            bg.tile_first, lb.reshape(()), ub.reshape(())), dict(
                tile_e=bg.tile_e, n_out=bg.n_out, index=bg.index)


# the parent commit's edge-relax wrappers (``--parent DIR``), timed beside
# this tree's on the same inputs; None when not asked for
PARENT = None


def load_parent(root: str):
    """The ``kernels.edge_relax.ops`` module of another checkout's port
    (its kernels built into that checkout's ``build/``), imported as the
    package ``parent_repro_torch`` beside this one."""
    import importlib.util
    pkg = Path(root).resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_repro_torch"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("parent_repro_torch.kernels._build").build_all()
    return importlib.import_module("parent_repro_torch.kernels.edge_relax.ops")


def scheduled_slots(args, kw):
    """The slots of the tiles ``schedule_tiles`` schedules for a round."""
    from repro_torch.kernels.edge_relax import ref
    dist, paths, parent, src, dst, w, tile_first, *_ = args
    tile_e = kw["tile_e"]
    sched, sched_n = ref.schedule_tiles(paths, src, w, tile_first, tile_e)
    return (sched[:int(sched_n)].long()[:, None] * tile_e
            + torch.arange(tile_e, device=w.device)[None, :]).reshape(-1)


def bound_bytes(args, kw, slots, fn: str):
    """Least bytes of one round, counted as ``relax_tiles`` reads them,
    and two coarser counts.  ``slots`` are the scheduled tiles' slots.
    The kernel's count: ``paths`` of every source (1 B), ``vt_ptr`` (8 B)
    and the index entries (4 B each) of each path source, the forced
    tiles (4 B each), ``src`` of every scheduled slot, ``w`` of each such
    slot whose source has a path and ``dst`` of each in-window candidate
    (4 B each), ``dist`` of each distinct path source in those slots and
    ``parent`` of each distinct source with an in-window candidate (4 B
    each), with ALT ``alt_lb`` of each distinct in-window destination (4
    B), ``vals`` and ``wins`` written (8 B per destination) and the four
    counters.  The second count charges ``src``, ``dst`` and ``w`` (12 B)
    for every scheduled slot instead.  The third is the parent design's:
    it read ``src`` of every slot and ``tile_first`` to find the tiles
    (row 1 also ``dist`` and ``paths`` of every vertex and 8 B per
    scheduled slot)."""
    dist, paths, parent, src, dst, w, tile_first, lb, ub, *alt = args
    vt_ptr, vt_tile, forced = kw["index"]
    n_out = kw["n_out"]
    s = src[slots].long()
    on = paths[s].bool()
    cand = dist[s] + w[slots]
    in_window = on & (cand >= lb) & (cand < ub)
    n_on, n_window = int(on.sum()), int(in_window.sum())
    n_path = int(torch.unique(s[on]).numel())
    n_par = int(torch.unique(s[in_window]).numel())
    n_dst = (int(torch.unique(dst[slots][in_window]).numel()) if alt
             else 0)
    pa = paths.bool()
    entries = int((vt_ptr[1:] - vt_ptr[:-1])[pa].sum())
    n_src, e, nt = dist.shape[0], src.shape[0], tile_first.shape[0]
    n_slots = slots.shape[0]
    shared = (n_src + 8 * int(pa.sum()) + 4 * entries + 4 * forced.shape[0]
              + 4 * n_path + 4 * n_par + 4 * n_dst + 8 * n_out + 16)
    new = shared + 4 * (n_slots + n_on + n_window)
    if fn == "relax_bucket":
        old = 4 * e + 8 * n_slots + nt + 5 * n_out + 8 * n_out
    else:
        old = (4 * e + nt + 8 * n_slots + n_src + 4 * n_path
               + 4 * n_par + 8 * n_out + 16)
    return new, shared + 12 * n_slots, old + 4 * n_dst, dict(
        path_sources=n_path, parent_sources=n_par, index_entries=entries,
        path_slots=n_on, destinations=n_dst)


def library_round(args, kw, slots, want):
    """The library yardstick of a one-round kernel: the whole output by
    one PyTorch scatter.  The keys are filled, ``scatter_reduce_`` (amin)
    takes the packed (value bits, source id) keys of the in-window kept
    candidates of the scheduled tiles' ``slots`` (found and packed
    beforehand: no schedule, gather or counter is timed), and the keys
    are unpacked to ``vals`` and ``wins``, which must equal the plain
    version's.  Returns its device ms (:func:`graph_ms`), the parent's
    scatter-only figure (``scatter_reduce_`` alone into filled keys, over
    every slot of the scheduled tiles, eager), the in-window and the kept
    candidates."""
    from repro_torch.kernels.edge_relax import ref
    dist, paths, parent, src, dst, w, tile_first, lb, ub, *alt = args
    n_out = kw["n_out"]
    s_src, s_dst = src[slots].long(), dst[slots].long()
    cand = dist[s_src] + w[slots]
    ok = paths[s_src] & (cand >= lb) & (cand < ub)
    n_window = int(ok.sum())
    if alt:
        ok = ok & (cand + alt[0][s_dst] <= alt[1])
    packed = torch.where(ok, (cand.view(torch.int32).long() << 32) | s_src,
                         ref.EMPTY_KEY)
    kept, k_dst = packed[ok], s_dst[ok]

    def whole():
        keys = torch.full((n_out,), ref.EMPTY_KEY, dtype=torch.int64,
                          device=w.device)
        keys.scatter_reduce_(0, k_dst, kept, "amin")
        return ((keys >> 32).to(torch.int32).view(torch.float32),
                (keys & 0xFFFFFFFF).to(torch.int32))
    vals, wins = whole()
    if not (bitwise_equal(vals, want[0]) and wins.equal(want[1])):
        raise AssertionError("the library yardstick's output differs from "
                             "the plain version's")
    keys = torch.full((n_out,), ref.EMPTY_KEY, dtype=torch.int64,
                      device=w.device)
    scatter_ms = cuda_ms(lambda: keys.scatter_reduce_(0, s_dst, packed,
                                                      "amin"))
    return graph_ms(whole), scatter_ms, n_window, int(ok.sum())


def in_turns(call, parent=None) -> dict:
    """Device ms (:func:`graph_ms`) and eager ms (:func:`cuda_ms`, the
    host's launch cost included) of ``call`` and, if given, of ``parent``
    (the parent design's call on the same inputs), timed in turns: parent,
    this, this, parent.  Returns the means and the turns."""
    times = dict(ms=[], eager_ms=[], parent_ms=[], parent_eager_ms=[])
    for f, tag in ((parent, "parent_"), (call, ""), (call, ""),
                   (parent, "parent_")):
        if f is not None:
            times[f"{tag}ms"].append(graph_ms(f))
            times[f"{tag}eager_ms"].append(cuda_ms(f))
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    return dict({k: mean(v) for k, v in times.items()}, turns=times)


def turn_times(fn: str, args, kw) -> dict:
    """:func:`in_turns` of ``ops.<fn>(*args, **kw)`` and, with
    ``--parent``, of the parent design's call on the same inputs."""
    from repro_torch.kernels.edge_relax import ops
    return in_turns(lambda: getattr(ops, fn)(*args, **kw),
                    None if PARENT is None
                    else lambda: getattr(PARENT, fn)(*args, **kw))


def round_numbers(fn: str, args, kw, what: str):
    """One one-round kernel call (``fn`` is ``relax_bucket``, row 1, or
    ``relax_partials``, row 3; ALT when ``args`` carry ``alt_lb`` and the
    bound) on the main path's inputs: the check against the plain
    version (:func:`round_pair`), the kernel's device time
    (:func:`graph_ms`) and eager time (:func:`cuda_ms`, the host's
    launch cost included), the plain version's, the library yardstick's
    (:func:`library_round`, with the parent's scatter-only figure), the
    bounds (:func:`bound_bytes`), and with ``--parent`` the parent
    design's device and eager times on the same inputs, timed parent,
    new, new, parent."""
    from repro_torch.kernels.edge_relax import ops, ref
    out, want = round_pair(args, kw, what, fn)
    err = float((out[0] - want[0]).abs().nan_to_num(0.0).max())
    times = turn_times(fn, args, kw)
    plain_kw = {k: v for k, v in kw.items() if k != "index"}
    plain_ms = cuda_ms(lambda: ref.edge_relax_partials_ref(*args,
                                                           **plain_kw))
    slots = scheduled_slots(args, kw)
    library_ms, scatter_ms, n_window, n_kept = library_round(args, kw, slots,
                                                             want)
    new_b, slots_b, old_b, seen = bound_bytes(args, kw, slots, fn)
    return dict(
        **times, plain_ms=plain_ms, library_ms=library_ms,
        library_scatter_ms=scatter_ms,
        bound_ms=new_b / HBM_BYTES_PER_S * 1e3,
        bound_ms_12b_slots=slots_b / HBM_BYTES_PER_S * 1e3,
        bound_ms_old=old_b / HBM_BYTES_PER_S * 1e3, bytes=new_b,
        bytes_12b_slots=slots_b, bytes_old=old_b, max_abs_err=err,
        sched_tiles=slots.shape[0] // kw["tile_e"],
        n_tiles=int(args[6].shape[0]), candidates=n_window, kept=n_kept,
        counts=dict(zip(ops.PARTIAL_COUNTERS, out[2].tolist())), **seen,
        window=[float(args[7]), float(args[8])])


def measure(res, device):
    args, kw = window_inputs(res, device)
    return round_numbers("relax_bucket", args, kw, "on the main path's "
                         "layout")


def fused_window_inputs(res, device):
    """A mid-solve state of the main path's layout: the vertices below
    the median distance settled (their solved dist and parent), the push
    band [median - maxW, median) on the frontier, the rest unreached,
    and the window [median, median + maxW)."""
    dg, bg, dist, parent = (res["graph"], res["layout"], res["dist"],
                            res["parent"])
    lb = dist[torch.isfinite(dist)].median()
    ub = lb + dg.max_w
    settled = dist < lb
    pad = bg.n_out - dg.n
    grow = lambda x, v: torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                                 device=device)])
    d0 = grow(torch.where(settled, dist, float("inf")), float("inf"))
    p0 = grow(torch.where(settled, parent, -1), -1)
    f0 = grow(settled & (dist >= lb - dg.max_w), False)
    return (d0, p0, f0, bg.deg, bg.src, bg.dst, bg.w, bg.tile_first,
            lb.reshape(()), ub.reshape(()))


def fused_bytes(args, kw, n_exec: int, want):
    """Least bytes of one fused call, counted as ``edge_relax_fused.cu``
    reads them, over the ``n_exec`` rounds it ran (the plain version
    stepped one round at a time from the call's inputs; the stepped state
    must end at ``want``'s).  Per round: 8 B of ``vt_ptr``, 4 B of
    ``dist`` and 5 B per index entry (``vt_tile``, ``tile_first``) of each
    path source, 4 B per forced tile, ``src`` of every scheduled slot,
    ``w`` of each slot of a path source, ``dst`` of each in-window
    candidate and ``parent`` of each source with one (4 B each), with ALT
    ``alt_lb`` of each distinct in-window destination (4 B), per touched
    destination its key read and reset and its dist read (20 B), per
    improved one dist and parent written, deg read and its list entry
    (16 B).  Once a call: dist, parent and front read and written (18 B a
    vertex), deg and the list entry of each frontier vertex (8 B).
    Returns ``(bytes, the old count's bytes, seen)``: the old count is
    the parent design's (``src`` of every slot and ``tile_first`` each
    round, 26 B a vertex a round, 12 B a vertex a call, 8 B per
    scheduled slot and the ALT destinations)."""
    from repro_torch.kernels.edge_relax import ref
    dist, parent, front, deg, src, dst, w, tile_first, lb, ub, *alt = args
    vt_ptr, vt_tile, forced = kw["index"]
    tile_e = kw["tile_e"]
    n_out, e, nt = dist.shape[0], src.shape[0], tile_first.shape[0]
    steps = torch.arange(tile_e, device=w.device)
    total = 18 * n_out + 8 * int(front.sum())
    old = 12 * n_out
    seen = dict(path_sources=0, index_entries=0, sched_tiles=0,
                path_slots=0, candidates=0, touched=0, improved=0,
                destinations=0)
    for _ in range(n_exec):
        paths = front & ((dist <= 0.0) | (deg > 1))
        sched, sched_n = ref.schedule_tiles(paths, src, w, tile_first,
                                            tile_e)
        slots = (sched[:int(sched_n)].long()[:, None] * tile_e
                 + steps[None, :]).reshape(-1)
        s, d = src[slots].long(), dst[slots].long()
        on = paths[s]
        c = dist[s] + w[slots]
        ok = on & (c >= lb) & (c < ub)
        kept = ok
        if alt:
            bound = torch.minimum(alt[1], dist[alt[3].long()] * alt[2])
            kept = ok & (c + alt[0][d] <= bound)
        n = dict(
            path_sources=int(paths.sum()),
            index_entries=int((vt_ptr[1:] - vt_ptr[:-1])[paths].sum()),
            sched_tiles=int(sched_n), path_slots=int(on.sum()),
            candidates=int(ok.sum()),
            touched=int(torch.unique(d[kept]).numel()),
            destinations=int(torch.unique(d[ok]).numel()) if alt else 0,
            sources=int(torch.unique(s[ok]).numel()))
        dist, parent, front, _ = ref.edge_relax_fused_ref(
            dist, parent, front, deg, src, dst, w, tile_first, lb, ub, *alt,
            tile_e=tile_e, fused_rounds=1)
        n["improved"] = int(front.sum())
        total += (12 * n["path_sources"] + 5 * n["index_entries"]
                  + 4 * forced.shape[0] + 4 * slots.shape[0]
                  + 4 * n["path_slots"] + 4 * n["candidates"]
                  + 4 * n["sources"] + 4 * n["destinations"]
                  + 20 * n["touched"] + 16 * n["improved"])
        old += (4 * e + nt + 26 * n_out + 8 * slots.shape[0]
                + 4 * n["destinations"])
        for k in seen:
            seen[k] += n[k]
    if not (bitwise_equal(dist, want[0]) and parent.equal(want[1])
            and front.equal(want[2])):
        raise AssertionError("the fused call's rounds stepped one at a time "
                             "end elsewhere than the call")
    return total, old, seen


def fused_numbers(args, kw, what: str):
    """One ``relax_fused`` call (ALT when ``args`` carry its operands) on
    the main path's inputs: the check against the plain version, the
    kernel's device time by CUDA-graph replay and eager time, with
    ``--parent`` the parent design's on the same inputs in turns
    (:func:`turn_times`), the plain version's time, and the bound as the
    kernel reads (:func:`fused_bytes`) beside the old count."""
    from repro_torch.kernels.edge_relax import ops, ref
    plain_kw = {k: v for k, v in kw.items() if k != "index"}
    out = ops.relax_fused(*args, **kw)
    want = ref.edge_relax_fused_ref(*args, **plain_kw)
    if not (bitwise_equal(out[0], want[0])
            and all(a.equal(b) for a, b in zip(out[1:], want[1:]))):
        raise AssertionError(f"edge_relax_fused disagrees with its plain "
                             f"version {what}")
    err = float((out[0] - want[0]).abs().nan_to_num(0.0).max())
    times = turn_times("relax_fused", args, kw)
    plain_ms = cuda_ms(lambda: ref.edge_relax_fused_ref(*args, **plain_kw))
    cnt = dict(zip(ops.FUSED_COUNTERS, out[3].tolist()))
    bytes_, old, seen = fused_bytes(args, kw, cnt["n_exec"], want)
    return dict(**times, plain_ms=plain_ms, library_ms=None,
                bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                bound_ms_old=old / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
                bytes=bytes_, bytes_old=old, counts=cnt, **seen,
                window=[float(args[8]), float(args[9])])


def measure_fused(res, device):
    bg = res["layout"]
    return fused_numbers(fused_window_inputs(res, device),
                         dict(tile_e=bg.tile_e, fused_rounds=FUSED_ROUNDS,
                              index=bg.index), "at the tree window")


class MiddleCall:
    """Records the arguments (cloned) of call ``k`` of the function
    ``name`` of ``repro_torch.core.relax`` while the context is open, and
    counts the calls."""

    def __init__(self, name: str, k: int):
        self.name, self.k, self.calls = name, k, 0
        self.args = self.kw = None

    def __enter__(self):
        from repro_torch.core import relax
        self.orig = getattr(relax, self.name)

        def recorded(*args, **kw):
            if self.calls == self.k:
                self.args = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
                self.kw = kw
            self.calls += 1
            return self.orig(*args, **kw)
        setattr(relax, self.name, recorded)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import relax
        setattr(relax, self.name, self.orig)


def mid_query_call(res, query, lm, fused: bool, device):
    """The arguments of the middle ALT kernel call of one of the p2p
    phase's ALT queries, solved again here on the main path's layout:
    ``relax_bucket`` calls (``edge_relax[alt]``) of the unfused query, or
    ``relax_fused`` calls (``edge_relax_fused[alt]``) of the fused one.
    Returns ``(args, kwargs, index, calls)``; the query must make as many
    calls as in the p2p phase."""
    from repro_torch.core.sssp import sssp
    name = "relax_fused" if fused else "relax_bucket"
    calls = query["solves"]["alt fused" if fused else "alt"]["launches"]
    with MiddleCall(name, calls // 2) as rec:
        sssp(res["graph"], query["source"], backend="blocked",
             layout=res["layout"], device=device, goal="p2p",
             goal_param=query["target"], landmarks=lm,
             fused_rounds=FUSED_ROUNDS if fused else 0)
    if rec.calls != calls:
        raise AssertionError(f"the ALT query ({query['source']}, "
                             f"{query['target']}) made {rec.calls} {name} "
                             f"calls, {calls} in the p2p phase")
    return rec.args, rec.kw, rec.k, calls


def measure_alt(res, lm, query, device):
    """``edge_relax``'s ALT branch at the middle call of an ALT query of
    the p2p phase (:func:`round_numbers`); ``ms_without_alt`` is the
    kernel's device time on the same state without the cut."""
    from repro_torch.kernels.edge_relax import ops
    args, kw, k, calls = mid_query_call(res, query, lm, False, device)
    m = round_numbers("relax_bucket", args, kw, "[alt] at the query's "
                      "middle call")
    m.update(ms_without_alt=graph_ms(lambda: ops.relax_bucket(*args[:9],
                                                              **kw)),
             query=[query["source"], query["target"]], call=[k, calls],
             prune_bound=float(args[10]))
    return m


def measure_fused_alt(res, lm, query, device):
    """``edge_relax_fused``'s ALT branch at the middle call of the fused
    ALT query of the p2p phase (:func:`fused_numbers`);
    ``ms_without_alt`` is the kernel's device time on the same state
    without the cut."""
    from repro_torch.kernels.edge_relax import ops
    args, kw, k, calls = mid_query_call(res, query, lm, True, device)
    m = fused_numbers(args, kw, "[alt] at the query's middle call")
    m.update(ms_without_alt=graph_ms(lambda: ops.relax_fused(*args[:10],
                                                             **kw)),
             query=[query["source"], query["target"]], call=[k, calls])
    return m


# ---------------------------------------------------------------------------
# the sharded v1 engine (edge_relax_partials)
# ---------------------------------------------------------------------------

def init_group(store_dir: str):
    """An NCCL process group of world size 1 on card 0 (a FileStore in
    ``store_dir``; no port is opened for the rendezvous)."""
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(Path(store_dir) / "store"), 1),
        rank=0, world_size=1)


def shard_inputs(arrays, q: int, block: int, dist, paths, parent, device):
    """Shard ``q``'s slabs and its slice of the padded state, on the card,
    as :func:`relax_partials` takes them, and the shard's tile index."""
    from repro_torch.core.graph import TileIndex
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lo, hi = q * block, (q + 1) * block
    return (dist[lo:hi], paths[lo:hi], parent[lo:hi], t(arrays.src[q]),
            t(arrays.dst[q]), t(arrays.w[q]), t(arrays.tile_first[q])), \
        TileIndex(arrays.vt_ptr[q], arrays.vt_tile[q],
                  arrays.forced[q]).to(device)


def partials_pair(args, lb, ub, kw, what, alt=()):
    """:func:`round_pair` for ``relax_partials`` on one shard, with the
    ALT operands ``alt`` (``alt_lb``, the prune bound) if given."""
    return round_pair(args + (lb, ub) + tuple(alt), kw,
                      f"{'[alt] ' if alt else ''}{what}", "relax_partials")


def mid_solve_window(res, n_pad, device):
    """The main path's mid-solve round padded to ``n_pad``: the window
    [median dist, median + maxW), the push band below it as frontier, the
    solved parents; returns ``(dist, paths, parent, lb, ub)``."""
    from repro_torch.core.relax import leaf_pruned
    dg, dist, parent = res["graph"], res["dist"], res["parent"]
    lb = dist[torch.isfinite(dist)].median()
    ub = lb + dg.max_w
    band = (dist >= lb - dg.max_w) & (dist < ub)
    pad = n_pad - dg.n
    grow = lambda x, v: torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                                 device=device)])
    deg = grow(dg.deg, 0)
    dist_p = grow(dist, float("inf"))
    paths = leaf_pruned(grow(band, False), dist_p, deg)
    return dist_p, paths, grow(parent, -1), lb.reshape(()), ub.reshape(())


def random_shard_calls(rng, n_random: int, device):
    """``n_random`` seeded random graphs over shard counts, geometries,
    windows and ties; yields ``(args, lb, ub, kw, label)`` for every
    shard of each, as :func:`partials_pair` takes them."""
    from repro_torch.core.distributed import shard_blocked
    from repro_torch.core.graph import build_csr
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    for i in range(n_random):
        n = int(rng.integers(64, 20000))
        m = int(rng.integers(0, 8 * n))
        ties = bool(rng.random() < 0.5)
        u, v = rng.integers(0, n, m), rng.integers(0, n, m)
        keep = u != v
        w = (rng.integers(1, 4, keep.sum()).astype(np.float64) if ties
             else rng.random(keep.sum()) + 1e-3)
        g = build_csr(n, u[keep], v[keep], w)
        p = int(rng.integers(1, 5))
        block_v = [64, 1024, None][int(rng.integers(0, 3))]
        tile_e = int(rng.choice([32, 64, 256, 512]))
        arrays, meta = shard_blocked(g, p, block_v=block_v, tile_e=tile_e,
                                     device=device)
        block = meta.n_src_blocks * meta.block_v
        n_pad = p * block
        d = (rng.integers(0, 6, n_pad) if ties
             else rng.random(n_pad) * 3).astype(np.float32)
        d[rng.random(n_pad) < 0.2] = np.inf
        front = (rng.random(n_pad) < 0.3) & np.isfinite(d)
        par = np.where(np.isfinite(d), rng.integers(0, n_pad, n_pad),
                       -1).astype(np.int32)
        t = lambda a: torch.from_numpy(a).to(device)
        lb0 = bool(rng.random() < 0.3)
        lb, ub = (f32(0.0), f32(np.inf)) if lb0 else (f32(1.0), f32(4.0))
        kw = dict(tile_e=meta.tile_e, n_out=meta.n_dst_blocks * meta.block_v)
        for q in range(p):
            args, index = shard_inputs(arrays, q, block, t(d), t(front),
                                       t(par), device)
            yield args, lb, ub, dict(kw, index=index), (
                f"random case {i} (n={n} m={m} P={p} block_v={meta.block_v} "
                f"tile_e={tile_e} ties={ties} lb0={lb0}) shard {q}")


def partials_vs_plain(results, device, seed: int = 2,
                      n_random: int = 30) -> int:
    """``edge_relax_partials`` against its plain version on every shard of
    a P = 4 layout of the kronecker graph at a mid-solve window of its
    solve (the shards' local source ranges differ from the destination
    range there; the layout is kept for the v1 queries), then on
    ``n_random`` seeded random graphs (:func:`random_shard_calls`).
    Returns the number of shard calls compared, raises on the first
    disagreement."""
    from repro_torch.core.distributed import shard_blocked
    res = results["kronecker(20,16)"]
    arrays, meta = res["shard4_layout"] = shard_blocked(res["host"], 4,
                                                        device=device)
    block = meta.n_src_blocks * meta.block_v
    dist, paths, parent, lb, ub = mid_solve_window(res, 4 * block, device)
    kw = dict(tile_e=meta.tile_e, n_out=meta.n_dst_blocks * meta.block_v)
    checked = 0
    for q in range(4):
        args, index = shard_inputs(arrays, q, block, dist, paths, parent,
                                   device)
        partials_pair(args, lb, ub, dict(kw, index=index),
                      f"kronecker(20,16) shard {q}/4")
        checked += 1
    log(f"[kernel-vs-plain] edge_relax_partials: kronecker(20,16) P=4 "
        f"block_v={meta.block_v} tile_e={meta.tile_e} "
        f"slots/shard={arrays.src.shape[1]} window=[{float(lb)!r}, "
        f"{float(ub)!r})")
    rng = np.random.default_rng(seed)
    for args, lb, ub, kw, what in random_shard_calls(rng, n_random, device):
        partials_pair(args, lb, ub, kw, what)
        checked += 1
    return checked


def sharded_path(results, device):
    """The v1 engine on each graph at world size 1 over NCCL: a blocked
    solve (``edge_relax_partials``, launch counters zeroed just before it
    and read just after) and a ``segment_min`` solve, each bitwise equal
    to the single-device blocked solve with equal logical counters, and
    matching Dijkstra."""
    from repro_torch.core.distributed import shard_blocked, shard_graph
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    for name, res in results.items():
        hg, source, n = res["host"], res["source"], res["host"].n
        t0 = time.perf_counter()
        sg = shard_graph(hg, 1)
        with IndexSeconds() as index_s:
            layout = shard_blocked(sg, device=device)
        layout_s = time.perf_counter() - t0
        arrays, meta = layout
        log(f"[layout] {name} v1: P=1 block_v={meta.block_v} "
            f"tile_e={meta.tile_e} padded slots={arrays.src.shape[1]} in "
            f"{layout_s:.2f} s, of which the vertex->tile index "
            f"{index_s.s:.2f} s ({arrays.vt_tile.shape[-1]} entries)")
        LAUNCHES.reset()
        vd, vp, vm, vs, vt = solve(sg, source, "blocked", device,
                                   sharded=True, blocked=layout)
        launches = LAUNCHES.edge_relax_partials
        stray = (LAUNCHES.edge_relax, LAUNCHES.edge_relax_fused)
        sd, sp, sm, ss, st = solve(sg, source, "segment_min", device,
                                   sharded=True)
        want = res["metrics"]
        vmd, smd = metrics_dict(vm), metrics_dict(sm)
        for what, d, p, md in (("v1 blocked", vd, vp, vmd),
                               ("v1 segment_min", sd, sp, smd)):
            if not (bitwise_equal(d[:n], res["dist"])
                    and p[:n].equal(res["parent"])):
                raise AssertionError(f"{name}: {what} and the single-device "
                                     "blocked solve differ")
            bad = [f for f in LOGICAL_METRIC_FIELDS if md[f] != want[f]]
            if bad:
                raise AssertionError(f"{name}: {what} logical counters "
                                     f"differ: {bad}")
            check_against_dijkstra(res["dijkstra"], d[:n])
        if launches <= 0 or any(stray):
            raise AssertionError(
                f"{name}: the v1 blocked solve launched edge_relax_partials "
                f"{launches} times and edge_relax/edge_relax_fused {stray}")
        v1_solves = [("v1 blocked", vs, vmd, launches, vt),
                     ("v1 segment_min", ss, smd, None, st)]
        for what, secs, md, n_launch, phases in v1_solves:
            spans = " ".join(f"{k}={v['calls']}x/{v['s']!r}s"
                             for k, v in phases.items())
            log(f"[solve] {name} {what}: source={source} {secs!r} s, "
                f"rounds={md['n_rounds']} steps={md['n_steps']} "
                f"iterations={int(md['n_host_syncs'])} "
                f"host_syncs={int(md['n_host_syncs'])} "
                f"invocations={int(md['n_invocations'])} "
                f"launches={n_launch} "
                f"tiles_scanned={int(md['n_tiles_scanned'])} {spans}")
        res.update(shard_layout=layout, sharded=sg, v1_launches=launches,
                   v1_solve_s=vs, v1_plain_solve_s=ss, v1_phases=vt,
                   v1_plain_phases=st, v1_metrics=vmd)


# ---------------------------------------------------------------------------
# queries on the v1 engine (edge_relax_partials' ALT branch)
# ---------------------------------------------------------------------------

# the p2p phase's pairs the v1 engine answers, by index; the first is the
# one whose middle kernel call is checked and timed (road_grid's pair 1
# takes twice as long as pair 2: left out for the run's time)
V1_PAIRS = {"kronecker(20,16)": (0, 1), "road_grid(1024)": (1,)}


def v1_queries(results, p2p, device):
    """ALT p2p queries on the v1 engine at world size 1 over NCCL: the
    ``V1_PAIRS`` of the p2p phase with its landmark sets, on ``blocked``
    (``edge_relax_partials``' ALT branch; counters zeroed just before
    each query and read just after) and ``segment_min``.  ``dist[t]`` and
    the path must equal the single-device unpruned query's, ``n_relax``
    and ``n_pruned`` the single-device ALT query's, the logical counters
    of both backends each other's; ``blocked`` must launch the ALT kernel
    and no other, and some candidate must be pruned on each graph.  The
    middle kernel call of each graph's first pair is kept.  Then a
    ``bounded`` and a ``knear`` query on kronecker with the goals phase's
    parameters, whose settled entries must equal the tree solve's."""
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.serve.queries import reconstruct_path
    out = {}
    for name, res in results.items():
        sg, layout, lm = res["sharded"], res["shard_layout"], \
            p2p[name]["landmarks"]
        queries, pruned, middle = [], 0, None
        for qi in V1_PAIRS[name]:
            q = p2p[name]["queries"][qi]
            s, t = q["source"], q["target"]
            dist_t, path = p2p[name]["exact"][s, t]
            single = q["solves"]["alt"]
            solves = {}
            for backend in ("blocked", "segment_min"):
                kw = dict(goal="p2p", goal_param=t, landmarks=lm)
                if backend == "blocked":
                    kw["blocked"] = layout
                rec = MiddleCall("relax_partials", single["launches"] // 2)
                LAUNCHES.reset()
                with rec:
                    d, p, m, secs, phases = solve(sg, s, backend, device,
                                                  sharded=True, **kw)
                others = dict(vars(LAUNCHES))
                alt_n = others.pop("edge_relax_partials_alt")
                if any(others.values()) or (alt_n > 0) != (
                        backend == "blocked"):
                    raise AssertionError(
                        f"{name} ({s}, {t}) v1 {backend}: kernel launches "
                        f"{vars(LAUNCHES)}")
                if backend == "blocked" and rec.calls != single["launches"]:
                    raise AssertionError(
                        f"{name} ({s}, {t}) v1: {rec.calls} partials calls, "
                        f"{single['launches']} relax calls single-device")
                if backend == "blocked" and qi == V1_PAIRS[name][0]:
                    middle = dict(args=rec.args, kw=rec.kw, k=rec.k,
                                  calls=rec.calls, query=[s, t])
                md = metrics_dict(m)
                if not (bitwise_equal(d[t:t + 1], dist_t)
                        and reconstruct_path(p.cpu().numpy(), s, t)
                        == path):
                    raise AssertionError(
                        f"{name} ({s}, {t}) v1 {backend}: d(s,t) "
                        f"{float(d[t])!r} or its path differs from the "
                        f"unpruned single-device query's")
                bad = [f for f in ("n_relax", "n_pruned")
                       if md[f] != single[f]]
                if bad:
                    raise AssertionError(
                        f"{name} ({s}, {t}) v1 {backend}: {bad} differ from "
                        "the single-device ALT query's")
                solves[backend] = dict(metrics=md, seconds=secs,
                                       phases=phases, launches=alt_n)
            bad = [f for f in LOGICAL_METRIC_FIELDS
                   if solves["blocked"]["metrics"][f]
                   != solves["segment_min"]["metrics"][f]]
            if bad:
                raise AssertionError(f"{name} ({s}, {t}) v1: blocked and "
                                     f"segment_min counters differ: {bad}")
            pruned += solves["blocked"]["metrics"]["n_pruned"]
            relax0 = q["solves"]["unpruned"]["n_relax"]
            for backend, r in solves.items():
                md = r["metrics"]
                one = q["solves"]["alt" if backend == "blocked"
                                  else "alt segment_min"]["seconds"]
                log(f"[p2p] {name} ({s} -> {t}) v1 alt {backend}: "
                    f"{r['seconds']!r} s (single-device {one!r} s), "
                    f"d={float(dist_t)!r}, path of {len(path)} vertices, "
                    f"rounds={md['n_rounds']} steps={md['n_steps']} "
                    f"iterations={int(md['n_host_syncs'])} "
                    f"n_relax={md['n_relax']} n_pruned={md['n_pruned']} "
                    f"relax ratio={md['n_relax'] / max(relax0, 1)!r} "
                    f"ALT launches={r['launches']} " + " ".join(
                        f"{k}={v['calls']}x/{v['s']!r}s"
                        for k, v in r["phases"].items()))
            queries.append(dict(source=s, target=t, solves={
                b: dict(seconds=r["seconds"], launches=r["launches"],
                        phases=r["phases"], **{k: r["metrics"][k] for k in (
                            "n_rounds", "n_steps", "n_relax", "n_pruned",
                            "n_host_syncs")})
                for b, r in solves.items()}))
        if pruned <= 0:
            raise AssertionError(f"{name}: no v1 ALT query pruned a "
                                 "candidate")
        out[name] = dict(queries=queries, middle=middle, pruned=pruned)
    res = results["kronecker(20,16)"]
    out["goals"] = {}
    for goal in ("bounded", "knear"):
        gp = p2p["goals"][goal]["param"]
        d, p, m, secs, _ = solve(res["sharded"], res["source"], "blocked",
                                 device, sharded=True,
                                 blocked=res["shard_layout"], goal=goal,
                                 goal_param=gp)
        n = res["host"].n
        md = metrics_dict(m)
        log(f"[goal] kronecker(20,16) v1 {goal}={gp!r}: {secs!r} s, "
            f"rounds={md['n_rounds']} steps={md['n_steps']} "
            f"iterations={int(md['n_host_syncs'])} "
            f"settled={int((d[:n] < float('inf')).sum())}")
        if not settled_as_tree(goal, gp, d[:n], p[:n], res["dist"],
                               res["parent"]):
            raise AssertionError(f"kronecker(20,16) v1 {goal}={gp!r}: "
                                 "settled entries differ from the tree "
                                 "solve's")
        out["goals"][goal] = dict(param=gp, seconds=secs,
                                  n_rounds=md["n_rounds"],
                                  n_steps=md["n_steps"])
    return out


def partials_alt_vs_plain(results, v1q, device, seed: int = 6,
                          n_random: int = 20) -> int:
    """``edge_relax_partials``' ALT branch against its plain version on
    every shard of the P = 4 kronecker layout at the middle kernel call of
    the first kronecker v1 ALT query (its state, window, ``alt_lb`` and
    prune bound, re-padded to the P = 4 ranges), then on ``n_random``
    seeded random layouts with the prune bound at +inf, below every
    candidate's ``cand + alt_lb[dst]``, exactly at one (a tie) and at
    their median, in turn.  Returns the shard calls compared."""
    name = "kronecker(20,16)"
    res, mid = results[name], v1q[name]["middle"]
    arrays, meta = res["shard4_layout"]
    block = meta.n_src_blocks * meta.block_v
    n_out = meta.n_dst_blocks * meta.block_v
    n = res["host"].n
    dist, paths, parent, *_, lb, ub, alt_lb, bound = mid["args"]

    def grow(x, size, v):
        x = x[:n]
        return torch.cat([x, torch.full((size - n,), v, dtype=x.dtype,
                                        device=device)])
    dist4, paths4, parent4 = (grow(x, 4 * block, v) for x, v in (
        (dist, float("inf")), (paths, False), (parent, -1)))
    alt = (grow(alt_lb, n_out, float("inf")), bound)
    kw = dict(tile_e=meta.tile_e, n_out=n_out)
    checked = 0
    for q in range(4):
        args, index = shard_inputs(arrays, q, block, dist4, paths4, parent4,
                                   device)
        partials_pair(args, lb, ub, dict(kw, index=index), f"{name} shard "
                      f"{q}/4 at the v1 query's call {mid['k']} of "
                      f"{mid['calls']}", alt)
        checked += 1
    rng = np.random.default_rng(seed)
    cases = ("inf", "below-all", "tie", "between")
    for i, (args, lb, ub, kw, what) in enumerate(
            random_shard_calls(rng, n_random, device)):
        alt_lb = (rng.integers(0, 12, kw["n_out"]) / 8).astype(np.float32)
        alt_lb[rng.random(kw["n_out"]) < 0.15] = np.inf
        alt_lb = torch.from_numpy(alt_lb).to(device)
        d, pa, _, src, dst, w, _ = args
        cand = d[src.long()] + w
        ok = pa[src.long()] & (cand >= lb) & (cand < ub)
        tot = (cand + alt_lb[dst.long()])[ok]
        tot = torch.sort(tot[torch.isfinite(tot)]).values
        case = cases[i % len(cases)]
        if case == "inf" or tot.numel() < 2:
            pb = float("inf")
        else:
            pb = {"below-all": float(tot[0]) / 2, "tie": float(
                tot[tot.numel() // 3]), "between": float(tot[
                    tot.numel() // 2])}[case]
        pb = torch.full((), pb, dtype=torch.float32, device=device)
        partials_pair(args, lb, ub, kw, f"{what} bound {case}", (alt_lb, pb))
        checked += 1
    return checked


def measure_partials_alt(res, mid, device):
    """``edge_relax_partials``' ALT branch at the middle kernel call of a
    v1 ALT query (:func:`round_numbers`); ``ms_without_alt`` is the
    kernel's device time on the same state without the cut."""
    from repro_torch.kernels.edge_relax import ops
    args, kw = mid["args"], mid["kw"]
    m = round_numbers("relax_partials", args, kw, "[alt] at the v1 query's "
                      "middle call")
    m.update(ms_without_alt=graph_ms(lambda: ops.relax_partials(*args[:9],
                                                                **kw)),
             query=mid["query"], call=[mid["k"], mid["calls"]],
             prune_bound=float(args[10]))
    return m


def measure_partials(res, device):
    """``edge_relax_partials`` at the main path's shape (the whole graph
    as one shard) and its mid-solve window (:func:`round_numbers`)."""
    arrays, meta = res["shard_layout"]
    block = meta.n_src_blocks * meta.block_v
    dist, paths, parent, lb, ub = mid_solve_window(res, block, device)
    args, index = shard_inputs(arrays, 0, block, dist, paths, parent, device)
    kw = dict(tile_e=meta.tile_e, n_out=meta.n_dst_blocks * meta.block_v,
              index=index)
    return round_numbers("relax_partials", args + (lb, ub), kw,
                         "on the main path's layout")


# ---------------------------------------------------------------------------
# phase 3c: the facade (Solver, SolveSpec, sssp_batch) and edge_relax over
# slots
# ---------------------------------------------------------------------------

FACADE_SLOTS = 8
ROAD_KNEAR = (4, 1000)           # road_grid's batched knear: sources, k
ROAD_ADAPTIVE_QUANTILE = 0.05    # road_grid's adaptive bounded query


def timed(fn, device):
    """``(fn(), host seconds)``, the device synchronized around it."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def slot_metrics(metrics, i=None) -> dict:
    """The logical counters of one solve (``i`` None) or of slot ``i`` of
    a batched one, as ints."""
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS
    pick = (lambda x: x) if i is None else (lambda x: x[i])
    return {f: int(pick(getattr(metrics, f))) for f in LOGICAL_METRIC_FIELDS}


def same_tree_up_to_ties(hg, dist, parent, want_dist, want_parent, keep,
                         what) -> int:
    """``dist`` bitwise ``want_dist`` (on ``keep``, or everywhere), and
    ``parent`` equal to ``want_parent`` except where both are exact f32
    ties: ``dist[p] + w(p, v) == dist[v]`` for both parents, over edges
    of the host graph ``hg``.  Windows are pure scheduling, so another
    window may take another of two equal candidates that arrive in
    different rounds (the reference's policies agree bitwise only on
    graphs without such ties).  Returns the number of tie parents."""
    sel = (lambda x: x) if keep is None else (lambda x: x[keep])
    if not bitwise_equal(sel(dist), sel(want_dist)):
        raise AssertionError(f"{what}: dist differs from the static solve's")
    d = dist.cpu().numpy()
    idx = torch.arange(dist.shape[0], device=dist.device)
    diff = sel(idx)[sel(parent) != sel(want_parent)].cpu().numpy()
    pa, pb = parent.cpu().numpy(), want_parent.cpu().numpy()
    for v in diff:
        for p in (int(pa[v]), int(pb[v])):
            lo, hi = hg.row_ptr[max(p, 0)], hg.row_ptr[max(p, 0) + 1]
            w = hg.w[lo:hi][hg.dst[lo:hi] == v].astype(np.float32)
            if p < 0 or not (np.float32(d[p]) + w == d[v]).any():
                raise AssertionError(
                    f"{what}: vertex {v}'s parent {p} is not a shortest-path "
                    "edge (the parents differ from the static solve's "
                    "other than at an exact tie)")
    return int(diff.size)


def slot_of(result, i):
    """Slot ``i`` of a batched ``SolveResult`` as ``(dist, parent,
    metrics)``."""
    return (result.dist[i], result.parent[i],
            type(result.metrics)(*(m[i] for m in result.metrics)))


def same_slot(batch, i, one, what):
    """Slot ``i`` of a batched result bitwise the single result ``one``
    (``(dist, parent, metrics)``): dist, parent and logical counters."""
    d, p, m = batch
    if not (bitwise_equal(d[i], one[0]) and p[i].equal(one[1])):
        raise AssertionError(f"{what} slot {i}: dist or parent differs from "
                             "the single solve's")
    if slot_metrics(m, i) != slot_metrics(one[2]):
        raise AssertionError(f"{what} slot {i}: logical counters "
                             f"{slot_metrics(m, i)} differ from the single "
                             f"solve's {slot_metrics(one[2])}")


def batch_slab_case(rng, n, m, *, block_v, tile_e, ties, n_slots, alt,
                    device):
    """A random slab (:func:`_slab_case`) and ``n_slots`` random states
    over it, each with its own window and, with ``alt``, its own ALT
    bound and prune bound.  Returns ``relax_bucket``'s batched arguments
    and keywords (``active`` to be added)."""
    (_, _, _, *slab, _, _), kw, bg = _slab_case(
        rng, n, m, block_v=block_v, tile_e=tile_e, ties=ties, lb0=False,
        device=device)
    n_out = bg.n_out
    shape = (n_slots, n_out)
    dist = (rng.integers(0, 6, shape) if ties
            else rng.random(shape) * 3).astype(np.float32)
    dist[rng.random(shape) < 0.2] = np.inf
    paths = (rng.random(shape) < rng.choice([0.01, 0.3, 1.0])) \
        & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, n_out, shape),
                      -1).astype(np.int32)
    lb = rng.choice([0.0, 1.0], n_slots).astype(np.float32)
    ub = (lb + rng.choice([3.0, np.inf], n_slots)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = (t(dist), t(paths), t(parent), *slab, t(lb), t(ub))
    if alt:
        args += (torch.stack([_alt_lb(rng, n_out, n, device, ties=ties)
                              for _ in range(n_slots)]),
                 t(rng.choice([b for _, b in ALT_BOUNDS], n_slots)
                   .astype(np.float32)))
    return args, kw


def batch_pair(args, kw, what):
    """``relax_bucket`` over slots (called twice, to catch races) against
    its plain version, ``ref.edge_relax_batch_ref``: each active slot's
    ``vals``, ``wins`` and four counters bitwise, and its scheduled-tile
    count that of ``schedule_tiles``.  Returns the kernel's and the plain
    version's outputs."""
    from repro_torch.kernels.edge_relax import ops, ref
    plain_kw = {k: v for k, v in kw.items() if k != "index"}
    want = ref.edge_relax_batch_ref(*args, **plain_kw)
    active = kw["active"].tolist()
    for _ in range(2):
        out = ops.relax_bucket(*args, **kw)
        for i in active:
            _, pn = ref.schedule_tiles(args[1][i], args[3], args[5],
                                       args[6], kw["tile_e"])
            if not (bitwise_equal(out[0][i], want[0][i])
                    and out[1][i].equal(want[1][i])
                    and out[2][i].equal(want[2][i])
                    and int(out[2][i][2]) == int(pn)):
                raise AssertionError(
                    f"edge_relax_batch {what} slot {i}: kernel "
                    f"{out[2][i].tolist()} and plain version "
                    f"{want[2][i].tolist()} (schedule_tiles: {int(pn)} "
                    "tiles) disagree")
    return out, want


def batch_vs_plain(device, seed: int = 7, n_random: int = 20) -> int:
    """The batched one-round kernel against its plain version on
    ``n_random`` seeded random slabs: slot counts 1, 3 and 8 in turn,
    with and without ALT, each over every slot, every other slot and the
    last slot alone.  Returns the number of calls checked."""
    rng = np.random.default_rng(seed)
    checked = 0
    for i in range(n_random):
        n = int(rng.integers(64, 20000))
        n_slots = (1, 3, FACADE_SLOTS)[i % 3]
        case = dict(n=n, m=int(rng.integers(0, 8 * n)),
                    block_v=int(rng.choice([64, 1024, -(-n // 256) * 256])),
                    tile_e=int(rng.choice([32, 64, 256, 512])),
                    ties=bool(rng.random() < 0.5), n_slots=n_slots,
                    alt=bool(i % 2))
        args, kw = batch_slab_case(rng, device=device, **case)
        for act in {tuple(range(n_slots)), tuple(range(0, n_slots, 2)),
                    (n_slots - 1,)}:
            kw["active"] = torch.tensor(act, dtype=torch.int32,
                                        device=device)
            batch_pair(args, kw, f"case {i} {case} active {list(act)}")
            checked += 1
    return checked


def facade_solves(results, p2p, device) -> dict:
    """Phase 3c's solves on kronecker(20,16) and road_grid(1024) through
    ``Solver``/``SolveSpec``, checked against single solves, Dijkstra and
    the launch counters (see the module docstring).  Returns the numbers
    and what :func:`facade_phase` times."""
    from repro_torch.api import EngineConfig, SolveSpec, Solver
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    out = {}
    name = "kronecker(20,16)"
    res = results[name]
    hg, dg, bg = res["host"], res["graph"], res["layout"]
    rng = np.random.default_rng(31)
    nz = np.flatnonzero(hg.deg > 0)
    srcs = [res["source"]] + [int(v) for v in rng.choice(
        nz[nz != res["source"]], FACADE_SLOTS - 1, replace=False)]
    # the yardstick: the same engine one source at a time
    single = Solver.open(dg, EngineConfig(backend="blocked"), layout=bg,
                         device=device)
    singles, single_s = [], 0.0
    for s in srcs:
        r, secs = timed(lambda: single.solve(SolveSpec.tree(s)), device)
        singles.append(tuple(r))
        single_s += secs
    solver, open_s = timed(lambda: Solver.open(dg, EngineConfig(
        backend="blocked", use_alt=True), layout=bg, device=device), device)
    if not bitwise_equal(solver.landmarks.D, p2p[name]["landmarks"].D):
        raise AssertionError(f"{name}: the session's landmark distances "
                             "differ from the p2p phase's")
    LAUNCHES.reset()
    tree, batch_s = timed(lambda: solver.solve(SolveSpec.tree(srcs)), device)
    launches = LAUNCHES.edge_relax_batch
    stray = (LAUNCHES.edge_relax, LAUNCHES.edge_relax_alt,
             LAUNCHES.edge_relax_batch_alt)
    iters = int(tree.metrics.n_host_syncs.max())
    if launches != iters or any(stray):
        raise AssertionError(
            f"{name}: the batched tree solve launched edge_relax_batch "
            f"{launches} times over {iters} iterations (one a round "
            f"expected) and (edge_relax, edge_relax_alt, "
            f"edge_relax_batch_alt) {stray} times (none expected)")
    for i in range(len(srcs)):
        same_slot(tuple(tree), i, singles[i], f"{name} tree")
    ref = scipy_dists(hg, srcs)
    for i in range(len(srcs)):
        check_against_dijkstra(ref[i], tree.dist[i])
    log(f"[facade] {name} tree x{len(srcs)}: batched {batch_s!r} s "
        f"({launches} edge_relax_batch launches, {iters} iterations) "
        f"against {single_s!r} s for the {len(srcs)} single solves; "
        f"session open (landmarks) {open_s!r} s; every slot bitwise its "
        "single solve and Dijkstra's")
    out["tree"] = dict(sources=srcs, batch_s=batch_s, single_s=single_s,
                       launches=launches, iterations=iters, open_s=open_s)

    # p2p with ALT: the p2p phase's pairs and two seeded ones
    pairs = [(q["source"], q["target"]) for q in p2p[name]["queries"]]
    pairs += pick_pairs(hg, 2, seed=32)
    exact = dict(p2p[name]["exact"])
    p2p_single_s = 0.0
    for s, t in pairs:
        one, secs = timed(lambda: solver.solve(SolveSpec.p2p(s, t)), device)
        p2p_single_s += secs
        if (s, t) not in exact:
            plain = single.solve(SolveSpec.p2p(s, t))
            exact[s, t] = (plain.dist[t:t + 1].clone(), plain.paths())
    LAUNCHES.reset()
    ps, pt = [s for s, _ in pairs], [t for _, t in pairs]
    pq, p2p_s = timed(lambda: solver.solve(SolveSpec.p2p(ps, pt)), device)
    alt_launches = LAUNCHES.edge_relax_batch_alt
    if alt_launches <= 0 or LAUNCHES.edge_relax_alt or LAUNCHES.edge_relax:
        raise AssertionError(f"{name}: the batched p2p spec launched "
                             f"edge_relax_batch_alt {alt_launches} times, "
                             f"edge_relax_alt {LAUNCHES.edge_relax_alt}")
    for i, (s, t) in enumerate(pairs):
        want_d, want_path = exact[s, t]
        if not (bitwise_equal(pq.dist[i][t:t + 1], want_d)
                and pq.paths(slot=i) == want_path):
            raise AssertionError(f"{name} batched p2p ({s}, {t}): d(s,t) or "
                                 "its path differs from the unpruned "
                                 "single-device query's")
    pruned = int(pq.metrics.n_pruned.sum())
    if pruned <= 0:
        raise AssertionError(f"{name}: the batched ALT p2p spec pruned no "
                             "candidate")
    log(f"[facade] {name} p2p x{len(pairs)} (ALT): batched {p2p_s!r} s "
        f"({alt_launches} edge_relax_batch_alt launches, n_pruned "
        f"{pruned}) against {p2p_single_s!r} s for the single ALT queries; "
        "d(s,t) and paths bitwise the unpruned queries'")
    out["p2p"] = dict(pairs=pairs, batch_s=p2p_s, single_s=p2p_single_s,
                      launches=alt_launches, pruned=pruned,
                      iterations=int(pq.metrics.n_host_syncs.max()))

    # bounded and knear with per-slot parameters
    bounds = [float(np.float32(torch.quantile(
        d[torch.isfinite(d)].double(), 0.4).item())) for d in tree.dist]
    ks = [1000, 200, 5000, 50, 1000, 300, 2000, 10][:len(srcs)]
    for goal, spec in (("bounded", SolveSpec.bounded(srcs, bounds)),
                       ("knear", SolveSpec.knear(srcs, ks))):
        r, secs = timed(lambda: solver.solve(spec), device)
        for i, gp in enumerate(spec.slot_params()):
            if not settled_as_tree(goal, gp, r.dist[i], r.parent[i],
                                   tree.dist[i], tree.parent[i]):
                raise AssertionError(f"{name} batched {goal} slot {i} "
                                     f"({gp!r}): settled entries differ "
                                     "from the tree solve's")
        log(f"[facade] {name} {goal} x{len(srcs)}: {secs!r} s, settled "
            "entries equal the tree solves'")
        out[goal] = dict(params=spec.slot_params(), seconds=secs)

    # solve_many over mixed kinds, each result its own solve
    mixed = [SolveSpec.tree(srcs[0]), SolveSpec.p2p(*pairs[0]),
             SolveSpec.knear(srcs[1:3], ks[1:3]),
             SolveSpec.bounded(srcs[3], bounds[3]),
             SolveSpec.tree(srcs[4:6]), SolveSpec.p2p(ps[1:3], pt[1:3])]
    many, many_s = timed(lambda: solver.solve_many(mixed), device)
    for spec, r in zip(mixed, many):
        one = solver.solve(spec)
        rows = range(spec.n_slots) if spec.batched else [None]
        for i in rows:
            pick = (lambda x: x) if i is None else (lambda x: x[i])
            if not (bitwise_equal(pick(r.dist), pick(one.dist))
                    and pick(r.parent).equal(pick(one.parent))
                    and slot_metrics(r.metrics, i)
                    == slot_metrics(one.metrics, i)):
                raise AssertionError(f"{name} solve_many {spec.kind}: "
                                     "differs from its own solve")
    log(f"[facade] {name} solve_many over {len(mixed)} specs of mixed "
        f"kinds: {many_s!r} s, each result equal to its own solve")
    out["solve_many_s"] = many_s

    # the fused kernel under the batch, slot by slot
    fused = Solver.open(dg, EngineConfig(backend="blocked",
                                         fused_rounds=FUSED_ROUNDS),
                        layout=bg, device=device)
    LAUNCHES.reset()
    ft, fused_s = timed(lambda: fused.solve(SolveSpec.tree(srcs)), device)
    if LAUNCHES.edge_relax_fused <= 0 or LAUNCHES.edge_relax_batch:
        raise AssertionError(f"{name}: the fused batch launched "
                             f"edge_relax_fused {LAUNCHES.edge_relax_fused} "
                             f"and edge_relax_batch "
                             f"{LAUNCHES.edge_relax_batch} times")
    for i in range(len(srcs)):
        same_slot(tuple(ft), i, slot_of(tree, i), f"{name} fused tree")
    log(f"[facade] {name} tree x{len(srcs)} fused_rounds={FUSED_ROUNDS}: "
        f"{fused_s!r} s ({LAUNCHES.edge_relax_fused} edge_relax_fused "
        "launches, slot by slot), bitwise the unfused batch")
    out["fused"] = dict(batch_s=fused_s,
                        launches=LAUNCHES.edge_relax_fused)
    out["solver"], out["single"] = solver, single

    single_road = Solver.open(results["road_grid(1024)"]["graph"],
                              EngineConfig(backend="blocked"),
                              layout=results["road_grid(1024)"]["layout"],
                              device=device)
    # the adaptive policy: kronecker's tree; on road_grid a bounded query
    # (its adaptive tree solve took 105 s on an H100, over the 90 s this
    # phase allows it)
    out["adaptive"] = {}
    for gname, r in results.items():
        sv = Solver.open(r["graph"], EngineConfig(backend="blocked",
                                                  policy="adaptive"),
                         layout=r["layout"], device=device)
        static = dict(seconds=r["solve_s"], dist=r["dist"],
                      parent=r["parent"], metrics=r["metrics"])
        if gname.startswith("road"):
            finite = r["dist"][torch.isfinite(r["dist"])]
            bound = float(np.float32(torch.quantile(
                finite.double(), ROAD_ADAPTIVE_QUANTILE).item()))
            spec = SolveSpec.bounded(r["source"], bound)
            b, secs = timed(lambda: single_road.solve(spec), device)
            static = dict(seconds=secs, dist=b.dist, parent=b.parent,
                          metrics=slot_metrics(b.metrics))
            keep = r["dist"] <= bound
        else:
            spec, keep = SolveSpec.tree(r["source"]), None
        a, secs = timed(lambda: sv.solve(spec), device)
        ties = same_tree_up_to_ties(r["host"], a.dist, a.parent,
                                    static["dist"], static["parent"], keep,
                                    f"{gname} adaptive {spec.kind}")
        kh = slice(None) if keep is None else keep.cpu().numpy()
        check_against_dijkstra(r["dijkstra"][kh],
                               torch.from_numpy(a.dist.cpu().numpy()[kh]))
        am, sm = slot_metrics(a.metrics), static["metrics"]
        log(f"[facade] {gname} adaptive {spec.kind}"
            f"{'' if keep is None else f' (bound {bound!r})'}: {secs!r} s, "
            f"steps={am['n_steps']} rounds={am['n_rounds']} against the "
            f"static solve's {static['seconds']!r} s, steps={sm['n_steps']} "
            f"rounds={sm['n_rounds']}; dist bitwise the static solve's, "
            f"parent too but at {ties} exact f32 ties, and Dijkstra's")
        out["adaptive"][gname] = dict(
            kind=spec.kind, seconds=secs, steps=am["n_steps"],
            rounds=am["n_rounds"], static_s=static["seconds"],
            static_steps=sm["n_steps"], static_rounds=sm["n_rounds"],
            tie_parents=ties)
    rname, road = "road_grid(1024)", single_road
    r = results[rname]
    n_src, k = ROAD_KNEAR
    rsrc = [int(v) for v in np.random.default_rng(33).choice(
        r["host"].n, n_src, replace=False)]
    ones, knear_single_s = [], 0.0
    for s in rsrc:
        one, secs = timed(lambda: road.solve(SolveSpec.knear(s, k)), device)
        ones.append(tuple(one))
        knear_single_s += secs
    kb, knear_s = timed(lambda: road.solve(SolveSpec.knear(rsrc, k)), device)
    for i in range(n_src):
        same_slot(tuple(kb), i, ones[i], f"{rname} knear")
    log(f"[facade] {rname} knear k={k} x{n_src}: batched {knear_s!r} s "
        f"against {knear_single_s!r} s for the single solves; every slot "
        "bitwise its single solve")
    out["road_knear"] = dict(sources=rsrc, k=k, batch_s=knear_s,
                             single_s=knear_single_s)
    return out


def batch_bound_bytes(args, kw):
    """Least bytes of one batched round: each active slot's own reads and
    writes as :func:`bound_bytes` counts them for a one-state round, the
    slab's (``src``, ``w``, ``dst``) read once for all slots (the union of
    their scheduled, path and in-window slots), the active list and the
    windows.  Also returns the sum of the slots' one-state bounds (the
    slab read once per slot), the bound of the same work as 8 calls."""
    dist, paths, parent, src, dst, w, tile_first, lb, ub, *alt = args
    e = src.shape[0]
    union = [torch.zeros(e, dtype=torch.bool, device=src.device)
             for _ in range(3)]
    shared = singles = 0
    for i in kw["active"].tolist():
        row = (dist[i], paths[i], parent[i], src, dst, w, tile_first, lb[i],
               ub[i], *((alt[0][i], alt[1][i]) if alt else ()))
        rkw = dict(tile_e=kw["tile_e"], n_out=kw["n_out"], index=kw["index"])
        slots = scheduled_slots(row, rkw)
        new, *_ = bound_bytes(row, rkw, slots, "relax_bucket")
        s = src[slots].long()
        on = paths[i][s].bool()
        cand = dist[i][s] + w[slots]
        window = on & (cand >= lb[i]) & (cand < ub[i])
        singles += new
        shared += new - 4 * (slots.shape[0] + int(on.sum())
                             + int(window.sum()))
        for u, m in zip(union, (slice(None), on, window)):
            u[slots[m]] = True
    n_active = kw["active"].shape[0]
    slab = 4 * sum(int(u.sum()) for u in union)
    return shared + slab + 12 * n_active, singles


def library_batch(args, kw, want):
    """The library yardstick of a batched round: one ``scatter_reduce_``
    (amin) of the packed keys of every active slot's in-window kept
    candidates of its scheduled tiles into ``[S * n_out]`` filled keys,
    unpacked to ``vals`` and ``wins`` (which must equal the plain
    version's on the active rows).  Returns its device ms."""
    from repro_torch.kernels.edge_relax import ref
    dist, paths, parent, src, dst, w, tile_first, lb, ub, *alt = args
    n_out, n_slots = kw["n_out"], dist.shape[0]
    active = kw["active"].tolist()
    keys_in, dsts = [], []
    for i in active:
        row = (dist[i], paths[i], parent[i], src, dst, w, tile_first)
        slots = scheduled_slots(row, kw)
        s, d = src[slots].long(), dst[slots].long()
        cand = dist[i][s] + w[slots]
        ok = paths[i][s] & (cand >= lb[i]) & (cand < ub[i])
        if alt:
            ok = ok & (cand + alt[0][i][d] <= alt[1][i])
        keys_in.append(((cand.view(torch.int32).long() << 32) | s)[ok])
        dsts.append(d[ok] + i * n_out)
    kept, k_dst = torch.cat(keys_in), torch.cat(dsts)

    def whole():
        keys = torch.full((n_slots * n_out,), ref.EMPTY_KEY,
                          dtype=torch.int64, device=w.device)
        keys.scatter_reduce_(0, k_dst, kept, "amin")
        keys = keys.reshape(n_slots, n_out)
        return ((keys >> 32).to(torch.int32).view(torch.float32),
                (keys & 0xFFFFFFFF).to(torch.int32))
    vals, wins = whole()
    for i in active:
        if not (bitwise_equal(vals[i], want[0][i])
                and wins[i].equal(want[1][i])):
            raise AssertionError("the batched library yardstick's output "
                                 "differs from the plain version's")
    return graph_ms(whole)


def batch_numbers(args, kw, what: str) -> dict:
    """One batched ``relax_bucket`` call on the main path's inputs: the
    check against the plain version (:func:`batch_pair`), its device time
    (:func:`graph_ms`) and eager time beside the same slots as one-state
    calls (all of them in one graph, and eagerly), the plain version's,
    the library yardstick's and the bounds (:func:`batch_bound_bytes`)."""
    from repro_torch.kernels.edge_relax import ops, ref
    out, want = batch_pair(args, kw, what)
    active = kw["active"].tolist()
    err = max(float((out[0][i] - want[0][i]).abs().nan_to_num(0.0).max())
              for i in active)
    dist, paths, parent, src, dst, w, tile_first, lb, ub, *alt = args
    rkw = dict(tile_e=kw["tile_e"], n_out=kw["n_out"], index=kw["index"])

    def singles():
        for i in active:
            ops.relax_bucket(dist[i], paths[i], parent[i], src, dst, w,
                             tile_first, lb[i], ub[i],
                             *((alt[0][i], alt[1][i]) if alt else ()), **rkw)
    call = lambda: ops.relax_bucket(*args, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "index"}
    bound_b, singles_b = batch_bound_bytes(args, kw)
    return dict(
        ms=graph_ms(call), eager_ms=cuda_ms(call),
        singles_ms=graph_ms(singles), singles_eager_ms=cuda_ms(singles),
        plain_ms=cuda_ms(lambda: ref.edge_relax_batch_ref(*args,
                                                          **plain_kw)),
        library_ms=library_batch(args, kw, want),
        bound_ms=bound_b / HBM_BYTES_PER_S * 1e3,
        bound_ms_singles=singles_b / HBM_BYTES_PER_S * 1e3, bytes=bound_b,
        bytes_singles=singles_b, max_abs_err=err, slots=dist.shape[0],
        active=len(active),
        counts=[out[2][i].tolist() for i in active])


def mid_batch_call(solver, spec, calls: int):
    """The arguments of the middle ``relax_bucket`` call of ``spec``
    solved again on ``solver``; it must make ``calls`` calls again."""
    with MiddleCall("relax_bucket", calls // 2) as rec:
        solver.solve(spec)
    if rec.calls != calls:
        raise AssertionError(f"the batched {spec.kind} spec made "
                             f"{rec.calls} relax_bucket calls, {calls} "
                             "before")
    # without ALT the call passes alt_lb and prune_bound as None
    return tuple(a for a in rec.args if a is not None), rec.kw


def facade_phase(results, p2p, device):
    """Phase 3c and its numbers: the batched kernel against its plain
    version, the facade's solves (:func:`facade_solves`), and the
    ``edge_relax_batch`` rows of the ``kernels`` line at the middle call
    of the batched tree and p2p specs on kronecker(20,16)."""
    from repro_torch.api import SolveSpec
    log(f"[kernel-vs-plain] edge_relax_batch: {batch_vs_plain(device)} "
        "batched calls on random slabs bitwise equal (1, 3 and 8 slots, "
        "active lists that skip slots, with and without ALT)")
    f = facade_solves(results, p2p, device)
    mark("facade solves")
    solver, name = f.pop("solver"), "kronecker(20,16)"
    f.pop("single")
    rows = []
    for key, spec, row, replaces in (
            ("tree", SolveSpec.tree(f["tree"]["sources"]),
             "edge_relax_batch", "edge_relax.py:188"),
            ("p2p", SolveSpec.p2p([s for s, _ in f["p2p"]["pairs"]],
                                  [t for _, t in f["p2p"]["pairs"]]),
             "edge_relax_batch[alt]", "edge_relax.py:158")):
        args, kw = mid_batch_call(solver, spec, f[key]["launches"])
        m = batch_numbers(args, kw, f"{key} at the batched solve's middle "
                                    "call")
        log(f"[{row}] {name} at the middle call of the batched {key} "
            f"spec: " + json.dumps(m))
        rows.append({
            "name": row, "route": "cuda",
            "source": "src/repro_torch/kernels/edge_relax/csrc/"
                      "edge_relax.cu",
            "replaces": f"src/repro/kernels/edge_relax/{replaces}",
            "launches": f[key]["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": m["library_ms"],
            "eager_ms": m["eager_ms"], "singles_ms": m["singles_ms"],
            "singles_eager_ms": m["singles_eager_ms"],
            "bound_ms_singles": m["bound_ms_singles"], "slots": m["slots"],
            "active": m["active"], "launches_per_solve": {
                name: f[key]["launches"]}})
    return rows, f


# ---------------------------------------------------------------------------
# the language-model serving path (flash_attention)
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVE = dict(max_batch=8, s_cache=4096, prompt_pad=256)
N_REQUESTS, MAX_NEW, PROMPT_LENGTHS = 12, 32, (256, 3072)
PARITY_PROMPT, PARITY_STEPS = 2048, 16
# float32 kernel path vs plain path: the same function evaluated twice in
# f32, differing only in the attention's summation order (about 1e-6
# relative per call); 1e-4 of the logits' largest magnitude leaves room
# for its growth through 28 layers
PARITY_TOL = 1e-4


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device, dtype)


def flash_check(out, want, dtype, what) -> float:
    """Max |kernel - plain|; raises beyond the stated tolerance."""
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    tol = FLASH_TOL[dtype]
    if not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash_attention {what} {dtype}: kernel and "
                             f"plain version differ by {err!r} (tolerance "
                             f"{tol})")
    return err


def flash_launches():
    """The flash kernel's launch counts: all calls and each design's."""
    from repro_torch.kernels.flash_attn import ops
    return dict(all=ops.LAUNCHES.flash_attention,
                **{n: getattr(ops.LAUNCHES, f"flash_attention_{n}")
                   for n in ops.VARIANTS})


def launches_since(before):
    now = flash_launches()
    return {n: now[n] - before[n] for n in now}


def flash_vs_plain(device, seed: int = 3):
    """``flash_attention`` against its plain version on seeded cases in
    float32 and bfloat16, each call checked to launch once, of the design
    ``ops.variant`` names; returns ``(cases, {dtype: max |err|},
    {design: cases})``."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.models.transformer import ring_positions
    rng = np.random.default_rng(seed)
    errs, n, by_kind = {}, 0, dict.fromkeys(ops.VARIANTS, 0)
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rand = lambda *shape: _randn(rng, shape, dtype, device)
        cases = []
        # the reference kernel's [B, H, S, D] form: S not a multiple of a
        # tile, GQA groups 1, 2, 8 and 16, D 64 and 128
        for b, h, hkv, s, d in ((2, 4, 4, 200, 64), (1, 8, 4, 130, 128),
                                (2, 16, 2, 67, 128), (1, 16, 8, 333, 128),
                                (3, 16, 1, 77, 64)):
            q, k, v = rand(b, h, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d)
            for causal, window in ((True, 0), (False, 0), (True, 50),
                                   (False, 33)):
                kw = dict(causal=causal, window=window)
                cases.append((f"B={b} H={h} Hkv={hkv} S={s} D={d} {kw}",
                              (s * (h // hkv), d),
                              lambda q=q, k=k, v=v, kw=kw:
                              ops.flash_attention(q, k, v, **kw),
                              lambda q=q, k=k, v=v, kw=kw:
                              ops.flash_attention_ref(q, k, v, **kw)))
        # prefill calls: S = T up to the longest padded prompt at
        # qwen3-0.6b's widths (8 KV heads of 2, D = 128), and D = 64 with
        # groups of 8; causal, non-causal and window 31
        for s, kv, hg, d in ((64, 8, 2, 128), (200, 8, 2, 128),
                             (2048, 8, 2, 128), (3072, 8, 2, 128),
                             (130, 2, 8, 64)):
            q, k, v = rand(1, s, kv, hg, d), rand(1, s, kv, d), \
                rand(1, s, kv, d)
            for causal, window in ((True, 0), (False, 0), (True, 31)):
                kw = dict(causal=causal, window=window)
                cases.append((f"prefill S=T={s} KV={kv} HG={hg} D={d} {kw}",
                              (s * hg, d),
                              lambda q=q, k=k, v=v, kw=kw:
                              ops.flash_attention_pos(q, k, v, **kw),
                              lambda q=q, k=k, v=v, kw=kw:
                              ops.flash_attention_pos_ref(q, k, v, **kw)))
        # a chunk of queries at positions 300..369 over 400 keys, at 0..T-1
        # and -1 padded
        q, k, v = rand(3, 70, 2, 4, 64), rand(3, 400, 2, 64), \
            rand(3, 400, 2, 64)
        q_pos = (300 + torch.arange(70, dtype=torch.int32, device=device)
                 ).expand(3, 70)
        pad = torch.arange(400, dtype=torch.int32, device=device).expand(
            3, 400).clone()
        pad[:, torch.from_numpy(rng.integers(0, 400, 133)).to(device)] = -1
        for name, k_pos in (("arange", None), ("padded", pad)):
            args = (q, k, v, q_pos, k_pos)
            cases.append((f"query chunk 300..369 {name}", (280, 64),
                          lambda args=args: ops.flash_attention_pos(
                              *args, causal=True),
                          lambda args=args: ops.flash_attention_pos_ref(
                              *args, causal=True)))
        # decode calls: one query per slot at its position over one layer
        # of a [L, B, T, KV, D] cache, keys at 0..T-1, -1 padded, or a ring;
        # positions past the cache, and below T - 1 with a window
        for b, kv, hg, d, t, window, below in (
                (8, 8, 2, 128, 4096, 0, False), (5, 2, 1, 64, 700, 0, False),
                (3, 1, 8, 128, 513, 0, False),
                (4, 8, 2, 128, 1024, 1024, False),
                (8, 8, 2, 128, 300, 0, True), (8, 8, 2, 128, 4096, 97, True)):
            cache = rand(2, 2, b, t, kv, d)
            kc, vc = cache[0, 1], cache[1, 1]
            q = rand(b, 1, kv, hg, d)
            pos = torch.from_numpy(rng.integers(
                0, t - 1 if below else 2 * t, b).astype(np.int32)).to(device)
            pad = torch.arange(t, dtype=torch.int32,
                               device=device).expand(b, t).clone()
            pad[:, torch.from_numpy(rng.integers(0, t, t // 4)).to(device)] = -1
            for name, k_pos in (("arange", None), ("padded", pad),
                                ("ring", ring_positions(pos, t))):
                args = (q, kc, vc, pos[:, None], k_pos)
                kw = dict(causal=True, window=window)
                cases.append((f"decode B={b} T={t} HG={hg} D={d} {name} "
                              f"{kw}", (hg, d),
                              lambda args=args, kw=kw:
                              ops.flash_attention_pos(*args, **kw),
                              lambda args=args, kw=kw:
                              ops.flash_attention_pos_ref(*args, **kw)))
        errs[key] = 0.0
        for what, (rows, d), kernel, plain in cases:
            kind = ops.variant(dtype, d, rows)
            before = flash_launches()
            got = kernel()
            launched = launches_since(before)
            if launched != dict(all=1, **{v: int(v == kind)
                                          for v in ops.VARIANTS}):
                raise AssertionError(f"flash_attention {what} {dtype}: "
                                     f"expected one {kind} launch, got "
                                     f"{launched}")
            errs[key] = max(errs[key], flash_check(got, plain(), dtype,
                                                   what))
            by_kind[kind] += 1
            n += 1
    return n, errs, by_kind


class PlainAttentionCalls:
    """Counts calls of the transformer's plain attention paths
    (``_sdpa_dense``, ``_sdpa_blockwise``, ``_sdpa_decode``) while open."""
    NAMES = ("_sdpa_dense", "_sdpa_blockwise", "_sdpa_decode")

    def __enter__(self):
        from repro_torch.models import transformer
        self.module = transformer
        self.saved = {n: getattr(transformer, n) for n in self.NAMES}
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name, fn in self.saved.items():
            setattr(transformer, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def counted(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def lm_serve(cfg, params, device):
    """The serving path at full width: ``SERVE`` answers ``N_REQUESTS``
    requests of ``MAX_NEW`` tokens.  The launch counter is zeroed just
    before the run and read just after; the engine's prefill and decode
    calls are timed (host clock, each ending in a synchronize)."""
    from repro_torch.kernels.flash_attn.ops import LAUNCHES, VARIANTS
    from repro_torch.serve.engine import Request, ServeEngine
    # warm-up: one short request (cuBLAS handles, first launches)
    warm = ServeEngine(cfg, params, max_batch=8, s_cache=512,
                       prompt_pad=256)
    warm.submit(Request(rid=-1, prompt=np.arange(300, dtype=np.int32) % cfg.vocab,
                        max_new=2))
    warm.run()
    del warm
    engine = ServeEngine(cfg, params, **SERVE)
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LENGTHS[0], PROMPT_LENGTHS[1] + 1,
                           N_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new=MAX_NEW) for i, n in enumerate(lengths)]
    st = dict(prefill=[], decode=[], first=[], nonfinite=0,
              by_design=dict(prefill=dict.fromkeys(("all",) + VARIANTS, 0),
                             decode=dict.fromkeys(("all",) + VARIANTS, 0)))
    prefill, decode = engine._prefill, engine._decode

    def count(call, before):
        for n, k in launches_since(before).items():
            st["by_design"][call][n] += k

    def timed_prefill(tokens):
        before, t = flash_launches(), time.perf_counter()
        cache, logits = prefill(tokens)
        torch.cuda.synchronize()
        now = time.perf_counter()
        st["prefill"].append((int(tokens.shape[1]), now - t))
        st["first"].append(now - t0)    # its token is the argmax just after
        count("prefill", before)
        st["nonfinite"] += int((~torch.isfinite(logits)).sum())
        return cache, logits

    def timed_decode(cache, tok):
        active = sum(r is not None for r in engine.slot_req)
        before, t = flash_launches(), time.perf_counter()
        logits, cache = decode(cache, tok)
        torch.cuda.synchronize()
        st["decode"].append((active, time.perf_counter() - t))
        count("decode", before)
        st["nonfinite"] += int((~torch.isfinite(logits)).sum())
        return logits, cache

    engine._prefill, engine._decode = timed_prefill, timed_decode
    torch.cuda.synchronize()
    LAUNCHES.reset()
    with PlainAttentionCalls() as plain:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        steps = engine.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = LAUNCHES.flash_attention
    lens = [len(r.out) for r in reqs]
    if lens != [MAX_NEW] * N_REQUESTS:
        raise AssertionError(f"served token counts {lens}, expected "
                             f"{MAX_NEW} each")
    if st["nonfinite"]:
        raise AssertionError(f"{st['nonfinite']} logits were NaN or inf")
    pre, dec = st["by_design"]["prefill"], st["by_design"]["decode"]
    if pre["all"] <= 0 or dec["all"] <= 0 or \
            launches != pre["all"] + dec["all"] or \
            pre["tc"] != pre["all"] or dec["split"] != dec["all"]:
        raise AssertionError(
            f"flash_attention launches by design in prefill {pre} and in "
            f"decode {dec} ({launches} in all): every prefill launch must "
            "be tc and every decode launch split")
    if any(plain.calls.values()):
        raise AssertionError(f"the serving path took the plain attention: "
                             f"{plain.calls}")
    pre_tok = sum(n for n, _ in st["prefill"])
    pre_s = sum(t for _, t in st["prefill"])
    dec_tok = sum(a for a, _ in st["decode"])
    dec_s = sum(t for _, t in st["decode"])
    return dict(
        requests=N_REQUESTS, max_new=MAX_NEW, engine_steps=steps,
        total_s=total_s, prompt_lengths=[int(n) for n in lengths],
        padded_prompt_lengths=[n for n, _ in st["prefill"]],
        ttft_s=st["first"], prefill_s=[t for _, t in st["prefill"]],
        prefill_tokens_per_s=pre_tok / pre_s,
        decode_steps=len(st["decode"]),
        decode_ms_per_step=dec_s / len(st["decode"]) * 1e3,
        decode_tokens_per_s=dec_tok / dec_s,
        decode_active_slots=[a for a, _ in st["decode"]],
        launches=launches, launches_prefill=pre["all"],
        launches_decode=dec["all"], launches_by_design=st["by_design"],
        plain_calls=plain.calls)


def trace_kernels(events, what: str):
    """The CUDA kernel entries of a profiled pass (its ``key_averages()``).
    A pass of work on the card whose trace holds none recorded nothing,
    which must not pass as an idle device: raises, naming the pass."""
    from torch.autograd import DeviceType
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError(f"{what}: the profiler's trace holds no CUDA "
                             "kernel")
    return kern


def lm_profile(cfg, params, device):
    """Where a served request's time goes: one 2048-token prefill and one
    decode step of 8 slots at position 2048 of a 4096-slot cache, each
    timed on the host clock (mean of 3, ending in a synchronize) and once
    under ``torch.profiler`` for the device time by kernel (the
    profiler's own host overhead is left out of the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 2048))).to(device)
    cache = T.init_cache(cfg, 8, 4096, device)
    cache["pos"].fill_(2048)
    tok = torch.zeros(8, dtype=torch.int32, device=device)
    calls = dict(prefill=lambda: T.prefill(cfg, params, tokens, 4096),
                 decode=lambda: T.decode_step(cfg, params, cache, tok))
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kern = trace_kernels(events, f"lm_profile {name}")
        ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
        device_ms = ms(kern)
        flash = [e for e in kern if "flash_fwd" in e.key]
        flash_ms = ms(flash)
        flash_by_kernel = {}
        for e in flash:
            kname = re.search(r"flash_fwd_\w+", e.key).group(0)
            flash_by_kernel[kname] = flash_by_kernel.get(kname, 0.0) + \
                ms([e])
        gemm_ms = ms(e for e in kern if any(
            w in e.key for w in ("gemm", "nvjet", "xmma", "cutlass")))
        out[name] = dict(
            wall_ms=wall_ms, device_ms=device_ms,
            device_busy_share=device_ms / wall_ms, flash_attention_ms=flash_ms,
            flash_attention_ms_by_kernel=flash_by_kernel,
            matmul_ms=gemm_ms, other_device_ms=device_ms - flash_ms - gemm_ms,
            kernels=sum(e.count for e in kern),
            host_launch_calls=sum(e.count for e in events if e.key in (
                "cudaLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")))
    return out


def lm_parity(cfg32, device):
    """The whole path, float32 then bfloat16: a ``PARITY_PROMPT``-token
    prefill and ``PARITY_STEPS`` teacher-forced decode steps through the
    kernel and through the plain attention, on the same weights."""
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = T.init_params(cfg32, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg32.vocab, (1, PARITY_PROMPT))).to(device)
    forced = torch.from_numpy(rng.integers(
        0, cfg32.vocab, (PARITY_STEPS, 1))).to(device)
    s_cache = PARITY_PROMPT + PARITY_STEPS

    def run(cfg, p, attn):
        cache, logits = T.prefill(cfg, p, prompt, s_cache, attn=attn)
        out = [logits.float()]
        for tok in forced:
            logits, cache = T.decode_step(cfg, p, cache, tok, attn=attn)
            out.append(logits.float())
        return torch.stack(out)            # [1 + steps, 1, V]

    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    p16 = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()}
               if k == "layers" else v.to(torch.bfloat16))
           for k, v in params.items()}
    res = {}
    for key, cfg, p in (("f32", cfg32, params), ("bf16", cfg16, p16)):
        kern, plain = run(cfg, p, "flash"), run(cfg, p, "plain")
        scale = float(plain.abs().max())
        gap = float((kern - plain).abs().max())
        res[key] = dict(max_abs_diff=gap, logit_scale=scale,
                        rel_to_scale=gap / scale,
                        top1_agree=float((kern.argmax(-1) == plain.argmax(-1)
                                          ).float().mean()),
                        finite=bool(torch.isfinite(kern).all()
                                    and torch.isfinite(plain).all()))
    if not (res["f32"]["finite"] and res["bf16"]["finite"]):
        raise AssertionError(f"non-finite logits in the parity run: {res}")
    if res["f32"]["rel_to_scale"] > PARITY_TOL:
        raise AssertionError(
            f"float32 whole path: kernel and plain attention differ by "
            f"{res['f32']['max_abs_diff']!r} at logit scale "
            f"{res['f32']['logit_scale']!r} (tolerance {PARITY_TOL} of it)")
    res["tolerance_f32"] = PARITY_TOL
    return res


PREFILL_LENGTHS = (256, 1024, 2048, 3072)   # S = T of a prefill call
DECODE_POSITIONS = (2048, 4095)             # of a 4096-slot cache


def measure_flash(device):
    """The kernel at qwen3-0.6b's prefill calls (S = T in
    ``PREFILL_LENGTHS``, causal) and decode calls (B = 8 slots at each of
    ``DECODE_POSITIONS`` of a 4096-slot cache), in bfloat16: its time,
    its plain version's, the library yardstick's
    (``scaled_dot_product_attention`` with ``enable_gqa``, timed only),
    its bound, the rate it reached and the design that served it; at S =
    2048 also the CUDA-core design ("simt", the only one before "tc") on
    the same call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops
    bf, h, kv, d = torch.bfloat16, 16, 8, 128
    rng = np.random.default_rng(4)
    out = {"prefill": {}, "decode": {}}
    for s in PREFILL_LENGTHS:
        q = _randn(rng, (1, s, kv, h // kv, d), bf, device)
        k, v = _randn(rng, (1, s, kv, d), bf, device), \
            _randn(rng, (1, s, kv, d), bf, device)
        qh = q.reshape(1, s, h, d).transpose(1, 2)
        calls = dict(
            kernel=lambda: ops.flash_attention_pos(q, k, v, causal=True),
            plain=lambda: ops.flash_attention_pos_ref(q, k, v, causal=True),
            library=lambda: F.scaled_dot_product_attention(
                qh, k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True).transpose(1, 2).reshape(q.shape))
        flops = 4 * d * h * (s * (s + 1) // 2)   # visible (query, key) pairs
        m = _flash_numbers(calls, flops=flops,
                           bytes_=2 * (2 * q.numel() + k.numel() + v.numel()),
                           what=f"prefill S=T={s}")
        m.update(design=ops.variant(bf, d, s * (h // kv)),
                 tflop_per_s=flops / m["ms"] / 1e9)
        if s == 2048:
            o = torch.empty_like(q)
            simt = lambda: ops._flash_cuda(q, k, v, None, None, o, True, 0,
                                           kind="simt")
            simt()
            m["simt_max_abs_err"] = flash_check(o, calls["plain"](), bf,
                                                "prefill S=T=2048 simt")
            m["simt_ms"] = graph_ms(simt)
        out["prefill"][s] = m
    b, t = 8, 4096
    cache = _randn(rng, (2, b, t, kv, d), bf, device)
    kc, vc = cache[0], cache[1]
    q = _randn(rng, (b, 1, kv, h // kv, d), bf, device)
    qh = q.reshape(b, 1, h, d).transpose(1, 2)
    for p in DECODE_POSITIONS:
        pos = torch.full((b, 1), p, dtype=torch.int32, device=device)
        mask = (torch.arange(t, device=device)[None, :] <= pos)[:, None,
                                                              None, :]
        calls = dict(
            kernel=lambda: ops.flash_attention_pos(q, kc, vc, pos, None,
                                                   causal=True),
            plain=lambda: ops.flash_attention_pos_ref(q, kc, vc, pos, None,
                                                      causal=True),
            library=lambda: F.scaled_dot_product_attention(
                qh, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                enable_gqa=True).transpose(1, 2).reshape(q.shape))
        visible = int(mask.sum())
        bytes_ = 2 * (2 * visible * kv * d + 2 * q.numel()) + 4 * b
        m = _flash_numbers(calls, flops=4 * d * h * visible, bytes_=bytes_,
                           what=f"decode B=8 at {p} of T=4096")
        m.update(design=ops.variant(bf, d, h // kv),
                 gb_per_s=bytes_ / m["ms"] / 1e6)
        out["decode"][p] = m
    return out


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed 3 times between CUDA events.  Unlike
    :func:`cuda_ms` this leaves out the host's cost of issuing a call,
    which a short kernel behind a Python wrapper can exceed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _flash_numbers(calls, *, flops, bytes_, what):
    """Device times of the three calls (:func:`graph_ms`), the kernel's
    eager time (:func:`cuda_ms`, host issue included) and the bound: the
    larger of the operations over the bf16 tensor-core rate and the bytes
    (inputs read once, output written once) over the memory rate."""
    got = calls["kernel"]()
    want = calls["plain"]()
    err = flash_check(got, want, torch.bfloat16, what)
    lib_err = float((calls["library"]().float() - want.float()).abs().max())
    op_ms = flops / BF16_FLOPS * 1e3
    byte_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ms = graph_ms(calls["kernel"])
    return dict(ms=ms, eager_ms=cuda_ms(calls["kernel"]),
                plain_ms=graph_ms(calls["plain"]),
                library_ms=graph_ms(calls["library"]),
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                bound_share=max(op_ms, byte_ms) / ms,
                flops=flops, bytes=bytes_, max_abs_err=err,
                library_max_abs_err=lib_err)


def lm_phases(device):
    """Phase 4 and its numbers; returns the ``flash_attention`` entry of
    the ``kernels`` line and the serving and parity numbers."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    cfg = get("qwen3-0.6b").make_config()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: {cfg.param_count()} parameters in {cfg.dtype}, "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    serving = lm_serve(cfg, params, device)
    serving["profile"] = lm_profile(cfg, params, device)
    del params
    for i, (n, ttft) in enumerate(zip(serving["padded_prompt_lengths"],
                                      serving["ttft_s"])):
        log(f"[serve] request {i}: prompt {serving['prompt_lengths'][i]} "
            f"tokens (padded {n}), time to first token {ttft!r} s")
    log(f"[serve] {N_REQUESTS} requests x {MAX_NEW} tokens in "
        f"{serving['total_s']!r} s over {serving['engine_steps']} engine "
        f"steps: prefill {serving['prefill_tokens_per_s']!r} tokens/s, "
        f"decode {serving['decode_ms_per_step']!r} ms/step "
        f"({serving['decode_tokens_per_s']!r} tokens/s), flash_attention "
        f"launches {serving['launches_prefill']} in prefill + "
        f"{serving['launches_decode']} in decode (by design: "
        f"{json.dumps(serving['launches_by_design'])}), plain attention "
        f"calls {sum(serving['plain_calls'].values())}")
    for key, m in serving["profile"].items():
        log(f"[profile] {key}: " + json.dumps(m))
    parity = lm_parity(dataclasses.replace(cfg, dtype=torch.float32), device)
    for key in ("f32", "bf16"):
        log(f"[parity] {key}: kernel vs plain attention over a "
            f"{PARITY_PROMPT}-token prefill and {PARITY_STEPS} decode steps: "
            + json.dumps(parity[key]))
    numbers = measure_flash(device)
    for call, by in numbers.items():
        for key, m in by.items():
            where = f"S=T={key}" if call == "prefill" else f"position {key}"
            log(f"[flash_attention] {call} {where}: " + json.dumps(m))
    pre, dec = numbers["prefill"][2048], numbers["decode"][4095]
    kernel = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:77",
        "launches": serving["launches"],
        "max_abs_err": max(m["max_abs_err"] for by in numbers.values()
                           for m in by.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "shape": "prefill: S = T = 2048, 16 heads over 8 KV heads, D = 128, "
                 "causal, bf16",
        "design": pre["design"],
        "simt_ms": pre["simt_ms"],
        "decode": dict(dec, shape="B = 8 at position 4095 of T = 4096, all "
                                  "keys visible, bf16"),
        "variants": {pre["design"]: "prefill", dec["design"]: "decode"},
        "launches_prefill": serving["launches_prefill"],
        "launches_decode": serving["launches_decode"],
        "launches_by_design": serving["launches_by_design"],
        "prefill_ms_by_length": {s: m["ms"] for s, m in
                                 numbers["prefill"].items()},
        "decode_ms_by_position": {p: m["ms"] for p, m in
                                  numbers["decode"].items()},
    }
    return dict(kernel=kernel, serving=serving, parity=parity)


# ---------------------------------------------------------------------------
# the recsys serving path (embedding_bag)
# ---------------------------------------------------------------------------

RECSYS_SHAPES = ("serve_p99", "serve_bulk")
N_CANDIDATES = 1_000_000
CPU_USERS, CPU_CANDIDATES = 64, 65_536
# card vs CPU for MIND in f32 with TF32 off: the same functions, the
# einsums summed in another order (about 1e-7 of the scale measured on
# the CPU between torch and XLA); rtol, and atol as a share of the
# largest magnitude
MIND_TOL = 1e-5
F32_FLOPS = 67e12                  # H100 SXM f32 rate outside the tensor cores


def same_bits(out, want) -> bool:
    """Bitwise equal, with NaN at the same places."""
    nan = torch.isnan(want)
    return bool(torch.isnan(out).equal(nan)) and bitwise_equal(
        out.masked_fill(nan, 0), want.masked_fill(nan, 0))


class PlainBagCalls:
    """Counts calls of ``embedding_bag``'s plain versions through the
    wrapper (``ops.embedding_bag_ref``, ``ops.embedding_bag_masked_ref``)
    while open."""

    NAMES = ("embedding_bag_ref", "embedding_bag_masked_ref")

    def __enter__(self):
        from repro_torch.kernels.embedding_bag import ops
        self.ops, self.calls = ops, 0
        self.saved = {n: getattr(ops, n) for n in self.NAMES}

        def counted(fn):
            def call(*args, **kw):
                self.calls += 1
                return fn(*args, **kw)
            return call
        for n, fn in self.saved.items():
            setattr(ops, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)


def bag_vs_plain(table, batches, device, seed: int = 5) -> int:
    """Both entries of ``embedding_bag`` against their plain versions,
    bitwise, each case through the wrapper twice; returns the number of
    cases."""
    from repro_torch.kernels.embedding_bag import ops, ref
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    bmask = lambda a: torch.from_numpy(np.asarray(a, bool)).to(device)
    cases = []          # (what, table, ids, weights or mask, mode, masked)
    # the reference kernel test's 12 shapes x modes x weights
    for (v, d, b, l), mode, weighted in itertools.product(
            ((64, 16, 4, 3), (300, 32, 8, 7), (1000, 64, 2, 20)),
            ("sum", "mean"), (False, True)):
        t = f32(rng.normal(0, 1, (v, d)))
        w = f32(rng.random((b, l))) if weighted else None
        cases.append((f"V={v} D={d} B={b} L={l} {mode} w={weighted}", t,
                      i32(rng.integers(0, v, (b, l))), w, mode, False))
    t = f32(rng.normal(0, 1, (300, 64)))
    w0 = rng.random((6, 9))
    w0[2] = 0.0
    cases += [("L=1", t, i32(rng.integers(0, 300, (40, 1))), None, "sum",
               False),
              ("L=1 mean", t, i32(rng.integers(0, 300, (40, 1))),
               f32(rng.random((40, 1))), "mean", False),
              ("zero-weight bag, mean", t,
               i32(rng.integers(0, 300, (6, 9))), f32(w0), "mean", False),
              ("ids -1, -V, V, 2V", t,
               i32([[-1, -300, 300, 600], [5, -1, 600, -301]]),
               f32(rng.random((2, 4))), "mean", False)]
    tb = t.to(torch.bfloat16)
    for mode in ("sum", "mean"):
        cases.append((f"bf16 table {mode}", tb,
                      i32(rng.integers(0, 300, (33, 17))), None, mode, False))
    for name in RECSYS_SHAPES:
        hist, mask = batches[name]
        for mode in ("sum", "mean"):
            cases.append((f"MIND {name} {mode}", table, hist, mask.float(),
                          mode, False))
    # the masked entry: Zipf ids (rows repeat within a chunk of 32), a
    # masked-in id outside [-V, V) in bag 0, ids -1 and -V (wrap), masked-out
    # ids outside [-V, V) (not read), an all-masked bag; L from 0 to 200
    # (0 to 7 chunks), rows of 64 B to 2 KB (one to eight 256-byte slices)
    for (v, d, b, l), mode in itertools.product(
            ((64, 16, 4, 3), (300, 32, 8, 7), (1000, 64, 2, 20),
             (500, 64, 512, 50), (2000, 128, 100, 65), (3000, 512, 64, 200),
             (50, 16, 9, 0), (70, 64, 40, 1), (4000, 64, 6000, 130),
             (900, 512, 3000, 65)), ("sum", "mean")):
        ids = (rng.zipf(1.2, (b, l)) - 1) % v
        ids[rng.random((b, l)) < 0.05] = -1
        ids[rng.random((b, l)) < 0.02] = -v
        mask = rng.random((b, l)) < 0.75
        ids = np.where(mask, ids, 2 * v + 1)
        if l:
            ids[0, l // 2], mask[0, l // 2] = v + 5, True
        mask[b - 1] = False
        for dt in ((torch.float32, torch.bfloat16) if d in (64, 512)
                   else (torch.float32,)):
            cases.append((f"masked V={v} D={d} B={b} L={l} {mode} {dt}",
                          f32(rng.normal(0, 1, (v, d))).to(dt), i32(ids),
                          bmask(mask), mode, True))
    t = f32(rng.normal(0, 1, (80, 64)))
    t[0, 3], t[0, 5], t[7, ::2] = float("inf"), float("nan"), float("nan")
    ids = rng.integers(1, 80, (50, 30))
    ids[ids == 7] = 8
    mask = rng.random((50, 30)) < 0.7
    ids = np.where(mask, ids, rng.choice([0, 7], (50, 30)))
    ids[3, 4], mask[3, 4] = 0, True
    for mode in ("sum", "mean"):
        cases += [(f"masked, rows 0 and 7 not finite {mode}", t, i32(ids),
                   bmask(mask), mode, True),
                  (f"masked, no mask {mode}", t[8:].contiguous(),
                   i32(rng.integers(-72, 72, (30, 50))), None, mode, True)]
    for name in RECSYS_SHAPES:
        hist, mask = batches[name]
        for mode in ("sum", "mean"):
            cases.append((f"masked MIND {name} {mode}", table, hist, mask,
                          mode, True))
    for what, t, ids, aux, mode, masked in cases:
        wrapper = ops.embedding_bag_masked if masked else ops.embedding_bag
        plain = (ref.embedding_bag_masked_ref if masked
                 else ref.embedding_bag_ref)
        outs = [wrapper(t, ids, aux, mode=mode), wrapper(t, ids, aux,
                                                        mode=mode)]
        want = plain(t, ids, aux, mode=mode)
        torch.cuda.synchronize()
        for got in outs:
            if not same_bits(got, want):
                err = float((got - want).abs().max())
                raise AssertionError(f"embedding_bag {what}: kernel and "
                                     f"plain version differ (max |err| "
                                     f"{err!r})")
    return len(cases)


def recsys_layer(table, batches, device):
    """The embedding layer's main path: ``embedding_bag_batched`` over the
    full table at both serve shapes, sum and mean, then a batch with ids
    outside ``[-V, V)``, then the serve_p99 batch with row 0 holding inf
    and NaN; one launch of the kernel's masked entry a call, none of the
    weighted entry and no plain-version call.  Each output bitwise equal
    to the masked entry's plain version on the card, and on the finite
    table to the parent's layer (the weighted entry over ``bag_inputs``'
    ids and weights, plain); NaN bags exactly where the reference has
    them; with the non-finite row 0, inf and NaN exactly in the bags that
    look row 0 up masked in, every other value finite.  Returns the
    launches."""
    from repro_torch.kernels.embedding_bag import ref
    from repro_torch.kernels.embedding_bag.ops import LAUNCHES
    from repro_torch.models.recsys.embedding import (bag_inputs,
                                                     embedding_bag_batched)
    v = table.shape[0]
    hist, mask = batches["serve_p99"]
    bad_h, bad_m = hist.clone(), mask.clone()
    for (row, col, bad, live) in ((0, 0, v, True), (1, 3, 2 * v, True),
                                  (2, 5, -v - 1, True), (3, 1, -1, True),
                                  (4, 0, 2 * v, False), (5, 2, -v, True)):
        bad_h[row, col], bad_m[row, col] = bad, live
    runs = [(f"{n} {mode}", *batches[n], mode)
            for n in RECSYS_SHAPES for mode in ("sum", "mean")]
    runs += [(f"serve_p99 with ids outside [-V, V) {mode}", bad_h, bad_m,
              mode) for mode in ("sum", "mean")]

    def layer(what, h, m, mode):
        before = (LAUNCHES.embedding_bag, LAUNCHES.embedding_bag_masked)
        out = embedding_bag_batched(table, h, m, mode=mode)
        after = (LAUNCHES.embedding_bag, LAUNCHES.embedding_bag_masked)
        if after != (before[0], before[1] + 1):
            raise AssertionError(f"embedding layer {what}: launches of the "
                                 f"weighted and masked entries went from "
                                 f"{before} to {after}, expected one masked")
        return out
    LAUNCHES.reset()
    with PlainBagCalls() as plain:
        outs = [layer(*run) for run in runs]
        saved = table[0].clone()
        table[0, 3], table[0, 5] = float("inf"), float("nan")
        try:
            inf_runs = [(mode, layer(f"row 0 not finite {mode}", hist, mask,
                                     mode),
                         ref.embedding_bag_masked_ref(table, hist, mask,
                                                      mode=mode))
                        for mode in ("sum", "mean")]
            torch.cuda.synchronize()
        finally:
            table[0] = saved
    launches = LAUNCHES.embedding_bag_masked
    if plain.calls or LAUNCHES.embedding_bag:
        raise AssertionError(f"the embedding layer ran the plain versions "
                             f"{plain.calls} times and the weighted entry "
                             f"{LAUNCHES.embedding_bag} times on the card")
    for (what, h, m, mode), out in zip(runs, outs):
        want = ref.embedding_bag_masked_ref(table, h, m, mode=mode)
        old = ref.embedding_bag_ref(table, *bag_inputs(v, h, m), mode=mode)
        if not (same_bits(out, want) and same_bits(out, old)):
            raise AssertionError(f"embedding layer {what}: differs from the "
                                 f"plain versions on the card")
    # the reference: a bag is NaN iff a masked-in id lies outside [-V, V)
    hn, mn = bad_h.cpu().numpy().astype(np.int64), bad_m.cpu().numpy()
    want_nan = (mn & ((hn < -v) | (hn >= v))).any(1)
    for out in outs[-2:]:
        got_nan = torch.isnan(out).any(1).cpu().numpy()
        if not (np.array_equal(got_nan, want_nan) and bool(
                torch.isnan(out[torch.from_numpy(want_nan).to(device)]).all())):
            raise AssertionError(f"embedding layer: NaN bags at "
                                 f"{np.flatnonzero(got_nan)}, the reference "
                                 f"has them at {np.flatnonzero(want_nan)}")
        if not bool(out[torch.from_numpy(~want_nan).to(device)].isfinite().all()):
            raise AssertionError("embedding layer: a non-finite bag where "
                                 "the reference has none")
    # the reference with inf at row 0, column 3 and NaN at column 5: those
    # two columns of a bag that looks row 0 up masked in, nothing else
    row0 = ((torch.where(hist < 0, hist + v, hist) == 0) & mask).any(1)
    want_bad = torch.zeros_like(inf_runs[0][1], dtype=torch.bool)
    want_bad[row0, 3] = want_bad[row0, 5] = True
    for mode, out, want in inf_runs:
        if not (same_bits(out, want)
                and bool(torch.isnan(out[:, 5]).equal(row0))
                and bool(torch.isinf(out[:, 3]).equal(row0))
                and bool((~out.isfinite()).equal(want_bad))):
            raise AssertionError(f"embedding layer, row 0 not finite, {mode}: "
                                 f"{int((~out.isfinite()).any(1).sum())} "
                                 f"bags not finite, the reference has "
                                 f"{int(row0.sum())}")
    return dict(launches=launches, weighted_launches=LAUNCHES.embedding_bag,
                plain_calls=plain.calls, calls=len(runs) + len(inf_runs),
                nan_bags=np.flatnonzero(want_nan).tolist(),
                row0_bags=int(row0.sum()))


def mind_serving(cfg, params, batches, device):
    """MIND's serving path on the card: interests at both serve shapes and
    user 0's scores over ``N_CANDIDATES`` ids (numpy seed 1); finite,
    interest norms below 1, and the first ``CPU_USERS`` users' interests
    and first ``CPU_CANDIDATES`` scores within ``MIND_TOL`` of the same
    functions on the CPU.  Returns their times and gaps."""
    from repro_torch.models.recsys.mind import (retrieval_scores,
                                                serve_interests)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cand = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.n_items, N_CANDIDATES).astype(np.int32)).to(device)
    cpu = {k: p.cpu() for k, p in params.items()}
    out, interests = {}, {}

    def check(what, got, want):
        scale = float(want.abs().max())
        gap = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, rtol=MIND_TOL,
                              atol=MIND_TOL * scale):
            raise AssertionError(f"MIND {what}: card and CPU differ by "
                                 f"{gap!r} at scale {scale!r}")
        return dict(max_abs_diff=gap, scale=scale)

    for name in RECSYS_SHAPES:
        hist, mask = batches[name]
        batch = {"hist": hist, "hist_mask": mask}
        u = serve_interests(cfg, params, batch)
        torch.cuda.synchronize()
        norms = u.norm(dim=-1)
        if not (bool(u.isfinite().all()) and bool((norms < 1).all())):
            raise AssertionError(f"MIND {name}: interests not finite or a "
                                 f"norm >= 1 (max {float(norms.max())!r})")
        small = {k: x[:CPU_USERS].cpu() for k, x in batch.items()}
        interests[name] = u
        b = hist.shape[0]
        ms = cuda_ms(lambda: serve_interests(cfg, params, batch), reps=5)
        out[name] = dict(users=b, serve_interests_ms=ms,
                         users_per_s=b / ms * 1e3,
                         max_interest_norm=float(norms.max()),
                         vs_cpu=check(f"{name} interests",
                                      u[:CPU_USERS],
                                      serve_interests(cfg, cpu, small)))
    u0 = interests["serve_p99"][0]
    scores = retrieval_scores(cfg, params, u0, cand)
    torch.cuda.synchronize()
    if not (scores.shape == (N_CANDIDATES,) and bool(scores.isfinite().all())):
        raise AssertionError("MIND retrieval: scores not finite")
    ms = cuda_ms(lambda: retrieval_scores(cfg, params, u0, cand), reps=5)
    out["retrieval_cand"] = dict(
        candidates=N_CANDIDATES, retrieval_scores_ms=ms,
        candidates_per_s=N_CANDIDATES / ms * 1e3,
        vs_cpu=check("retrieval scores", scores[:CPU_CANDIDATES],
                     retrieval_scores(cfg, cpu, u0.cpu(),
                                      cand[:CPU_CANDIDATES].cpu())))
    out["tolerance"] = MIND_TOL
    return out


def measure_bag(table, hist, mask):
    """Both entries at a serve shape, in sum and mean.  The weighted entry
    (row 5, the Pallas kernel's counterpart) as the parent's layer called
    it, on ``bag_inputs``' ids and 0/1 weights; the masked entry as the
    layer calls it now, on the raw ids and mask.  For each: its device
    time by CUDA-graph replay and eager (:func:`in_turns`, with
    ``--parent`` beside the parent's design on the same inputs in turns:
    the parent's kernel for the weighted entry, the parent's whole layer
    for the masked one), its plain version's (eager),
    ``torch.nn.functional.embedding_bag``'s by graph replay (timed only:
    the port never calls it; the mean as its weighted sum and a divide,
    the masked entry's mask as f32 weights made beforehand) and the byte
    bound: each distinct row once (masked: each distinct masked-in row),
    8 B a lookup (masked: 5), the f32 output."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.models.recsys.embedding import bag_inputs
    v, d = table.shape
    kid, w = bag_inputs(v, hist, mask)
    b, l = kid.shape
    live = torch.where(hist < 0, hist + v, hist)[mask]
    live = live[(live >= 0) & (live < v)]
    parent_bag = parent_layer = None
    if PARENT is not None:
        parent_bag = importlib.import_module(
            "parent_repro_torch.kernels.embedding_bag.ops").embedding_bag
        parent_layer = importlib.import_module(
            "parent_repro_torch.models.recsys.embedding").embedding_bag_batched

    def library(ids, weights, mode):
        def call():
            s = F.embedding_bag(ids, table, per_sample_weights=weights,
                                mode="sum")
            return s if mode == "sum" else \
                s / weights.sum(1, keepdim=True).clamp_min(1e-9)
        return call

    def weighted(mode):
        return dict(
            kernel=lambda: ops.embedding_bag(table, kid, w, mode=mode),
            plain=lambda: ref.embedding_bag_ref(table, kid, w, mode=mode),
            parent=parent_bag and (lambda: parent_bag(table, kid, w,
                                                      mode=mode)),
            library=library(kid, w, mode))

    def masked(mode):
        return dict(
            kernel=lambda: ops.embedding_bag_masked(table, hist, mask,
                                                    mode=mode),
            plain=lambda: ref.embedding_bag_masked_ref(table, hist, mask,
                                                       mode=mode),
            parent=parent_layer and (lambda: parent_layer(table, hist, mask,
                                                          mode=mode)),
            library=library(hist, mask.float(), mode))
    # entry: (its calls by mode, distinct rows read, bytes a lookup)
    entries = {"weighted": (weighted, int(torch.unique(kid).numel()), 8),
               "masked": (masked, int(torch.unique(live).numel()), 5)}
    res = dict(bags=b, lookups=b * l, live_lookups=int(mask.sum()))
    for name, (calls, distinct, per_lookup) in entries.items():
        bytes_ = distinct * d * table.element_size() + b * l * per_lookup \
            + b * d * 4
        out = res[name] = dict(distinct_rows=distinct, bytes=bytes_)
        for mode in ("sum", "mean"):
            flops = 2 * b * l * d + (b * d if mode == "mean" else 0)
            byte_ms = bytes_ / HBM_BYTES_PER_S * 1e3
            op_ms = flops / F32_FLOPS * 1e3
            c = calls(mode)
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"embedding_bag {name} {mode} at B={b}: "
                                     f"kernel and plain version differ")
            if c["parent"] is not None and not same_bits(c["parent"](), want):
                raise AssertionError(f"embedding_bag {name} {mode} at B={b}: "
                                     f"the parent's design differs")
            times = in_turns(c["kernel"], c["parent"])
            out[mode] = dict(
                times, graph_ms=times["ms"], plain_ms=cuda_ms(c["plain"]),
                library_ms=graph_ms(c["library"]),
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                flops=flops, max_abs_err=float((got - want).abs().max()),
                library_max_abs_err=float(
                    (c["library"]() - want).abs().max()))
    return res


def bag_designs(table, batches):
    """The kernel against copies of it with one path at every batch
    (``staged``, ``direct``) and with bulk staging (``bulk``), built and
    timed by ``tools/embedding_bag_grid.py`` (its ``build_copies`` and
    ``design_times``: both entries, sum, graph ms in turns, each copy
    bitwise equal to the kernel) at each serve shape."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "embedding_bag_grid",
        Path(__file__).resolve().parent / "tools" / "embedding_bag_grid.py")
    grid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(grid)
    libs = grid.build_copies()
    return {name: grid.design_times(libs, table, *batches[name])
            for name in RECSYS_SHAPES}


def recsys_profile(cfg, params, batches, device):
    """Where the recsys path's time goes: :func:`profile_pass` of the
    embedding layer at ``serve_bulk`` (mean), ``serve_interests`` at both
    shapes and ``retrieval_scores`` over ``N_CANDIDATES``."""
    from repro_torch.models.recsys.mind import (retrieval_scores,
                                                serve_interests)
    cand = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.n_items, N_CANDIDATES).astype(np.int32)).to(device)
    as_batch = lambda n: dict(zip(("hist", "hist_mask"), batches[n]))
    u0 = serve_interests(cfg, params, as_batch("serve_p99"))[0]
    calls = {
        "layer serve_bulk mean": layer_call(params, batches),
        **{f"serve_interests {n}": (lambda n=n: serve_interests(
            cfg, params, as_batch(n))) for n in RECSYS_SHAPES},
        "retrieval_scores": lambda: retrieval_scores(cfg, params, u0, cand)}
    return {name: profile_pass(name, fn) for name, fn in calls.items()}


def layer_call(params, batches):
    """The embedding layer at ``serve_bulk``, mean: the profiled call."""
    from repro_torch.models.recsys.embedding import embedding_bag_batched
    return lambda: embedding_bag_batched(
        params["item_embed"], *batches["serve_bulk"], mode="mean")


def profile_pass(name, fn, *, empty_ok: bool = False):
    """``fn`` timed on the host clock (mean of 3, ending in a synchronize)
    and once under ``torch.profiler``: device time, its share of the wall
    time, the kernels launched and the four costliest by device time.  An
    empty trace raises (:func:`trace_kernels`) unless ``empty_ok``; a pass
    of the embedding layer fails if it launches more than one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kern = ([e for e in events if e.device_type == DeviceType.CUDA]
            if empty_ok else trace_kernels(events, f"recsys_profile {name}"))
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               device_busy_share=device_ms / wall_ms,
               kernels=sum(e.count for e in kern),
               top=[(e.key[:60], e.self_device_time_total / 1e3)
                    for e in top])
    if name.startswith("layer") and out["kernels"] > 1:
        raise AssertionError(f"recsys_profile {name}: {out['kernels']} "
                             f"kernels, expected one launch of the masked "
                             f"entry: {out['top']}")
    return out


def recsys_inputs(device):
    """MIND's config, its parameters drawn on ``device`` from a generator
    seeded with 0, and ``{shape: (hist, hist_mask)}`` for
    ``RECSYS_SHAPES`` from ``RecsysStream(seed=0)`` at step 0."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import RecsysStream
    from repro_torch.models.recsys.mind import init_params
    mind = get("mind")
    cfg = mind.make_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    table = params["item_embed"]
    log(f"[recsys] {cfg.name}: item table {tuple(table.shape)} {table.dtype} "
        f"({table.numel() * table.element_size() / 1e9:.2f} GB) drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    stream = RecsysStream(cfg.n_items, cfg.hist_len, seed=0)
    batches = {}
    for name in RECSYS_SHAPES:
        b = stream.batch(0, mind.SHAPES[name]["batch"])
        batches[name] = (torch.from_numpy(b["hist"]).to(device),
                         torch.from_numpy(b["hist_mask"]).to(device))
    return cfg, params, batches


def recsys_profiled(device):
    """The recsys path's profiled passes (:func:`recsys_profile`), run
    right after the build: late in the run, after the other phases, the
    layer's pass (one kernel, under a millisecond) came back with no
    kernel in its trace three times, though it records its kernel when
    it comes first.  :func:`recsys_phases` profiles the layer late once
    more and prints what that trace holds."""
    cfg, params, batches = recsys_inputs(device)
    profiled = recsys_profile(cfg, params, batches, device)
    for name, m in profiled.items():
        log(f"[profile] {name}: " + json.dumps(m))
    del params, batches
    torch.cuda.empty_cache()
    return profiled


def recsys_phases(device, profiled):
    """Phase 5 and its numbers, with the profiled passes' results
    (:func:`recsys_profiled`); returns the ``embedding_bag`` entry of the
    ``kernels`` line and the recsys numbers."""
    cfg, params, batches = recsys_inputs(device)
    table = params["item_embed"]
    n_cases = bag_vs_plain(table, batches, device)
    log(f"[kernel-vs-plain] embedding_bag and embedding_bag_masked: "
        f"{n_cases} seeded cases bitwise equal (each through the wrapper "
        f"twice)")
    layer = recsys_layer(table, batches, device)
    log(f"[recsys] embedding layer: {layer['calls']} calls of "
        f"embedding_bag_batched over the full table, {layer['launches']} "
        f"launches of the masked entry, {layer['weighted_launches']} of the "
        f"weighted, {layer['plain_calls']} plain-version calls, bitwise "
        f"equal to both plain versions; NaN bags {layer['nan_bags']} as the "
        f"reference; row 0 not finite: {layer['row0_bags']} bags with inf "
        f"and NaN where the reference has them, the rest finite")
    serving = mind_serving(cfg, params, batches, device)
    serving["profile"] = profiled
    # the probe of the empty trace: the layer's pass again, late in the
    # run, recorded whatever its trace holds (an empty one does not fail)
    late = profile_pass("layer serve_bulk mean", layer_call(params, batches),
                        empty_ok=True)
    serving["profile_late"] = late
    log("[profile] layer serve_bulk mean, late in the run (a probe; an "
        "empty trace is recorded, not failed): " + json.dumps(late))
    for key in (*RECSYS_SHAPES, "retrieval_cand"):
        log(f"[recsys] MIND {key}: " + json.dumps(serving[key]))
    numbers = {name: measure_bag(table, *batches[name])
               for name in RECSYS_SHAPES}
    for name, m in numbers.items():
        log(f"[embedding_bag] {name}: " + json.dumps(m))
    design = bag_designs(table, batches)
    for name, m in design.items():
        log(f"[embedding_bag design] {name} (graph ms, sum, in turns; "
            f"kernel: staged at a small batch, direct at a large one; "
            f"staged, direct: that path at every batch; bulk: staged with "
            f"one cp.async.bulk a row): " + json.dumps(m))
    del params, table, batches
    torch.cuda.empty_cache()
    bulk = numbers["serve_bulk"]
    keys = ("ms", "graph_ms", "eager_ms", "parent_ms", "parent_eager_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    row = lambda m: {k: m[k] for k in keys}
    entry = lambda name: dict(
        row(bulk[name]["sum"]), distinct_rows=bulk[name]["distinct_rows"],
        mean=row(bulk[name]["mean"]),
        serve_p99={mode: row(numbers["serve_p99"][name][mode])
                   for mode in ("sum", "mean")})
    kernel = {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:48",
        "entry": "embedding_bag_masked_launch",
        "launches": layer["launches"],
        "launches_by_entry": {
            "embedding_bag_launch": layer["weighted_launches"],
            "embedding_bag_masked_launch": layer["launches"]},
        **entry("masked"),
        "max_abs_err": max(m[e][mode]["max_abs_err"]
                           for m in numbers.values()
                           for e in ("weighted", "masked")
                           for mode in ("sum", "mean")),
        "shape": "serve_bulk: B = 262,144 bags of L = 50 over the 10^7 x 64 "
                 "f32 MIND table, the masked entry on the layer's raw ids "
                 "and mask, sum",
        "lookups": bulk["lookups"],
        "design": design,
        "weighted": dict(entry("weighted"), entry="embedding_bag_launch",
                         launches=layer["weighted_launches"],
                         shape="serve_bulk, bag_inputs' ids and 0/1 "
                               "weights, sum: row 5, the Pallas kernel's "
                               "counterpart"),
    }
    return dict(kernel=kernel, layer=layer, serving=serving)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: time its "
                    "edge-relax and embedding_bag kernels on the same "
                    "inputs as this tree's")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Kineto tears CUPTI down after each profiled pass and sets it up again
    # lazily at the next; with CUDA graphs captured in between (graph_ms)
    # that re-init is what PyTorch's own profiler turns off
    # (torch/profiler/profiler.py, "CUDA Graph does not work well with
    # CUPTI teardown"), and a later pass can then record no kernel.
    os.environ["TEARDOWN_CUPTI"] = "0"
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import tempfile

    import torch.distributed as tdist
    from repro_torch.data.generators import kronecker, road_grid
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    if opts.parent:
        global PARENT
        t0 = time.perf_counter()
        PARENT = load_parent(opts.parent)
        log(f"[build] the parent's kernels from {opts.parent} in "
            f"{time.perf_counter() - t0:.2f} s")
    profiled = recsys_profiled(device)
    mark("recsys profiled passes")

    log(f"[kernel-vs-plain] edge_relax: {kernel_vs_plain(device)} random "
        "slab cases bitwise equal")
    log(f"[kernel-vs-plain] edge_relax_fused: {fused_vs_plain(device)} "
        "random slab cases bitwise equal")
    log(f"[kernel-vs-plain] edge_relax[alt] and edge_relax_fused[alt]: "
        f"{alt_vs_plain(device)} random slab cases bitwise equal")
    n_flash, flash_err, flash_kinds = flash_vs_plain(device)
    log(f"[kernel-vs-plain] flash_attention: {n_flash} seeded cases within "
        f"tolerance (max |err| f32 {flash_err['f32']!r}, bf16 "
        f"{flash_err['bf16']!r}), cases by design {flash_kinds}")
    mark("phase 2")

    t0 = time.perf_counter()
    graphs = [("kronecker(20,16)", kronecker(**KRON)),
              ("road_grid(1024)", road_grid(**ROAD))]
    log(f"[data] generated in {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{n}: n={g.n} m={g.m}" for n, g in graphs))
    with tempfile.TemporaryDirectory() as store_dir:
        init_group(store_dir)
        try:
            kernels, solves = report(graphs, device)
        finally:
            tdist.destroy_process_group()
    del graphs

    lm = lm_phases(device)
    mark("phase 4 (language model)")
    kernels.append(lm["kernel"])
    torch.cuda.empty_cache()
    recsys = recsys_phases(device, profiled)
    mark("phase 5 (recsys)")
    kernels.append(recsys["kernel"])
    print(json.dumps({"kernels": kernels}), flush=True)
    log(json.dumps(solves))
    log(json.dumps({"serving": lm["serving"], "parity": lm["parity"]}))
    log(json.dumps({"recsys": {"layer": recsys["layer"],
                               "mind": recsys["serving"]}}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def report(graphs, device):
    """Phase 3 and the shortest-path numbers, under the process group;
    returns the edge-relax ``kernels`` entries and the solves' numbers."""
    warm_up(device)
    results = main_path(graphs, device)
    mark("tree solves")
    p2p = p2p_path(results, device)
    log(f"[kernel-vs-plain] edge_relax_partials: "
        f"{partials_vs_plain(results, device)} shard calls bitwise equal")
    sharded_path(results, device)
    mark("v1 engine")
    v1q = v1_queries(results, p2p, device)
    log(f"[kernel-vs-plain] edge_relax_partials[alt]: "
        f"{partials_alt_vs_plain(results, v1q, device)} shard calls bitwise "
        "equal")
    mark("v1 queries")
    facade_rows, facade = facade_phase(results, p2p, device)
    mark("phase 3c (facade)")

    per_graph = {name: measure(res, device) for name, res in results.items()}
    for name, m in per_graph.items():
        log(f"[edge_relax] {name}: " + json.dumps(m))
    fused = {name: measure_fused(res, device)
             for name, res in results.items()}
    for name, m in fused.items():
        log(f"[edge_relax_fused] {name}: " + json.dumps(m))
    partials = {name: measure_partials(res, device)
                for name, res in results.items()}
    for name, m in partials.items():
        log(f"[edge_relax_partials] {name}: " + json.dumps(m))
    partials_alt = {name: measure_partials_alt(res, v1q[name]["middle"],
                                               device)
                    for name, res in results.items()}
    for name, m in partials_alt.items():
        log(f"[edge_relax_partials[alt]] {name}: " + json.dumps(m))
    alt = {name: measure_alt(res, p2p[name]["landmarks"],
                             p2p[name]["queries"][0], device)
           for name, res in results.items()}
    for name, m in alt.items():
        log(f"[edge_relax[alt]] {name}: " + json.dumps(m))
    fused_alt = {name: measure_fused_alt(res, p2p[name]["landmarks"],
                                         p2p[name]["queries"][0], device)
                 for name, res in results.items()}
    for name, m in fused_alt.items():
        log(f"[edge_relax_fused[alt]] {name}: " + json.dumps(m))
    mark("kernel numbers")
    head, fhead = per_graph["kronecker(20,16)"], fused["kronecker(20,16)"]
    phead = partials["kronecker(20,16)"]
    pahead = partials_alt["kronecker(20,16)"]
    v1_alt_launches = {n: [q["solves"]["blocked"]["launches"]
                           for q in v1q[n]["queries"]] for n in results}
    ahead, fahead = alt["kronecker(20,16)"], fused_alt["kronecker(20,16)"]

    def alt_launches(kinds):
        """Launches of an ALT kernel over the p2p phase's solves of
        ``kinds``, per graph."""
        return {n: sum(q["solves"][k]["launches"] for q in p2p[n]["queries"]
                       for k in kinds) for n in results}
    alt_per_graph = alt_launches(("alt", "alt bidirectional"))
    fused_alt_per_graph = alt_launches(("alt fused",))
    per_query = lambda kind: {n: [q["solves"][kind]["launches"]
                                  for q in p2p[n]["queries"]]
                              for n in results}
    def by_graph(numbers, keys=("ms", "eager_ms", "parent_ms",
                                "parent_eager_ms", "plain_ms", "library_ms",
                                "library_scatter_ms", "bound_ms",
                                "bound_ms_12b_slots", "bound_ms_old",
                                "sched_tiles")):
        """Each graph's times and bounds of a kernel row."""
        return {n: {k: m[k] for k in keys} for n, m in numbers.items()}
    fused_keys = ("ms", "eager_ms", "parent_ms", "parent_eager_ms",
                  "plain_ms", "bound_ms", "bound_ms_old", "sched_tiles",
                  "touched", "improved")
    kernels = [{
        "name": "edge_relax", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:188",
        "launches": sum(r["launches"] for r in results.values()),
        "max_abs_err": max(m["max_abs_err"] for m in per_graph.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "launches_per_solve": {n: r["launches"] for n, r in results.items()},
        "per_graph": by_graph(per_graph),
    }, {
        "name": "edge_relax[alt]", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:158",
        "launches": sum(alt_per_graph.values()),
        "max_abs_err": max(m["max_abs_err"] for m in alt.values()),
        "ms": ahead["ms"], "plain_ms": ahead["plain_ms"],
        "bound_ms": ahead["bound_ms"], "bound_by": "bytes",
        "library_ms": ahead["library_ms"],
        "per_graph": by_graph(alt),
        "launches_per_graph": alt_per_graph,
        "launches_per_query": per_query("alt"),
        "launches_per_bidirectional_query": per_query("alt bidirectional"),
    }, {
        "name": "edge_relax_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/"
                  "edge_relax_fused.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:431",
        "launches": sum(r["fused_launches"] for r in results.values()),
        "max_abs_err": max(m["max_abs_err"] for m in fused.values()),
        "ms": fhead["ms"], "plain_ms": fhead["plain_ms"],
        "bound_ms": fhead["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_per_solve": {n: r["fused_launches"]
                               for n, r in results.items()},
        "per_graph": by_graph(fused, fused_keys),
    }, {
        "name": "edge_relax_fused[alt]", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/"
                  "edge_relax_fused.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:360",
        "launches": sum(fused_alt_per_graph.values()),
        "max_abs_err": max(m["max_abs_err"] for m in fused_alt.values()),
        "ms": fahead["ms"], "plain_ms": fahead["plain_ms"],
        "bound_ms": fahead["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "per_graph": by_graph(fused_alt, fused_keys),
        "launches_per_graph": fused_alt_per_graph,
        "launches_per_query": per_query("alt fused"),
    }, {
        "name": "edge_relax_partials", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:522",
        "launches": sum(r["v1_launches"] for r in results.values()),
        "max_abs_err": max(m["max_abs_err"] for m in partials.values()),
        "ms": phead["ms"], "plain_ms": phead["plain_ms"],
        "bound_ms": phead["bound_ms"], "bound_by": "bytes",
        "library_ms": phead["library_ms"],
        "per_graph": by_graph(partials),
        "launches_per_solve": {n: r["v1_launches"]
                               for n, r in results.items()},
    }, {
        "name": "edge_relax_partials[alt]", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:497",
        "launches": sum(map(sum, v1_alt_launches.values())),
        "max_abs_err": max(m["max_abs_err"] for m in partials_alt.values()),
        "ms": pahead["ms"], "plain_ms": pahead["plain_ms"],
        "bound_ms": pahead["bound_ms"], "bound_by": "bytes",
        "library_ms": pahead["library_ms"],
        "per_graph": by_graph(partials_alt),
        "launches_per_query": v1_alt_launches,
    }]
    solves = {"solves": {n: dict(
        solve_s=r["solve_s"], fused_solve_s=r["fused_solve_s"],
        plain_solve_s=r["plain_solve_s"], phases=r["phases"],
        fused_phases=r["fused_phases"], plain_phases=r["plain_phases"],
        rounds=r["metrics"]["n_rounds"],
        host_syncs=int(r["metrics"]["n_host_syncs"]),
        fused_host_syncs=int(r["fused_metrics"]["n_host_syncs"]),
        invocations=int(r["metrics"]["n_invocations"]),
        fused_invocations=int(r["fused_metrics"]["n_invocations"]))
        for n, r in results.items()},
        "v1": {n: dict(
            v1_solve_s=r["v1_solve_s"], v1_plain_solve_s=r["v1_plain_solve_s"],
            v1_phases=r["v1_phases"], v1_plain_phases=r["v1_plain_phases"],
            v1_host_syncs=int(r["v1_metrics"]["n_host_syncs"]),
            v1_invocations=int(r["v1_metrics"]["n_invocations"]))
            for n, r in results.items()},
        "p2p": {n: dict(landmark_build_s=p2p[n]["build_s"],
                        landmark_select_s=p2p[n]["select_s"],
                        landmark_symmetry_s=p2p[n]["symmetry_s"],
                        landmarks=p2p[n]["landmarks"].landmarks.tolist(),
                        max_hops=p2p[n]["landmarks"].max_hops,
                        queries=p2p[n]["queries"], pruned=p2p[n]["pruned"])
                for n in results},
        "goals": p2p["goals"],
        "v1_queries": {n: dict(queries=v1q[n]["queries"],
                               pruned=v1q[n]["pruned"]) for n in results},
        "v1_goals": v1q["goals"], "facade": facade}
    return kernels + facade_rows, solves


if __name__ == "__main__":
    sys.exit(main())
