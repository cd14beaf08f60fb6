"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (a checkout of another commit, e.g. ``git archive`` of
the parent unpacked into an ignored directory) also times that checkout's
``edge_relax`` (one-state and over slots), ``edge_relax_partials``,
``edge_relax_fused`` and ``embedding_bag`` kernels, and its embedding
layer, on the same inputs as this tree's, in turns (parent, this, this,
parent).  Run with no argument, the script needs one card and nothing
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
   names ("tc" bf16 tensor cores, "split" split-KV decode, "split_tc"
   split-KV on the tensor cores for 9 to 63 rows, "simt" CUDA cores): S
   not a multiple of a tile, GQA groups 1, 2, 8 and 16, D 64 and 128,
   causal, non-causal and windowed masks; prefill calls at S = T of 64,
   200, 2048 and 3072 with qwen3-0.6b's 8 KV heads of 2 and D = 128, and
   S = 130 with groups of 8 at D = 64; a chunk of queries at positions
   300..369 over keys at 0..T-1 and -1 padded, and one of 48 rows (3
   queries in groups of 16 over one KV head); decode calls over a cache
   slice with keys at 0..T-1, -1 padded or at ring-buffer positions,
   slots past the cache and below T - 1, with and without a window, at
   2 to 63 rows (granite-34b's 48 over one KV head among them).  Then
   the ALT branches of
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
   backend with ``fused_rounds=4`` (the ``edge_relax_fused`` kernel) and,
   on kronecker only (``PLAIN_GRAPHS``: road_grid's plain solves, 28.6
   and 33.6 s on an H100, are cut for phase 3f's time), on
   ``segment_min`` (plain torch).  ``dist``/``parent`` must be bitwise
   equal and the logical counters equal across the solves, each kernel
   must have launched in its own solve, the fused solve must not launch
   ``edge_relax`` and, on the road graph, must make at most half the
   unfused solve's invocations, and ``dist`` must match scipy's float64
   Dijkstra at ``rtol=1e-4, atol=1e-5``.
   Then point-to-point queries with ALT landmark pruning:
   ``"farthest"`` landmarks (8 on kronecker, 2 on road_grid: a cut of
   depth, the road build being one 23–45 s tree solve a landmark on an
   H100) are
   built on the card with the fused blocked path (the build time is
   printed), and 2 seeded
   (source, target) pairs, the target reachable from the source, are
   each solved five ways: p2p without landmarks on ``blocked``; with
   landmarks on ``blocked`` (``edge_relax``'s ALT branch), on ``blocked``
   with ``fused_rounds=4`` (``edge_relax_fused``'s ALT branch),
   bidirectionally on ``blocked``, and, on kronecker only
   (``PLAIN_GRAPHS``), on ``segment_min`` (plain); on road_grid the
   bidirectional queries and pair 1's ALT and fused ALT queries are cut
   for the run's time (``P2P_CUTS``, a cut of depth).
   ``dist[t]`` and the reconstructed path must be bitwise equal across
   the solves, ``dist[t]`` must equal the tree solve's (same source) or
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
   launch, with no launch of the other two) and, on kronecker, on
   ``segment_min``: each bitwise equal to the single-device blocked
   solve, with equal logical counters, and matching Dijkstra; on
   road_grid the v1 solve is a ``bounded`` query to a quarter of the
   tree's largest distance (``V1_BOUNDED``, a cut of depth, as phase
   3b2's v2 query), its settled entries bitwise the tree solve's.  Then
   queries on the v1 engine: both kronecker pairs of the p2p phase and road_grid's pair 2 with its
   landmark sets, on ``blocked`` (``edge_relax_partials``' ALT branch,
   which must launch, with no other kernel) and, on kronecker, on
   ``segment_min``: ``dist[t]`` and the path bitwise the unpruned
   single-device query's,
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
3b2. The sharded engines v2 and v3 (:func:`v2_path`), at world size 1
   over the NCCL group of phase 3.  First ``edge_relax_partials`` against
   its plain version at the call shape v2 makes (the rank's own ``[B]``
   state, no slice of a replicated one) on the P = 1 layout of each graph
   at the mid-solve window.  On kronecker(20,16): v2 and v3 ``blocked``
   tree solves, v2 ``blocked`` with ``fused_rounds=4`` (grouped complete
   rounds) and v2 ``segment_min``; on road_grid(1024) a v2 ``blocked``
   ``bounded`` query to a quarter of the tree's largest distance
   (``ROAD_V2_BOUND_FRACTION``: a cut of depth, and its v3 solve is cut,
   for the run's time; kronecker's v3 takes both exchanges).  Each tree
   bitwise the single-device blocked solve with equal logical counters
   and matching Dijkstra, the bounded query's settled entries bitwise
   the tree solve's; each ``blocked``
   solve must launch ``edge_relax_partials`` and neither ``edge_relax``
   nor ``edge_relax_fused`` (counters zeroed just before it and read
   just after), and the v3 solve must take at least one compact
   exchange.  ``[v2]`` lines: seconds beside v1's, rounds, host
   syncs (v3 reads its overflow flag once an exchange), invocations,
   launches, exchanges by path (``distributed.EXCHANGES``) and
   ``PhaseTimes`` (the loop, transitions, rounds and the collectives by
   kind).  Then on kronecker: ALT p2p on v2 ``blocked`` for the
   ``V1_PAIRS`` (the ALT branch alone launched; ``dist[t]`` and the path
   bitwise the unpruned single-device query's, ``n_relax`` and
   ``n_pruned`` the single-device ALT query's); a v2 batched tree spec
   of 8 sources (``sssp_distributed_batch``), each slot bitwise its
   single-device solve; phase 3d's delta A repaired at v2 and v3 on
   ``blocked`` shards (``repair_distributed``), each bitwise the
   single-device repair; and the sharded tier:
   ``Solver(EngineConfig(tier="sharded", backend="blocked"))`` solving
   a tree and a knear spec, and a ``GraphRegistry`` with
   ``shard_threshold_n=1`` behind a ``QueryRouter``, 4 tree queries
   through the mesh scheduler (one ``ShardedGraphEngine`` batch), every
   answer bitwise the single-device solves.
3c. The facade (``repro_torch.api``: ``Solver``, ``SolveSpec``,
   ``sssp_batch`` underneath), on the graphs and layouts above.  First
   ``edge_relax`` over slots against its plain version on 20 seeded
   random slabs (1, 3, 8 and 33 slots, each slot with its own frontier
   density, none included, with and without ALT, each over every slot,
   every other slot and the last alone; each call twice; every active
   slot's ``vals``, ``wins`` and four counters bitwise).  On
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
   a road_grid(1024) ``bounded`` query (the 1st percentile of its tree's
   distances, cut from the 5th in PR 25) under the adaptive policy against the static one (the
   adaptive road tree solve took 105 s on an H100, more than this phase
   has), then
   on road_grid(1024) a batched ``knear`` spec (4 seeded sources, k =
   1,000), each slot bitwise its single solve.  The batched kernel is
   then held against its plain version again at the middle call of the
   batched tree and p2p specs.
3d. Streaming deltas (``repro_torch.delta``), on the same graphs and
   layouts (:func:`delta_phase`).  Per graph two seeded deltas
   (:func:`make_deltas`): A, 32 undirected removals of the phase-3 tree's
   edges, 32 reweights of other edges to ``w * U[0.5, 2.0]`` and 32
   additions with the graph's own weights; B (decrease-only), 32
   reweights to ``w * 0.5`` and 32 additions.  For each: ``patch_host``,
   ``patch_blocked_with`` on a copy of the phase-3 layout, equal to
   ``build_blocked`` of the patched host field for field with its
   vertex->tile index; ``repair`` from the phase-3 tree state on
   ``blocked`` (``edge_relax``) and with ``fused_rounds=4``
   (``edge_relax_fused``), each launch counter zeroed just before and
   read just after, both a fixpoint with tight parents
   (:func:`check_fixpoint`, as is the from-scratch solve) and equal to a
   from-scratch solve on the patched layout (fused on road_grid): dist
   bitwise, parents too but at exact f32 ties (counted; the reference
   holds repair parents bitwise only where no exact ties are, and
   road_grid(1024) has some); B must take the fast path.  On
   kronecker's A, the v1 ``repair_distributed`` at world size 1 on
   ``blocked`` shards (``edge_relax_partials``), bitwise the
   single-device repair.  ``[delta]`` lines: patch seconds beside
   ``build_blocked``'s, ``n_invalid``, ``n_seeds``, each repair's
   seconds, iterations, launches and ``n_relax`` beside the from-scratch
   solve's.
3e. Traces (``repro_torch.obs``, :func:`trace_phase`): on kronecker,
   traced tree solves on ``blocked``, fused and adaptive, a traced
   batched tree spec of phase 3c's 8 sources through
   ``Solver(EngineConfig(trace=True))`` and a traced v1 solve, each
   bitwise the untraced one (dist, parent, every metric) with counter
   sums equal to the metrics and one record per iteration (``[trace]``
   lines: traced against untraced seconds); a ring of 8 records drops
   the right number; the Perfetto file written and read back, and a
   ``MetricsRegistry`` of the phase's counters through the Prometheus
   text and back.  Then one ``torch.profiler`` pass over a kronecker
   ``blocked`` tree solve and one over a road_grid bounded query (static
   policy; the 0.1st percentile of the tree's distances, cut from phase
   3c's 5th for the profiler's time): ``[profile]`` lines with the
   ``repro:`` ranges seen, device kernel time over the unprofiled wall
   time (the busy share) and the top kernels; a trace with no CUDA
   kernel fails.
3f. The tuner and the serving plane on kronecker(20,16)
   (:func:`serving_phase`).  ``repro_torch.tune.tune`` over a ``blocked``
   base in ``TUNE_SPACE`` (alpha 1.5/3/6 x beta 0.7/0.9 x both policies x
   fused_rounds 0/4), budget 6, 2 probe sources, into a temporary
   ``TunedStore``, each candidate's session on the phase-3 layout: no
   parity reject, the winner no worse than the baseline, ``edge_relax``
   (and ``edge_relax_fused`` when a fused candidate ran) launched, and
   ``Solver.open(..., tuned=store)`` overlaying the winner with a tree
   solve bitwise the baseline's (``[tune]`` line: evaluations, seconds,
   winner, objective reduction, the trajectory).  Then
   ``Solver.open(hg, EngineConfig(tier="routed", backend="blocked",
   use_alt=True, devices=(card, card), max_batch=8))``: two schedulers on
   the one card, the graph placed on both (``plan_placement``), warmed up
   (engine build, landmarks, one p2p batch), then 64 seeded queries (16
   each of tree, p2p, bounded, knear, interleaved) through ``submit``
   from this thread; every future must resolve, both schedulers serve,
   ``edge_relax_batch`` and ``edge_relax_batch_alt`` must launch (zeroed
   just before the first submit, read after the last answer; no
   one-state launch), and every answer must be bitwise the single
   tier's batched specs of the same queries, finalized alike (dist,
   parents but at verified exact f32 ties, the logical counters, p2p
   paths).  The same queries go once more straight to one scheduler (one
   thread, queued while its worker is stopped so that it forms full
   batches; answers bitwise the routed ones), and 8 tree and 8 p2p
   queries once more, a full batch on each scheduler, with a 0.5 s window
   of their serving under ``torch.profiler`` (:func:`busy_window`: the
   card's busy share).  Then phase 3d's kronecker delta A through
   the routed tier's
   ``apply_delta`` with two cached trees: one engine patched (the served
   layout cloned, then patched), no replica rebuilt, each repaired tree
   (``repair_relax`` on the patched layout, ``edge_relax`` launched)
   bitwise a from-scratch solve on the patched layout, which is a
   fixpoint with tight parents, and a routed query after the delta
   equal to it.  ``[serving]`` lines: queries/s routed and through the
   single tier, batches, occupancy, launches, and the delta's seconds by
   part (``patch_host``, ``patch_blocked_with``, ``repair_state``,
   ``repair_relax``).
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
4b. The other four LMs of the substrate (:func:`lm_configs_phase`), in
   bfloat16 with weights drawn on the card, after every earlier phase's
   tensors and the kernels' cached scratch are released (``[memory]``
   lines).  First ``flash_attention`` against its plain version at each
   model's prefill call (S = T = 512, causal) and decode call (its
   engine's slots at seeded positions of its cache), each launching the
   design ``ops.variant`` names and timed (``[flash_attention] <arch>``
   lines: graph replay, eager, plain, ``scaled_dot_product_attention``,
   the bound): phi4-mini 8 KV heads of 3, granite-34b's MQA (48 query
   heads over one KV head: its decode runs "split_tc", timed beside
   "simt" forced on the same call), deepseek-moe's MHA,
   granite-moe's D = 64.  Then ``moe_block`` on the card against the CPU
   in float32 with TF32 off at deepseek-moe-16b's and granite-moe's full
   width cut to one layer, 512 seeded tokens (``[moe]`` lines: routing
   equal where no near-tie, ``y`` and ``aux`` within rtol 1e-4, atol
   1e-5).  Then phi4-mini-3.8b, deepseek-moe-16b, granite-moe-3b-a800m
   and granite-34b (67.9 GB of weights, last) each served by
   :func:`lm_serve` (``ARCH_SERVE``: 8 requests of 16 new tokens, 4 with
   a 512-slot cache for granite-34b) and the same requests served again,
   whose tokens must be identical (``[lm]``, ``[serve4b]`` lines:
   parameters and bytes, time to first token, prefill tokens/s, decode
   ms/step, peak memory, launches by design, the MoE token-choices
   dropped by capacity).
4c. Training (:func:`training_phase`, ``[train]`` lines): qwen3-0.6b at
   full width in bf16 with f32 master weights, ``make_lm_train_step(
   microbatches=2)`` on ``LMTokenStream`` batches of 8 x 512 for 4 steps
   (finite loss and grad norm, every parameter moved, dtypes kept, no
   flash launch; ms/step, tokens/s, peak memory, one profiled step's
   device time); the same step on the card and on the CPU at qwen3's
   width cut to 2 layers in f32 (TF32 off), batch 2 x 128 (loss at rtol
   1e-5, grad norm at 1e-4, parameters within 2·lr); MIND uncut (10^7 x
   64) for 3 steps of 512 users; ``run_restartable`` on a 2-layer
   full-width qwen3 preempted by SIGTERM to itself in step 2 and resumed
   to step 4 in a temporary directory, against a straight run (within
   2·lr per step; whether bitwise is printed).
4d. GNN training (:func:`gnn_phase`, ``[gnn]`` and ``[anchors]`` lines),
   in float32 with TF32 off: GIN (5 x 64), GatedGCN (16 x 70), PNA (4 x
   75) and DimeNet (6 blocks x 128, 8 bilinear, 7 spherical, 6 radial)
   at full width as the reference's ``launch/cells.py::_gnn_cell``
   builds them, on ``full_graph_sm`` (``gnn_node_classification``: 2,708
   nodes, 21,112 directed edges, 1,433 features, 7 classes, positions,
   168,896 triplet slots at cap 8; cross entropy, remat) and on
   ``molecule`` (``molecule_batch`` flattened and symmetrised: 128
   graphs, 3,840 nodes, 16,384 directed edges, 16 seeded features,
   131,072 triplet slots; the regression step), AdamW without master
   weights, 4 steps each (ms/step after the first, peak memory, losses
   finite), the first step held against the same step on the CPU (loss
   at rtol 1e-5, parameters within 2·lr; PNA on ``molecule``, whose
   isolated nodes overflow its loss on both, reference fault 5: the
   same non-finite loss and NaN in the same leaves), DimeNet's geometry
   and bases on the card bitwise the CPU's.  Then the reference
   example's anchor features on phase 3's kronecker(20,16) (kept on the
   host): 8 seeded anchors solved as one batched ``SolveSpec.tree`` on
   ``blocked`` (``edge_relax_batch`` launched, counted from zero just
   before; every slot bitwise its single ``sssp`` solve), features
   ``exp(-d)``, the nearest anchor as label, and gin-tu at full width
   (remat) trained for 30 AdamW steps over the 33,554,432 directed
   edges (ms/step, peak memory, final accuracy); the batched solve's
   launches join row 1 batch's in the ``kernels`` line.
4e. The workload side (``tools/tooling_phase.py``, ``[tooling]`` lines),
   on phase 3's graphs and trees: ``bellman_ford`` on both graphs and
   ``delta_stepping`` at one ``delta`` a graph, each ``dist`` bitwise
   phase 3's tree but at vertices shown to be reference fault 1, each
   parent tree valid; ``make_variant(kronecker(20,16), power=4)`` solved
   on ``blocked`` unfused and fused (bitwise) and by ``bellman_ford``
   (scipy's Dijkstra; EIC bitwise under the same rule); 32 Zipf queries
   of ``make_traffic`` over both kronecker graphs through
   ``GraphRegistry`` and ``QueryRouter`` (every answer bitwise the single
   tier's); ``minibatch_lg`` (``tools/gnn_phase.py``: the Reddit-sized
   graph, its CSR by receiver on the card, ``NeighborSampler`` (15, 10)
   batches of 1,024 seeds padded to 181,248 nodes and 184,320 edges, the
   four GNNs at full width, each held to its CPU step on a cut batch of
   64 seeds); and the five ``examples/torch`` scripts, each ``main`` on
   the card printing its correctness line.  Cut for the run's time
   (``tools/tooling_phase.py::SMOKE_CUTS``): the examples are quickstart
   and serving_demo only, road has no ``delta_stepping``,
   ``minibatch_lg`` one timed step after the warm-up, and the traffic 16
   queries (``tools/tooling_phase.py`` alone serves 32).  The variant's
   ``edge_relax`` and ``edge_relax_fused`` launches and the traffic's
   ``edge_relax_batch`` launches join their rows in the ``kernels`` line.
4f. The many-device tooling (``tools/dryrun_phase.py``, ``[dryrun]``
   lines): over an NCCL group of world size 1 (:func:`init_group`),
   ``compressed_psum`` and its tree form bitwise the dequantized payload,
   and the four sharded GNN ops on a one-rank ``cuda`` mesh against
   their one-device forms (forward and gradient; gather, max and min
   bitwise); then two subprocesses of ``python -m
   repro_torch.launch.dryrun``, started together, under a ``"fake"``
   group: one of 256 and of 512 ranks, rank 0's shard of gr26 (262,144
   vertices and 8,388,608 edges at 256 ranks) built on the card, a
   warm-up and a timed iteration (one round and one transition) of v1,
   v2 and v3 on ``blocked`` (``edge_relax_partials``, counted: its
   launches join that row's in the ``kernels`` line) with the
   iteration's collective bytes by kind and its device ms, each round
   then held bitwise against the plain ``segment_min`` round from the
   same state (every exchanged key of the 2^26 destinations, and the
   round's state); the other tracing
   ``tools/dryrun_phase.py::SMOKE_CELLS`` (one cell, a cut for time:
   ``CELLS`` has three) on ``meta`` DTensors on the single-pod mesh;
   both exit codes must be 0.
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
   ALT rows at the middle kernel call of the first p2p pair's (road's
   second, ``ALT_ROW_PAIR``) ALT query, unfused and fused, captured by
   solving that query again,
   with their launches over the p2p queries; ``edge_relax_partials``'
   ALT row at the middle call of each graph's first v1 ALT query,
   captured in that query, with its launches over the v1 queries;
   ``edge_relax_batch`` and ``edge_relax_batch[alt]`` at the middle call
   of phase 3c's batched tree and p2p specs (8 and 4 slots): graph
   replay and eager (with ``--parent`` beside the parent design's, in
   turns), beside the same slots as one-state calls, the plain
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
# the graphs whose tree solve and ALT p2p queries also run on segment_min,
# single-device and v1 (no kernel; on road_grid(1024) the tree solves took
# 28.6 and 33.6 s in chip run C of PR 24, the two single-device and the
# v1 ALT queries 15.4, 8.5 and 9.8 s in PR 25's run B, the time phase 3f
# needs): road_grid's blocked and fused solves are held against each
# other and Dijkstra instead, its ALT queries against the unpruned one
PLAIN_GRAPHS = ("kronecker(20,16)",)


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
    transitions; for v2/v3 (whose loop is ``_solve_loop`` too)
    ``_v2_transition``, ``_v2_round`` and the collectives by kind:
    ``_exchange_dense`` (the reduce-scatter), ``_exchange_compact`` (v3's
    all-to-all), ``_overflow`` (v3's MAX of the flag and its host read),
    ``_sum``, ``_all_min`` (the MINs) and ``_gather`` (the result).  The
    events are recorded on the stream with no synchronize, so the solve
    keeps its own host reads; a span runs from the call's first launch to
    its last, the host's launch gaps included, since the loop's host read
    leaves the stream idle when the call begins."""
    TARGETS = (("core.sssp", "_solve_loop"),
               ("core.sssp", "_transition"),
               ("core.sssp", "_relax_round"),
               ("core.sssp", "_fused_relax_rounds"),
               ("core.distributed", "_v1_relax_round"),
               ("core.distributed", "_merge_partials"),
               ("core.distributed", "_sum"),
               ("core.distributed", "_v2_transition"),
               ("core.distributed", "_v2_round"),
               ("core.distributed", "_exchange_dense"),
               ("core.distributed", "_exchange_compact"),
               ("core.distributed", "_overflow"),
               ("core.distributed", "_all_min"),
               ("core.distributed", "_gather"))

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
    solves the :class:`ShardedGraph` ``g`` over the world process group
    with the engine ``opts["version"]`` names (default v1)."""
    mod = importlib.import_module(
        f"repro_torch.core.{'distributed' if sharded else 'sssp'}")
    entry = mod.sssp_distributed if sharded else mod.sssp
    if sharded:
        opts.setdefault("version", "v1")
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
        for version in ("v1", "v2", "v3"):
            solve(shard_graph(g, 1), int(np.argmax(g.deg)), backend, device,
                  sharded=True, version=version)
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
    """Three solves per graph (two off ``PLAIN_GRAPHS``); returns
    per-graph results.  The launch counters are zeroed just before each
    kernel's solve and read just after it."""
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
        kmd, fmd = metrics_dict(km), metrics_dict(fm)
        pd = pp = pmd = ps = pt = None
        checks = [("fused", fd, fp, fmd, "blocked", kd, kp, kmd)]
        if name in PLAIN_GRAPHS:
            pd, pp, pm, ps, pt = solve(dg, source, "segment_min", device)
            pmd = metrics_dict(pm)
            checks = [(what, d, p, md, "segment_min", pd, pp, pmd)
                      for what, d, p, md in (("blocked", kd, kp, kmd),
                                             ("fused", fd, fp, fmd))]
        for what, d, p, md, other, od, op, omd in checks:
            if not (bitwise_equal(d, od) and p.equal(op)):
                raise AssertionError(f"{name}: {what} and {other} differ")
            bad = [f for f in LOGICAL_METRIC_FIELDS if md[f] != omd[f]]
            if bad:
                raise AssertionError(f"{name}: {what} logical counters "
                                     f"differ from {other}: {bad}")
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
                  ("segment_min", ps, pmd, None, pt)][:2 + (pd is not None)]
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
# landmarks per graph: road_grid's build is one fused tree solve of 23 to
# 45 s a landmark on an H100; its first four farthest landmarks are the
# corners, and two are kept (cuts of depth paying for phases 4e and 4f:
# the third corner's bound was as tight as the fourth's for both road
# pairs; the two opposite corners still bound pair 1)
N_LANDMARKS = {"kronecker(20,16)": 8, "road_grid(1024)": 2}
# name, backend, options, the ALT launch counter the solve must move
P2P_SOLVES = (("unpruned", "blocked", {}, None),
              ("alt", "blocked", {}, "edge_relax_alt"),
              ("alt fused", "blocked", dict(fused_rounds=FUSED_ROUNDS),
               "edge_relax_fused_alt"),
              ("alt bidirectional", "blocked",
               dict(p2p_mode="bidirectional"), "edge_relax_alt"),
              ("alt segment_min", "segment_min", {}, None))
ALT_SOLVES = ("alt", "alt fused", "alt segment_min")
# solves cut from the p2p phase for the run's time, by graph and pair
# index (a cut of depth, paying for phases 4b and 4c; seconds on an
# H100): road_grid's bidirectional queries (26.4 s for pair 1, 13.3 for
# pair 2) and pair 1's ALT and fused ALT queries (16.9 and 15.3 s, where
# pair 2's took 8.6 s and about as long again; PERF.md §4).
# Road pair 1 keeps its unpruned query, pair 2 its unpruned, ALT and
# fused ALT queries (the ALT rows are measured at their middle calls,
# ALT_ROW_PAIR, and the v1 engine answers pair 2 against them).
P2P_CUTS = {"road_grid(1024)": {0: ("alt", "alt fused",
                                    "alt bidirectional"),
                                1: ("alt bidirectional",)}}
# the pair, by index, whose ALT queries' middle calls give a graph's ALT
# rows (default the first)
ALT_ROW_PAIR = {"road_grid(1024)": 1}


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
        for qi, (s, t) in enumerate(pairs):
            solves = {}
            for what, backend, opts, counter in P2P_SOLVES:
                if backend == "segment_min" and name not in PLAIN_GRAPHS or \
                        what in P2P_CUTS.get(name, {}).get(qi, ()):
                    continue
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
            for what in [w for w in ALT_SOLVES[1:] if w in solves]:
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
                          for w in ALT_SOLVES + ("alt bidirectional",)
                          if w in solves)
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
    and read just after) and, on ``PLAIN_GRAPHS``, a ``segment_min``
    solve, each bitwise equal to the single-device blocked solve with
    equal logical counters, and matching Dijkstra."""
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
        goal = {}
        if name in V1_BOUNDED:
            dist = res["dist"]
            goal = dict(goal="bounded", goal_param=float(
                dist[torch.isfinite(dist)].max()) * V1_BOUNDED[name])
        LAUNCHES.reset()
        vd, vp, vm, vs, vt = solve(sg, source, "blocked", device,
                                   sharded=True, blocked=layout, **goal)
        launches = LAUNCHES.edge_relax_partials
        stray = (LAUNCHES.edge_relax, LAUNCHES.edge_relax_fused)
        v1_what = "v1 blocked" + (f" bounded (bound {goal['goal_param']!r})"
                                  if goal else "")
        v1_solves = [(v1_what, vd, vp, metrics_dict(vm), vs, launches,
                      vt)]
        ss = st = None
        if name in PLAIN_GRAPHS:
            sd, sp, sm, ss, st = solve(sg, source, "segment_min", device,
                                       sharded=True)
            v1_solves.append(("v1 segment_min", sd, sp, metrics_dict(sm),
                              ss, None, st))
        want = res["metrics"]
        for what, d, p, md, *_ in v1_solves:
            if goal:
                # the settled entries are the tree solve's, which matched
                # the single-device solves' counters and Dijkstra
                if not settled_as_tree("bounded", goal["goal_param"],
                                       d[:n], p[:n], res["dist"],
                                       res["parent"]):
                    raise AssertionError(f"{name}: {what}'s settled "
                                         "entries differ from the "
                                         "single-device tree solve's")
                continue
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
        for what, _, _, md, secs, n_launch, phases in v1_solves:
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
                   v1_plain_phases=st, v1_metrics=v1_solves[0][3])


# ---------------------------------------------------------------------------
# queries on the v1 engine (edge_relax_partials' ALT branch)
# ---------------------------------------------------------------------------

# the p2p phase's pairs the v1 engine answers, by index; the first is the
# one whose middle kernel call is checked and timed (road_grid's pair 1
# takes twice as long as pair 2: left out for the run's time)
V1_PAIRS = {"kronecker(20,16)": (0, 1), "road_grid(1024)": (1,)}
# the graphs whose v1 solve is a bounded query to this fraction of the
# tree's largest distance instead of a tree (a cut of depth for the run's
# time: road_grid's v1 tree takes about 49 s on an H100), as phase 3b2
# runs road's v2 solve
V1_BOUNDED = {"road_grid(1024)": 0.25}


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
            for backend in ("blocked", "segment_min")[
                    :1 + (name in PLAIN_GRAPHS)]:
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
                   if "segment_min" in solves
                   and solves["blocked"]["metrics"][f]
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
# phase 3b2: the sharded engines v2 and v3 (world size 1, NCCL)
# ---------------------------------------------------------------------------

# the v2/v3 solves of each graph: (label, keyword arguments); road_grid's
# is its v2 blocked tree solve: its v3 solve (47.0 s in PR 26's chip run
# C, 68.3 s in run D, where the whole smoke took 1,289 s) and its
# segment_min solve are cut for the smoke's time
V2_SOLVES = {
    "kronecker(20,16)": (
        ("v2 blocked", dict(version="v2", backend="blocked")),
        ("v3 blocked", dict(version="v3", backend="blocked")),
        ("v2 blocked fused", dict(version="v2", backend="blocked",
                                  fused_rounds=FUSED_ROUNDS)),
        ("v2 segment_min", dict(version="v2", backend="segment_min"))),
    "road_grid(1024)": (
        ("v2 blocked bounded", dict(version="v2", backend="blocked",
                                    goal="bounded")),),
}
# road_grid's v2 solve is a bounded query to this fraction of the tree
# solve's largest distance, a cut of depth for the run's time (its tree
# solve took 40.6 s in PR 26's chip run F and 59.4 s on run D's slower
# host, where the whole smoke would have run past its limit)
ROAD_V2_BOUND_FRACTION = 0.25


def phase_spans(phases) -> str:
    return " ".join(f"{k}={v['calls']}x/{v['s']!r}s"
                    for k, v in phases.items())


def v2_solve(sg, source, device, **kw):
    """One timed sharded solve with the kernel launches and exchanges
    counted (zeroed just before it, read just after); returns ``(dist,
    parent, metrics dict, seconds, phases, launches, exchanges)``."""
    from repro_torch.core.distributed import EXCHANGES
    from repro_torch.core.sssp import metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    backend = kw.pop("backend")
    LAUNCHES.reset()
    EXCHANGES.reset()
    d, p, m, secs, phases = solve(sg, source, backend, device, sharded=True,
                                  **kw)
    return (d, p, metrics_dict(m), secs, phases, dict(vars(LAUNCHES)),
            EXCHANGES.as_dict())


def check_partials_only(what, launches, blocked: bool, alt: bool = False):
    """On ``blocked`` the partials kernel (``alt``: its ALT branch) must
    have launched and no other edge-relax kernel; on ``segment_min``
    none."""
    mine = "edge_relax_partials" + ("_alt" if alt else "")
    others = {k: v for k, v in launches.items() if k != mine and v}
    if others or (launches[mine] > 0) != blocked:
        raise AssertionError(f"{what}: kernel launches {launches}")


def v2_path(results, p2p, device) -> dict:
    """Phase 3b2 (see the module docstring): the v2 and v3 engines at
    world size 1 over NCCL on both graphs, each solve bitwise the
    single-device blocked solve with equal logical counters and matching
    Dijkstra (road_grid's a bounded query, its settled entries bitwise the
    tree solve's); on kronecker also ALT p2p, a batched tree spec, delta A's
    repairs, a sharded-tier ``Solver`` and a ``ShardedGraphEngine``
    behind the router's mesh scheduler."""
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS
    out = {}
    for name, res in results.items():
        sg, layout, n = res["sharded"], res["shard_layout"], res["host"].n
        # the partials kernel at v2's call shape: the rank's own [B] state
        # (tensors of their own, no slice of a replicated one)
        arrays, meta = layout
        block = meta.n_src_blocks * meta.block_v
        dist, paths, parent, lb, ub = mid_solve_window(res, block, device)
        args, index = shard_inputs(arrays, 0, block, dist, paths, parent,
                                   device)
        args = tuple(a.clone() for a in args[:3]) + args[3:]
        partials_pair(args, lb, ub, dict(tile_e=meta.tile_e, n_out=block,
                                         index=index),
                      f"{name} P=1, the v2 call shape")
        rows = {}
        for what, kw in V2_SOLVES[name]:
            blocked = kw["backend"] == "blocked"
            goal = kw.get("goal", "tree")
            if goal == "bounded":
                dist = res["dist"]
                kw = dict(kw, goal_param=float(
                    dist[torch.isfinite(dist)].max()) * ROAD_V2_BOUND_FRACTION)
            d, p, md, secs, phases, launches, ex = v2_solve(
                sg, res["source"], device,
                **dict(kw, **({"blocked": layout} if blocked else {})))
            full = f"{name} {what}"
            if goal == "bounded":
                # the settled entries are the tree solve's, which matched
                # the single-device solves' counters and Dijkstra
                if not settled_as_tree(goal, kw["goal_param"], d[:n], p[:n],
                                       res["dist"], res["parent"]):
                    raise AssertionError(f"{full}: the settled entries "
                                         "differ from the single-device "
                                         "tree solve's")
                full += f" (bound {kw['goal_param']!r})"
            else:
                if not (bitwise_equal(d[:n], res["dist"])
                        and p[:n].equal(res["parent"])):
                    raise AssertionError(f"{full}: differs from the "
                                         "single-device blocked solve")
                bad = [f for f in LOGICAL_METRIC_FIELDS
                       if md[f] != res["metrics"][f]]
                if bad:
                    raise AssertionError(f"{full}: logical counters "
                                         f"differ: {bad}")
                check_against_dijkstra(res["dijkstra"], d[:n])
            check_partials_only(full, launches, blocked)
            n_launch = launches["edge_relax_partials"]
            log(f"[v2] {full}: source={res['source']} {secs!r} s (v1 "
                f"blocked {res.get('v1_solve_s')!r} s), "
                f"rounds={md['n_rounds']} "
                f"steps={md['n_steps']} host_syncs={int(md['n_host_syncs'])} "
                f"invocations={int(md['n_invocations'])} "
                f"launches={n_launch} exchanges dense={ex['dense']} "
                f"compact={ex['compact']} {phase_spans(phases)}")
            rows[what] = dict(seconds=secs, launches=n_launch, exchanges=ex,
                              phases=phases, n_rounds=md["n_rounds"],
                              n_host_syncs=int(md["n_host_syncs"]),
                              n_invocations=int(md["n_invocations"]))
        out[name] = dict(solves=rows)
    compact = sum(r["exchanges"]["compact"] for o in out.values()
                  for w, r in o["solves"].items() if w.startswith("v3"))
    if compact <= 0:
        raise AssertionError("no v3 solve took a compact exchange")
    name = "kronecker(20,16)"
    res = results[name]
    out[name].update(queries=v2_queries(res, p2p[name], device),
                     batch=v2_batch(res, device),
                     repairs=v2_repairs(name, res, device),
                     tier=v2_tier(res, device))
    return out


def v2_queries(res, p2p, device) -> list:
    """ALT p2p on v2 ``blocked`` for the ``V1_PAIRS``: ``dist[t]`` and
    the path bitwise the unpruned single-device query's, ``n_relax`` and
    ``n_pruned`` the single-device ALT query's, only the ALT branch of
    the partials kernel launched."""
    from repro_torch.serve.queries import reconstruct_path
    name, rows = "kronecker(20,16)", []
    for qi in V1_PAIRS[name]:
        q = p2p["queries"][qi]
        s, t = q["source"], q["target"]
        dist_t, path = p2p["exact"][s, t]
        single = q["solves"]["alt"]
        d, p, md, secs, phases, launches, ex = v2_solve(
            res["sharded"], s, device, version="v2", backend="blocked",
            blocked=res["shard_layout"], goal="p2p", goal_param=t,
            landmarks=p2p["landmarks"])
        what = f"{name} ({s}, {t}) v2 alt blocked"
        check_partials_only(what, launches, True, alt=True)
        if not (bitwise_equal(d[t:t + 1], dist_t)
                and reconstruct_path(p.cpu().numpy(), s, t) == path):
            raise AssertionError(f"{what}: d(s,t) or its path differs from "
                                 "the unpruned single-device query's")
        if (md["n_relax"], md["n_pruned"]) != (single["n_relax"],
                                               single["n_pruned"]) \
                or md["n_pruned"] <= 0:
            raise AssertionError(f"{what}: n_relax/n_pruned "
                                 f"{md['n_relax']}/{md['n_pruned']}, the "
                                 f"single-device ALT query's "
                                 f"{single['n_relax']}/{single['n_pruned']}")
        n_launch = launches["edge_relax_partials_alt"]
        log(f"[p2p] {what}: {secs!r} s (single-device {single['seconds']!r}"
            f" s), d={float(dist_t)!r}, rounds={md['n_rounds']} "
            f"host_syncs={int(md['n_host_syncs'])} n_relax={md['n_relax']} "
            f"n_pruned={md['n_pruned']} ALT launches={n_launch} exchanges "
            f"dense={ex['dense']} {phase_spans(phases)}")
        rows.append(dict(source=s, target=t, seconds=secs,
                         launches=n_launch, n_relax=md["n_relax"],
                         n_pruned=md["n_pruned"]))
    return rows


def v2_batch(res, device) -> dict:
    """A v2 ``blocked`` batched tree spec of ``FACADE_SLOTS`` sources (the
    max-degree one and seeded others), each slot bitwise the
    single-device solve from its source with equal logical counters."""
    from repro_torch.core.distributed import EXCHANGES, sssp_distributed_batch
    from repro_torch.core.sssp import sssp
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    hg = res["host"]
    rng = np.random.default_rng(37)
    nz = np.flatnonzero(hg.deg > 0)
    srcs = [res["source"]] + [int(v) for v in rng.choice(
        nz[nz != res["source"]], FACADE_SLOTS - 1, replace=False)]
    LAUNCHES.reset()
    EXCHANGES.reset()
    (d, p, m), secs = timed(lambda: sssp_distributed_batch(
        res["sharded"], srcs, version="v2", backend="blocked",
        blocked=res["shard_layout"], device=device), device)
    launches, ex = dict(vars(LAUNCHES)), EXCHANGES.as_dict()
    check_partials_only("kronecker(20,16) v2 batch", launches, True)
    single_s = 0.0
    for i, s in enumerate(srcs):
        (sd, sp, sm), one_s = timed(lambda: sssp(
            res["graph"], s, backend="blocked", layout=res["layout"],
            device=device), device)
        single_s += one_s
        if not (bitwise_equal(d[i, :hg.n], sd) and p[i, :hg.n].equal(sp)) \
                or slot_metrics(m, i) != slot_metrics(sm):
            raise AssertionError(f"kronecker(20,16) v2 batch slot {i} "
                                 f"(source {s}) differs from its "
                                 "single-device solve")
    n_launch = launches["edge_relax_partials"]
    log(f"[v2] kronecker(20,16) v2 batch of {len(srcs)} tree sources: "
        f"{secs!r} s beside {single_s!r} s single-device, launches="
        f"{n_launch} exchanges dense={ex['dense']}; every slot bitwise its "
        "single-device solve")
    return dict(slots=len(srcs), seconds=secs, single_s=single_s,
                launches=n_launch)


def v2_repairs(name, res, device) -> dict:
    """Delta A repaired at v2 and v3 on ``blocked`` shards
    (``repair_distributed``), each bitwise the single-device repair
    (``repro_torch.delta.repair`` on a patched copy of the phase-3
    layout: dist, parent, logical counters) and its dist bitwise the
    from-scratch solve's on the patched graph."""
    from repro_torch.core.distributed import (EXCHANGES, repair_distributed,
                                              shard_blocked)
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
    from repro_torch.delta import (patch_blocked_with, patch_host,
                                   patch_sharded_with, repair, repair_state)
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    hg, n = res["host"], res["host"].n
    delta = make_deltas(res, DELTA_SEEDS[name])["A mixed"]
    new_host, applied = patch_host(hg, delta)
    patched = patch_blocked_with(clone_layout(res["layout"]), hg, new_host,
                                 applied)
    rd, rp, rm, _ = repair(patched, new_host, res["dist"], res["parent"],
                           applied, backend="blocked")
    rmd = metrics_dict(rm)
    sd, _, _ = sssp(new_host.to_device(device), res["source"],
                    backend="blocked", layout=patched, device=device)
    if not bitwise_equal(rd, sd):
        raise AssertionError(f"{name} A: the single-device repair's dist "
                             "differs from the from-scratch solve's")
    sg = patch_sharded_with(res["sharded"], new_host, applied)
    shards = shard_blocked(sg, device=device)
    d_i, p_i, front, _ = repair_state(new_host, res["dist"], res["parent"],
                                      applied)
    out = {}
    for version in ("v2", "v3"):
        LAUNCHES.reset()
        EXCHANGES.reset()
        (d, p, m), secs = timed(lambda: repair_distributed(
            sg, d_i, p_i, front, version=version, backend="blocked",
            blocked=shards, device=device), device)
        launches, ex = dict(vars(LAUNCHES)), EXCHANGES.as_dict()
        md = metrics_dict(m)
        what = f"{name} A repair {version}"
        check_partials_only(what, launches, True)
        if not (bitwise_equal(d[:n], rd) and p[:n].equal(rp)) or any(
                md[f] != rmd[f] for f in LOGICAL_METRIC_FIELDS):
            raise AssertionError(f"{what}: differs from the single-device "
                                 "repair")
        its = int(md["n_host_syncs"])
        log(f"[delta] {what} (world size 1, blocked shards): {secs!r} s, "
            f"host_syncs={its} rounds={md['n_rounds']} edge_relax_partials "
            f"launches={launches['edge_relax_partials']} exchanges "
            f"dense={ex['dense']} compact={ex['compact']}; bitwise the "
            "single-device repair, dist bitwise the from-scratch solve's")
        out[version] = dict(seconds=secs, host_syncs=its,
                            launches=launches["edge_relax_partials"],
                            exchanges=ex)
    return out


def v2_tier(res, device) -> dict:
    """The sharded tier at world size 1: ``Solver(EngineConfig(tier=
    "sharded", backend="blocked"))`` (v2) solving a tree and a knear spec,
    and a ``GraphRegistry`` whose graph is sharded (``shard_threshold_n=1``)
    behind a ``QueryRouter``: 4 tree queries through the mesh scheduler,
    one ``ShardedGraphEngine`` batch; every answer bitwise the
    single-device solves."""
    from repro_torch.api import EngineConfig, SolveSpec, Solver
    from repro_torch.core.sssp import sssp
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.serve.queries import Query
    from repro_torch.serve.registry import GraphRegistry, ShardedGraphEngine
    from repro_torch.serve.router import QueryRouter
    hg, n, src = res["host"], res["host"].n, res["source"]
    solver, open_s = timed(lambda: Solver.open(hg, EngineConfig(
        tier="sharded", backend="blocked"), device=device), device)
    k = 1000
    LAUNCHES.reset()
    tree, tree_s = timed(lambda: solver.solve(SolveSpec.tree(src)), device)
    knear = solver.solve(SolveSpec.knear(src, k))
    check_partials_only("sharded-tier Solver", dict(vars(LAUNCHES)), True)
    solver_launches = LAUNCHES.edge_relax_partials
    if not (bitwise_equal(tree.dist, res["dist"])
            and tree.parent.equal(res["parent"])) \
            or slot_metrics(tree.metrics) != {
                f: res["metrics"][f] for f in slot_metrics(tree.metrics)}:
        raise AssertionError("kronecker(20,16): the sharded-tier Solver's "
                             "tree differs from the single-device solve")
    want = sssp(res["graph"], src, backend="blocked", layout=res["layout"],
                goal="knear", goal_param=k, device=device)
    if not (bitwise_equal(knear.dist, want[0])
            and knear.parent.equal(want[1])):
        raise AssertionError("kronecker(20,16): the sharded-tier knear "
                             "differs from the single-device query")
    reg = GraphRegistry(shard_threshold_n=1, shard_backend="blocked",
                        shard_devices=[device], device=device)
    reg.register("kron", hg)
    # FIFO and no rounds feedback: the eccentricity hints' host BFS (4
    # over kronecker, about 6 s in chip runs C and E, PR 26) would order
    # or be fed by 4 queries of one batch
    router = QueryRouter(reg, devices=[device], max_batch=4,
                         ecc_batching=False, feedback=False)
    rng = np.random.default_rng(53)
    srcs = [src] + [int(v) for v in rng.choice(n, 3, replace=False)]
    eng, build_s = timed(lambda: reg.engine("kron"), device)
    if not isinstance(eng, ShardedGraphEngine):
        raise AssertionError(f"the registry built a {type(eng).__name__}")
    LAUNCHES.reset()
    t0 = time.perf_counter()
    futs = [router.submit(Query(gid="kron", source=s)) for s in srcs]
    router.drain()
    answers = [f.result(timeout=600) for f in futs]
    serve_s = time.perf_counter() - t0
    check_partials_only("mesh scheduler", dict(vars(LAUNCHES)), True)
    mesh_launches = LAUNCHES.edge_relax_partials
    for s, a in zip(srcs, answers):
        sd, sp, _ = sssp(res["graph"], s, backend="blocked",
                         layout=res["layout"], device=device)
        if a.served_by != "mesh" or not (
                np.array_equal(a.dist.view(np.int32),
                               sd.cpu().numpy().view(np.int32))
                and np.array_equal(a.parent, sp.cpu().numpy())):
            raise AssertionError(f"the mesh scheduler's tree from {s} "
                                 "differs from the single-device solve")
    stats = router.stats()
    log(f"[v2] kronecker(20,16) sharded tier: Solver.open {open_s!r} s, "
        f"tree {tree_s!r} s, knear k={k} bitwise; registry build "
        f"{build_s!r} s, {len(srcs)} tree queries through the mesh "
        f"scheduler in {serve_s!r} s ({stats['n_batches']} batches), each "
        "bitwise the single-device solve")
    return dict(open_s=open_s, tree_s=tree_s, build_s=build_s,
                serve_s=serve_s, queries=len(srcs),
                batches=stats["n_batches"], launches=solver_launches,
                mesh_launches=mesh_launches)


# ---------------------------------------------------------------------------
# phase 3c: the facade (Solver, SolveSpec, sssp_batch) and edge_relax over
# slots
# ---------------------------------------------------------------------------

FACADE_SLOTS = 8
ROAD_KNEAR = (4, 1000)           # road_grid's batched knear: sources, k
# road_grid's adaptive bounded query (cut from the 5th percentile in PR 25
# for phase 3f's time: 22.7 s adaptive against 4.9 s static, run B)
ROAD_ADAPTIVE_QUANTILE = 0.01


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
    # uneven frontiers: each slot's own density, none at all included
    paths = (rng.random(shape) < rng.choice([0.0, 0.01, 0.3, 1.0],
                                            (n_slots, 1))) \
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
    ``n_random`` seeded random slabs: slot counts 1, 3, 8 and 33 (two
    groups of the 32 a tile's slot mask holds) in turn, with and without
    ALT, each over every slot, every other slot and the last slot alone.
    Returns the number of calls checked."""
    rng = np.random.default_rng(seed)
    checked = 0
    for i in range(n_random):
        n = int(rng.integers(64, 20000))
        n_slots = (1, 3, FACADE_SLOTS, 33)[i % 4]
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
    (:func:`graph_ms`) and eager time (with ``--parent`` beside the
    parent design's on the same inputs, in turns: :func:`in_turns`)
    beside the same slots as one-state calls (all of them in one graph,
    and eagerly), the plain version's, the library yardstick's and the
    bounds (:func:`batch_bound_bytes`)."""
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
    parent_call = None if PARENT is None else \
        lambda: PARENT.relax_bucket(*args, **kw)
    return dict(
        **in_turns(call, parent_call),
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
        "batched calls on random slabs bitwise equal (1, 3, 8 and 33 "
        "slots, active lists that skip slots, with and without ALT)")
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
            "eager_ms": m["eager_ms"], "parent_ms": m["parent_ms"],
            "parent_eager_ms": m["parent_eager_ms"],
            "singles_ms": m["singles_ms"],
            "singles_eager_ms": m["singles_eager_ms"],
            "bound_ms_singles": m["bound_ms_singles"], "slots": m["slots"],
            "active": m["active"], "launches_per_solve": {
                name: f[key]["launches"]}})
    return rows, f


# ---------------------------------------------------------------------------
# phase 3d: streaming deltas (patch, repair) on the graphs above
# ---------------------------------------------------------------------------

DELTA_EDITS = 32                 # undirected edits of each kind a delta
DELTA_SEEDS = {"kronecker(20,16)": 41, "road_grid(1024)": 43}


def _first_weight(hg, u: int, v: int) -> float:
    """The weight of the slot ``patch_host`` edits for ``(u, v)``: the
    first match in ``u``'s CSR row."""
    lo, hi = int(hg.row_ptr[u]), int(hg.row_ptr[u + 1])
    return float(hg.w[lo + int(np.argmax(hg.dst[lo:hi] == v))])


def make_deltas(r, seed: int):
    """Delta A (mixed): ``DELTA_EDITS`` undirected removals of edges of the
    phase-3 tree solve's tree, as many reweights of random other edges to
    ``w * U[0.5, 2.0]`` (f32) and as many additions between random vertex
    pairs with weights drawn from the graph's own; delta B
    (decrease-only): reweights to ``w * 0.5`` and additions.  Road
    closures, congestion and new links between queries."""
    from repro_torch.delta import EdgeDelta
    hg, k = r["host"], DELTA_EDITS
    rng = np.random.default_rng(seed)
    parent = r["parent"].cpu().numpy()
    tree = np.flatnonzero((parent >= 0) & (parent != np.arange(hg.n)))
    removes = [(int(parent[v]), int(v))
               for v in rng.choice(tree, k, replace=False)]
    taken = {(min(u, v), max(u, v)) for u, v in removes}

    def other_edges():
        out = []
        while len(out) < k:
            e = int(rng.integers(hg.m))
            u, v = int(hg.src[e]), int(hg.dst[e])
            if u != v and (min(u, v), max(u, v)) not in taken:
                taken.add((min(u, v), max(u, v)))
                out.append((u, v, _first_weight(hg, u, v)))
        return out

    def additions():
        pairs = rng.integers(0, hg.n, (2 * k, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]][:k]
        return [(int(u), int(v), float(rng.choice(hg.w))) for u, v in pairs]

    mixed = EdgeDelta(remove=removes, add=additions(), reweight=[
        (u, v, float(np.float32(w * rng.uniform(0.5, 2.0))))
        for u, v, w in other_edges()])
    decrease = EdgeDelta(add=additions(), reweight=[
        (u, v, float(np.float32(w * 0.5))) for u, v, w in other_edges()])
    return {"A mixed": mixed, "B decrease-only": decrease}


def clone_layout(bg):
    """A copy of a blocked layout with tensors of its own (a patch writes
    the tensors it is given)."""
    from repro_torch.core.graph import TileIndex
    return dataclasses.replace(
        bg, **{f: getattr(bg, f).clone() for f in (
            "src", "dst", "w", "tile_dst", "tile_first", "bucket_nonempty",
            "deg")}, index=TileIndex(*(t.clone() for t in bg.index)))


def same_layout(a, b) -> bool:
    scalars = ("n", "block_v", "n_blocks", "n_dst_blocks", "tile_e",
               "dense_grid_tiles", "slab_ptr")
    tensors = ("src", "dst", "w", "tile_dst", "tile_first",
               "bucket_nonempty", "deg")
    return all(getattr(a, f) == getattr(b, f) for f in scalars) and all(
        getattr(a, f).shape == getattr(b, f).shape
        and getattr(a, f).equal(getattr(b, f)) for f in tensors) and all(
        x.shape == y.shape and x.equal(y) for x, y in zip(a.index, b.index))


def check_fixpoint(g, dist, parent, source: int, what: str):
    """The certificate of a shortest-path tree, on the card: no edge of
    ``g`` (a ``DeviceGraph``) improves ``dist`` (``dist[v] <= dist[u] +
    w`` in f32), and every vertex reached, but the source, has a parent
    edge that is tight (``dist[p] + w == dist[v]``)."""
    cand = dist[g.src] + g.w
    if bool((cand < dist[g.dst]).any()):
        raise AssertionError(f"{what}: an edge improves dist")
    tight = (parent.long()[g.dst] == g.src) & (cand == dist[g.dst])
    has = torch.zeros_like(dist, dtype=torch.bool)
    has[g.dst[tight]] = True
    has[source] = True
    if not bool((has | ~torch.isfinite(dist)).all()):
        raise AssertionError(f"{what}: a parent edge is not tight")


def delta_case(name, r, label, delta, device, v1: bool):
    """One graph and delta: ``patch_host``, ``patch_blocked_with`` on a copy
    of the phase-3 layout (against ``build_blocked`` of the patched host,
    index included), ``repair`` on ``blocked`` and fused from the phase-3
    tree state (launches counted, each zeroed just before and read just
    after), both a fixpoint with tight parents (:func:`check_fixpoint`)
    and equal to a from-scratch solve on the patched layout: dist
    bitwise, parents too but where both are exact f32 ties
    (:func:`same_tree_up_to_ties`; ``repro/delta/repair.py`` holds
    parents bitwise only where no exact f32 ties are), and with ``v1``
    the v1 ``repair_distributed`` at world size 1 on ``blocked`` shards
    (``edge_relax_partials``), bitwise the single-device repair."""
    from repro_torch.core.distributed import repair_distributed, shard_blocked
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
    from repro_torch.delta import (patch_blocked_with, patch_host,
                                   patch_sharded_with, repair, repair_state)
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    hg, source, n = r["host"], r["source"], r["host"].n
    t0 = time.perf_counter()
    new_host, applied = patch_host(hg, delta)
    host_s = time.perf_counter() - t0
    base = clone_layout(r["layout"])        # the phase-3 layout stays
    ptr = base.src.data_ptr()
    sync(device)
    t0 = time.perf_counter()
    patched = patch_blocked_with(base, hg, new_host, applied)
    sync(device)
    patch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rebuilt = build_blocked(new_host, block_v=base.block_v,
                            tile_e=base.tile_e, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    if not same_layout(patched, rebuilt):
        raise AssertionError(f"{name} {label}: the patched layout differs "
                             "from build_blocked of the patched host")
    del rebuilt, base
    in_place = patched.src.data_ptr() == ptr
    t0 = time.perf_counter()
    *_, stats = repair_state(new_host, r["dist"], r["parent"], applied)
    state_s = time.perf_counter() - t0
    if label.startswith("B") and not stats.fast_path:
        raise AssertionError(f"{name} {label}: a decrease-only delta did "
                             "not take the fast path")
    new_dg = new_host.to_device(device)
    fused_scratch = name.startswith("road")     # its unfused solve is slow
    (sd, sp, sm), scratch_s = timed(lambda: sssp(
        new_dg, source, backend="blocked", layout=patched, device=device,
        fused_rounds=FUSED_ROUNDS if fused_scratch else 0), device)
    check_fixpoint(new_dg, sd, sp, source, f"{name} {label} from scratch")
    smd = metrics_dict(sm)
    out = dict(edits=delta.n_edits, directed=applied.n_edits,
               patch_host_s=host_s, patch_blocked_s=patch_s,
               build_blocked_s=build_s, in_place=in_place,
               repair_state_s=state_s, n_invalid=stats.n_invalid,
               n_seeds=stats.n_seeds, fast_path=stats.fast_path,
               scratch="fused" if fused_scratch else "blocked",
               scratch_s=scratch_s, scratch_n_relax=smd["n_relax"],
               scratch_iterations=int(smd["n_host_syncs"]) - 1, repairs={},
               tie_parents={})
    log(f"[delta] {name} {label}: {delta.n_edits} edits ({applied.n_edits} "
        f"directed), patch_host {host_s!r} s, patch_blocked {patch_s!r} s "
        f"({'in place' if in_place else 'new tensors'}) beside build_blocked "
        f"{build_s!r} s, equal to the rebuild with its index; repair_state "
        f"{state_s!r} s: n_invalid={stats.n_invalid} n_seeds={stats.n_seeds}"
        f" fast_path={stats.fast_path}; from-scratch {out['scratch']} solve "
        f"{scratch_s!r} s, n_relax={smd['n_relax']}, a fixpoint with tight "
        "parents")
    rep = None
    for mode, fr, counter in (("blocked", 0, "edge_relax"),
                              ("fused", FUSED_ROUNDS, "edge_relax_fused")):
        LAUNCHES.reset()
        (d, p, m, _), secs = timed(lambda: repair(
            patched, new_host, r["dist"], r["parent"], applied,
            backend="blocked", fused_rounds=fr), device)
        launches = getattr(LAUNCHES, counter)
        stray = LAUNCHES.edge_relax_fused if fr == 0 else LAUNCHES.edge_relax
        if launches <= 0 or stray:
            raise AssertionError(f"{name} {label}: the {mode} repair "
                                 f"launched {counter} {launches} times and "
                                 f"the other kernel {stray}")
        what = f"{name} {label} {mode} repair"
        check_fixpoint(new_dg, d, p, source, what)
        ties = same_tree_up_to_ties(new_host, d, p, sd, sp, None, what)
        out["tie_parents"][mode] = ties
        md = metrics_dict(m)
        if mode == "blocked":
            rep = (d, p, md)
        elif any(md[f] != rep[2][f] for f in LOGICAL_METRIC_FIELDS):
            raise AssertionError(f"{name} {label}: the fused repair's "
                                 "logical counters differ")
        its = int(md["n_host_syncs"]) - 1
        out["repairs"][mode] = dict(
            seconds=secs, iterations=its, launches=launches,
            rounds=md["n_rounds"], n_relax=md["n_relax"],
            relax_reduction=smd["n_relax"] / max(md["n_relax"], 1))
        log(f"[delta] {name} {label} repair {mode}: {secs!r} s, "
            f"iterations={its} rounds={md['n_rounds']} {counter} "
            f"launches={launches}, n_relax={md['n_relax']} against the "
            f"from-scratch solve's {smd['n_relax']} (reduction "
            f"{out['repairs'][mode]['relax_reduction']:.4g}x) and "
            f"{scratch_s!r} s; a fixpoint with tight parents, dist bitwise "
            f"the from-scratch solve's, parents too but at {ties} exact "
            "f32 ties")
    if v1:
        sg = patch_sharded_with(r["sharded"], new_host, applied)
        t0 = time.perf_counter()
        shards = shard_blocked(sg, device=device)
        shard_s = time.perf_counter() - t0
        d_i, p_i, front, _ = repair_state(new_host, r["dist"], r["parent"],
                                          applied)
        LAUNCHES.reset()
        (vd, vp, vm), secs = timed(lambda: repair_distributed(
            sg, d_i, p_i, front, version="v1", backend="blocked",
            blocked=shards, device=device), device)
        launches = LAUNCHES.edge_relax_partials
        vmd = metrics_dict(vm)
        if launches <= 0 or not (bitwise_equal(vd[:n], rep[0])
                                 and vp[:n].equal(rep[1])) or any(
                vmd[f] != rep[2][f] for f in LOGICAL_METRIC_FIELDS):
            raise AssertionError(f"{name} {label}: the v1 repair differs "
                                 "from the single-device repair (or "
                                 "launched no edge_relax_partials)")
        out["repairs"]["v1"] = dict(
            seconds=secs, shard_blocked_s=shard_s, launches=launches,
            iterations=int(vmd["n_host_syncs"]) - 1, n_relax=vmd["n_relax"])
        log(f"[delta] {name} {label} repair v1 (world size 1, blocked "
            f"shards): {secs!r} s (shard_blocked {shard_s!r} s), "
            f"iterations={int(vmd['n_host_syncs']) - 1} edge_relax_partials "
            f"launches={launches}; bitwise the single-device repair")
    del patched, new_dg
    torch.cuda.empty_cache()
    return out


def delta_phase(results, device) -> dict:
    """Phase 3d: both deltas on both graphs (:func:`delta_case`); the v1
    repair on kronecker's delta A."""
    out = {}
    for name, r in results.items():
        for label, delta in make_deltas(r, DELTA_SEEDS[name]).items():
            out[f"{name} {label}"] = delta_case(
                name, r, label, delta, device,
                v1=name.startswith("kron") and label.startswith("A"))
    return out


# ---------------------------------------------------------------------------
# phase 3e: per-round traces, metrics export and profiled solves
# ---------------------------------------------------------------------------

TRACE_SMALL_RING = 8
# road_grid's profiled bounded query: the 0.1st percentile of its tree's
# distances (at phase 3c's 5th, 337,442 kernels took the profiler about
# 195 s to collect and sum on an H100 host)
ROAD_PROFILE_QUANTILE = 0.001


def traced_pair(what, untraced, traced, counter, device):
    """Time an untraced call, then the traced one (launches of ``counter``
    zeroed just before it and read just after); both must agree bitwise
    (dist, parent, every metric).  Returns the numbers and the trace."""
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.obs import materialize_trace
    (d0, p0, m0), plain_s = timed(untraced, device)
    LAUNCHES.reset()
    (d, p, m, buf), secs = timed(traced, device)
    launches = getattr(LAUNCHES, counter)
    md, md0 = metrics_dict(m), metrics_dict(m0)
    if launches <= 0 or not (bitwise_equal(d, d0) and p.equal(p0)) \
            or md != md0:
        raise AssertionError(f"{what}: the traced solve differs from the "
                             f"untraced one (or launched no {counter})")
    t = materialize_trace(buf)
    sums = t.counter_sums()
    iterations = int(md["n_host_syncs"]) - 1
    bad = [f for f in LOGICAL_METRIC_FIELDS
           if sums[f] + (f == "n_extended") != md[f]]
    if bad or t.n_records != iterations or t.dropped:
        raise AssertionError(f"{what}: trace sums differ at {bad}, or "
                             f"{t.n_records} records for {iterations} "
                             f"iterations ({t.dropped} dropped)")
    log(f"[trace] {what}: traced {secs!r} s against untraced {plain_s!r} s "
        f"(x{secs / plain_s:.4f}), {t.n_records} records = iterations, "
        f"{int(t.columns['stepped'].sum())} stepped, counter sums equal "
        f"the metrics, {counter} launches={launches}; bitwise the untraced "
        "solve")
    return dict(traced_s=secs, untraced_s=plain_s, records=t.n_records,
                launches=launches), t


def profiled_solve(what, fn, wall, device):
    """One ``torch.profiler`` pass over ``fn`` (a solve): the ``repro:``
    ranges it recorded, device kernel time against ``wall``, the same
    solve's seconds unprofiled (timed here if None; the busy share), and
    the top kernels.  The ranges' own spans on the device timeline are
    not kernels and are left out.  A trace with no CUDA kernel fails
    (:func:`trace_kernels`)."""
    from torch.profiler import ProfilerActivity, profile
    if wall is None:
        _, wall = timed(fn, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        _, prof_wall = timed(fn, device)
    events = prof.key_averages()
    kern = [e for e in trace_kernels(events, what)
            if not e.key.startswith("repro:")]
    if not kern:
        raise AssertionError(f"{what}: the profiler's trace holds no CUDA "
                             "kernel")
    device_s = sum(e.self_device_time_total for e in kern) / 1e6
    ranges = {e.key: e.count for e in events if e.key.startswith("repro:")}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(wall_s=wall, profiled_wall_s=prof_wall, device_s=device_s,
               busy_share=device_s / wall,
               busy_share_profiled=device_s / prof_wall,
               kernels=sum(e.count for e in kern), ranges=ranges,
               top={e.key[:60]: dict(count=e.count,
                                     ms=e.self_device_time_total / 1e3)
                    for e in top})
    log(f"[profile] {what}: " + json.dumps(out))
    return out


def trace_phase(results, facade, device) -> dict:
    """Phase 3e on kronecker(20,16): traced tree solves on ``blocked``,
    fused and adaptive, a traced batched tree spec through ``Solver``,
    a traced v1 solve, a ring smaller than the iterations, the Perfetto
    export written and read back and a ``MetricsRegistry`` of the
    phase's counters through the Prometheus text; then profiled passes
    over a kronecker ``blocked`` tree solve and a road_grid bounded query
    (static policy, bound at ``ROAD_PROFILE_QUANTILE``)."""
    import tempfile

    from repro_torch.api import EngineConfig, SolveSpec, Solver
    from repro_torch.core.distributed import sssp_distributed
    from repro_torch.core.sssp import metrics_dict, sssp
    from repro_torch.obs import (MetricsRegistry, materialize_trace,
                                 parse_prometheus, to_prometheus,
                                 write_perfetto)
    name = "kronecker(20,16)"
    r = results[name]
    dg, bg, s = r["graph"], r["layout"], r["source"]
    out, traces = {}, {}
    for what, opts, counter in (
            ("blocked", {}, "edge_relax"),
            ("fused", dict(fused_rounds=FUSED_ROUNDS), "edge_relax_fused"),
            ("adaptive", dict(policy="adaptive"), "edge_relax")):
        solve_ = lambda **kw: sssp(dg, s, backend="blocked", layout=bg,
                                   device=device, **opts, **kw)
        out[what], traces[what] = traced_pair(
            f"{name} tree {what}", solve_, lambda: solve_(trace=True),
            counter, device)
    if not (bitwise_equal(r["dist"], sssp(dg, s, backend="blocked",
                                          layout=bg, device=device)[0])):
        raise AssertionError(f"{name}: a tree solve differs from phase 3's")
    *_, buf = sssp(dg, s, backend="blocked", layout=bg, device=device,
                   trace=True, trace_capacity=TRACE_SMALL_RING)
    small = materialize_trace(buf)
    full = traces["blocked"]
    if (small.n_recorded, small.dropped) != (
            full.n_records, full.n_records - TRACE_SMALL_RING) or not all(
            np.array_equal(small.columns[c],
                           full.columns[c][-TRACE_SMALL_RING:])
            for c in small.columns):
        raise AssertionError(f"{name}: a ring of {TRACE_SMALL_RING} kept "
                             f"{small.n_records} records, dropped "
                             f"{small.dropped} of {small.n_recorded}")
    log(f"[trace] {name} ring of {TRACE_SMALL_RING}: {small.n_recorded} "
        f"written, {small.dropped} dropped, the last {small.n_records} "
        "equal to the full trace's")
    out["small_ring"] = dict(capacity=TRACE_SMALL_RING,
                             written=small.n_recorded, dropped=small.dropped)

    srcs = facade["tree"]["sources"]
    traced = Solver.open(dg, EngineConfig(backend="blocked", trace=True),
                         layout=bg, device=device)
    plain = Solver.open(dg, EngineConfig(backend="blocked"), layout=bg,
                        device=device)
    spec = SolveSpec.tree(srcs)
    b0, plain_s = timed(lambda: plain.solve(spec), device)
    b, secs = timed(lambda: traced.solve(spec), device)
    for i in range(len(srcs)):
        m, m0 = (type(x.metrics)(*(f[i] for f in x.metrics))
                 for x in (b, b0))
        md = metrics_dict(m)
        sums = b.trace[i].counter_sums()
        if not (bitwise_equal(b.dist[i], b0.dist[i])
                and b.parent[i].equal(b0.parent[i])) \
                or md != metrics_dict(m0) \
                or sums["n_relax"] != md["n_relax"] \
                or b.trace[i].n_records != int(md["n_host_syncs"]) - 1:
            raise AssertionError(f"{name}: traced batch slot {i} differs")
    log(f"[trace] {name} tree x{len(srcs)} through Solver(trace=True): "
        f"traced {secs!r} s against untraced {plain_s!r} s "
        f"(x{secs / plain_s:.4f}), records per slot "
        f"{[len(t) for t in b.trace]}, every slot bitwise the untraced "
        "batch's, sums equal its metrics")
    out["batch"] = dict(traced_s=secs, untraced_s=plain_s,
                        records=[len(t) for t in b.trace])

    v1 = lambda **kw: sssp_distributed(
        r["sharded"], s, version="v1", backend="blocked",
        blocked=r["shard_layout"], device=device, **kw)
    out["v1"], _ = traced_pair(f"{name} v1 blocked", v1,
                               lambda: v1(trace=True),
                               "edge_relax_partials", device)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        write_perfetto(full, path, name=f"{name} tree blocked")
        events = json.loads(path.read_text())["traceEvents"]
    rounds = sum(e.get("cat") == "round" for e in events)
    if rounds != full.n_records:
        raise AssertionError(f"{name}: the Perfetto file holds {rounds} "
                             f"rounds of {full.n_records} records")
    reg = MetricsRegistry()
    for what, m in out.items():
        if "records" in m and what != "batch":
            reg.counter("sssp_trace_records_total", "trace records",
                        {"solve": what}).inc(m["records"])
            reg.histogram("sssp_solve_seconds", "traced solve seconds",
                          {"solve": what}).observe(m["traced_s"])
    parsed = parse_prometheus(to_prometheus(reg.snapshot()))
    for what, m in out.items():
        if "records" in m and what != "batch":
            key = f'sssp_trace_records_total{{solve="{what}"}}'
            if parsed[key] != m["records"]:
                raise AssertionError(f"{key}: {parsed[key]} after the "
                                     "Prometheus round trip")
    log(f"[trace] Perfetto file: {len(events)} events, {rounds} round "
        f"spans; Prometheus text: {len(parsed)} samples, read back equal")

    profiles = {f"{name} tree blocked": profiled_solve(
        f"sssp {name} tree blocked", lambda: sssp(
            dg, s, backend="blocked", layout=bg, device=device),
        out["blocked"]["untraced_s"], device)}
    rname = "road_grid(1024)"
    rr = results[rname]
    finite = rr["dist"][torch.isfinite(rr["dist"])]
    bound = float(np.float32(torch.quantile(
        finite.double(), ROAD_PROFILE_QUANTILE).item()))
    road = Solver.open(rr["graph"], EngineConfig(backend="blocked"),
                       layout=rr["layout"], device=device)
    profiles[f"{rname} bounded"] = profiled_solve(
        f"sssp {rname} bounded (static, bound {bound!r})",
        lambda: road.solve(SolveSpec.bounded(rr["source"], bound)), None,
        device)
    out["profiles"] = profiles
    return out


# ---------------------------------------------------------------------------
# phase 3f: the tuner and the serving plane (the routed tier) on kronecker
# ---------------------------------------------------------------------------

# fused_rounds first: within the budget, coordinate descent reaches the
# axes in this order, and a fused candidate runs edge_relax_fused
TUNE_SPACE = {"fused_rounds": (0, 4), "alpha": (1.5, 3.0, 6.0),
              "beta": (0.7, 0.9), "policy": ("static", "adaptive")}
TUNE_BUDGET = 6
ROUTED_PER_KIND = 16             # queries of each kind through the router
ROUTED_BATCH = 8                 # the schedulers' max_batch
ROUTED_KINDS = ("tree", "p2p", "bounded", "knear")
# the routed busy share: profile this many seconds of two schedulers
# serving one full batch each, after this many from their start (the
# profiler's processing costs about 0.2 ms a kernel on the host, and the
# serving launches tens of thousands of kernels a second)
BUSY_WINDOW_S, BUSY_SKIP_S = 0.5, 0.2


def tuner_phase(res, device) -> dict:
    """The tuner on kronecker(20,16) over a ``blocked`` base in
    ``TUNE_SPACE`` (budget ``TUNE_BUDGET``, 2 probe sources) into a
    temporary ``TunedStore``, every candidate's sessions on the phase-3
    layout; then ``Solver.open(..., tuned=store)``, whose tree solve from
    the max-degree source must be bitwise the baseline's.  Launches of
    ``edge_relax`` and ``edge_relax_fused`` are counted over the tune."""
    import tempfile

    from repro_torch.api import EngineConfig, SolveSpec, Solver
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.tune import TUNED_FIELDS, TunedStore, tune
    name = "kronecker(20,16)"
    dg, bg, s = res["graph"], res["layout"], res["source"]
    base = EngineConfig(backend="blocked")
    with tempfile.TemporaryDirectory() as tmp:
        store = TunedStore(Path(tmp) / "tuned.json")
        LAUNCHES.reset()
        result, secs = timed(lambda: tune(
            dg, base, gid="kron", budget=TUNE_BUDGET, seed=0, restarts=0,
            n_sources=2, space=TUNE_SPACE, store=store, device=device,
            layout=bg), device)
        launches = dict(edge_relax=LAUNCHES.edge_relax,
                        edge_relax_fused=LAUNCHES.edge_relax_fused)
        if result.n_parity_rejects or result.n_evals > TUNE_BUDGET \
                or result.best_objective > result.baseline_objective:
            raise AssertionError(
                f"{name} tune: {result.n_evals} evaluations, "
                f"{result.n_parity_rejects} parity rejects, objective "
                f"{result.best_objective!r} against the baseline's "
                f"{result.baseline_objective!r}")
        tried = {r["config"]["fused_rounds"] for r in result.trajectory}
        if launches["edge_relax"] <= 0 or (
                FUSED_ROUNDS in tried and launches["edge_relax_fused"] <= 0):
            raise AssertionError(f"{name} tune: kernel launches {launches} "
                                 f"over candidates with fused_rounds {tried}")
        want = Solver.open(dg, base, layout=bg, device=device).solve(
            SolveSpec.tree(s))
        tuned = Solver.open(dg, base, layout=bg, device=device, tuned=store,
                            gid="kron")
        winner = {f: getattr(result.best_config, f) for f in TUNED_FIELDS}
        if {f: getattr(tuned.config, f) for f in TUNED_FIELDS} != winner:
            raise AssertionError(f"{name}: Solver.open(tuned=) overlaid "
                                 f"{tuned.config} for the winner {winner}")
        got = tuned.solve(SolveSpec.tree(s))
        if not (bitwise_equal(got.dist, want.dist)
                and got.parent.equal(want.parent)):
            raise AssertionError(f"{name}: the tuned session's tree solve "
                                 "differs from the baseline's")
    rows = [dict(eval=r["eval"], origin=r["origin"],
                 objective=r["objective"], accepted=r["accepted"],
                 **{k: r["config"][k] for k in TUNE_SPACE})
            for r in result.trajectory]
    log(f"[tune] {name}: {result.n_evals} evaluations in {secs!r} s, "
        f"winner {winner}, objective {result.best_objective!r} against "
        f"the baseline's {result.baseline_objective!r} (reduction "
        f"{result.reduction!r}), {result.n_parity_rejects} parity rejects, "
        f"launches {launches}; Solver.open(tuned=) solves bitwise the "
        f"baseline; trajectory {json.dumps(rows)}")
    return dict(seconds=secs, n_evals=result.n_evals, winner=winner,
                objective=result.best_objective,
                baseline=result.baseline_objective,
                reduction=result.reduction, launches=launches,
                trajectory=rows)


def routed_queries(res, seed: int = 61):
    """``ROUTED_PER_KIND`` seeded queries of each kind on kronecker's
    non-isolated vertices, interleaved by kind: trees, p2p to random
    targets, bounded at the 40th percentile of the phase-3 tree's
    distances, knear with k from 10 to 5,000.  Returns ``(kind, source,
    parameter)`` triples."""
    hg = res["host"]
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(hg.deg > 0)
    d = res["dist"]
    bound = float(np.float32(torch.quantile(
        d[torch.isfinite(d)].double(), 0.4).item()))
    ks = (10, 100, 1000, 5000)
    out = []
    for i in range(ROUTED_PER_KIND):
        s = [int(v) for v in rng.choice(nz, 5, replace=False)]
        out += [("tree", s[0], None), ("p2p", s[1], s[4]),
                ("bounded", s[2], bound), ("knear", s[3], ks[i % 4])]
    return out


def spec_of(kind, sources, params):
    from repro_torch.api import SolveSpec
    if kind == "tree":
        return SolveSpec.tree(sources)
    return getattr(SolveSpec, kind)(sources, params)


def routed_phase(res, device) -> dict:
    """The routed tier on kronecker(20,16): ``Solver(EngineConfig(tier=
    "routed", backend="blocked", use_alt=True))`` with two schedulers on
    the one card (its graph placed on both), warmed up, then fed the 64
    queries of :func:`routed_queries` through ``submit`` from this
    thread.  Every future must resolve, both schedulers must serve, the
    batched launches are counted (zeroed just before the first submit,
    read after the last answer), and every answer must be bitwise the
    single tier's for the same query (its batched specs of up to
    ``ROUTED_BATCH`` slots, finalized as the scheduler finalizes):
    dist, parent (but at verified exact f32 ties) and the logical
    counters.  Then phase 3d's delta A through the routed tier's
    ``apply_delta``, with two cached trees repaired: each bitwise a
    from-scratch solve on the patched engine's layout, a routed query
    after the delta equal to it, and no replica rebuilt."""
    from repro_torch.api import EngineConfig, Solver
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, sssp
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.serve import registry as registry_mod
    from repro_torch.serve.queries import Query, finalize
    name = "kronecker(20,16)"
    hg, dg, bg = res["host"], res["graph"], res["layout"]
    queries = routed_queries(res)
    cfg = EngineConfig(tier="routed", backend="blocked", use_alt=True,
                       devices=(device, device), max_batch=ROUTED_BATCH)
    solver = Solver.open(hg, cfg)
    router = solver.router
    router.plan_placement({solver.gid: 1.0})
    _, warm_s = timed(lambda: solver.warmup(kinds=("p2p",)), device)
    LAUNCHES.reset()
    sync(device)
    t0 = time.perf_counter()
    futs = [solver.submit(spec_of(k, s, p)) for k, s, p in queries]
    answers = [f.result(timeout=600) for f in futs]
    sync(device)
    routed_s = time.perf_counter() - t0
    launches = dict(edge_relax_batch=LAUNCHES.edge_relax_batch,
                    edge_relax_batch_alt=LAUNCHES.edge_relax_batch_alt)
    stray = dict(edge_relax=LAUNCHES.edge_relax,
                 edge_relax_alt=LAUNCHES.edge_relax_alt,
                 edge_relax_fused=LAUNCHES.edge_relax_fused)
    served = sorted({a.served_by for a in answers})
    stats = router.stats()
    if min(launches.values()) <= 0 or any(stray.values()):
        raise AssertionError(f"{name} routed: launches {launches}, "
                             f"one-state launches {stray}")
    if served != ["dev0", "dev1"]:
        raise AssertionError(f"{name} routed: served by {served}, not by "
                             "both schedulers of the card")
    log(f"[serving] {name}: {len(queries)} queries ({ROUTED_PER_KIND} each "
        f"of {', '.join(ROUTED_KINDS)}) through submit in {routed_s!r} s "
        f"({len(queries) / routed_s!r} queries/s) on {router.n_devices} "
        f"schedulers of one card, {stats['n_batches']} batches, occupancy "
        f"{stats['occupancy']!r}, launches {launches}; engine build, "
        f"landmarks and a p2p batch (warmup) {warm_s!r} s")
    kw = {"p2p": "target", "bounded": "bound", "knear": "k"}
    qobjs = [Query(gid=solver.gid, source=s, kind=k,
                   **({kw[k]: p} if k in kw else {}))
             for k, s, p in queries]

    # one scheduler thread alone: the same queries straight to scheduler
    # 0, queued while its worker is stopped (so it forms full batches)
    sched = router.schedulers[0]
    n0 = sched.n_batches
    sched.stop()
    futs = [sched.submit(q) for q in qobjs]
    sync(device)
    t0 = time.perf_counter()
    sched.start()
    alone = [f.result(timeout=600) for f in futs]
    sync(device)
    one_s = time.perf_counter() - t0
    for q, a, b in zip(qobjs, alone, answers):
        if not (np.array_equal(a.dist.view(np.int32), b.dist.view(np.int32))
                and np.array_equal(a.parent, b.parent)):
            raise AssertionError(f"{name}: {q} served by one scheduler "
                                 "differs from the two schedulers' answer")
    log(f"[serving] {name}: the same queries to one scheduler thread alone "
        f"in {one_s!r} s ({len(queries) / one_s!r} queries/s, "
        f"{sched.n_batches - n0} batches), answers bitwise the routed ones")

    # the yardstick: the single tier's batched specs of the same queries
    single, open_s = timed(lambda: Solver.open(dg, EngineConfig(
        backend="blocked", use_alt=True), layout=bg, device=device), device)
    groups = {k: [i for i, q in enumerate(queries) if q[0] == k]
              for k in ROUTED_KINDS}
    want = [None] * len(queries)
    sync(device)
    t0 = time.perf_counter()
    for kind, idx in groups.items():
        for lo in range(0, len(idx), ROUTED_BATCH):
            part = idx[lo:lo + ROUTED_BATCH]
            spec = spec_of(kind, [queries[i][1] for i in part],
                           None if kind == "tree"
                           else [queries[i][2] for i in part])
            out = single.solve(spec)
            for j, i in enumerate(part):
                want[i] = (out.dist[j], out.parent[j],
                           type(out.metrics)(*(m[j] for m in out.metrics)))
    sync(device)
    single_s = time.perf_counter() - t0
    ties = 0
    for q, a, (d, par, m) in zip(qobjs, answers, want):
        kind, s = q.kind, q.source
        w = finalize(q, hg.deg, d, par, m)
        ties += same_tree_up_to_ties(
            hg, torch.from_numpy(a.dist), torch.from_numpy(a.parent),
            torch.from_numpy(w.dist), torch.from_numpy(w.parent), None,
            f"{name} routed {kind} from {s}")
        logical = lambda md: {f: md[f] for f in (
            "n_steps", "n_rounds", "n_relax", "n_updates", "n_pruned",
            "nFrontier", "nSync", "nTrav", "reachable")}
        if logical(a.metrics) != logical(w.metrics) \
                or (kind == "p2p" and a.paths() != w.path):
            raise AssertionError(f"{name} routed {kind} from {s}: counters "
                                 "or path differ from the single tier's")
    log(f"[serving] {name}: the same queries through the single tier's "
        f"batched specs (up to {ROUTED_BATCH} slots) in {single_s!r} s "
        f"({len(queries) / single_s!r} queries/s; routed/single "
        f"{routed_s / single_s!r}); session open (landmarks) {open_s!r} s; "
        f"every routed answer bitwise the single tier's ({ties} parents "
        "at exact f32 ties)")

    # the card's busy share while both schedulers serve: 8 tree and 8
    # p2p queries queued alternately with the workers stopped (so dev0
    # takes the trees and dev1 the p2p queries, a full batch each)
    trees = [q for q in qobjs if q.kind == "tree"][:ROUTED_BATCH]
    pairs = [q for q in qobjs if q.kind == "p2p"][:ROUTED_BATCH]
    router.stop()
    futs = [router.submit(q) for pair in zip(trees, pairs) for q in pair]
    router.start()
    time.sleep(BUSY_SKIP_S)
    prof = busy_window(f"{name} routed: {ROUTED_BATCH} tree queries on "
                       f"dev0 and {ROUTED_BATCH} p2p on dev1, a "
                       f"{BUSY_WINDOW_S} s window", BUSY_WINDOW_S)
    by = {f.result(timeout=600).served_by for f in futs}
    if by != {"dev0", "dev1"}:
        raise AssertionError(f"{name}: the profiled batches were served by "
                             f"{by}")

    # phase 3d's delta A through the routed tier, with cached trees
    trees = [(s, a) for (k, s, _), a in zip(queries, answers)
             if k == "tree"][:2]
    reg = solver.registry
    for s, a in trees:
        reg.cache_result(solver.gid, s, a.dist, a.parent)
    delta = make_deltas(res, DELTA_SEEDS[name])["A mixed"]
    names = ("patch_host", "patch_blocked_with", "repair_state",
             "repair_relax")
    LAUNCHES.reset()
    with HostTimes(registry_mod, names) as host:
        report, delta_s = timed(lambda: solver.apply_delta(delta), device)
    repair_launches = LAUNCHES.edge_relax
    eng = reg.peek(solver.gid, device=device)
    if report["engines_patched"] != 1 or report["results_repaired"] != 2 \
            or router.n_rebuilds or eng is None or repair_launches <= 0:
        raise AssertionError(f"{name} routed apply_delta: "
                             f"{report['engines_patched']} engines patched, "
                             f"{report['results_repaired']} trees repaired, "
                             f"{router.n_rebuilds} rebuilds, "
                             f"{repair_launches} edge_relax launches")
    delta_ties = 0
    for s, _ in trees:
        d, p, _ = sssp(eng.g, s, backend="blocked", layout=eng.layout,
                       device=device)
        check_fixpoint(eng.g, d, p, s, f"{name} from scratch after delta A")
        d2, p2 = reg.cached_result(solver.gid, s)
        delta_ties += same_tree_up_to_ties(
            report["host"], torch.from_numpy(d2).to(device),
            torch.from_numpy(p2).to(device), d, p, None,
            f"{name} routed repair of the tree from {s}")
        after = solver.submit(spec_of("tree", s, None)).result(timeout=600)
        if not (bitwise_equal(torch.from_numpy(after.dist).to(device), d)
                and torch.from_numpy(after.parent).to(device).equal(p)):
            raise AssertionError(f"{name}: a routed tree query after the "
                                 "delta differs from a from-scratch solve")
    solver.close()
    log(f"[serving] {name} delta A through the routed apply_delta: "
        f"{delta_s!r} s, of which patch_host "
        f"{host.s['patch_host']!r} s, patch_blocked_with (a clone of the "
        f"served layout) {host.s['patch_blocked_with']!r} s, repair_state "
        f"{host.s['repair_state']!r} s and repair_relax "
        f"{host.s['repair_relax']!r} s for {len(trees)} cached trees "
        f"({repair_launches} edge_relax launches); each repaired tree "
        f"bitwise a from-scratch solve on the patched layout ({delta_ties} "
        "tie parents), routed queries after it too, no replica rebuilt")
    return dict(queries=len(queries), routed_s=routed_s, single_s=single_s,
                routed_qps=len(queries) / routed_s,
                single_qps=len(queries) / single_s, one_scheduler_s=one_s,
                busy_share=prof["busy_share"], warm_s=warm_s,
                open_s=open_s, launches=launches, served=served,
                batches=stats["n_batches"], occupancy=stats["occupancy"],
                tie_parents=ties, delta_s=delta_s,
                delta_parts={n: host.s[n] for n in names},
                repair_launches=repair_launches, delta_tie_parents=delta_ties)


def busy_window(what: str, seconds: float) -> dict:
    """Profile the card (CUDA activity only) for ``seconds`` of host
    time while other threads drive it: device kernel time over the
    window (the busy share) and the top kernels.  A window with no CUDA
    kernel fails (:func:`trace_kernels`)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        time.sleep(seconds)
        wall = time.perf_counter() - t0
    kern = trace_kernels(prof.key_averages(), what)
    device_s = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(window_s=wall, device_s=device_s, busy_share=device_s / wall,
               kernels=sum(e.count for e in kern),
               top={e.key[:60]: dict(count=e.count,
                                     ms=e.self_device_time_total / 1e3)
                    for e in top})
    log(f"[profile] {what}: " + json.dumps(out))
    return out


def serving_phase(results, device) -> dict:
    """Phase 3f: :func:`tuner_phase` and :func:`routed_phase`."""
    res = results["kronecker(20,16)"]
    return dict(tuner=tuner_phase(res, device),
                routed=routed_phase(res, device))


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
        # 48 rows of 3 queries at 500..502 in groups of 16 over one KV head
        # (split_tc in bf16), keys at 0..599 and -1 padded, with a window
        q, k, v = rand(2, 3, 1, 16, 128), rand(2, 600, 1, 128), \
            rand(2, 600, 1, 128)
        q_pos = (500 + torch.arange(3, dtype=torch.int32, device=device)
                 ).expand(2, 3)
        pad = torch.arange(600, dtype=torch.int32, device=device).expand(
            2, 600).clone()
        pad[:, torch.from_numpy(rng.integers(0, 600, 200)).to(device)] = -1
        for name, k_pos, window in (("arange", None, 0), ("padded", pad, 0),
                                    ("arange", None, 77)):
            args = (q, k, v, q_pos, k_pos)
            kw = dict(causal=True, window=window)
            cases.append((f"query chunk 500..502 HG=16 {name} {kw}",
                          (48, 128),
                          lambda args=args, kw=kw: ops.flash_attention_pos(
                              *args, **kw),
                          lambda args=args, kw=kw:
                          ops.flash_attention_pos_ref(*args, **kw)))
        # decode calls: one query per slot at its position over one layer
        # of a [L, B, T, KV, D] cache, keys at 0..T-1, -1 padded, or a ring;
        # positions past the cache, and below T - 1 with a window; the last
        # four with 9 to 63 rows (split_tc in bf16; granite-34b's 48 heads
        # over one KV head at its served cache first)
        for b, kv, hg, d, t, window, below in (
                (8, 8, 2, 128, 4096, 0, False), (5, 2, 1, 64, 700, 0, False),
                (3, 1, 8, 128, 513, 0, False),
                (4, 8, 2, 128, 1024, 1024, False),
                (8, 8, 2, 128, 300, 0, True), (8, 8, 2, 128, 4096, 97, True),
                (4, 1, 48, 128, 512, 0, False), (2, 2, 24, 64, 300, 0, False),
                (3, 1, 9, 128, 700, 61, True), (1, 1, 63, 64, 1000, 0, False)):
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


class MoeDrops:
    """Token-choices the MoE layers routed, and those capacity dropped,
    while open (``transformer.moe_route`` wrapped; the counts stay on the
    card until :attr:`dropped` reads them)."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.module, self.saved = transformer, transformer.moe_route
        self.counts, self.routed = [], 0

        def counted(cfg, lp, xt):
            r = self.saved(cfg, lp, xt)
            self.counts.append((~r.keep).sum())
            self.routed += r.keep.numel()
            return r
        transformer.moe_route = counted
        return self

    def __exit__(self, *exc):
        self.module.moe_route = self.saved
        self.dropped = int(torch.stack(self.counts).sum()) \
            if self.counts else 0

    @property
    def share(self) -> float:
        return self.dropped / self.routed if self.routed else 0.0


def lm_serve(cfg, params, device, *, serve=SERVE, n_requests=N_REQUESTS,
             max_new=MAX_NEW, prompt_lengths=PROMPT_LENGTHS, warm=True):
    """The serving path at full width: an engine of ``serve`` answers
    ``n_requests`` requests of ``max_new`` tokens (prompt lengths drawn by
    numpy seed 0 in ``prompt_lengths``).  The launch counter is zeroed
    just before the run and read just after; the engine's prefill and
    decode calls are timed (host clock, each ending in a synchronize).
    Every prefill launch must be the "tc" design and every decode launch
    the one ``ops.variant`` gives the model's decode rows; no plain
    attention may run.  MoE layers count their dropped token-choices
    (:class:`MoeDrops`)."""
    from repro_torch.kernels.flash_attn.ops import LAUNCHES, VARIANTS, \
        variant
    from repro_torch.serve.engine import Request, ServeEngine
    if warm:    # one short request (cuBLAS handles, first launches)
        warm = ServeEngine(cfg, params, max_batch=8, s_cache=512,
                           prompt_pad=256)
        warm.submit(Request(rid=-1, prompt=np.arange(300, dtype=np.int32)
                            % cfg.vocab, max_new=2))
        warm.run()
        del warm
    engine = ServeEngine(cfg, params, **serve)
    rng = np.random.default_rng(0)
    lengths = rng.integers(prompt_lengths[0], prompt_lengths[1] + 1,
                           n_requests)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new=max_new) for i, n in enumerate(lengths)]
    decode_kind = variant(cfg.dtype, cfg.hd, cfg.n_heads // cfg.n_kv)
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
    with PlainAttentionCalls() as plain, MoeDrops() as drops:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        steps = engine.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = LAUNCHES.flash_attention
    lens = [len(r.out) for r in reqs]
    if lens != [max_new] * n_requests:
        raise AssertionError(f"{cfg.name}: served token counts {lens}, "
                             f"expected {max_new} each")
    if st["nonfinite"]:
        raise AssertionError(f"{cfg.name}: {st['nonfinite']} logits were "
                             "NaN or inf")
    pre, dec = st["by_design"]["prefill"], st["by_design"]["decode"]
    if pre["all"] <= 0 or dec["all"] <= 0 or \
            launches != pre["all"] + dec["all"] or \
            pre["tc"] != pre["all"] or dec[decode_kind] != dec["all"]:
        raise AssertionError(
            f"{cfg.name}: flash_attention launches by design in prefill "
            f"{pre} and in decode {dec} ({launches} in all): every "
            f"prefill launch must be tc and every decode launch "
            f"{decode_kind}")
    if drops.routed and not cfg.moe:
        raise AssertionError(f"{cfg.name}: a dense model routed tokens")
    if any(plain.calls.values()):
        raise AssertionError(f"the serving path took the plain attention: "
                             f"{plain.calls}")
    pre_tok = sum(n for n, _ in st["prefill"])
    pre_s = sum(t for _, t in st["prefill"])
    dec_tok = sum(a for a, _ in st["decode"])
    dec_s = sum(t for _, t in st["decode"])
    return dict(
        requests=n_requests, max_new=max_new, engine_steps=steps,
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
        decode_design=decode_kind, plain_calls=plain.calls,
        moe_choices=drops.routed, moe_dropped=drops.dropped,
        moe_dropped_share=drops.share, tokens=[r.out for r in reqs])


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
# phase 4b: the other four LMs served at full width
# ---------------------------------------------------------------------------

# granite-34b last: its 67.9 GB of bf16 weights fill most of the card
SERVED_ARCHS = ("phi4-mini-3.8b", "deepseek-moe-16b", "granite-moe-3b-a800m",
                "granite-34b")
ARCH_SERVE = {arch: dict(serve=dict(max_batch=8, s_cache=1024,
                                    prompt_pad=256),
                         n_requests=8, max_new=16, prompt_lengths=(100, 700))
              for arch in SERVED_ARCHS}
ARCH_SERVE["granite-34b"] = dict(
    serve=dict(max_batch=4, s_cache=512, prompt_pad=256), n_requests=4,
    max_new=16, prompt_lengths=(100, 240))
FLASH_PREFILL_S = 512                # S = T of the new shapes' prefill check
MOE_TOKENS = (2, 256)                # moe_block's card-vs-CPU input
MOE_TOL = dict(rtol=1e-4, atol=1e-5)  # the CPU tests' float32 tolerance
NEAR_TIE = 1e-6


def release_card(what: str):
    """Drop every earlier phase's tensors that only caches still hold (the
    edge-relax kernels' scratch, the allocator's free blocks) and print
    what stays allocated."""
    import gc
    from repro_torch.kernels.edge_relax import ops
    ops._SCRATCH.clear()
    ops._FUSED_SCRATCH.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[memory] {what}: {torch.cuda.memory_allocated() / 1e9!r} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9!r} GB reserved")
    return torch.cuda.memory_allocated()


def serve_config(arch, device):
    """One architecture at full width in bf16, weights drawn on the card:
    ``ARCH_SERVE[arch]``'s requests through :func:`lm_serve`, then the
    same requests again, whose tokens must be identical."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    cfg = get(arch).make_config()
    before = release_card(f"before {arch}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ts = [params[k] for k in params if k != "layers"] + list(
        params["layers"].values())
    n = sum(t.numel() for t in ts)
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    if n != cfg.param_count():
        raise AssertionError(f"{arch}: {n} parameters drawn, "
                             f"param_count() {cfg.param_count()}")
    log(f"[lm] {arch}: {n} parameters, {nbytes / 1e9!r} GB in {cfg.dtype} "
        f"(router float32), drawn on the card in {init_s!r} s")
    spec = ARCH_SERVE[arch]
    first = lm_serve(cfg, params, device, **spec)
    again = lm_serve(cfg, params, device, warm=False, **spec)
    if again["tokens"] != first["tokens"]:
        raise AssertionError(f"{arch}: the same requests served twice gave "
                             "different tokens")
    peak = torch.cuda.max_memory_allocated()
    del params, ts
    out = dict(
        params=n, bytes=nbytes, init_s=init_s, peak_bytes=peak,
        allocated_before_bytes=before, tokens_identical_twice=True,
        **{k: first[k] for k in (
            "requests", "max_new", "engine_steps", "total_s",
            "prompt_lengths", "padded_prompt_lengths", "ttft_s",
            "prefill_tokens_per_s", "decode_ms_per_step",
            "decode_tokens_per_s", "launches", "launches_prefill",
            "launches_decode", "launches_by_design", "decode_design",
            "moe_choices", "moe_dropped", "moe_dropped_share")},
        again_total_s=again["total_s"],
        again_decode_ms_per_step=again["decode_ms_per_step"])
    log(f"[serve4b] {arch}: {out['requests']} requests x {out['max_new']} "
        f"tokens in {out['total_s']!r} s, time to first token "
        f"{min(out['ttft_s'])!r}..{max(out['ttft_s'])!r} s, prefill "
        f"{out['prefill_tokens_per_s']!r} tokens/s, decode "
        f"{out['decode_ms_per_step']!r} ms/step, peak memory "
        f"{peak / 1e9!r} GB, flash_attention launches "
        f"{json.dumps(out['launches_by_design'])} (decode design "
        f"{out['decode_design']}), MoE token-choices dropped by capacity "
        f"{out['moe_dropped']} of {out['moe_choices']} "
        f"({out['moe_dropped_share']!r}); served twice, tokens identical")
    return out


def flash_config_shapes(device):
    """``flash_attention`` at each served config's prefill call (S = T =
    ``FLASH_PREFILL_S``, causal) and decode call (its engine's slots at
    seeded positions of its cache) in bfloat16: against the plain
    version, launching the design ``ops.variant`` names, and timed
    (:func:`_flash_numbers`; the library yardstick is
    ``scaled_dot_product_attention``)."""
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attn import ops
    bf = torch.bfloat16
    rng = np.random.default_rng(9)
    out = {}
    for arch in SERVED_ARCHS:
        cfg = get(arch).make_config()
        kv, hg, d, h = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd, cfg.n_heads
        s = FLASH_PREFILL_S
        q = _randn(rng, (1, s, kv, hg, d), bf, device)
        k, v = _randn(rng, (1, s, kv, d), bf, device), \
            _randn(rng, (1, s, kv, d), bf, device)
        qh = q.reshape(1, s, h, d).transpose(1, 2)
        calls = dict(
            kernel=lambda: ops.flash_attention_pos(q, k, v, causal=True),
            plain=lambda: ops.flash_attention_pos_ref(q, k, v, causal=True),
            library=lambda: F.scaled_dot_product_attention(
                qh, k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True).transpose(1, 2).reshape(q.shape))
        row = {}
        for call, rows in (("prefill", s * hg), ("decode", hg)):
            if call == "decode":
                eng = ARCH_SERVE[arch]["serve"]
                b, t = eng["max_batch"], eng["s_cache"]
                cache = _randn(rng, (2, b, t, kv, d), bf, device)
                kc, vc = cache[0], cache[1]
                q = _randn(rng, (b, 1, kv, hg, d), bf, device)
                qh = q.reshape(b, 1, h, d).transpose(1, 2)
                pos = torch.from_numpy(rng.integers(
                    t // 4, t, (b, 1)).astype(np.int32)).to(device)
                mask = (torch.arange(t, device=device)[None, :] <= pos)[
                    :, None, None, :]
                calls = dict(
                    kernel=lambda: ops.flash_attention_pos(
                        q, kc, vc, pos, None, causal=True),
                    plain=lambda: ops.flash_attention_pos_ref(
                        q, kc, vc, pos, None, causal=True),
                    library=lambda: F.scaled_dot_product_attention(
                        qh, kc.transpose(1, 2), vc.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True).transpose(
                        1, 2).reshape(q.shape))
                visible = int(mask.sum())
                flops = 4 * d * h * visible
                bytes_ = 2 * (2 * visible * kv * d + 2 * q.numel()) + 4 * b
            else:
                flops = 4 * d * h * (s * (s + 1) // 2)
                bytes_ = 2 * (2 * q.numel() + k.numel() + v.numel())
            kind = ops.variant(bf, d, rows)
            before = flash_launches()
            calls["kernel"]()
            launched = launches_since(before)
            if launched != dict(all=1, **{n: int(n == kind)
                                          for n in ops.VARIANTS}):
                raise AssertionError(f"flash_attention {arch} {call}: "
                                     f"expected one {kind} launch, got "
                                     f"{launched}")
            m = _flash_numbers(calls, flops=flops, bytes_=bytes_,
                               what=f"{arch} {call}")
            m.update(design=kind, kv=kv, hg=hg, d=d, rows=rows)
            if kind == "split_tc":
                # the CUDA-core design that served this call before, on the
                # same inputs
                o = torch.empty_like(q)
                simt = lambda: ops._flash_cuda(q, kc, vc, pos, None, o, True,
                                               0, kind="simt")
                simt()
                m["simt_max_abs_err"] = flash_check(
                    o, calls["plain"](), bf, f"{arch} {call} simt")
                m["simt_ms"] = graph_ms(simt)
            row[call] = m
            log(f"[flash_attention] {arch} {call} (KV={kv} HG={hg} D={d}, "
                f"{kind}): " + json.dumps(m))
        out[arch] = row
    return out


def _near_ties(probs, k: int):
    top = torch.sort(probs, dim=-1, descending=True).values
    return (top[:, k - 1] - top[:, k]) <= NEAR_TIE * top[:, k - 1]


def moe_card_vs_cpu(device):
    """``moe_block`` on the card against the same call on the CPU, in
    float32 with TF32 off, at each MoE config's full width cut to one
    layer (weights drawn on the card, copied to the CPU), on
    ``MOE_TOKENS`` seeded tokens: ``idx`` equal wherever the k-th and
    (k+1)-th probabilities are more than ``NEAR_TIE`` apart (the
    near-ties are counted), ``keep`` and ``cap`` equal, ``y`` and
    ``aux`` within ``MOE_TOL``."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch in ("deepseek-moe-16b", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(get(arch).make_config(), n_layers=1,
                                  dtype=torch.float32)
        params = T.init_params(cfg, torch.Generator(device=device).manual_seed(1))
        lp = T._layer(params, 0)
        lp = {k: v for k, v in lp.items() if k not in ("wq", "wk", "wv",
                                                       "wo")}
        del params
        lp_cpu = {k: v.cpu() for k, v in lp.items()}
        x = np.random.default_rng(8).normal(
            0, 1, (*MOE_TOKENS, cfg.d_model)).astype(np.float32)
        xc, xh = torch.from_numpy(x).to(device), torch.from_numpy(x)
        yc, auxc = T.moe_block(cfg, lp, xc)
        yh, auxh = T.moe_block(cfg, lp_cpu, xh)
        rc = T.moe_route(cfg, lp, xc.reshape(-1, cfg.d_model))
        rh = T.moe_route(cfg, lp_cpu, xh.reshape(-1, cfg.d_model))
        near = _near_ties(rh.probs, cfg.top_k)
        ok = ~near
        same_idx = bool(rc.idx.cpu()[ok].equal(rh.idx[ok]))
        same_keep = bool(rc.keep.cpu().equal(rh.keep)) if not near.any() \
            else None
        gap = float((yc.cpu() - yh).abs().max())
        close = bool(torch.allclose(yc.cpu()[ok.reshape(yh.shape[:2])],
                                    yh[ok.reshape(yh.shape[:2])],
                                    **MOE_TOL))
        aux_close = abs(float(auxc) - float(auxh)) <= \
            MOE_TOL["atol"] + MOE_TOL["rtol"] * abs(float(auxh))
        ms = cuda_ms(lambda: T.moe_block(cfg, lp, xc), reps=10)
        m = dict(tokens=int(np.prod(MOE_TOKENS)), cap=rh.cap,
                 near_ties=int(near.sum()), idx_equal=same_idx,
                 keep_equal=same_keep, max_abs_err=gap,
                 aux=float(auxc), aux_cpu=float(auxh),
                 dropped=int((~rc.keep).sum()), card_ms=ms)
        log(f"[moe] {arch} one layer at full width, f32: " + json.dumps(m))
        if rc.cap != rh.cap or not same_idx or same_keep is False or \
                not close or not aux_close:
            raise AssertionError(f"moe_block {arch}: the card and the CPU "
                                 f"differ: {m}")
        out[arch] = m
        del lp, lp_cpu
    return out


def lm_configs_phase(device):
    """Phase 4b: ``flash_attention`` at the new shapes, ``moe_block`` card
    against CPU, then each of ``SERVED_ARCHS`` served
    (:func:`serve_config`)."""
    release_card("phase 4b")
    flash = flash_config_shapes(device)
    mark("phase 4b flash_attention at the new shapes")
    moe = moe_card_vs_cpu(device)
    mark("phase 4b moe_block card vs CPU")
    served = {}
    for arch in SERVED_ARCHS:
        served[arch] = serve_config(arch, device)
        mark(f"phase 4b {arch} served")
    release_card("after phase 4b")
    return dict(flash=flash, moe=moe, served=served)


# ---------------------------------------------------------------------------
# phase 4c: training (AdamW, microbatches, checkpoints, the restartable loop)
# ---------------------------------------------------------------------------

LM_TRAIN = dict(batch=8, seq=512, steps=4, microbatches=2)
PARITY_TRAIN = dict(n_layers=2, batch=2, seq=128, steps=1)
MIND_TRAIN = dict(batch=512, steps=3)
RESTART = dict(n_layers=2, batch=4, seq=256, steps=4, preempt_at=1)


def _leaves(tree):
    from repro_torch.train.tree import leaves
    return leaves(tree)


def timed_steps(step, state, batches, what):
    """Run ``step`` over ``batches`` from ``state = (params, opt_state)``;
    each step ends in a synchronize.  The loss and ``grad_norm`` must be
    finite.  Returns the final state, the seconds of each step and the
    metrics."""
    params, opt_state = state
    secs, metrics = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{what} step {i}: non-finite {m}")
        metrics.append(m)
    return (params, opt_state), secs, metrics


def check_trained(before, state, what):
    """Parameters kept their dtypes and shapes; every parameter moved (in
    its f32 master copy where the state holds one: a bf16 norm weight at
    1.0 does not show a step of 3e-4); the moments (and master weights)
    are float32."""
    params, opt_state = state
    moved = _leaves(opt_state.get("master", params))
    for b, p, m in zip(_leaves(before), _leaves(params), moved):
        if p.dtype != b.dtype or p.shape != b.shape:
            raise AssertionError(f"{what}: a parameter changed dtype or "
                                 f"shape: {b.dtype} -> {p.dtype}")
        if torch.equal(m, b.to(m.dtype)):
            raise AssertionError(f"{what}: a parameter of shape "
                                 f"{tuple(p.shape)} did not move")
    for key in ("m", "v", "master"):
        if any(t.dtype != torch.float32 for t in
               _leaves(opt_state.get(key, {}))):
            raise AssertionError(f"{what}: optimizer state {key} is not "
                                 "float32")


def lm_training(device):
    """qwen3-0.6b at full width in bf16 with f32 master weights:
    ``make_lm_train_step(microbatches=2)`` on ``LMTokenStream`` batches
    of 8 x 512 for 4 steps; ms/step, tokens/s, peak memory, and one
    profiled step's device time against its wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.data.synthetic import LMTokenStream
    from repro_torch.kernels.flash_attn.ops import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.train import loop, optimizer as opt
    cfg = get("qwen3-0.6b").make_config()
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=2,
                           total_steps=LM_TRAIN["steps"])
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    before = [t.clone() for t in _leaves(params)]
    state = (params, opt.adamw_init(params, ocfg))
    del params
    step = loop.make_lm_train_step(cfg, ocfg,
                                   microbatches=LM_TRAIN["microbatches"])
    stream = LMTokenStream(cfg.vocab, seed=0)
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    batches = [{"tokens": stream.batch(i, b, s)}
               for i in range(LM_TRAIN["steps"])]
    LAUNCHES.reset()
    state, secs, metrics = timed_steps(step, state, batches, "qwen3 train")
    if LAUNCHES.flash_attention:
        raise AssertionError("training launched the flash kernel")
    check_trained(before, state, "qwen3 train")
    if int(state[1]["step"]) != LM_TRAIN["steps"]:
        raise AssertionError("the optimizer did not count its steps")
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        _, sec5, _ = timed_steps(step, state, batches[:1], "profiled step")
    kern = trace_kernels(prof.key_averages(), "lm_training step")
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    steady = float(np.mean(secs[1:]))
    out = dict(params=cfg.param_count(), batch=b, seq=s,
               microbatches=LM_TRAIN["microbatches"], step_s=secs,
               ms_per_step=steady * 1e3, tokens_per_s=b * s / steady,
               peak_bytes=peak, losses=[m["loss"] for m in metrics],
               grad_norms=[m["grad_norm"] for m in metrics],
               lrs=[m["lr"] for m in metrics],
               profiled_step_wall_ms=sec5[0] * 1e3,
               profiled_step_device_ms=device_ms,
               profiled_step_kernels=sum(e.count for e in kern))
    log(f"[train] qwen3-0.6b full width bf16 (master weights), "
        f"{b} x {s} tokens, microbatches {LM_TRAIN['microbatches']}: "
        f"{out['ms_per_step']!r} ms/step after the first "
        f"({secs[0] * 1e3!r} ms), {out['tokens_per_s']!r} tokens/s, peak "
        f"memory {peak / 1e9!r} GB, losses {out['losses']}, grad norms "
        f"{out['grad_norms']}; a profiled step {device_ms!r} ms on the "
        f"device of {sec5[0] * 1e3!r} ms wall (profiler on)")
    return out


def train_card_vs_cpu(device):
    """The same train step on the card and on the CPU: qwen3-0.6b's width
    cut to 2 layers, float32 with TF32 off, ``LMTokenStream`` batches of
    2 x 128, 2 steps from the same weights: the losses at rtol 1e-5,
    ``grad_norm`` at rtol 1e-4, the parameters within an absolute 2·lr
    per step taken (the CPU tests' tolerances)."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import LMTokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import loop, optimizer as opt
    from repro_torch.train.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get("qwen3-0.6b").make_config(),
                              n_layers=PARITY_TRAIN["n_layers"],
                              dtype=torch.float32)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(2))
    states = {"card": (params, opt.adamw_init(params, ocfg))}
    cpu = tree_map(lambda t: t.cpu(), params)
    states["cpu"] = (cpu, opt.adamw_init(cpu, ocfg))
    del params, cpu
    step = loop.make_lm_train_step(cfg, ocfg)
    stream = LMTokenStream(cfg.vocab, seed=3)
    budget, out = 0.0, dict(steps=[])
    for i in range(PARITY_TRAIN["steps"]):
        batch = {"tokens": stream.batch(i, PARITY_TRAIN["batch"],
                                        PARITY_TRAIN["seq"])}
        res = {}
        for where, (p, o) in states.items():
            t0 = time.perf_counter()
            p, o, m = step(p, o, batch)
            sync(_leaves(p)[0].device)
            res[where] = (p, o, {k: float(v) for k, v in m.items()},
                          time.perf_counter() - t0)
            states[where] = (p, o)
        budget += 2 * res["cpu"][2]["lr"]
        gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            _leaves(res["card"][0]), _leaves(res["cpu"][0])))
        mc, mh = res["card"][2], res["cpu"][2]
        row = dict(loss=mc["loss"], loss_cpu=mh["loss"],
                   grad_norm=mc["grad_norm"], grad_norm_cpu=mh["grad_norm"],
                   max_param_gap=gap, param_budget=budget,
                   card_s=res["card"][3], cpu_s=res["cpu"][3])
        out["steps"].append(row)
        log(f"[train] card vs CPU step {i} (qwen3 width, 2 layers, f32): "
            + json.dumps(row))
        if abs(mc["loss"] - mh["loss"]) > 1e-5 * abs(mh["loss"]) or \
                abs(mc["grad_norm"] - mh["grad_norm"]) > \
                1e-4 * abs(mh["grad_norm"]) or gap > budget:
            raise AssertionError(f"train step {i}: the card and the CPU "
                                 f"differ: {row}")
    return out


def mind_training(device):
    """MIND uncut (a 10^7 x 64 f32 item table on the card):
    ``make_mind_train_step`` (AdamW, no master weights) on
    ``RecsysStream`` batches of 512 for 3 steps; ms/step, users/s, peak
    memory."""
    from repro_torch.configs import get
    from repro_torch.data.synthetic import RecsysStream
    from repro_torch.models.recsys import mind
    from repro_torch.train import loop, optimizer as opt
    cfg = get("mind").make_config()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                           total_steps=MIND_TRAIN["steps"],
                           master_weights=False)
    release_card("before MIND training")
    torch.cuda.reset_peak_memory_stats()
    params = mind.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    before = [t.clone() for t in _leaves(params)]
    state = (params, opt.adamw_init(params, ocfg))
    del params
    stream = RecsysStream(cfg.n_items, cfg.hist_len, seed=0)
    batches = [stream.batch(i, MIND_TRAIN["batch"])
               for i in range(MIND_TRAIN["steps"])]
    state, secs, metrics = timed_steps(loop.make_mind_train_step(cfg, ocfg),
                                       state, batches, "MIND train")
    check_trained(before, state, "MIND train")
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(secs[1:]))
    out = dict(batch=MIND_TRAIN["batch"], step_s=secs,
               ms_per_step=steady * 1e3,
               users_per_s=MIND_TRAIN["batch"] / steady, peak_bytes=peak,
               losses=[m["loss"] for m in metrics])
    log(f"[train] MIND 10^7 x 64, batch {MIND_TRAIN['batch']}: "
        f"{out['ms_per_step']!r} ms/step after the first "
        f"({secs[0] * 1e3!r} ms), {out['users_per_s']!r} users/s, peak "
        f"memory {peak / 1e9!r} GB, losses {out['losses']}")
    return out


def restartable_training(device):
    """``run_restartable`` on a 2-layer full-width qwen3 in bf16: 4 steps
    straight through, then a run that signals itself (SIGTERM) in step
    2, checkpoints at step 2 and stops, and its resumption to step 4, in
    a temporary directory removed afterwards.  The resumed run's
    parameters and optimizer state must equal the straight run's within
    an absolute 2·lr per step (printed: whether they are bitwise)."""
    import signal
    import tempfile
    from repro_torch.configs import get
    from repro_torch.data.synthetic import LMTokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import failure, loop, optimizer as opt
    cfg = dataclasses.replace(get("qwen3-0.6b").make_config(),
                              n_layers=RESTART["n_layers"])
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                           total_steps=RESTART["steps"])
    step = loop.make_lm_train_step(cfg, ocfg)
    stream = LMTokenStream(cfg.vocab, seed=4)

    def run(ckpt_dir, preempt_at=None):
        params = T.init_params(
            cfg, torch.Generator(device=device).manual_seed(3))

        def make_batch(i):
            if i == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return {"tokens": stream.batch(i, RESTART["batch"],
                                           RESTART["seq"])}
        t0 = time.perf_counter()
        res = failure.run_restartable(
            step, make_batch, (params, opt.adamw_init(params, ocfg)),
            n_steps=RESTART["steps"], ckpt_dir=ckpt_dir, ckpt_every=0,
            log_fn=log)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        (want, last, pre), straight_s = run(os.path.join(tmp, "straight"))
        if (last, pre) != (RESTART["steps"], False):
            raise AssertionError(f"straight run ended at {last}, {pre}")
        cut_dir = os.path.join(tmp, "cut")
        (_, last, pre), cut_s = run(cut_dir, RESTART["preempt_at"])
        if (last, pre) != (RESTART["preempt_at"] + 1, True):
            raise AssertionError(f"preempted run ended at {last}, {pre}")
        ckpt_bytes = sum(f.stat().st_size for f in
                         Path(cut_dir).rglob("*") if f.is_file())
        (got, last, pre), resume_s = run(cut_dir)
        if (last, pre) != (RESTART["steps"], False):
            raise AssertionError(f"resumed run ended at {last}, {pre}")
    pairs = list(zip(_leaves(got), _leaves(want)))
    bitwise = all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs)
    gap = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    budget = 2 * ocfg.lr * RESTART["steps"]
    out = dict(steps=RESTART["steps"], preempted_at=RESTART["preempt_at"]
               + 1, checkpoint_bytes=ckpt_bytes, straight_s=straight_s,
               preempted_s=cut_s, resumed_s=resume_s, bitwise=bitwise,
               max_abs_diff=gap, tolerance=budget)
    log(f"[train] restartable (qwen3 width, 2 layers, bf16): " +
        json.dumps(out))
    if gap > budget:
        raise AssertionError(f"the resumed run differs from the straight "
                             f"one by {gap!r} (> {budget!r})")
    return out


def training_phase(device):
    """Phase 4c: :func:`lm_training`, :func:`train_card_vs_cpu`,
    :func:`mind_training`, :func:`restartable_training`."""
    release_card("phase 4c")
    out = dict(lm=lm_training(device))
    mark("phase 4c qwen3-0.6b training")
    release_card("after qwen3 training")
    out["card_vs_cpu"] = train_card_vs_cpu(device)
    mark("phase 4c train step card vs CPU")
    out["mind"] = mind_training(device)
    mark("phase 4c MIND training")
    release_card("after MIND training")
    out["restartable"] = restartable_training(device)
    mark("phase 4c restartable loop")
    release_card("after phase 4c")
    return out


# ---------------------------------------------------------------------------
# phase 4d: the GNN models trained at full width, and the anchor features
# ---------------------------------------------------------------------------

GNN_ARCHS = ("gin-tu", "gatedgcn", "pna", "dimenet")
GNN_SHAPES = ("full_graph_sm", "molecule")
GNN_STEPS = 4                    # one warm-up step, then the timed ones
GNN_SEED = 0
# 30 steps, a cut of depth paying for phase 4f (60 before it; after 60
# the accuracy was the majority label's share, 0.6161)
ANCHORS = dict(k=8, seed=0, steps=30, lr=5e-3, warmup=5)


def gnn_cell_batch(shape: str, seed: int = GNN_SEED):
    """``(arrays, n_graphs, graph_level)`` of a GNN cell, shaped as the
    reference's ``launch/cells.py::_gnn_cell`` counts it: ``full_graph_sm``
    is ``gnn_node_classification`` (symmetrised, with positions);
    ``molecule`` is ``molecule_batch`` flattened with node offsets and
    symmetrised, with seeded normal features and regression targets.
    Both carry ``build_triplets`` slots at the shape's cap (DimeNet's)."""
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.data.generators import molecule_batch
    from repro_torch.data.synthetic import gnn_node_classification
    from repro_torch.data.triplets import build_triplets
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        arrays = gnn_node_classification(sh["n_nodes"], sh["n_edges"],
                                         sh["d_feat"], sh["n_classes"],
                                         seed=seed, with_pos=True)
        arrays["graph_ids"] = np.zeros(sh["n_nodes"], np.int32)
        n_graphs = 1
    else:
        n, b = sh["n_nodes"], sh["batch"]
        mb = molecule_batch(n, sh["n_edges"], b, seed=seed)
        off = (np.arange(b, dtype=np.int32) * n)[:, None]
        snd = (mb["senders"] + off).ravel()
        rcv = (mb["receivers"] + off).ravel()
        rng = np.random.default_rng(seed + 1)
        arrays = dict(
            node_feat=rng.normal(0, 1, (n * b, sh["d_feat"])).astype(
                np.float32),
            senders=np.concatenate([snd, rcv]),
            receivers=np.concatenate([rcv, snd]),
            pos=mb["pos"].reshape(-1, 3),
            graph_ids=np.repeat(np.arange(b, dtype=np.int32), n),
            labels=rng.normal(0, 1, b).astype(np.float32))
        n_graphs = b
    kj, ji, mk = build_triplets(arrays["senders"], arrays["receivers"],
                                sh["triplet_cap"], seed=seed)
    arrays.update(triplet_kj=kj, triplet_ji=ji, triplet_mask=mk)
    return arrays, n_graphs, sh["kind"] == "train_graphs"


def gnn_model(arch: str, shape: str, graph_level: bool):
    """The module, the config at full width as ``_gnn_cell`` builds it
    (``remat`` but on the molecule shape, f32) and the train step
    (AdamW without master weights; cross entropy, or the regression step
    at graph level)."""
    from repro_torch.configs import get
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.train import loop, optimizer as opt
    conf = get(arch)
    mod = importlib.import_module(f"repro_torch.models.gnn.{conf.MODEL}")
    sh = SHAPES[shape]
    kw = dict(remat=sh["kind"] != "train_graphs")
    if conf.MODEL == "dimenet":
        kw["triplet_chunks"] = sh.get("dimenet_chunks", 1)
    cfg = conf.make_config(d_in=sh["d_feat"], n_classes=sh["n_classes"],
                           graph_level=graph_level, **kw)
    ocfg = opt.AdamWConfig(master_weights=False)
    if graph_level:
        step = loop.make_gnn_regression_step(mod.forward, cfg, ocfg)
    else:
        step = loop.make_gnn_train_step(mod.forward, cfg, ocfg)
    return mod, cfg, ocfg, step


def same_step(card, cpu, what):
    """One step's card result against the CPU's from the same weights and
    batch: the loss at rtol 1e-5 and every parameter within 2·lr, or,
    where the CPU's loss is not finite (PNA at the molecule shape,
    reference fault 5), the same non-finite loss and NaN in the same
    leaves, the rest within 2·lr."""
    (p, m), (pc, mc) = card, cpu
    loss, loss_cpu = float(m["loss"]), float(mc["loss"])
    budget = 2 * float(mc["lr"])
    gap, nan_same = 0.0, True
    for a, b in zip(_leaves(p), _leaves(pc)):
        a = a.cpu()
        na, nb = torch.isnan(a), torch.isnan(b)
        nan_same &= bool(torch.equal(na, nb))
        keep = ~(na | nb)
        if bool(keep.any()):
            gap = max(gap, float((a[keep] - b[keep]).abs().max()))
    row = dict(loss=loss, loss_cpu=loss_cpu, max_param_gap=gap,
               param_budget=budget, nan_leaves_same=nan_same,
               fault5=not np.isfinite(loss_cpu))
    if np.isfinite(loss_cpu):
        ok = abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu) and gap <= budget
    else:
        ok = (not np.isfinite(loss) and nan_same and gap <= budget)
    if not ok:
        raise AssertionError(f"{what}: the card's step differs from the "
                             f"CPU's: {row}")
    return row


def dimenet_basis_card_vs_cpu(gb, cfg, device, what):
    """DimeNet's geometry and bases on the card bitwise the CPU's, on the
    cell's positions and triplets."""
    from repro_torch.models.gnn import dimenet
    out = {}
    for where in ("card", "cpu"):
        b = gb.to(device if where == "card" else "cpu")
        vec, dist = dimenet.edge_geometry(b.pos, b.senders, b.receivers)
        cos_t = dimenet.triplet_cos(b.pos, vec, b.senders, b.receivers,
                                    b.triplet_kj, b.triplet_ji)
        out[where] = [t.cpu() for t in (
            dist, cos_t, dimenet.rbf_basis(cfg, dist),
            dimenet.sbf_basis(cfg, dist[b.triplet_kj], cos_t))]
    names = ("dist", "cos", "rbf", "sbf")
    differ = {n: int((a.view(torch.int32) != b.view(torch.int32)).sum())
              for n, a, b in zip(names, out["card"], out["cpu"])}
    row = dict(elements={n: a.numel() for n, a in zip(names, out["cpu"])},
               differ=differ, sbf_max_abs=float(out["cpu"][3].abs().max()),
               min_dist=float(out["cpu"][0].min()))
    log(f"[gnn] {what} DimeNet basis card vs CPU: " + json.dumps(row))
    if any(differ.values()):
        raise AssertionError(f"{what}: DimeNet's basis on the card is not "
                             f"the CPU's bit for bit: {differ}")
    return row


def gnn_cell(arch, shape, arrays, n_graphs, graph_level, device):
    """One cell: the model at full width trained for ``GNN_STEPS`` steps
    on the card (the first a warm-up), its first step against the same
    step on the CPU; ms/step (the median of the others: the phase's
    first cell still warms the context up in its second step), peak
    memory, losses."""
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.tree import tree_map
    mod, cfg, ocfg, step = gnn_model(arch, shape, graph_level)
    gb = GraphBatch(edge_feat=None, n_graphs=n_graphs,
                    **{k: torch.from_numpy(v) for k, v in arrays.items()})
    card_gb = gb.to(device)
    torch.cuda.reset_peak_memory_stats()
    params = mod.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(GNN_SEED))
    n_params = sum(t.numel() for t in _leaves(params))
    cpu = tree_map(lambda t: t.cpu(), params)
    state = (params, opt.adamw_init(params, ocfg))
    del params
    params1 = None
    secs, metrics = [], []
    for i in range(GNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(*state, card_gb)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            params1 = tree_map(lambda t: t.cpu(), p)
        state = (p, o)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pc, _, mc = step(cpu, opt.adamw_init(cpu, ocfg), gb)
    cpu_s = time.perf_counter() - t0
    vs = same_step((params1, metrics[0]), (pc, mc), f"{arch} {shape}")
    losses = [m["loss"] for m in metrics]
    if not vs["fault5"] and not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} {shape}: non-finite losses {losses}")
    out = dict(arch=arch, shape=shape, params=n_params,
               nodes=int(arrays["node_feat"].shape[0]),
               edges=int(arrays["senders"].shape[0]),
               triplet_slots=int(arrays["triplet_kj"].shape[0]),
               remat=cfg.remat, step_s=secs,
               ms_per_step=float(np.median(secs[1:])) * 1e3, peak_bytes=peak,
               losses=losses, grad_norms=[m["grad_norm"] for m in metrics],
               cpu_step_s=cpu_s, card_vs_cpu=vs)
    if arch == "dimenet":
        out["basis"] = dimenet_basis_card_vs_cpu(gb, cfg, device,
                                                 f"{arch} {shape}")
    log(f"[gnn] {arch} {shape}: {out['ms_per_step']!r} ms/step (median "
        f"after the first, {secs[0] * 1e3!r} ms), peak {peak / 1e9!r} GB, "
        f"{n_params} parameters, losses {losses}; the CPU's step "
        f"{cpu_s:.2f} s; card vs CPU " + json.dumps(vs))
    del state, card_gb
    return out


def anchor_training(kron, device):
    """The reference example's flow (``examples/gnn_sssp_features.py``) on
    phase 3's kronecker(20,16): 8 seeded anchors solved as one batched
    ``SolveSpec.tree`` on ``blocked`` (``edge_relax_batch``: counted from
    zero just before and read just after; each slot bitwise its single
    ``sssp`` solve), features ``exp(-d)``, the nearest anchor as label,
    and gin-tu at full width (5 x 64, remat) for 30 AdamW steps (the
    example's 3 x 32 widened).  Returns the numbers and the batch
    kernel's launches."""
    from repro_torch.api import EngineConfig
    from repro_torch.configs import get
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import sssp
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.models.gnn import gin
    from repro_torch.models.gnn.anchors import anchor_distance_features
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train import loop, optimizer as opt
    t0 = time.perf_counter()
    dg = kron.to_device(device)
    bg = build_blocked(dg)
    sync(device)
    layout_s = time.perf_counter() - t0
    LAUNCHES.reset()
    sync(device)
    t0 = time.perf_counter()
    feats, anchors = anchor_distance_features(
        dg, ANCHORS["k"], ANCHORS["seed"],
        config=EngineConfig(backend="blocked"), layout=bg, device=device)
    sync(device)
    solve_s = time.perf_counter() - t0
    launches = LAUNCHES.edge_relax_batch
    if not launches or LAUNCHES.edge_relax:
        raise AssertionError(f"the anchors' batched solve launched "
                             f"edge_relax_batch {launches} and edge_relax "
                             f"{LAUNCHES.edge_relax} times")
    want = torch.stack([sssp(dg, int(a), backend="blocked", layout=bg,
                             device=device)[0] for a in anchors])
    want = torch.where(torch.isfinite(want), torch.exp(-want), 0.0).T
    if not torch.equal(feats, want):
        raise AssertionError("the anchors' batched distances are not the "
                             "single solves'")
    labels = feats.argmax(1).to(torch.int32)
    gb = GraphBatch(node_feat=feats,
                    senders=torch.from_numpy(kron.src).to(device),
                    receivers=torch.from_numpy(kron.dst).to(device),
                    edge_feat=None,
                    graph_ids=torch.zeros(kron.n, dtype=torch.int32,
                                          device=device), labels=labels)
    cfg = get("gin-tu").make_config(d_in=ANCHORS["k"],
                                    n_classes=ANCHORS["k"], remat=True)
    ocfg = opt.AdamWConfig(lr=ANCHORS["lr"], warmup_steps=ANCHORS["warmup"],
                           total_steps=ANCHORS["steps"],
                           master_weights=False)
    torch.cuda.reset_peak_memory_stats()
    params = gin.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0))
    state = (params, opt.adamw_init(params, ocfg))
    del params
    state, secs, metrics = timed_steps(
        loop.make_gnn_train_step(gin.forward, cfg, ocfg), state,
        [gb] * ANCHORS["steps"], "anchor GIN")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        acc = float((gin.forward(cfg, state[0], gb).argmax(-1) == labels)
                    .float().mean())
    out = dict(anchors=[int(a) for a in anchors], layout_s=layout_s,
               solve_s=solve_s,
               batch_launches=launches, nodes=kron.n, edges=kron.m,
               label_share=torch.bincount(labels.long(), minlength=8)
               .div(kron.n).tolist(),
               steps=ANCHORS["steps"], first_step_ms=secs[0] * 1e3,
               ms_per_step=float(np.mean(secs[1:])) * 1e3, peak_bytes=peak,
               losses=[m["loss"] for m in metrics[::10]] +
               [metrics[-1]["loss"]],
               accuracy=acc)
    log("[anchors] kronecker(20,16), 8 anchors on blocked, gin-tu 5 x 64: "
        + json.dumps(out))
    del state, gb, feats, dg, bg
    return out


def gnn_phase(kron, device):
    """Phase 4d: each GNN at full width on ``full_graph_sm`` and
    ``molecule`` (:func:`gnn_cell`), in float32 with TF32 off, then the
    anchor features on kronecker(20,16) (:func:`anchor_training`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    release_card("phase 4d")
    cells = []
    for shape in GNN_SHAPES:
        t0 = time.perf_counter()
        arrays, n_graphs, graph_level = gnn_cell_batch(shape)
        log(f"[gnn] {shape}: {arrays['node_feat'].shape[0]} nodes, "
            f"{arrays['senders'].shape[0]} directed edges, "
            f"{int(arrays['triplet_mask'].sum())} of "
            f"{arrays['triplet_kj'].shape[0]} triplet slots, data in "
            f"{time.perf_counter() - t0:.2f} s")
        for arch in GNN_ARCHS:
            cells.append(gnn_cell(arch, shape, arrays, n_graphs, graph_level,
                                  device))
        mark(f"phase 4d {shape}")
    release_card("before the anchor features")
    anchors = anchor_training(kron, device)
    mark("phase 4d anchor features")
    release_card("after phase 4d")
    return dict(cells=cells, anchors=anchors)


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
            kernels, solves, trees = report(graphs, device)
        finally:
            tdist.destroy_process_group()
    kron = graphs[0][1]           # kept on the host for phases 4d and 4e
    del graphs

    lm = lm_phases(device)
    mark("phase 4 (language model)")
    lm_configs = lm_configs_phase(device)
    mark("phase 4b (four LMs served)")
    training = training_phase(device)
    mark("phase 4c (training)")
    gnn = gnn_phase(kron, device)
    mark("phase 4d (GNN training)")
    del kron
    # phase 4e's module imports this script by name: let it find this run
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from tooling_phase import tooling_phase
    tooling = tooling_phase(trees, device, cut=True)
    mark("phase 4e (tooling)")
    del trees
    torch.cuda.empty_cache()
    from dryrun_phase import SMOKE_CELLS, dryrun_phase
    dry = dryrun_phase(device, SMOKE_CELLS)
    mark("phase 4f (dry-run)")
    rows = {r["name"]: r for r in kernels}
    partials = rows["edge_relax_partials"]
    partials["launches_dryrun"] = dry["launches"]
    partials["launches"] += dry["launches"]
    partials["dryrun_shapes"] = {
        key: {k: r[k] for k in ("world", "block", "edges", "launches",
                                "round_ms", "n_relax", "keys_vs_plain")}
        for key, r in dry["sssp"].items() if "v2" in key}
    for name, launches in (
            ("edge_relax", tooling["variant"]["launches"]),
            ("edge_relax_fused", tooling["variant"]["fused_launches"]),
            ("edge_relax_batch",
             tooling["traffic"]["launches"]["edge_relax_batch"])):
        rows[name]["launches_tooling"] = launches
        rows[name]["launches"] += launches
    batch_row = rows["edge_relax_batch"]
    batch_row["launches_gnn_anchors"] = gnn["anchors"]["batch_launches"]
    batch_row["launches"] += gnn["anchors"]["batch_launches"]
    served = lm_configs["served"]
    row = lm["kernel"]
    row["launches_qwen3"] = row["launches"]
    row["launches"] += sum(m["launches"] for m in served.values())
    row["launches_by_config"] = {
        arch: dict(prefill=m["launches_prefill"], decode=m["launches_decode"],
                   decode_design=m["decode_design"],
                   by_design=m["launches_by_design"])
        for arch, m in served.items()}
    row["new_shapes"] = {
        arch: {call: {k: m[k] for k in ("design", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
               for call, m in by.items()}
        for arch, by in lm_configs["flash"].items()}
    row["max_abs_err"] = max([row["max_abs_err"]] + [
        m["max_abs_err"] for by in lm_configs["flash"].values()
        for m in by.values()])
    kernels.append(row)
    kernels.append(split_tc_row(lm_configs))
    torch.cuda.empty_cache()
    recsys = recsys_phases(device, profiled)
    mark("phase 5 (recsys)")
    kernels.append(recsys["kernel"])
    print(json.dumps({"kernels": kernels}), flush=True)
    log(json.dumps(solves))
    log(json.dumps({"serving": lm["serving"], "parity": lm["parity"]}))
    log(json.dumps({"lm_configs": {
        "served": {a: {k: v for k, v in m.items() if k != "tokens"}
                   for a, m in served.items()},
        "moe": lm_configs["moe"]}, "training": training}))
    log(json.dumps({"gnn": gnn}))
    log(json.dumps({"tooling": tooling}, default=str))
    log(json.dumps({"dryrun": dry}))
    log(json.dumps({"recsys": {"layer": recsys["layer"],
                               "mind": recsys["serving"]}}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def split_tc_row(lm_configs) -> dict:
    """The ``kernels`` entry of flash_attention's "split_tc" design: its
    numbers at granite-34b's decode call (phase 4b, beside "simt" forced
    on the same call) and its launches in phase 4b's served runs."""
    served = lm_configs["served"]
    m = lm_configs["flash"]["granite-34b"]["decode"]
    eng = ARCH_SERVE["granite-34b"]["serve"]
    if m["design"] != "split_tc":
        raise AssertionError(f"granite-34b's decode call ran {m['design']}")
    by_arch = {arch: sum(r["launches_by_design"][call]["split_tc"]
                         for call in ("prefill", "decode"))
               for arch, r in served.items()}
    return {
        "name": "flash_attention[split_tc]", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:77",
        "launches": sum(by_arch.values()), "launches_by_config": by_arch,
        **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "eager_ms",
                             "simt_ms", "simt_max_abs_err")},
        "shape": f"granite-34b decode: B = {eng['max_batch']} slots of a "
                 f"{eng['s_cache']}-slot cache, {m['hg']} query heads over "
                 f"{m['kv']} KV head, D = {m['d']}, bf16",
    }


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
    v2 = v2_path(results, p2p, device)
    mark("phase 3b2 (v2, v3)")
    facade_rows, facade = facade_phase(results, p2p, device)
    mark("phase 3c (facade)")
    deltas = delta_phase(results, device)
    mark("phase 3d (deltas)")
    traces = trace_phase(results, facade, device)
    mark("phase 3e (traces)")
    serving = serving_phase(results, device)
    mark("phase 3f (tuner, serving plane)")

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
    row_query = lambda name: p2p[name]["queries"][ALT_ROW_PAIR.get(name, 0)]
    alt = {name: measure_alt(res, p2p[name]["landmarks"], row_query(name),
                             device)
           for name, res in results.items()}
    for name, m in alt.items():
        log(f"[edge_relax[alt]] {name}: " + json.dumps(m))
    fused_alt = {name: measure_fused_alt(res, p2p[name]["landmarks"],
                                         row_query(name), device)
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
    # edge_relax_partials' launches on phase 3b2's paths
    kv2 = v2["kronecker(20,16)"]
    v2_launches = {f"{n} {w}": r["launches"] for n in results
                   for w, r in v2[n]["solves"].items()}
    v2_launches.update({
        "kronecker(20,16) v2 batch": kv2["batch"]["launches"],
        **{f"kronecker(20,16) A repair {v}": r["launches"]
           for v, r in kv2["repairs"].items()},
        "kronecker(20,16) sharded-tier Solver": kv2["tier"]["launches"],
        "kronecker(20,16) mesh scheduler": kv2["tier"]["mesh_launches"]})

    def alt_launches(kinds):
        """Launches of an ALT kernel over the p2p phase's solves of
        ``kinds``, per graph."""
        return {n: sum(q["solves"][k]["launches"] for q in p2p[n]["queries"]
                       for k in kinds if k in q["solves"]) for n in results}
    alt_per_graph = alt_launches(("alt", "alt bidirectional"))
    fused_alt_per_graph = alt_launches(("alt fused",))
    per_query = lambda kind: {n: [q["solves"][kind]["launches"]
                                  if kind in q["solves"] else None
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
        "launches": sum(r["v1_launches"] for r in results.values())
        + sum(v2_launches.values()),
        "max_abs_err": max(m["max_abs_err"] for m in partials.values()),
        "ms": phead["ms"], "plain_ms": phead["plain_ms"],
        "bound_ms": phead["bound_ms"], "bound_by": "bytes",
        "library_ms": phead["library_ms"],
        "per_graph": by_graph(partials),
        "launches_per_solve": {n: r["v1_launches"]
                               for n, r in results.items()},
        "launches_v2_v3": v2_launches,
    }, {
        "name": "edge_relax_partials[alt]", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/edge_relax.py:497",
        "launches": sum(map(sum, v1_alt_launches.values()))
        + sum(q["launches"] for q in v2["kronecker(20,16)"]["queries"]),
        "max_abs_err": max(m["max_abs_err"] for m in partials_alt.values()),
        "ms": pahead["ms"], "plain_ms": pahead["plain_ms"],
        "bound_ms": pahead["bound_ms"], "bound_by": "bytes",
        "library_ms": pahead["library_ms"],
        "per_graph": by_graph(partials_alt),
        "launches_per_query": v1_alt_launches,
        "launches_per_v2_query": [
            q["launches"] for q in v2["kronecker(20,16)"]["queries"]],
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
        "v1_goals": v1q["goals"], "v2": v2, "facade": facade,
        "deltas": deltas,
        "traces": traces, "serving": serving}
    # launches of each kernel in each repair of phase 3d
    per_repair = lambda mode: {k: d["repairs"][mode]["launches"]
                               for k, d in deltas.items()
                               if mode in d["repairs"]}
    for row in kernels:
        mode = {"edge_relax": "blocked", "edge_relax_fused": "fused",
                "edge_relax_partials": "v1"}.get(row["name"])
        if mode:
            row["launches_per_repair"] = per_repair(mode)
    # launches on phase 3f's paths: the tuner's candidates, the 64 routed
    # queries and the routed tier's repair of two cached trees
    tuner, routed = serving["tuner"], serving["routed"]
    kernels[0]["launches_tuner"] = tuner["launches"]["edge_relax"]
    kernels[0]["launches_routed_repair"] = routed["repair_launches"]
    kernels[2]["launches_tuner"] = tuner["launches"]["edge_relax_fused"]
    for row in facade_rows:
        row["launches_routed"] = routed["launches"][
            row["name"].replace("[alt]", "_alt")]
    # phase 3's trees on the host, for phase 4e
    trees = {n: dict(host=r["host"], source=r["source"],
                     dist=r["dist"].cpu().numpy(),
                     parent=r["parent"].cpu().numpy(), metrics=r["metrics"])
             for n, r in results.items()}
    return kernels + facade_rows, solves, trees


if __name__ == "__main__":
    sys.exit(main())
