#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

  python3 chip_smoke.py [--scale 22] [--reps 10]

1. Starts the distributed phase's host ingress in a child process (step
   3b), prints the card's name and power limit and builds the four CUDA
   sources from `src/repro_torch/kernels/csrc/` (the combine,
   flash-attention forward and backward, EmbeddingBag) with `nvcc`
   (sm_90a), one `nvcc` per source, all started together.  Every phase ends with a
   `phase_s <name>=<seconds>` line, and the run with one `phase_s` JSON
   line of them all.
2. Builds the Graph500 R-MAT graph (a=0.57, b=c=0.19, edge factor 16,
   seed 0, integer weights in [1, 65535]) at `--scale` and its partitions
   on the card, then holds the combine kernel against its plain PyTorch
   version on messages gathered from that partition: the dense route at
   D=1 (sum, min, max) and D=32 (min), and one real bucketed frontier tile
   (min), whose lanes go through the tile route: the compaction kernel
   (held bitwise, in lane order, against `compact_lanes_plain`, once with
   the frontier counts' valid total and once counting on its own), the
   stable sort of the valid lanes, the row pointer and the combine kernel.
   Then the kernels' edge cases (`adversarial_inputs`: every segment empty,
   a hub of 1,200,000 edges across hundreds of shares, adjacent hubs, a
   segment count that is no multiple of a share, a ragged tile and a tile
   with no valid lane) at D in {1, 3, 32, 64} and each op, on positive
   messages.  Min/max must be bitwise equal to the plain version, and two
   launches bitwise equal to each other.  Sums must agree with the plain
   version evaluated in float64 on the same values to within 1e-5 of the
   float64 sum of the terms' magnitudes (the sum itself for positive
   messages; held GNN messages and gradients carry signs): the
   float32 plain version sums with atomics in an arbitrary order, and on
   hub segments (in-degree ~1e5) its own rounding drift
   (~eps·sqrt(in-degree)) is of the order of that tolerance; its distance
   from the float64 sum is printed beside the kernel's.
   Times come from CUDA events (median of `--reps`); `launches` counts
   the kernel launches of the timed loop; `bound_ms` is the bytes the
   kernel must move over 3.35 TB/s: the messages of the edges this input
   routes to a segment (a tile's sentinel lanes lie past the row
   pointer's end and are never read), the row pointer and the output
   (the kernel never reads dst).  The whole tile route (compaction, sort,
   row pointer, kernel) also reads every lane's dst; its `route_bound_ms`
   counts that, and the compaction's `bound_ms` is that read plus 8 bytes
   written per valid lane.  `library_ms` is one `torch.segment_reduce`
   call on the same inputs, a yardstick only (the compaction has none).
3. Drives the graph path through the port's entry points
   (`DevicePartition.from_graph`, `GREEngine`, `init_state`, `run`):
   PageRank (30 supersteps), SSSP (frontier "auto"), BFS (frontier
   "compact" and "dense"), CC and 32-lane BFS, each held against a
   numpy/scipy oracle: one untimed pass, then the timed pass, with the
   combine and compaction kernels' launch counters set to 0 before it and
   read after it.
3a. Right after step 3, on its graph and source: plan autotuning
   (`repro_torch.tuning.tune`) for SSSP over the default `PlanSearchSpace`
   (dense, flat at 4 caps, compact at 4 caps x 3 bucket ladders, the
   engine's default plan seeded into the final rung; each ladder's
   partition built once) and for BFS over `SMOKE_SPACE`, each into a plan
   cache of its own in a temporary directory (`tune` lines: candidates,
   every final-rung time, the candidates the card cannot run (a tile
   beyond the kernels' int32 lanes, or out of memory: `inf`), the winner,
   its time against the default's, the partition builds' seconds).  A second `tune` must hit the cache with no
   probe.  `GREEngine(plan="auto-tuned")` then adopts the stored plan on
   the partition of its ladder; its first 3 supersteps' combine calls are
   held against the plain version, and its run (untimed, then timed with
   the combine counts set to 0 before and read after, beside the default
   engine's) must equal the default engine's and the oracle bitwise
   (`tuned_run` lines).  Then multi-stage Brandes BC
   (`repro_torch.core.multistage`) over 64 sources (numpy seed 0, among
   the vertices with out-edges) in batches of 16 payload lanes
   (`BC_BATCH`: the dense scan's messages and gathered rows take
   2·E·3·batch·4 bytes, ~25 GB at 16), `max_depth` the largest finite BFS
   depth from these sources plus one: every combine call of the first
   batch held against the plain version as it returns, its depths exactly
   equal to a host Brandes in numpy/scipy float64 (`host_brandes`), σ within
   1e-4 and BC within 1e-3 relative (f32 sums of positive terms: each
   level adds a few ulps a sum, and δ compounds σ's error over the
   levels); then the 4 batches through `accumulate_bc` (what
   `betweenness_centrality` runs) with the counts set to 0 before and read
   after, one `bc_batch` line a batch (wall, supersteps), the peak memory,
   and the dense route launched (the tile route too where `auto` compacts:
   at scale 22 its worst-case hub tile out-scans the dense path, so it
   stays dense).  Then `kernels.ops.embedding_bag` on
   autoint's largest table, `[10_000_000, 16]` f32, with 4,096 sorted bags
   of 1-64 ids and per-id weights: one counted call (exactly one forward
   launch of `csrc/embedding_bag.cu` and no combine launch), both of its
   kernels held on its inputs (two launches bitwise equal, within SUM_RTOL
   of the plain versions in float64), the scratch bytes the forward and
   the backward allocate above their inputs and outputs (less than one
   `[n, d]` buffer, and the backward less than a row pointer over the
   table), its time, device time (profiler), bound and
   `torch.nn.functional.embedding_bag`'s time (a yardstick only).  Then
   the kernels' edge cases, each forward and backward held the same way at
   d in {1, 3, 16, 64, 100, 128, 200}: empty bags between full ones and 100
   trailing, one bag holding every id, one id at every position, ids 0 and
   N - 1, no weights, no id at all, int64 ids, bags past num_bags.  Then,
   information only, the forward at GCN's propagate shape on the scale-22
   partition (ids its src, bags its dst, GCN's sym norm, a `[V, d]` table,
   d = 16 and 100): held in float64 a few columns at a time, timed beside
   today's route (`index_select`, scale, the combine kernel) and
   `F.embedding_bag` (`embedding_bag_gcn` lines).
3b. Distributed phase, after the single-shard partitions are freed: the
   same graph on k = 8 shards stacked on the card
   (`repro_torch.core.dist_engine`), placed by `partition_edges(method=
   "hdrf")`, CC on the agent graph of the undirected graph.  The child
   process of step 1 builds both agent graphs and `partition_quality`
   while the phases before run; the `dist_ingress` lines print its
   seconds, the replication factor and remote-edge fraction, |V_s|, |V_c|,
   the exchange pads and the stacked topologies' bytes on the card.
   PageRank (30 supersteps) under agent, agent with overlap, dense and
   pipelined (async must refuse it); SSSP ("auto") under those and async
   (staleness 2); BFS ("compact") under agent, pipelined and async; CC
   under agent and async.  One untimed pass of every run, then the
   timed pass with the combine and compaction counts set to 0 before it
   and read after it (the `dist_launches` line).  SSSP, BFS and CC must
   equal the oracles bitwise and PageRank within 1e-4; the sync and
   pipelined runs must take the single-shard run's supersteps; the
   dense-route combine must launch in every run and the tile route in
   the compacted BFS.  One `dist_run` line a run: supersteps, wall ms,
   edges/s, launches, and the values the exchange moves a superstep:
   |V_s| + |V_c| for agent and pipelined (a window's share for async),
   |V_s| + k·k·cap for dense (paper §5.1), beside the entries counted
   through the communicator (padding and activity flags included).
   Then the SSSP winner of step 3a, stored with `phases="pipelined"`
   under the k = 8 agent graph's plan key: `DistGREEngine(plan=
   "auto-tuned")` must select the pipelined exchange, and its SSSP must
   equal the default (agent) engine's and the oracle bitwise
   (`dist_tuned` line).
   Then the kernels at the distributed path's own shapes: every combine
   call of the first 3 supersteps of PageRank and SSSP under agent,
   dense and pipelined, the compacted BFS under agent and pipelined and
   CC under agent is recorded (inputs as the wrapper got them) and held
   as in step 2: the stacked combine, the flush route, the dense
   exchange's `[k, k·cap]` vectors, the pipelined compact spaces and the
   compacted tiles (one `dist_hold` line a run).
3c. Incremental re-convergence, single shard, right after step 3 (one
   `incremental` line a program): a 1% churn delta of the directed graph
   (numpy seed 21: ~652 K removals and ~652 K adds at scale 22, weights in
   [1, 100)) on a partition built from the edge stream in chunks with slack
   for its adds (its first E columns, CSR and row pointer must equal the
   main path's), and a 1% symmetric churn of the undirected graph on the
   main path's partition.  `apply_edge_delta`, then per program
   `warm_start_state` (host seconds of both printed) and the warm run
   against a cold run on the mutated partition: BFS "compact", SSSP "auto"
   and CC bitwise equal, PageRank (100 supersteps) within 1e-4.  Each run
   first goes superstep by superstep, counting its exact edge scans (the
   active masters' live out-degrees, as benchmarks/bench_incremental.py
   counts them), untimed; then the timed run with the combine counts set to
   0 just before and read just after.
3d. Graph serving, single shard (`graph_serving` lines): a `ServingFrontend`
   over 8-lane BFS, SSSP and PPR batchers (4 supersteps a tick) serves 48
   queries arriving by `poisson_ticks` (2 a round, kinds in turn, sources
   among the vertices with out-edges, numpy seed 0; BFS on compacted
   frontiers, SSSP "auto", PPR on the dense scan): an untimed pass of the
   first 6 queries, the timed pass, then the stream again with a small
   delta (0.01% churn)
   landing mid-flight on the BFS batcher under "finish" and on the SSSP
   batcher under "reseed".  Each pass: every BFS and SSSP answer equals a
   fresh single-source run on the graph its query ran on, bitwise, and the
   last PPR answer (a recycled lane) a fresh PPR batcher's, bitwise; p50
   and p99 latency, queries a second, ticks, supersteps, host reads a tick
   and the combine counts are printed.  Then the graph engine's restart
   contract (paper §6.3; `graph_checkpoint` line): the main path's SSSP on
   its partition runs 3 supersteps, `graph_engine_snapshot` (masters and
   the active bitmap) goes into a synchronous `CheckpointManager`, comes
   back through `restore` and `graph_engine_restore` (agent slots at the
   identity) and runs to its end: its state must equal the uninterrupted
   run's bit for bit, in as many supersteps, and the oracle exactly.
3f. GNN training, right after the `embedding_bag` phase of step 3a
   (`repro_torch.models.gnn`, `repro_torch.optim.AdamW`, K1 behind
   autograd): gcn-cora (2 layers, d_hidden 16, sym norm, 7 classes) and
   gin-tu (5 layers, d_hidden 64, learnable eps, 2 classes) over the whole
   graph with `[V, 100]` planted features (ogb_products' d_feat; labels
   and features planted as in examples/gnn_fullbatch.py): a first step
   with every combine call, forward and backward, held against the plain
   version as it returns (the float64 reference a block of columns at a
   time), then 5 timed steps of forward, `gnn_loss`, backward and AdamW
   (`gnn_step` lines: ms, peak memory, K1 launches forward and backward
   beside the expected `n_layers` and `n_layers - 1`; no tile-route or
   compaction launch), then the first step's gradients again from the
   same parameters, bitwise equal (no float atomic in the backward).  At
   scale 16 both models' loss and gradients through the kernels against
   the same functions on the plain versions in float64 on the card, within
   1e-4 (`gnn_f64_check`).  Then GCN on `NeighborSampler` minibatches
   (1024 seeds, fanout (15, 10), a `[V, 602]` feature table on the card;
   3 steps: host sample seconds, device ms) and one GIN step on 128
   molecule graphs of 30 nodes and 64 edges, mean-pooled through K1.
   After step 3e, on the directed graph's k = 8 sync topology: one GCN
   gradient pass through `propagate_sharded` from the single-card run's
   initial parameters, its loss within 1e-5 and its gradients within 1e-4
   (of each leaf's largest) of the single card's (`gnn_dist` line).  The
   `embedding_bag` phase also runs its backward (one launch: a sort of
   the ids, a memset, one walk of the sorted runs for the table and weight
   gradients): both gradients against float64, timed (and with only the
   weights asked for) against the plain version and `F.embedding_bag`'s
   backward.
3e. After step 3b, on its stacked shards: SSSP under agent re-converges
   through `DistGREEngine.rerun_incremental` from step 3c's delta on the
   directed graph's agent graph built with head-room in its pads (by the
   child of step 1: the same placement, `pad_multiple` 2**18), from the
   fixed point of the step-3b agent graph (at scale 22 the two share their
   master rows); it must equal a cold stacked run on a topology built anew
   and step 3c's single-shard cold result, bitwise (`dist_incremental`
   line: host seconds of the delta ingress, warm start, topology rebuild
   and run).  The compaction fallback runs on an R-MAT scale-16
   hash-partitioned graph built there.  Then step 3d's BFS queries through
   an 8-lane batcher ("compact") on the k = 8 shards under agent (an
   untimed pass of the first 6 first), each held bitwise against step
   3d's single-shard answer on the unchanged graph (`dist_serving` line).
   Step 3b's `dist_run` lines also count each run's host reads of the
   frontier and of a compaction's valid total; the latter must be 0
   (every tile route passes its count).
3g. After the k = 8 GCN pass: the same distributed path on 8 processes,
   one shard a rank (`repro_torch.dist.world`, `ProcessGroupComm`, gloo
   over CUDA tensors on the one card: gloo stages them through host
   memory and TCP on 127.0.0.1, so the ranks' times measure that, not
   NVLink).  The parent writes both agent graphs and GCN's node rows
   (planted features, labels, train mask, degrees) to `.npy` files once
   and frees the card; each rank memory-maps them and builds only its
   shard's topology.  Each rank runs PageRank (30) under agent and dense,
   SSSP under agent, pipelined and async (staleness 2), the compacted BFS
   under agent and CC under agent: the combine calls of its first 3
   supersteps held on their own inputs as in step 3b, then the run with
   the counts and `values` set to 0 just before and read just after,
   between two barriers (`dist_rank_run` lines: rank 0's wall, launches,
   peak memory and topology seconds of each rank).  Min programs must
   equal step 3b's stacked run and the oracle bitwise, PageRank the
   stacked run within 1e-5 (whether bitwise is printed) and the oracle
   within 1e-4; every rank's result must be the same, the supersteps the
   stacked run's, and the ranks' `values` add up to the stacked count.
   Then one GCN gradient pass over the 8 ranks (`rank_gcn`: the loss's
   count and the gradients summed over the ranks in rank order) within
   1e-5 (loss) and 1e-4 (gradients) of step 3f's stacked k = 8 pass, the
   ranks bitwise equal to each other (`dist_rank_gcn`); then, in the same
   world (`rank_models`), step 3h's DimeNet gradient pass over the ranks
   within the same bounds of the stacked pass, every rank's loss and
   gradients equal (`dist_rank_dimenet`), AutoInt's serve_p99 batch
   through `sharded_embedding_lookup` on each rank's 4,627,500 table rows,
   bitwise the whole table's lookup, the logits within 1e-5
   (`dist_rank_autoint`), and BFS x8 and SSSP x8 batchers over the
   directed agent graph serving the first 16 BFS/SSSP queries of step
   3d's stream, every answer's digest equal to the stacked k = 8
   batchers' (computed after step 3e's `dist_serving`; p50/p99 latency,
   queries a second, host reads a tick: `graph_serving_ranks`); a world of one
   NCCL rank whose every communicator call must equal `StackedComm(1)`'s
   bitwise (`dist_nccl_world`).  The `dist_ranks_world` line prints the
   spawn and init seconds of each rank, the parent's memory on the card
   before the spawn and each rank's peak.
3h. After the GNN phase of step 3f, full width, every sum through K1:
   DimeNet (6 blocks, d_hidden 128, n_bilinear 8, 7 spherical, 6
   radial) and MACE (2 layers, d_hidden 128, l_max 2, correlation 3, 8
   radial) on GNN_SHAPES' molecule batch: 128 `random_geometric_molecule`
   graphs of 30 atoms and 64 edges (numpy seeds 0-127), species in
   [0, 16) and planted targets (numpy seed 5), DimeNet's triplets from
   `build_triplets`.  Per model a first MSE step with every combine call
   (forward and backward) held against the plain version, EQ_TIMED_STEPS
   timed steps of AdamW (`eq_step`: ms, peak memory, K1 launches against
   `expected_eq_launches`), and the summed outputs' rotation and
   translation invariance within the JAX package's bounds (1e-4 DimeNet,
   1e-3 MACE, relative) (`dimenet_molecule`, `mace_molecule`).  AutoInt
   on the `[37,020,000, 16]` table (`autoint`): serve_p99 logits (B =
   512), a held then timed train_batch steps (B = 65,536; one K1 launch,
   the table gradient), retrieval against 10^6 candidates, and
   `sharded_embedding_lookup` over `StackedComm(8)` bitwise the whole
   table's at both batch sizes.  Then DimeNet on 1,024 molecules (30,720
   atoms, 65,536 edges) through the single-card forward and through
   `dimenet_forward_sharded` on k = 8 HDRF shards stacked on the card:
   loss within 1e-5 and gradients within 1e-4 of each leaf's largest
   (`dimenet_sharded`).  Step 3g repeats it over the ranks.
4. Attention kernel phase: the flash-attention kernel against its plain
   version at smollm-135m's prefill shape (B=4, S=2048, 3 kv heads x 3,
   H=64, causal, bf16), a ragged causal length (S=1000, bf16), float32
   (2, 512, 2, 2, 64), non-causal Sq != Sk (1, 64/192, 2, 2, 32, float32)
   and H=128 (bf16), and the corners of the bf16 kernel's design: non-
   causal Sq != Sk (2, 300/1000, 2, 3, 64), H=16 and H=32, G=1 and G=8
   (three shares of a kv head's query heads, the last one short), and B=2
   at a ragged Sq = Sk = 1000 (a TMA map that read past a batch's rows
   into the next batch would show there).  Tolerances: float32 within
   2e-5 (the JAX package's own, tests/test_kernels.py; TF32 is off and the
   kernel uses none);
   bf16, against the plain version on the same bf16 inputs, within two
   bf16 ulps of each element (2**-6 of it) plus 3% of the RMS of its row
   (the head dim): the two round p to bf16 at different scales, and an
   element that cancels to near 0 keeps the rounding error of its row's
   terms.  A late causal row averages ~2000 keys, so its outputs are
   ~0.02-0.05 and a flat 3e-2 would be as large as they are.  The limit is
   checked, not assumed: at smollm's shape two faults planted in the plain
   version's last query tile (kv tile [64, 128) skipped; the causal mask
   leaking key i+1 into row i) must each exceed it.  Two launches must be
   bitwise equal.  `bound_ms` is the larger of the
   FLOPs the visible (query, key) pairs need, 4·H per pair, over the
   peak for the input type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
   float32), and the bytes of q, k, v and o over 3.35 TB/s.  `library_ms`
   is one `scaled_dot_product_attention(enable_gqa=True)` call on the same
   inputs in its own layout, a yardstick the port never calls.
4a. The attention backward (`attention_backward_case` lines): at the
   LM training shapes (smollm-135m B=4, S=4096, Kv=3, G=3, H=64;
   granite-moe B=2, S=4096, Kv=8, G=2, H=64; qwen3-moe B=1, S=2048, Kv=4,
   G=8, H=128; bf16, causal) and six small cases in float32 and bf16
   (causal and not, Sq < Sk and Sq > Sk, ragged S=1000, G = 1, 3 and 8,
   every head dim), the forward kernel's row statistic `lse` against the
   plain logsumexp (1e-4 of 1 + |lse|; the forward's output unchanged by
   asking for it), then the backward kernel against
   `flash_attention_bwd_plain` on the same (q, k, v, o, lse, dO): dQ, dK,
   dV within 1e-4 (float32) or one bf16 ulp (bf16) of the element plus
   1e-4 of its row's and its tensor's RMS (dS cancels to rounding noise
   on rows whose probabilities are one-hot, query row 0 among them), two
   launches bitwise equal.  Times are CUDA-event medians; `bound_ms` is 5
   products of 2·H FLOP a visible pair over the type's peak against the
   bytes of q, k, v, o, dO, lse, dQ, dK, dV; `library_ms` at every case
   is SDPA's backward through `autograd.grad`, a yardstick.  Every bound
   is `repro_torch.launch.roofline`'s, the counts the dry run charges a
   kernel call.
5. LM serving phase, full-width smollm-135m (30 layers, d_model 576, 9
   heads over 3 kv heads, bf16; random weights from a CUDA generator
   seeded 0), with the attention kernel's launch count set to 0 before and
   read after: the `launch/serve.py` flow (batched prefill B=4 of 2048
   tokens, then 32 greedy decode steps; one warm-up run of the flow at
   that shape comes first, uncounted), then `ContinuousBatcher(8 slots,
   max_len 2112)` serving 16 requests with prompt lengths uniform in
   128-2048 (numpy seed 0) and 32 new tokens each.  Each run must launch
   the kernel 30 times per prefill.  Then: prefill's last-position logits
   must be bitwise equal to `lm_forward`'s on the same tokens (a plumbing
   check of the cache path: both run the same kernels at the same shapes);
   one decode step's logits must lie within 5e-2 of the largest
   `lm_forward` logit (bf16 through 30 layers, decode attention a plain
   product on one side and the kernel on the other); and, the check that
   holds decode exactly, at full width in float32 (TF32 off) three short
   requests through the batcher must give exactly the tokens of offline
   greedy generation through `lm_forward`.
5a. MoE serving (`moe_model` lines): granite-moe-1b-a400m at full width
   and depth (24 layers, d_model 1024, 32 experts top-8, bf16, 1.385 B
   parameters) through the serve flow (B=4 × 2048, 32 decode steps) and
   the batcher (as step 5), then qwen3-moe-30b-a3b at full width (d_model
   2048, 128 experts top-8, H = 128, G = 8) cut to 4 of its 48 layers
   (3.1 B parameters; 48 layers would need 61 GB of bf16 weights) through
   the serve flow (B=1 × 2048, 8 decode steps).  K3 must launch once a
   layer a prefill and K1 (the MoE combine) once a layer a prefill or
   decode step; the logits are held as in step 5 under a capacity factor
   that drops no hit (cap = T: a full forward and a decode step then see
   the same sums); layer 0's `moe_ffn` at ample capacity is held against
   `moe_ffn_reference` (the `[T, E, D]` oracle) and the expert-sharded
   form on `StackedComm(4)` against the local call, within the bf16
   attention limit.
5b. LM training (`train_run` lines) through `launch.train.main`:
   smollm-135m `--full-size` at seq 4096 (LM_SHAPES train_4k; batch cut
   256 → 4), 6 steps (the first untimed), then the same run crashed at
   step 4 (`--fail-at 4`, a snapshot every 4 steps) and resumed: the
   resumed run's loss and final snapshot must equal the uninterrupted
   run's bit for bit; granite-moe-1b-a400m `--full-size`, seq 4096, batch
   2, 4 steps, its final parameters kept, then twice more as the mesh
   holds' planted faults (uncounted): with `--lr 0` (an update never
   applied) and at batch 1 (a gradient of other tokens).  Each step must
   launch K3's forward 2·L times (every layer checkpointed) and its
   backward L times; the first backward call of each model's first step
   is held against the plain backward.
5c. LM training over a device mesh (`lm_mesh` lines): the granite run of
   step 5b again with `--mesh 2x2` (4 gloo ranks sharing the card, each
   holding its blocks of `dist.sharding.lm_mesh_specs`, the same weights
   and batches), started in a thread before step 3b's wait for the
   ingress children (the card is idle then) and joined within it; held
   after step 5b.  One `lm_mesh_step` line a rank and step (loss, ms, the
   step's peak, launches); each rank's step must launch K3's forward 2·L,
   its backward L and K1 `1 + 2·L` times; every K1 call of each rank's
   first step is held on its own inputs; rank 0's loss at each step must
   lie within MESH_LOSS_RTOL of the 1x1 run's, and the final parameters,
   gathered from the ranks, within MESH_PARAM_LIMIT of the 1x1 run's
   leaf by leaf (`mesh_state` line: ‖P_mesh − P_1x1‖ / ‖P_1x1 − P_0‖);
   the frozen run's losses must fail the first limit and the batch-1
   run's parameters the second.  Then `dryrun_hold`:
   a child process that sees no card, started before step 4, dry-runs
   smollm's training step at 1x1 (B=4) and granite's at 2x2 (B=2) on fake
   tensors (`launch.cells.lm_train_setup`); each predicted peak a device
   must lie within [0.67, 1.5] of the peak the card measured in this run,
   and the predicted bound is printed beside the measured step time.
6. Prints the `kernels` JSON line (the combine kernel's two routes, the
   compaction, `embedding_bag` and the attention kernel; the combine
   entries also carry their launches in step 3a's tuned runs and BC pass,
   the GNN steps' forward and backward launches and the ranks' of step 3g
   (summed over the ranks), and the (op, width) of
   every call held on the path's own inputs; `embedding_bag` its
   backward's launches and times, its edge cases held and its GCN-shaped
   times; the attention backward at smollm's training shape, its launches
   those of the training runs), the nvidia-smi line, and last
   `{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero; without a card it
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the kernels' bounds (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16, 67 f32),
# the same counts the dry run charges a kernel call
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_FLOPS, attention_bound, attention_bwd_bound,
    bound_ms, emb_bound_ms, route_bound_ms)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/segment_combine.cu"
REPLACES = {"dense": "src/repro/kernels/segment_combine.py:232",
            "tile": "src/repro/kernels/segment_combine.py:194"}
ATTN_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attention.py:70"
SUM_RTOL = 1e-5                    # f32 sum vs the plain version in f64
HOLD_F64_BYTES = 4 << 30           # the float64 messages of a held sum
F32_ATTN_TOL = 2e-5                # atol and rtol, the JAX package's
BF16_RTOL = 2.0 ** -6              # two bf16 ulps of the element ...
BF16_ROW_ATOL = 3e-2               # ... plus 3% of its row's RMS
LOGIT_RTOL = 5e-2                  # bf16 logits, of the largest reference


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of `fn()` over `reps` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ------------------------------------------------------------ kernel phase
def hold_combine(name, op, first, second, msgs, dst, num_segments):
    """Hold two launches' outputs against each other (bitwise) and against
    the plain version on (msgs, dst), in any order of dst: min/max
    bitwise, sums within SUM_RTOL of the float64 sum of the messages'
    magnitudes (of the sum itself where they are positive).  Returns the
    errors."""
    from repro_torch.kernels import segment_combine as sc
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: two launches differ")
    plain = sc.segment_combine_plain(msgs, dst, num_segments, op)
    if first.shape != plain.shape:
        raise AssertionError(f"{name}: shape {tuple(first.shape)} != "
                             f"{tuple(plain.shape)}")
    if op != "sum":
        if not torch.equal(first, plain):
            raise AssertionError(f"{name}: {op} is not bitwise equal")
        return {"max_abs_err": 0.0, "max_rel_err": 0.0, "mag_rel_err": 0.0}
    if not first.numel():
        return {"max_abs_err": 0.0, "max_rel_err": 0.0, "mag_rel_err": 0.0}
    # the float64 sum a block of columns at a time, so that its copy of
    # the messages stays within HOLD_F64_BYTES at the GNN path's [E, 100]
    first2 = first.reshape(first.shape[0], -1)
    plain2 = plain.reshape(plain.shape[0], -1)
    msgs2 = msgs.reshape(msgs.shape[0], first2.shape[1])
    cols = max(1, HOLD_F64_BYTES // max(8 * msgs2.shape[0], 1))
    worst = abs_err = rel_err = plain_rel = mag_rel = 0.0
    for c in range(0, msgs2.shape[1], cols):
        block = msgs2[:, c:c + cols].double()
        exact = sc.segment_combine_plain(block, dst, num_segments, op)
        # a float sum's error scales with the sum of its terms' magnitudes
        # (|Σ m| for the graph path's positive messages; more where signed
        # GNN messages cancel)
        mag = sc.segment_combine_plain(block.abs_(), dst, num_segments, op)
        del block
        err = (first2[:, c:c + cols].double() - exact).abs()
        scale = exact.abs().clamp(min=1e-30)
        worst = max(worst, float((err - SUM_RTOL * mag).max()))
        mag_rel = max(mag_rel, float((err / mag.clamp(min=1e-30)).max()))
        abs_err = max(abs_err, float(err.max()))
        rel_err = max(rel_err, float((err / scale).max()))
        plain_rel = max(plain_rel, float(
            ((plain2[:, c:c + cols].double() - exact).abs() / scale).max()))
        del exact, mag, err, scale
    if not (torch.isfinite(first).all() and worst <= 0.0):
        raise AssertionError(f"{name}: sum off by more than rtol "
                             f"{SUM_RTOL} (excess {worst})")
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "mag_rel_err": mag_rel, "plain_f32_max_rel_err": plain_rel}


def check_case(name, route, op, msgs, dst, seg_ptr, num_segments, reps):
    """Kernel vs plain on one input; returns the case's record."""
    from repro_torch.kernels import segment_combine as sc
    first = sc.segment_combine_cuda(msgs, dst, seg_ptr, num_segments, op,
                                    route=route)
    second = sc.segment_combine_cuda(msgs, dst, seg_ptr, num_segments, op,
                                     route=route)
    errs = hold_combine(name, op, first, second, msgs, dst, num_segments)
    del first, second
    n_used = int(seg_ptr[-1])           # edges routed to some segment
    offsets = seg_ptr.to(torch.int64)
    lib_data = msgs[:n_used]
    ident = sc.IDENTITY[op]
    launches_before = sc.LAUNCHES[route]
    kernel_ms = cuda_ms(lambda: sc.segment_combine_cuda(
        msgs, dst, seg_ptr, num_segments, op, route=route), reps)
    rec = {
        "case": name, "route": route, "op": op, "E": int(msgs.shape[0]),
        "E_routed": n_used, "D": int(msgs.shape[1]),
        "segments": num_segments,
        **errs, "kernel_ms": kernel_ms,
        "launches": sc.LAUNCHES[route] - launches_before,
        "plain_ms": cuda_ms(lambda: sc.segment_combine_plain(
            msgs, dst, num_segments, op), reps),
        "library_ms": cuda_ms(lambda: torch.segment_reduce(
            lib_data, op, offsets=offsets, axis=0, unsafe=True,
            initial=ident), reps),
        "bound_ms": bound_ms(n_used, msgs.shape[1], num_segments),
    }
    log("kernel_case", json.dumps(rec))
    return rec


def pick_frontier_tile(part, source, max_supersteps=8):
    """The largest real bucketed tile of a compact BFS from `source`: run
    supersteps until the frontier leaves the compacted range, keeping the
    (msgs, dst, valid lanes) of the widest bucket tile the route gathered,
    with the valid count the frontier counts gave for it."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.core.frontier import frontier_counts, frontier_tile
    eng = GREEngine(algorithms.bfs_program(), frontier="compact")
    plan = eng.make_plan().frontier(part)
    assert plan.kind == "bucketed", plan
    state = eng.init_state(part, source=source)
    best = None
    for step in range(max_supersteps):
        counts = frontier_counts(part, state.active_scatter)
        if counts.live == 0 or counts.live > sum(plan.caps):
            break
        for b, (cap_b, deg_b) in enumerate(zip(plan.caps,
                                               part.bucket_max_deg)):
            n_b = counts.members[b]
            if 0 < n_b <= cap_b and (best is None
                                     or cap_b * deg_b > best[0]):
                mask_b = state.active_scatter & (part.bucket_id == b)
                msgs, dst = frontier_tile(eng.program, part, state,
                                          part.num_slots, cap_b, deg_b,
                                          mask_b)
                best = (cap_b * deg_b, step, b, n_b, msgs, dst,
                        counts.bucket_edges[b])
        state = eng.superstep(part, state)
    assert best is not None, "no bucketed tile on this BFS"
    lanes, step, b, n_b, msgs, dst, valid = best
    counted = int((dst < part.num_slots).sum())
    log(f"frontier_tile superstep={step} bucket={b} live={n_b} "
        f"lanes={lanes} valid={valid}")
    if counted != valid:
        raise AssertionError(f"frontier counts give {valid} valid lanes, the "
                             f"tile holds {counted}")
    return msgs, dst, valid


def hold_compaction(name, dst, num_segments, valid):
    """The compaction kernel against its plain version (bitwise, in lane
    order), once with the caller's valid total and once counting on its
    own."""
    from repro_torch.kernels import segment_combine as sc
    first = sc.compact_lanes_cuda(dst, num_segments, valid)
    second = sc.compact_lanes_cuda(dst, num_segments)   # counts on its own
    plain = sc.compact_lanes_plain(dst, num_segments)
    torch.cuda.synchronize()
    for got in (first, second):
        if not all(torch.equal(g, p) for g, p in zip(got, plain)):
            raise AssertionError(f"{name}: compaction differs from its "
                                 "plain version")


def check_compaction(dst, num_segments, valid, reps):
    """`hold_compaction` on a tile, then its times; returns its record."""
    from repro_torch.kernels import segment_combine as sc
    hold_compaction("tile_compact", dst, num_segments, valid)
    before = sc.LAUNCHES["compact"]
    rec = {"case": "tile_compact", "route": "compact",
           "lanes": int(dst.shape[0]),
           "valid": valid, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: sc.compact_lanes_cuda(
               dst, num_segments, valid), reps),
           "launches": sc.LAUNCHES["compact"] - before,
           "plain_ms": cuda_ms(lambda: sc.compact_lanes_plain(
               dst, num_segments), reps),
           "library_ms": None,
           "bound_ms": (dst.shape[0] * 4 + valid * 8) / HBM_BYTES_PER_S * 1e3}
    log("kernel_case", json.dumps(rec))
    return rec


def kernel_phase(part, source, reps):
    from repro_torch.kernels import segment_combine as sc
    nseg = part.num_slots
    gen = torch.Generator(device=part.device).manual_seed(0)
    records = []
    # D = 1: PageRank's first-superstep messages, pr0 / outdeg per source
    x = 1.0 / torch.clamp(part.aux["out_degree"], min=1.0)
    x = torch.cat([x, torch.zeros(1, device=x.device)])
    msgs = x.index_select(0, part.src).unsqueeze(1).contiguous()
    for op in ("sum", "min", "max"):
        records.append(check_case(f"dense_D1_{op}", "dense", op, msgs,
                                  part.dst, part.seg_ptr, nseg, reps))
    del msgs
    # D = 32: 32-lane traversal values gathered along src
    x32 = torch.rand((nseg, 32), generator=gen, device=part.device)
    msgs = x32.index_select(0, part.src)
    records.append(check_case("dense_D32_min", "dense", "min", msgs,
                              part.dst, part.seg_ptr, nseg, reps))
    del msgs, x32
    # one real bucketed frontier tile of a BFS: its compaction, then the
    # kernel on the route's compacted, sorted lanes
    tmsgs, tdst, valid = pick_frontier_tile(part, source)
    tmsgs = tmsgs.reshape(-1, 1).contiguous()
    records.append(check_compaction(tdst, nseg, valid, reps))
    cmsgs, cdst = sc.sort_valid_lanes(tmsgs,
                                      *sc.compact_lanes_plain(tdst, nseg))
    tptr = sc.segment_row_pointer(cdst, nseg)
    rec = check_case("tile_D1_min", "tile", "min", cmsgs, cdst, tptr, nseg,
                     reps)
    # the whole tile route: compaction + sort + row pointer + kernel
    route = sc.tile_segment_combine_cuda(tmsgs, tdst, nseg, "min", valid)
    hold_combine("tile_route_D1_min", "min", route,
                 sc.tile_segment_combine_cuda(tmsgs, tdst, nseg, "min", valid),
                 tmsgs, tdst, nseg)
    del route
    rec["lanes"] = int(tdst.shape[0])
    rec["route_ms"] = cuda_ms(lambda: sc.tile_segment_combine_cuda(
        tmsgs, tdst, nseg, "min", valid), reps)
    rec["route_bound_ms"] = route_bound_ms(
        tdst.shape[0], rec["E_routed"], rec["D"], nseg)
    log(f"tile_route_ms={rec['route_ms']} "
        f"route_bound_ms={rec['route_bound_ms']}")
    records.append(rec)
    torch.cuda.synchronize()
    return records


ADVERSARIAL_D = (1, 3, 32, 64)


def adversarial_inputs(gen):
    """(name, route, dst, num_segments, valid) of the kernel's edge cases;
    dense-route dst is sorted, tile-route dst is a ragged tile."""
    dev = "cuda"

    def sorted_dst(counts):
        return torch.repeat_interleave(
            torch.arange(counts.shape[0], dtype=torch.int32, device=dev),
            counts.to(dev))

    cases = []
    # every segment empty: no edge at all, and only padding past the end
    cases.append(("all_empty", "dense",
                  torch.zeros(0, dtype=torch.int32, device=dev), 10_000, None))
    cases.append(("all_empty_padding", "dense",
                  torch.full((5000,), 10_000, dtype=torch.int32, device=dev),
                  10_000, None))
    # one hub of 1,200,000 edges (spanning hundreds of shares) among
    # random in-degrees, and a segment count that is no multiple of a share
    v = 2048 * 37 + 5
    counts = torch.randint(0, 8, (v,), generator=gen, device=dev)
    counts[777] = 1_200_000
    cases.append(("hub_1M", "dense", sorted_dst(counts), v, None))
    # ten adjacent hubs, each straddling many shares, then empty segments
    counts = torch.zeros(3 * 2048 + 1, dtype=torch.int64, device=dev)
    counts[:10] = 100_003
    cases.append(("hubs_adjacent", "dense", sorted_dst(counts),
                  counts.shape[0], None))
    # a tile of ragged valid prefixes (dst ascending in each row), and one
    # with no valid lane at all
    rows, width, v = 3000, 257, 70_001
    deg = torch.randint(0, width + 1, (rows,), generator=gen, device=dev)
    deg[::7] = 0
    col = torch.arange(width, device=dev)
    dst = torch.sort(torch.randint(0, v, (rows, width), generator=gen,
                                   device=dev), dim=1).values
    tile = torch.where(col[None, :] < deg[:, None], dst, v)
    cases.append(("tile_ragged", "tile", tile.reshape(-1).to(torch.int32), v,
                  int(deg.sum())))
    cases.append(("tile_zero_valid", "tile",
                  torch.full((rows * width,), v, dtype=torch.int32,
                             device=dev), v, 0))
    return cases


def adversarial_phase():
    """Every edge case of `adversarial_inputs` at every D of ADVERSARIAL_D
    and every op, each held to its plain version and launched twice."""
    from repro_torch.kernels import segment_combine as sc
    gen = torch.Generator(device="cuda").manual_seed(1)
    held = 0
    for name, route, dst, nseg, valid in adversarial_inputs(gen):
        for d in ADVERSARIAL_D:
            # positive, as the main path's sums are (PageRank's messages):
            # a sum that cancels has no relative error to hold it to
            msgs = torch.rand((dst.shape[0], d), generator=gen,
                              device="cuda")
            if route == "dense":
                ptr = sc.segment_row_pointer(dst, nseg)

                def run(op):
                    return sc.segment_combine_cuda(msgs, dst, ptr, nseg, op)
            else:
                msgs[dst >= nseg] = float("nan")   # never read

                def run(op):
                    return sc.tile_segment_combine_cuda(msgs, dst, nseg, op,
                                                        valid)
            keep = dst < nseg
            errs = {}
            for op in ("sum", "min", "max"):
                errs[op] = hold_combine(f"{name}_D{d}_{op}", op, run(op),
                                        run(op), msgs[keep], dst[keep], nseg)
                held += 1
            log(f"adversarial_case {name} D={d} E={dst.shape[0]} "
                f"segments={nseg} held {json.dumps(errs)}")
            del msgs
    torch.cuda.synchronize()
    log(f"adversarial_cases_held={held}")
    return held


# ------------------------------------------------------------- main path
class Inputs(NamedTuple):
    graph: object          # repro_torch.graph.structures.Graph
    ugraph: object         # graph.as_undirected(), for CC
    part: object           # DevicePartition of graph, on the card
    upart: object          # DevicePartition of ugraph, on the card
    source: int            # the highest-out-degree vertex
    sources: list          # source + 31 sampled with seed 0 (32-lane BFS)


def build_inputs(scale: int) -> Inputs:
    """The main path's graph, partitions and traversal sources; the one
    set-up of this script and `tools/profile_torch_main_path.py`.  Needs
    `src/` on `sys.path`."""
    from repro_torch.core.engine import DevicePartition
    from repro_torch.graph.generators import rmat_edges
    t0 = time.perf_counter()
    graph = rmat_edges(scale, 16, seed=0, weights=True).dedup()
    ugraph = graph.as_undirected()
    log(f"ingress_graph_s={time.perf_counter() - t0:.3f} "
        f"V={graph.num_vertices} E={graph.num_edges}")
    t0 = time.perf_counter()
    part = DevicePartition.from_graph(graph, device="cuda")
    upart = DevicePartition.from_graph(ugraph, device="cuda")
    torch.cuda.synchronize()
    log(f"ingress_partition_s={time.perf_counter() - t0:.3f} "
        f"bucket_sizes={part.bucket_sizes} "
        f"bucket_max_deg={part.bucket_max_deg}")
    outdeg = graph.out_degree()
    source = int(np.argmax(outdeg))
    cands = np.flatnonzero(outdeg > 0)
    cands = cands[cands != source]
    rng = np.random.default_rng(0)
    sources = [source] + [int(s) for s in
                          rng.choice(cands, size=31, replace=False)]
    return Inputs(graph, ugraph, part, upart, source, sources)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def report(name, eng, part, out, wall_ms, num_edges):
    plan = eng.make_plan().frontier(part)
    rate = num_edges * out.step / (wall_ms / 1e3) if out.step else 0.0
    log(f"program={name} plan={plan.kind} caps={plan.caps} "
        f"supersteps={out.step} wall_ms={wall_ms:.3f} "
        f"edges_per_s={rate:.6e}")
    return {"program": name, "plan": plan.kind, "supersteps": out.step,
            "wall_ms": wall_ms, "edges_per_s": rate}


def host_oracles(graph, ugraph, source):
    """numpy/scipy references of every program of the main path."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = graph.num_vertices
    t0 = time.perf_counter()
    adj = sp.csr_matrix((graph.edge_props["weight"].astype(np.float64),
                         (graph.src, graph.dst)), shape=(n, n))
    pr = np.ones(n)
    outdeg = np.maximum(graph.out_degree(), 1).astype(np.float64)
    for _ in range(30):
        pr = 0.15 + 0.85 * np.bincount(graph.dst, weights=(pr / outdeg)[
            graph.src], minlength=n)
    ref = {"pagerank": pr,
           "sssp": csgraph.dijkstra(adj, indices=source),
           "bfs": csgraph.shortest_path(adj, unweighted=True, indices=source)}
    uadj = sp.csr_matrix((np.ones(ugraph.num_edges), (ugraph.src,
                                                       ugraph.dst)),
                         shape=(n, n))
    _, comp = csgraph.connected_components(uadj, directed=False)
    first = np.full(comp.max() + 1, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n))
    ref["cc"] = first[comp].astype(np.float64)
    log(f"host_oracles_s={time.perf_counter() - t0:.3f}")
    return ref


def assert_exact(name, got: torch.Tensor, want: np.ndarray):
    got = got.double().cpu().numpy()
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"{name}: {bad.size} vertices differ from the "
                             f"oracle, e.g. {bad[:5]} {got[bad[:5]]} "
                             f"{want[bad[:5]]}")


def main_path(graph, part, upart, source, sources, ref):
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.kernels.segment_combine import LAUNCHES
    e = graph.num_edges
    runs = []

    eng = GREEngine(algorithms.pagerank_program())
    st = eng.init_state(part)
    out, ms = timed(lambda: eng.run(part, st, 30))
    runs.append(report("pagerank", eng, part, out, ms, e))
    assert out.step == 30 and LAUNCHES["dense"] > 0, LAUNCHES
    np.testing.assert_allclose(out.vertex_data.cpu().numpy(),
                               ref["pagerank"], rtol=1e-4, atol=1e-4)

    eng = GREEngine(algorithms.sssp_program(), frontier="auto")
    st = eng.init_state(part, source=source)
    out, ms = timed(lambda: eng.run(part, st, 10_000))
    runs.append(report("sssp", eng, part, out, ms, e))
    assert_exact("sssp", out.vertex_data, ref["sssp"])

    bfs = {}
    for frontier in ("compact", "dense"):
        tile_before, compact_before = LAUNCHES["tile"], LAUNCHES["compact"]
        eng = GREEngine(algorithms.bfs_program(), frontier=frontier)
        st = eng.init_state(part, source=source)
        out, ms = timed(lambda: eng.run(part, st, 10_000))
        runs.append(report(f"bfs_{frontier}", eng, part, out, ms, e))
        assert_exact(f"bfs_{frontier}", out.vertex_data, ref["bfs"])
        bfs[frontier] = out
        if frontier == "compact":
            assert LAUNCHES["tile"] > tile_before, LAUNCHES
            assert LAUNCHES["compact"] > compact_before, LAUNCHES
    assert torch.equal(bfs["compact"].vertex_data, bfs["dense"].vertex_data)
    assert bfs["compact"].step == bfs["dense"].step

    eng = GREEngine(algorithms.cc_program())
    st = eng.init_state(upart)
    out, ms = timed(lambda: eng.run(upart, st, 10_000))
    runs.append(report("cc", eng, upart, out, ms, 2 * e))
    assert_exact("cc", out.vertex_data, ref["cc"])

    eng = GREEngine(algorithms.bfs_program(len(sources)))
    st = eng.init_state(part, source=sources)
    out, ms = timed(lambda: eng.run(part, st, 10_000))
    runs.append(report(f"bfs_x{len(sources)}", eng, part, out, ms, e))
    multi = out.vertex_data
    return runs, multi, bfs["dense"].vertex_data


def check_lanes(part, sources, multi, single0):
    """Sampled lanes of the multi-source BFS vs single-source runs."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    assert torch.equal(multi[:, 0], single0), "lane 0"
    eng = GREEngine(algorithms.bfs_program(), frontier="dense")
    lanes = (7, 19, len(sources) - 1)
    for lane in lanes:
        out = eng.run(part, eng.init_state(part, source=sources[lane]),
                      10_000)
        assert torch.equal(multi[:, lane], out.vertex_data), f"lane {lane}"
    log(f"multi_source lanes {(0,) + lanes} bitwise equal to single-source "
        "runs")


# ------------------------------------------------------------- tuning phase
def probe_logger(prog, graph, source):
    """A `ProbeEvaluator` on the card that keeps each probe's time and each
    bucket ladder's partition build seconds (the evaluator is `tune`'s
    measurement half, passed in as it lets a caller do)."""
    from repro_torch.tuning import ProbeEvaluator

    class Logged(ProbeEvaluator):
        def __init__(self):
            super().__init__(prog, graph, source=source, device="cuda")
            self.probes, self.build_s = [], {}

        def partition(self, bounds=None):
            key = tuple(bounds) if bounds else None
            if key not in self._parts:
                t0 = time.perf_counter()
                super().partition(bounds)
                torch.cuda.synchronize()
                self.build_s[str(key)] = time.perf_counter() - t0
            return super().partition(bounds)

        def evaluate(self, plan, probe_steps=2, iters=1):
            us = super().evaluate(plan, probe_steps, iters)
            self.probes.append((plan, probe_steps, us))
            return us
    return Logged()


def plan_label(plan) -> str:
    return (f"{plan.strategy}/cap={plan.frontier_cap}/"
            f"bounds={plan.bucket_bounds}")


def tuning_phase(graph, part, source, ref, cache_dir):
    """`tune` for SSSP (the default `PlanSearchSpace`: dense, flat at 4
    caps, compact at 4 caps x 3 bucket ladders, and the engine's default
    plan seeded into the final rung) and for BFS (`SMOKE_SPACE`) on the
    main path's graph, each into a plan cache of its own under
    `cache_dir` (the two programs' keys are equal: both scalar, min and
    halting); a second `tune` must hit the cache with no probe.  Then `GREEngine(plan="auto-tuned")`
    adopts the stored plan on the partition of its bucket ladder: its first
    3 supersteps' combine calls are held against the plain version, and
    its run (untimed, then timed with the combine counts set to 0 just
    before and read just after) must equal the default engine's on the
    main path's partition and the oracle bitwise.  Returns the SSSP winner
    and the counts of the timed tuned runs."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.tuning import SMOKE_SPACE, PlanSearchSpace, tune
    t_phase = time.perf_counter()
    winners, launches = {}, {r: 0 for r in sc.LAUNCHES}
    for name, factory, space in (
            ("sssp", algorithms.sssp_program, PlanSearchSpace()),
            ("bfs", algorithms.bfs_program, SMOKE_SPACE)):
        prog = factory()
        cache_path = cache_dir / f"{name}.json"
        ev = probe_logger(prog, graph, source)
        t0 = time.perf_counter()
        res = tune(prog, graph, source=source, cache=cache_path, space=space,
                   evaluator=ev)
        tune_s = time.perf_counter() - t0
        final = max(steps for _, steps, _ in ev.probes)
        rec = {"program": name, "key": res.key,
               "candidates": sum(steps == 2 for _, steps, _ in ev.probes),
               "num_probes": res.num_probes,
               "final_rung_us": {plan_label(p): us for p, steps, us
                                 in ev.probes if steps == final},
               "unrunnable": [plan_label(p) for p, steps, us in ev.probes
                              if steps == 2 and math.isinf(us)],
               "winner": res.plan.to_json(), "probe_us": res.probe_us,
               "default_us": res.default_us,
               "partition_build_s": ev.build_s, "tune_s": tune_s}
        log("tune", json.dumps(rec))
        n = ev.num_probes
        hit = tune(prog, graph, source=source, cache=cache_path,
                   space=space, evaluator=ev)
        if not (hit.from_cache and hit.num_probes == 0
                and ev.num_probes == n and hit.plan == res.plan):
            raise AssertionError(f"tune {name}: the second call is no "
                                 f"clean cache hit: {hit}")
        log(f"tune_hit program={name} from_cache={hit.from_cache} "
            f"num_probes={hit.num_probes}")
        # the auto-tuned engine on the partition of the winner's ladder
        tpart = ev.partition(res.plan.bucket_bounds)
        eng = GREEngine(prog, plan="auto-tuned", plan_cache=cache_path)
        st = eng.init_state(tpart, source=source)
        if (eng.make_plan() != dataclasses.replace(res.plan,
                                                   bucket_bounds=None)
                or eng.bucket_bounds != res.plan.bucket_bounds):
            raise AssertionError(f"tuned {name}: adopted {eng.make_plan()}"
                                 f" bounds {eng.bucket_bounds}, stored "
                                 f"{res.plan}")
        held = hold_block(f"tuned {name}", lambda: eng.run(tpart, st, 3))
        default = GREEngine(prog)
        dst0 = default.init_state(part, source=source)
        eng.run(tpart, st, 10_000)                      # untimed
        default.run(part, dst0, 10_000)
        before = dict(sc.LAUNCHES)
        out, ms = timed(lambda: eng.run(tpart, st, 10_000))
        runs = {r: sc.LAUNCHES[r] - before[r] for r in sc.LAUNCHES}
        for r in launches:
            launches[r] += runs[r]
        dout, dms = timed(lambda: default.run(part, dst0, 10_000))
        if not torch.equal(out.vertex_data, dout.vertex_data):
            raise AssertionError(f"tuned {name} != the default engine's")
        assert_exact(f"tuned {name}", out.vertex_data, ref[name])
        log("tuned_run", json.dumps({
            "program": name, "plan": plan_label(eng.make_plan()),
            "supersteps": out.step, "wall_ms": ms,
            "default_supersteps": dout.step, "default_wall_ms": dms,
            "launches": runs, "held": held}))
        winners[name] = res.plan
        del ev, tpart, eng, st, default, dst0, out, dout
        torch.cuda.empty_cache()
    if launches["dense"] + launches["tile"] <= 0:
        raise AssertionError(f"the tuned runs launched no combine {launches}")
    log(f"tuning_phase_s={time.perf_counter() - t_phase:.3f} "
        f"launches={json.dumps(launches)}")
    return winners["sssp"], launches


# -------------------------------------------------------- multi-stage BC
BC_SOURCES = 64
BC_BATCH = 16       # dense messages of [E, 3·batch] f32 and their gathered
                    # rows: 2·E·3·batch·4 bytes, ~25 GB at 16, ~100 GB at 64
BC_SIGMA_RTOL = 1e-4
BC_RTOL = 1e-3


def host_brandes(graph, sources):
    """Brandes over `sources` in numpy/scipy float64, level-synchronous:
    forward σ by sparse products of the transposed adjacency with the
    frontier's σ, backward δ by products of the adjacency with the next
    level's (1 + δ)/σ.  Returns (depth, σ, Σ_lanes δ), a source's own δ
    zero at its vertex."""
    import scipy.sparse as sp
    n, s = graph.num_vertices, len(sources)
    adj = sp.csr_matrix((np.ones(graph.num_edges), (graph.src, graph.dst)),
                        shape=(n, n))
    adj_t = adj.T.tocsr()
    lanes = np.arange(s)
    depth = np.full((n, s), np.inf)
    sigma = np.zeros((n, s))
    depth[sources, lanes] = 0.0
    sigma[sources, lanes] = 1.0
    front = np.zeros((n, s), dtype=bool)
    front[sources, lanes] = True
    level = 0
    while front.any():
        contrib = adj_t @ np.where(front, sigma, 0.0)
        front = (contrib > 0) & np.isinf(depth)
        level += 1
        depth[front] = level
        sigma[front] = contrib[front]
    delta = np.zeros((n, s))
    for lvl in range(level - 1, 0, -1):
        coeff = np.where(depth == lvl, (1.0 + delta) / np.maximum(sigma, 1.0),
                         0.0)
        delta = np.where(depth == lvl - 1, delta + sigma * (adj @ coeff),
                         delta)
    delta[sources, lanes] = 0.0
    return depth, sigma, delta.sum(axis=1)


def bc_phase(graph, part):
    """Multi-stage Brandes BC (`repro_torch.core.multistage`) over 64
    sources (numpy seed 0, among the vertices with out-edges) in batches
    of 16 payload lanes.  `max_depth` is the largest finite BFS depth from
    these sources (16-lane BFS runs on the main path's partition) plus
    one, so no depth is cut.  The first batch runs with each of its combine calls
    held against the plain version, and its depths (exactly), σ (within
    BC_SIGMA_RTOL) and BC (within BC_RTOL) against `host_brandes`.  Then
    `accumulate_bc` over the pipeline (what `betweenness_centrality` runs)
    with the combine counts set to 0 just before and read just after:
    every batch's wall and supersteps, and its first batch bitwise equal to
    the held pass.  Returns the counts."""
    from repro_torch.core import algorithms, multistage
    from repro_torch.core.engine import GREEngine
    from repro_torch.kernels import segment_combine as sc
    t_phase = time.perf_counter()
    V = graph.num_vertices
    rng = np.random.default_rng(0)
    sources = rng.choice(np.flatnonzero(graph.out_degree() >= 1),
                         size=BC_SOURCES, replace=False)
    eng = GREEngine(algorithms.bfs_program(BC_BATCH))
    max_depth = 0
    for lo in range(0, BC_SOURCES, BC_BATCH):
        hops = eng.run(part, eng.init_state(
            part, source=list(sources[lo:lo + BC_BATCH])), 10_000).vertex_data
        max_depth = max(max_depth, int(hops[torch.isfinite(hops)].max()) + 1)
    del hops
    t0 = time.perf_counter()
    run = multistage._make_bc_batch(graph, max_depth, BC_BATCH,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"bc max_depth={max_depth} sources={BC_SOURCES} batch={BC_BATCH} "
        f"partitions_s={time.perf_counter() - t0:.3f}")
    first = sources[:BC_BATCH]
    box = []
    held = hold_block("bc batch 0", lambda: box.append(run(first)))
    bc0 = box.pop().sum(dim=1).double().cpu().numpy()
    depth = run.depth.double().cpu().numpy()
    sigma = run.sigma.double().cpu().numpy()
    t0 = time.perf_counter()
    want_depth, want_sigma, want_bc = host_brandes(graph, first)
    host_s = time.perf_counter() - t0
    if not np.array_equal(depth, want_depth):
        bad = np.argwhere(depth != want_depth)
        raise AssertionError(f"bc depths: {len(bad)} entries differ, e.g. "
                             f"{bad[:3].tolist()}")
    sig_err = np.abs(sigma - want_sigma)
    bc_err = np.abs(bc0 - want_bc)
    if not (sig_err <= BC_SIGMA_RTOL * want_sigma).all():
        raise AssertionError(f"bc sigma off by more than rtol "
                             f"{BC_SIGMA_RTOL}: {sig_err.max()}")
    if not (bc_err <= BC_RTOL * want_bc).all():
        raise AssertionError(f"bc off by more than rtol {BC_RTOL}: "
                             f"{bc_err.max()}")
    pos_s, pos_b = want_sigma > 0, want_bc > 0
    log("bc_check", json.dumps({
        "batch": 0, "depth_max": float(want_depth[np.isfinite(
            want_depth)].max()),
        "sigma_max": float(want_sigma.max()),
        "sigma_max_rel_err": float((sig_err[pos_s] / want_sigma[pos_s]
                                    ).max()),
        "bc_max": float(want_bc.max()),
        "bc_max_rel_err": float((bc_err[pos_b] / want_bc[pos_b]).max()),
        "host_brandes_s": host_s, "held": held}))
    batches = []

    def timed_batch(srcs):
        out, ms = timed(lambda: run(srcs))
        batches.append({"batch": len(batches), "wall_ms": ms,
                        "forward_supersteps": run.supersteps[0],
                        "backward_supersteps": run.supersteps[1]})
        if len(batches) == 1:
            batches[0]["equals_held_pass"] = bool(np.array_equal(
                out.sum(dim=1).double().cpu().numpy(), bc0))
        log("bc_batch", json.dumps(batches[-1]))
        return out
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    t0 = time.perf_counter()
    bc = multistage.accumulate_bc(timed_batch, sources, BC_BATCH, V)
    total_s = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    log(f"bc_s={total_s:.3f} launches={json.dumps(launches)} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not batches[0]["equals_held_pass"]:
        raise AssertionError("bc: the first batch differs from its held "
                             "pass")
    if not (bc.shape == (V,) and np.isfinite(bc).all() and (bc >= 0).all()
            and bc.max() > 0):
        raise AssertionError("bc: the scores are not finite, non-negative "
                             "and non-zero")
    if launches["dense"] <= 0:      # `auto` may keep every scan dense
        raise AssertionError(f"bc launched no dense-route combine: "
                             f"{launches}")
    del run
    torch.cuda.empty_cache()
    log(f"bc_phase_s={time.perf_counter() - t_phase:.3f}")
    return launches


# --------------------------------------------------------- embedding_bag
EMB_ROWS, EMB_DIM = 10_000_000, 16  # autoint's largest table
EMB_BAGS = 4096
EMB_SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
EMB_REPLACES = "src/repro/kernels/ops.py:64"
EMB_EDGE_D = (1, 3, 16, 64, 100, 128, 200)   # 200: two column tiles
EMB_GCN_D = (16, 100)


def counted(fn):
    """`fn()` with the embedding_bag and combine launch counts set to 0
    just before and read just after: `(result, eb counts, combine
    counts)`."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import segment_combine as sc
    torch.cuda.synchronize()
    eb.reset_launches()
    sc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(eb.LAUNCHES), dict(sc.LAUNCHES)


def check_emb_launches(name, eb_counts, sc_counts, want):
    if eb_counts != want or any(sc_counts.values()):
        raise AssertionError(f"{name}: embedding_bag launches {eb_counts} "
                             f"(want {want}), combine launches {sc_counts} "
                             "(want none)")


def extra_peak_bytes(fn, kept_bytes):
    """Peak bytes `fn()` allocates above what was in use before it, less
    the `kept_bytes(result)` it returns: its scratch."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - kept_bytes(out)
    del out
    return extra


def device_ms(fn, reps):
    """Device time of one `fn()`: every kernel and memset it runs, from
    torch.profiler over `reps` calls after a warm-up call, in total and by
    kernel name (ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0][:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by:
        raise AssertionError("the profiler recorded no device time")
    return sum(by.values()) / reps, {k: v / reps for k, v in by.items()}


def hold_embedding_bag(name, table, ids, bags, num_bags, w, cot):
    """Both kernels on one input (`cot` the forward's cotangent), each
    launched twice, bitwise equal, against the plain versions in float64:
    within SUM_RTOL of the float64 result (positive inputs, so of the sum
    of the terms' magnitudes).  Returns the largest errors."""
    from repro_torch.kernels import embedding_bag as eb
    need_w = w is not None
    outs = [(eb.embedding_bag_forward_cuda(table, ids, bags, num_bags, w),
             *eb.embedding_bag_backward_cuda(cot, table, ids, bags, num_bags,
                                             w, True, need_w))
            for _ in range(2)]
    torch.cuda.synchronize()
    w64 = None if w is None else w.double()
    want = (eb.embedding_bag_forward_plain(table.double(), ids, bags,
                                           num_bags, w64),
            *eb.embedding_bag_backward_plain(cot.double(), table.double(),
                                             ids, bags, num_bags, w64, True,
                                             need_w))
    errs = {}
    for key, got, again, ref in zip(("forward", "table_grad", "weight_grad"),
                                    outs[0], outs[1], want):
        if ref is None:
            continue
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {key}: two launches differ")
        err = (got.double() - ref).abs()
        if not (torch.isfinite(got).all()
                and (err <= SUM_RTOL * ref.abs()).all()):
            raise AssertionError(f"{name} {key}: off by more than rtol "
                                 f"{SUM_RTOL}: {float(err.max())}")
        errs[key] = float(err.max()) if err.numel() else 0.0
    return errs


def embedding_phase(reps):
    """`kernels.ops.embedding_bag` on a `[10_000_000, 16]` f32 table (CUDA
    generator seed 0) with 4,096 sorted bags of 1-64 ids and per-id weights
    (numpy seed 0): one counted call (one forward launch, no combine
    launch), both kernels held on its inputs (`hold_embedding_bag`), the
    call itself against float64 within SUM_RTOL, its scratch bytes, then
    times: the call's, its device time, the plain version's,
    `F.embedding_bag`'s.  Returns the kernels-line record."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.rand((EMB_ROWS, EMB_DIM), generator=gen, device="cuda")
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 65, EMB_BAGS)
    n = int(sizes.sum())
    ids = torch.from_numpy(rng.integers(0, EMB_ROWS, n).astype(np.int32)
                           ).cuda()
    w = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
    bags = torch.from_numpy(np.repeat(np.arange(EMB_BAGS), sizes).astype(
        np.int32)).cuda()
    cot = torch.rand((EMB_BAGS, EMB_DIM), generator=gen, device="cuda")

    def call():
        return ops.embedding_bag(table, ids, bags, EMB_BAGS, weights=w)
    out, eb_counts, sc_counts = counted(call)
    check_emb_launches("embedding_bag", eb_counts, sc_counts,
                       {"forward": 1, "backward": 0})
    held = hold_embedding_bag("embedding_bag", table, ids, bags, EMB_BAGS,
                              w, cot)
    exact = eb.embedding_bag_forward_plain(table.double(), ids, bags,
                                           EMB_BAGS, w.double())
    err = (out.double() - exact).abs()
    if not (err <= SUM_RTOL * exact.abs()).all():
        raise AssertionError(f"embedding_bag off by more than rtol "
                             f"{SUM_RTOL}: {float(err.max())}")
    extra = extra_peak_bytes(call, lambda o: o.numel() * 4)
    if not extra < n * EMB_DIM * 4:
        raise AssertionError(f"embedding_bag forward took {extra} bytes of "
                             "scratch: an [n, d] buffer")
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]])
                               .astype(np.int32)).cuda()
    distinct = int(torch.unique(ids).numel())
    dev_ms, dev_by = device_ms(call, reps)
    rec = {"name": "embedding_bag", "route": "cuda",
           "source": EMB_SOURCE, "replaces": EMB_REPLACES,
           "launches": eb_counts["forward"],
           "max_abs_err": float(err.max()),
           "ms": cuda_ms(call, reps),
           "plain_ms": cuda_ms(lambda: eb.embedding_bag_forward_plain(
               table, ids, bags, EMB_BAGS, w), reps),
           "bound_ms": emb_bound_ms(n, distinct, EMB_DIM, EMB_BAGS),
           "bound_by": "bytes",
           "library_ms": cuda_ms(lambda: F.embedding_bag(
               ids, table, offsets, mode="sum", per_sample_weights=w), reps),
           "device_ms": dev_ms, "device_ms_by_kernel": dev_by,
           "library_device_ms": device_ms(lambda: F.embedding_bag(
               ids, table, offsets, mode="sum", per_sample_weights=w),
               reps)[0],
           "extra_peak_bytes": extra}
    rec.update(embedding_backward(table, ids, bags, w, offsets, cot,
                                  distinct, reps))
    log("embedding_bag", json.dumps({**rec, "ids": n, "distinct_ids":
                                     distinct, "bags": EMB_BAGS,
                                     "max_rel_err": float(
                                         (err / exact.abs()).max()),
                                     "held": held}))
    del table, exact
    torch.cuda.empty_cache()
    return rec


def embedding_backward(table, ids, bags, w, offsets, cot, distinct, reps):
    """The gradients of `kernels.ops.embedding_bag` at the same call: the
    table's and the per-id weights' for the `[4096, 16]` cotangent `cot`.
    One counted backward (one backward launch, no combine launch), both
    gradients against float64 within SUM_RTOL, its scratch bytes, then the
    backward's time (and with only the weights asked for), its device time
    by kernel (sort, memset, walk, fold), against the plain version and
    `F.embedding_bag`'s backward.  Returns the `backward_*` fields of the
    kernels-line record."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    tab = table.detach().requires_grad_(True)
    wt = w.detach().requires_grad_(True)
    out = ops.embedding_bag(tab, ids, bags, EMB_BAGS, weights=wt)

    def grads():
        return torch.autograd.grad(out, (tab, wt), cot, retain_graph=True)
    (g_tab, g_w), eb_counts, sc_counts = counted(grads)
    check_emb_launches("embedding_bag backward", eb_counts, sc_counts,
                       {"forward": 0, "backward": 1})
    exact, exact_w = eb.embedding_bag_backward_plain(
        cot.double(), table.double(), ids, bags, EMB_BAGS, w.double())
    err = (g_tab.double() - exact).abs()
    err_w = (g_w.double() - exact_w).abs()
    if not ((err <= SUM_RTOL * exact.abs()).all()
            and (err_w <= SUM_RTOL * exact_w.abs()).all()):
        raise AssertionError(f"embedding_bag gradients off by more than "
                             f"rtol {SUM_RTOL}: table {float(err.max())}, "
                             f"weights {float(err_w.max())}")
    fields = {"backward_max_abs_err": max(float(err.max()),
                                          float(err_w.max()))}
    del exact, exact_w, err, g_tab, g_w
    n = ids.shape[0]
    extra = extra_peak_bytes(grads, lambda g: sum(x.numel() * 4 for x in g))
    if not extra < min(n * EMB_DIM * 4, (EMB_ROWS + 1) * 4):
        raise AssertionError(f"embedding_bag backward took {extra} bytes of "
                             "scratch: an [n, d] buffer or a row pointer")
    wt_only = w.detach().requires_grad_(True)
    out_w = ops.embedding_bag(table, ids, bags, EMB_BAGS, weights=wt_only)
    lib_out = F.embedding_bag(ids, tab, offsets, mode="sum",
                              per_sample_weights=wt)
    dev_ms, dev_by = device_ms(grads, reps)
    # read: the cotangent, ids, bag ids, weights, each distinct table row;
    # written: the whole table gradient and the weight gradient
    moved = (EMB_BAGS * EMB_DIM * 4 + 3 * n * 4 + distinct * EMB_DIM * 4
             + EMB_ROWS * EMB_DIM * 4 + n * 4)
    fields.update({
        "backward_launches": eb_counts["backward"],
        "backward_ms": cuda_ms(grads, reps),
        "backward_device_ms": dev_ms,
        "backward_device_ms_by_kernel": dev_by,
        "backward_weights_only_ms": cuda_ms(lambda: torch.autograd.grad(
            out_w, (wt_only,), cot, retain_graph=True), reps),
        "backward_plain_ms": cuda_ms(lambda: eb.embedding_bag_backward_plain(
            cot, table, ids, bags, EMB_BAGS, w), reps),
        "backward_bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "backward_library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (tab, wt), cot, retain_graph=True), reps),
        "backward_library_device_ms": device_ms(lambda: torch.autograd.grad(
            lib_out, (tab, wt), cot, retain_graph=True), reps)[0],
        "backward_extra_peak_bytes": extra})
    del out, out_w, lib_out
    return fields


def embedding_edge_inputs(d, gen):
    """(name, table, ids, bag ids, num_bags, weights, cotangent) of the
    kernels' edge cases at width d: positive values (CUDA generator), a
    100,000-row table, 50,000 ids."""
    rows, n, used = 100_000, 50_000, 20_000
    table = torch.rand((rows, d), generator=gen, device="cuda")
    ids = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(n, generator=gen, device="cuda")
    bags = torch.sort(torch.randint(0, used, (n,), generator=gen,
                                    device="cuda", dtype=torch.int32)).values
    cot = torch.rand((3 * used + 100, d), generator=gen, device="cuda")

    def case(name, ids_, bags_, num_bags, w_):
        return (name, table, ids_.contiguous(),
                bags_.to(torch.int32).contiguous(), num_bags, w_,
                cot[:num_bags].contiguous())
    return [
        # two empty bags after each used one, and 100 trailing
        case("empty_between_and_100_trailing", ids, 3 * bags,
             3 * used + 100, w),
        case("one_bag_holds_every_id", ids, torch.zeros_like(bags), 1, w),
        case("one_id_at_every_position", torch.full_like(ids, 5), bags,
             used, w),
        case("ids_0_and_N-1", torch.where(ids % 2 == 0, 0, rows - 1),
             bags, used, w),
        case("weights_None", ids, bags, used, None),
        case("n_0", ids[:0], bags[:0], used, w[:0]),
        case("int64_ids", ids.long(), bags, used, w),
        case("bags_past_num_bags_dropped", ids, 2 * bags, used, w)]


def embedding_edge_phase():
    """Every case of `embedding_edge_inputs` at every width of EMB_EDGE_D,
    both kernels held (`hold_embedding_bag`).  Returns the cases held."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    held = 0
    for d in EMB_EDGE_D:
        for name, *args in embedding_edge_inputs(d, gen):
            errs = hold_embedding_bag(f"embedding_bag {name} d={d}", *args)
            log(f"embedding_bag_case {name} d={d} n={args[1].shape[0]} "
                f"bags={args[3]} held {json.dumps(errs)}")
            held += 1
        torch.cuda.empty_cache()
    log(f"embedding_bag_cases_held={held}")
    return held


def embedding_gcn_phase(part, reps):
    """The forward at GCN's propagate shape, information only: ids = the
    dst-sorted partition's `src`, bags = its `dst` (and `seg_ptr`), weights
    = GCN's sym norm, a `[V, d]` table (CUDA generator seed 3) for d in
    EMB_GCN_D.  One counted call, held against the plain version in
    float64 (a few columns at a time), then its time, device time and
    bound beside today's route (`index_select`, scale, the combine kernel:
    `models/gnn.py`'s propagate) and `F.embedding_bag`.  Returns one
    record a width."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import gnn
    v = part.num_masters
    n = int(part.seg_ptr[v])                  # the edges routed to a vertex
    ids, bags = part.src[:n], part.dst[:n]
    seg_ptr = part.seg_ptr[:v + 1]
    w = gnn.compute_gcn_edge_norm(ids, bags, torch.ones(
        n, dtype=torch.bool, device="cuda"), v)
    distinct = int(torch.unique(ids).numel())
    gen = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for d in EMB_GCN_D:
        table = torch.rand((v, d), generator=gen, device="cuda")

        def call():
            return ops.embedding_bag(table, ids, bags, v, weights=w,
                                     seg_ptr=seg_ptr)

        def today():
            msg = table.index_select(0, ids).mul_(w[:, None])
            return ops.segment_combine(msg, bags, v, "sum", seg_ptr=seg_ptr)
        out, eb_counts, sc_counts = counted(call)
        check_emb_launches(f"embedding_bag gcn d={d}", eb_counts, sc_counts,
                           {"forward": 1, "backward": 0})
        cols = max(1, HOLD_F64_BYTES // (8 * n))
        worst = 0.0
        for c in range(0, d, cols):
            ref = eb.embedding_bag_forward_plain(
                table[:, c:c + cols].double().contiguous(), ids, bags, v,
                w.double())
            err = (out[:, c:c + cols].double() - ref).abs()
            if not (err <= SUM_RTOL * ref.abs()).all():
                raise AssertionError(f"embedding_bag gcn d={d} off by more "
                                     f"than rtol {SUM_RTOL}")
            worst = max(worst, float(err.max()))
            del ref, err
        del out
        dev_ms, dev_by = device_ms(call, reps)
        rec = {"d": d, "ids": n, "distinct_ids": distinct, "bags": v,
               "max_abs_err": worst,
               "ms": cuda_ms(call, reps), "device_ms": dev_ms,
               "device_ms_by_kernel": dev_by,
               "bound_ms": emb_bound_ms(n, distinct, d, v),
               "gather_bound_ms": emb_bound_ms(n, n, d, v),
               "today_ms": cuda_ms(today, reps),
               "today_device_ms": device_ms(today, reps)[0],
               "library_ms": cuda_ms(lambda: F.embedding_bag(
                   ids, table, seg_ptr[:-1], mode="sum",
                   per_sample_weights=w), reps)}
        log("embedding_bag_gcn", json.dumps(rec))
        records.append(rec)
        del table
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ GNN phase
GNN_D_FEAT = 100        # ogb_products' d_feat (GNN_SHAPES)
GNN_TIMED_STEPS = 5
GNN_LR = 1e-2           # launch/cells.py's full-graph AdamW
GNN_LOSS_RTOL = 1e-5    # k = 8 loss against the single card's
GNN_GRAD_TOL = 1e-4     # of the largest |gradient| of each leaf
GNN_F64_TOL = 1e-4      # f32 kernels against the plain versions in f64
GNN_F64_SCALE = 16
MB_SEEDS, MB_FANOUT, MB_D_FEAT, MB_STEPS = 1024, (15, 10), 602, 3
MOL_GRAPHS, MOL_NODES, MOL_EDGES, MOL_D_FEAT = 128, 30, 64, 16


def planted_labels(num_nodes, n_classes, seed):
    """examples/gnn_fullbatch.py's planting: labels uniform over the
    classes and a train mask of about half the vertices (numpy seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_classes, num_nodes), rng.random(num_nodes) < 0.5


def planted_features(labels, d_feat, seed):
    """`[V, d_feat]` float32 features on the card: N(0, 0.1²) from a CUDA
    generator, plus 1 at column `label % d_feat` (the weak signal of
    examples/gnn_fullbatch.py)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v = labels.shape[0]
    feats = torch.randn((v, d_feat), generator=gen, device="cuda") * 0.1
    lab = torch.from_numpy(labels).cuda()
    feats[torch.arange(v, device="cuda"), lab % d_feat] += 1.0
    return feats


def full_graph_batch(graph, cfg, seed=0, device="cuda"):
    """The whole graph as one `GraphBatch` of planted features, labels and
    train mask; GCN's sym norm for the gcn family."""
    from repro_torch.models import gnn
    labels, train = planted_labels(graph.num_vertices, cfg.n_classes, seed)
    src = torch.from_numpy(graph.src.astype(np.int32)).to(device)
    dst = torch.from_numpy(graph.dst.astype(np.int32)).to(device)
    mask = torch.ones(graph.num_edges, dtype=torch.bool, device=device)
    norm = (gnn.compute_gcn_edge_norm(src, dst, mask, graph.num_vertices)
            if cfg.family == "gcn" else None)
    feats = planted_features(labels, GNN_D_FEAT, seed).to(device)
    return gnn.GraphBatch.build(feats, src, dst, mask, labels, train,
                                edge_norm=norm, device=device)


def clone_tree(tree, dtype=None):
    """A parameter tree's leaves copied (optionally cast) as fresh leaves
    that require gradients."""
    if isinstance(tree, dict):
        return {k: clone_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v, dtype) for v in tree]
    if tree is None:
        return None
    return tree.detach().to(dtype or tree.dtype).clone().requires_grad_(True)


def gnn_grads(params, batch, cfg, prop_fn=None):
    """`gnn_loss` and its backward from `params` (gradients left in each
    leaf's `.grad`): `(loss, [gradient copies], forward launches, total
    launches)`, the combine counts set to 0 just before."""
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import gnn
    leaves = gnn.parameters(params)
    for p in leaves:
        p.grad = None
    sc.reset_launches()
    loss = gnn.gnn_loss(params, batch, cfg, prop_fn)
    fwd = dict(sc.LAUNCHES)
    loss.backward()
    total = dict(sc.LAUNCHES)
    return (loss.detach(), [p.grad.detach().clone() for p in leaves], fwd,
            total)


def expected_launches(cfg, pooled=False):
    """K1 launches of one training step: one forward combine a layer (and
    the mean-pool's), one backward combine over the src order for each
    layer whose input needs a gradient (all but the first)."""
    return cfg.n_layers + int(pooled), cfg.n_layers - 1


def check_launches(name, cfg, fwd, total, pooled=False):
    want_f, want_b = expected_launches(cfg, pooled)
    got_f, got_b = fwd["dense"], total["dense"] - fwd["dense"]
    if ((got_f, got_b) != (want_f, want_b) or total["tile"]
            or total["compact"]):
        raise AssertionError(f"{name}: K1 forward/backward launches "
                             f"{got_f}/{got_b}, expected {want_f}/{want_b}; "
                             f"counts {total}")
    return {"launches_forward": got_f, "launches_backward": got_b,
            "expected_forward": want_f, "expected_backward": want_b}


def train_steps(name, params, opt, batch, cfg, steps, counted, pooled=False):
    """`steps` timed training steps (forward, `gnn_loss`, backward, AdamW):
    one `gnn_step` line each (wall ms to a sync, peak memory, K1 launches
    forward and backward beside the expected); adds the launches to
    `counted`."""
    losses = []
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, fwd, total = gnn_grads(params, batch, cfg)
        opt.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"run": name, "step": i, "loss": float(loss), "ms": ms,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               **check_launches(name, cfg, fwd, total, pooled)}
        log("gnn_step", json.dumps(rec))
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{name}: loss {rec['loss']}")
        counted["forward"] += fwd["dense"]
        counted["backward"] += total["dense"] - fwd["dense"]
        losses.append(rec["loss"])
    return losses


def full_graph_run(graph, arch, counted):
    """One config over the whole graph: the first step from the initial
    parameters with every combine call (forward and backward) held, then
    GNN_TIMED_STEPS timed steps, then the first step's gradients again
    from the same parameters, which must be bitwise equal.  Returns the
    initial parameters, the first loss and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    cfg = get_config(arch)[0]
    t0 = time.perf_counter()
    batch = full_graph_batch(graph, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = gnn.init_gnn(gen, cfg, GNN_D_FEAT, cfg.n_classes)
    params0 = clone_tree(params)
    opt = AdamW(gnn.parameters(params), lr=GNN_LR)
    torch.cuda.reset_peak_memory_stats()
    box = []
    held = hold_block(f"{arch} step 0",
                      lambda: box.append(gnn_grads(params, batch, cfg)))
    loss0, grads0, _, _ = box.pop()
    peak0 = torch.cuda.max_memory_allocated()
    opt.step()
    torch.cuda.empty_cache()     # the holds' float64 blocks fragment the pool
    losses = train_steps(arch, params, opt, batch, cfg, GNN_TIMED_STEPS,
                         counted)
    again, grads1, _, _ = gnn_grads(clone_tree(params0), batch, cfg)
    same = bool(torch.equal(again, loss0)) and all(
        torch.equal(a, b) for a, b in zip(grads0, grads1))
    log("gnn_run", json.dumps({
        "run": arch, "V": graph.num_vertices, "E": graph.num_edges,
        "d_feat": GNN_D_FEAT, "layers": cfg.n_layers,
        "d_hidden": cfg.d_hidden, "classes": cfg.n_classes,
        "batch_build_s": build_s, "loss0": float(loss0),
        "step0_held_max_memory_allocated": peak0, "held": held,
        "losses": losses, "bitwise_equal_gradients": same}))
    if not same:
        raise AssertionError(f"{arch}: two gradient passes from the same "
                             f"parameters and batch differ")
    if not all(torch.isfinite(g).all() for g in grads0):
        raise AssertionError(f"{arch}: non-finite gradients")
    del batch, opt
    torch.cuda.empty_cache()
    return params0, loss0, grads0


@contextlib.contextmanager
def plain_combines():
    """Inside the block the combine entry points run the plain versions on
    every device (the kernels' own reference), so a CUDA tensor in float64
    stays in float64 on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_combine as sc
    dense, tile = ops._dense, ops._tile
    ops._dense = (lambda msgs, dst, n, op, seg_ptr:
                  sc.segment_combine_plain(msgs, dst, n, op))
    ops._tile = (lambda msgs, dst, n, op, valid:
                 sc.tile_segment_combine_plain(msgs, dst, n, op, valid))
    try:
        yield
    finally:
        ops._dense, ops._tile = dense, tile


def leaf_errors(got, want):
    """Per leaf: the largest |got - want| over the largest |want|."""
    return [float((g.double() - w).abs().max()
                  / w.abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def gnn_f64_check(scale):
    """At R-MAT `scale`, each config's loss and gradients through the
    kernels in float32 against the same functions on the plain versions in
    float64 on the card (`plain_combines`, which must launch no kernel):
    the loss within GNN_F64_TOL relative, each gradient within
    GNN_F64_TOL of its largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.graph.generators import rmat_edges
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import gnn
    g = rmat_edges(scale, 16, seed=0, weights=True).dedup()
    out = {}
    for arch in ("gcn-cora", "gin-tu"):
        cfg = get_config(arch)[0]
        batch = full_graph_batch(g, cfg)
        params = gnn.init_gnn(torch.Generator(device="cuda").manual_seed(1),
                              cfg, GNN_D_FEAT, cfg.n_classes)
        loss, grads, _, _ = gnn_grads(params, batch, cfg)
        b64 = dataclasses.replace(
            batch, node_feats=batch.node_feats.double(),
            edge_norm=(None if batch.edge_norm is None
                       else batch.edge_norm.double()))
        with plain_combines():
            loss64, grads64, _, total = gnn_grads(
                clone_tree(params, torch.float64), b64, cfg)
        if any(total.values()):
            raise AssertionError(f"the float64 reference launched {total}")
        loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
        errs = leaf_errors(grads, grads64)
        out[arch] = {"loss": float(loss), "loss64": float(loss64),
                     "loss_rel_err": loss_err, "grad_max_err": max(errs)}
        if loss_err > GNN_F64_TOL or max(errs) > GNN_F64_TOL:
            raise AssertionError(f"{arch} against float64: {out[arch]}, "
                                 f"per leaf {errs}")
    log("gnn_f64_check", json.dumps({"scale": scale, "V": g.num_vertices,
                                     "E": g.num_edges, **out}))


def gnn_minibatch_run(graph, counted):
    """GCN on `NeighborSampler` minibatches of the graph: minibatch_lg's
    1024 seeds, fanout (15, 10) and d_feat 602 (a `[V, 602]` planted
    feature table on the card).  MB_STEPS steps, each: host sample
    seconds, then the device ms (CUDA events) of the subgraph's batch
    (gather of its feature rows, routes, norm) and its training step; loss
    on the seed nodes."""
    from repro_torch.configs import get_config
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    cfg = get_config("gcn-cora")[0]
    labels, _ = planted_labels(graph.num_vertices, cfg.n_classes, 2)
    table = planted_features(labels, MB_D_FEAT, 2)
    labels_t = torch.from_numpy(labels).cuda()
    t0 = time.perf_counter()
    sampler = NeighborSampler(graph, MB_FANOUT, seed=0)
    csr_s = time.perf_counter() - t0
    n_pad, e_pad = sampler.budget(MB_SEEDS)
    params = gnn.init_gnn(torch.Generator(device="cuda").manual_seed(3), cfg,
                          MB_D_FEAT, cfg.n_classes)
    opt = AdamW(gnn.parameters(params), lr=1e-3)
    for step in range(MB_STEPS):
        t0 = time.perf_counter()
        sub = sampler.sample(MB_SEEDS, step)
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        ids = torch.from_numpy(sub.node_ids).cuda().clamp(min=0)
        src = torch.from_numpy(sub.src).cuda()
        dst = torch.from_numpy(sub.dst).cuda()
        mask = torch.from_numpy(sub.edge_mask).cuda()
        batch = gnn.GraphBatch.build(
            table.index_select(0, ids), src, dst, mask,
            labels_t.index_select(0, ids), sub.seed_mask,
            edge_norm=gnn.compute_gcn_edge_norm(src, dst, mask, n_pad))
        loss, _, fwd, total = gnn_grads(params, batch, cfg)
        opt.step()
        end.record()
        end.synchronize()
        rec = {"run": "minibatch", "step": step, "loss": float(loss),
               "host_sample_s": host_s, "device_ms": start.elapsed_time(end),
               "nodes": sub.num_nodes, "edges": sub.num_edges,
               "node_budget": n_pad, "edge_budget": e_pad,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               **check_launches("minibatch", cfg, fwd, total)}
        log("gnn_step", json.dumps(rec))
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"minibatch: loss {rec['loss']}")
        counted["forward"] += fwd["dense"]
        counted["backward"] += total["dense"] - fwd["dense"]
    log(f"gnn_minibatch csr_s={csr_s:.3f} table_bytes="
        f"{table.numel() * table.element_size()}")
    del table, batch
    torch.cuda.empty_cache()


def gnn_molecule_run(counted):
    """One GIN step on the molecule shape: 128 graphs of 30 nodes and 64
    random edges each (numpy seed 0), 16 features, graph labels in {0, 1},
    mean-pooled by graph through the combine.  A first step with every
    combine call held, then one timed, counted step."""
    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    cfg = get_config("gin-tu")[0]
    rng = np.random.default_rng(0)
    off = np.repeat(np.arange(MOL_GRAPHS) * MOL_NODES, MOL_EDGES)
    src = rng.integers(0, MOL_NODES, MOL_GRAPHS * MOL_EDGES) + off
    dst = rng.integers(0, MOL_NODES, MOL_GRAPHS * MOL_EDGES) + off
    v = MOL_GRAPHS * MOL_NODES
    batch = gnn.GraphBatch.build(
        rng.normal(size=(v, MOL_D_FEAT)).astype(np.float32), src, dst,
        np.ones(src.shape[0], bool), rng.integers(0, 2, MOL_GRAPHS),
        np.ones(v, bool), graph_ids=np.repeat(np.arange(MOL_GRAPHS),
                                              MOL_NODES),
        num_graphs=MOL_GRAPHS)
    params = gnn.init_gnn(torch.Generator(device="cuda").manual_seed(4), cfg,
                          MOL_D_FEAT, cfg.n_classes)
    opt = AdamW(gnn.parameters(params), lr=1e-3)
    held = hold_block("molecule step 0",
                      lambda: gnn_grads(params, batch, cfg))
    opt.step()
    train_steps("molecule", params, opt, batch, cfg, 1, counted, pooled=True)
    log("gnn_molecule", json.dumps({"graphs": MOL_GRAPHS, "nodes": v,
                                    "edges": int(src.shape[0]),
                                    "held": held}))


def gnn_phase(graph, f64_scale):
    """GCN and GIN training over the whole graph, the float64 check at
    `f64_scale`, the minibatch and the molecule runs.  Returns the timed
    steps' K1 launches (forward, backward) and GCN's initial parameters,
    first loss and gradients (the k = 8 run's reference)."""
    t0 = time.perf_counter()
    counted = {"forward": 0, "backward": 0}
    gcn_ref = full_graph_run(graph, "gcn-cora", counted)
    full_graph_run(graph, "gin-tu", counted)
    gnn_f64_check(f64_scale)
    gnn_minibatch_run(graph, counted)
    gnn_molecule_run(counted)
    log(f"gnn_phase_s={time.perf_counter() - t0:.3f} "
        f"launches={json.dumps(counted)}")
    return counted, gcn_ref


def gnn_dist_run(graph, inputs, gcn_ref):
    """One GCN gradient pass through `propagate_sharded` over the k = 8
    stacked shards of the directed graph's agent graph (sync topology),
    from GCN's initial parameters: its loss within GNN_LOSS_RTOL of the
    single card's and every gradient within GNN_GRAD_TOL of the largest
    magnitude of its leaf.  Returns the pass's loss and gradients (the
    reference of the pass over ranks, `dist_ranks_phase`)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.comm import StackedComm
    from repro_torch.models import gnn
    params0, loss0, grads0 = gcn_ref
    cfg = get_config("gcn-cora")[0]
    ag, topos, _ = inputs["directed"]
    comm = StackedComm(ag.k)
    t0 = time.perf_counter()
    batch = full_graph_batch(graph, cfg)
    stacked, prop_fn = gnn.shard_graph_batch(batch, ag, topos["sync"], comm)
    del batch
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    (loss, grads, fwd, total), ms = timed(lambda: gnn_grads(
        clone_tree(params0), stacked, cfg, prop_fn))
    loss_err = abs(float(loss) - float(loss0)) / abs(float(loss0))
    errs = leaf_errors(grads, [g.double() for g in grads0])
    rec = {"k": ag.k, "loss": float(loss), "single_card_loss": float(loss0),
           "loss_rel_err": loss_err, "grad_max_err": max(errs),
           "layout_s": layout_s, "ms": ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches_forward": fwd["dense"],
           "launches_backward": total["dense"] - fwd["dense"],
           "values_moved": comm.values}
    log("gnn_dist", json.dumps(rec))
    if loss_err > GNN_LOSS_RTOL or max(errs) > GNN_GRAD_TOL:
        raise AssertionError(f"k = {ag.k} GCN against the single card: "
                             f"{rec}, per leaf {errs}")
    del stacked, prop_fn
    torch.cuda.empty_cache()
    return loss, grads


# ----------------------------------------------------- incremental phase
INC_CHURN = 0.01                    # the share of edges a delta retires
INC_SEED = 21
INC_HOLD_STEPS = 3                  # warm supersteps whose combines are held


def churn_delta(graph, frac, seed, undirected=False):
    """A churn batch in the shape of tests/test_conformance.py's
    `_mutation_delta`, from a numpy seed: retire `frac` of the live edges
    and add about as many fresh random ones (symmetric pairs when
    `undirected`, so CC's graph stays undirected), with integer weights in
    [1, 100): exact in f32, so warm == cold stays bitwise."""
    from repro_torch.graph.structures import EdgeDelta
    rng = np.random.default_rng(seed)
    src, dst, n = graph.src, graph.dst, graph.num_vertices
    if undirected:
        fwd = np.flatnonzero(src < dst)
        m = max(1, int(fwd.size * frac))
        pick = rng.choice(fwd, size=m, replace=False)
        rem_s = np.concatenate([src[pick], dst[pick]])
        rem_d = np.concatenate([dst[pick], src[pick]])
        u = rng.integers(0, n, size=m)
        v = (u + 1 + rng.integers(0, n - 1, size=m)) % n
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        _, first = np.unique(lo * np.int64(n) + hi, return_index=True)
        keep = np.sort(first)
        add_s = np.concatenate([u[keep], v[keep]])
        add_d = np.concatenate([v[keep], u[keep]])
    else:
        m = max(1, int(graph.num_edges * frac))
        pick = rng.choice(graph.num_edges, size=m, replace=False)
        rem_s, rem_d = src[pick], dst[pick]
        add_s = rng.integers(0, n, size=m)
        add_d = rng.integers(0, n, size=m)
        _, first = np.unique(add_s * np.int64(n) + add_d, return_index=True)
        keep = np.sort(first)
        add_s, add_d = add_s[keep], add_d[keep]
    props = {}
    for key in graph.edge_props:
        w = rng.integers(1, 100, size=keep.size).astype(np.float32)
        props[key] = np.concatenate([w, w]) if undirected else w
    return EdgeDelta(add_src=add_s, add_dst=add_d, add_props=props,
                     rem_src=rem_s, rem_dst=rem_d)


def counted_run(eng, part, state, max_steps):
    """The run superstep by superstep, counting its exact edge scans (the
    active masters' live out-degrees summed over supersteps, as
    benchmarks/bench_incremental.py counts them).  Returns `(state, scans,
    supersteps)`."""
    n = part.num_masters
    deg = (part.csr_indptr[1:] - part.csr_indptr[:-1])[:n].to(torch.int64)
    scans = steps = 0
    while steps < max_steps:
        live = int(torch.where(state.active_scatter[:n], deg, 0).sum())
        if not bool(state.active_scatter[:n].any()):
            break
        scans += live
        state = eng.superstep(part, state)
        steps += 1
    return state, scans, steps


def warm_vs_cold(name, eng, new_part, prev, report, source, max_steps,
                 seconds):
    """One program's warm start on the mutated partition against its cold
    run there: the combine calls of the first INC_HOLD_STEPS warm
    supersteps held on their own inputs (`hold_block`), the counted pass of each (untimed), then
    the timed run with the combine counts set to 0 just before and read
    just after.  Halting
    programs must agree bitwise (and with their counted passes); PageRank
    within 1e-4.  Returns `(record, cold vertex data)`."""
    from repro_torch.kernels import segment_combine as sc
    t0 = time.perf_counter()
    warm0 = eng.warm_start_state(new_part, prev, report, source=source)
    torch.cuda.synchronize()
    seconds = dict(seconds, warm_start_state=time.perf_counter() - t0)
    cold0 = eng.init_state(new_part, source=source)
    rec = {"program": name, "host_s": seconds}

    # the combine calls of the first warm supersteps, held on their inputs
    def first_steps(state=warm0):
        for _ in range(INC_HOLD_STEPS):
            state = eng.superstep(new_part, state)

    rec["held"] = hold_block(f"incremental {name} warm", first_steps)
    if not rec["held"]:
        raise AssertionError(f"incremental {name}: no combine call held")
    outs = {}
    for kind, st0 in (("warm", warm0), ("cold", cold0)):
        counted, scans, steps = counted_run(eng, new_part, st0, max_steps)
        sc.reset_launches()
        out, ms = timed(lambda: eng.run(new_part, st0, max_steps))
        rec[kind] = {"supersteps": out.step, "wall_ms": ms,
                     "edge_scans": scans, "launches": dict(sc.LAUNCHES)}
        if out.step != steps or not torch.equal(out.vertex_data,
                                                counted.vertex_data):
            raise AssertionError(f"incremental {name} {kind}: the run and "
                                 "its counted pass differ")
        outs[kind] = out.vertex_data
    if eng.program.halts:
        if not torch.equal(outs["warm"], outs["cold"]):
            bad = int((outs["warm"] != outs["cold"]).sum())
            raise AssertionError(f"incremental {name}: warm != cold at "
                                 f"{bad} vertices")
    else:
        np.testing.assert_allclose(outs["warm"].cpu().numpy(),
                                   outs["cold"].cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)
    rec["scan_ratio"] = rec["cold"]["edge_scans"] / max(
        rec["warm"]["edge_scans"], 1)
    log("incremental", json.dumps(rec))
    return rec, outs["cold"]


def incremental_phase(graph, ugraph, part, upart, source):
    """Incremental re-convergence on one shard at the main path's scale: a
    1% churn delta of the directed graph (BFS "compact", SSSP "auto" and
    PageRank, 100 supersteps) on a partition built with slack for it, and
    one of the undirected graph (CC) on the main path's partition.  The
    body of
    `GREEngine.rerun_incremental` (`apply_edge_delta`, `warm_start_state`,
    `run`), split so one delta serves three programs and each run gets an
    untimed pass first.  (The undirected delta adds no more edges than it
    retires, so the main path's partition holds it without slack.)
    Returns the records, the delta and SSSP's cold result on the mutated
    graph."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import DevicePartition, GREEngine
    from repro_torch.kernels import segment_combine as sc
    t_phase = time.perf_counter()
    delta = churn_delta(graph, INC_CHURN, INC_SEED)
    udelta = churn_delta(ugraph, INC_CHURN, INC_SEED + 12, undirected=True)
    log(f"incremental_delta adds={delta.num_adds} "
        f"removes={delta.num_removes} undirected_adds={udelta.num_adds} "
        f"undirected_removes={udelta.num_removes}")
    # the slack partition, built from the edge stream in chunks: its first
    # E columns, CSR and row pointer are the main path partition's
    t0 = time.perf_counter()
    spart = DevicePartition.from_graph(graph, edge_slack=delta.num_adds,
                                       chunk_size=1 << 22, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    e = graph.num_edges
    same = [torch.equal(spart.src[:e], part.src[:e]),
            torch.equal(spart.dst[:e], part.dst[:e]),
            torch.equal(spart.edge_props["weight"][:e],
                        part.edge_props["weight"][:e]),
            torch.equal(spart.csr_indptr, part.csr_indptr),
            torch.equal(spart.csr_eidx[:e], part.csr_eidx[:e]),
            torch.equal(spart.seg_ptr[:-1], part.seg_ptr[:-1]),
            int(spart.seg_ptr[-1]) == e + delta.num_adds]
    if not all(same):
        raise AssertionError(f"chunked slack partition differs: {same}")
    t0 = time.perf_counter()
    new_part, report = spart.apply_edge_delta(delta)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    del spart
    if report.compacted or report.num_removed != delta.num_removes:
        raise AssertionError(f"delta ingress: compacted={report.compacted} "
                             f"removed={report.num_removed}")
    sink = int(new_part.seg_ptr[-1] - new_part.seg_ptr[-2])
    if sink != new_part.src.shape[0] - int(new_part.edge_mask.sum()):
        raise AssertionError("the row pointer's sink segment does not hold "
                             "every tombstone and padding slot")
    log(f"incremental_ingress slack_build_s={build_s:.3f} "
        f"apply_edge_delta_s={apply_s:.3f} removed={report.num_removed} "
        f"sink_segment_edges={sink}")
    records, launches = [], {r: 0 for r in sc.LAUNCHES}
    sssp_cold = None
    for name, factory, frontier, steps in (
            ("bfs_compact", "bfs_program", "compact", 10_000),
            ("sssp", "sssp_program", "auto", 10_000),
            ("pagerank", "pagerank_program", "auto", 100)):
        eng = GREEngine(getattr(algorithms, factory)(), frontier=frontier)
        seeded = name != "pagerank"
        prev = eng.run(part, eng.init_state(
            part, source=source if seeded else None), steps)
        rec, cold = warm_vs_cold(name, eng, new_part, prev, report,
                                 source if seeded else None, steps,
                                 {"apply_edge_delta": apply_s})
        records.append(rec)
        for r in launches:
            launches[r] += rec["warm"]["launches"][r]
        if name == "sssp":
            sssp_cold = cold.cpu().numpy()
    del new_part
    eng = GREEngine(algorithms.cc_program())
    prev = eng.run(upart, eng.init_state(upart), 10_000)
    t0 = time.perf_counter()
    new_upart, ureport = upart.apply_edge_delta(udelta)
    torch.cuda.synchronize()
    uapply_s = time.perf_counter() - t0
    rec, _ = warm_vs_cold("cc", eng, new_upart, prev, ureport, None, 10_000,
                          {"apply_edge_delta": uapply_s})
    rec["compacted"] = ureport.compacted
    records.append(rec)
    for r in launches:
        launches[r] += rec["warm"]["launches"][r]
    del new_upart
    torch.cuda.empty_cache()
    for route in ("dense", "tile"):
        if launches[route] <= 0:
            raise AssertionError(f"incremental: no {route}-route launch in "
                                 f"the warm runs {launches}")
        if not any(key.startswith(route) for r in records
                   for key in r["held"]):
            raise AssertionError(f"incremental: no {route}-route call held")
    log(f"incremental_phase_s={time.perf_counter() - t_phase:.3f} "
        f"warm_launches={json.dumps(launches)}")
    return records, delta, sssp_cold


# ---------------------------------------------------- graph serving phase
SERVE_LANES = 8
SERVE_QUERIES = 48
SERVE_RATE = 2.0                    # expected arrivals a round
SERVE_STEPS_PER_TICK = 4
SERVE_KINDS = ("bfs", "sssp", "ppr")
SERVE_DELTA_ROUNDS = {"finish": ("bfs", 4), "reseed": ("sssp", 6)}
# BFS on compacted frontiers (the tile route), as the main path's
# `bfs_compact`; SSSP "auto" (the dense scan at scale 22); PPR is pinned to
# the dense scan by its batcher
SERVE_FRONTIER = {"bfs": "compact", "sssp": "auto", "ppr": "auto"}
SERVE_WARMUP = 6                    # queries of the untimed first pass


def serving_stream(graph, seed=0):
    """`(arrival round, kind, source)` of each query: `poisson_ticks`
    arrivals (rate SERVE_RATE), kinds in turn, sources drawn without
    replacement among the vertices with out-edges (numpy seed)."""
    from repro_torch.serving import poisson_ticks
    rng = np.random.default_rng(seed)
    cands = np.flatnonzero(graph.out_degree() > 0)
    sources = rng.choice(cands, size=SERVE_QUERIES, replace=False)
    arrive = poisson_ticks(SERVE_QUERIES, SERVE_RATE, rng)
    return [(int(a), SERVE_KINDS[i % 3], int(s))
            for i, (a, s) in enumerate(zip(arrive, sources))]


def drive_stream(frontend, stream, deltas=None, on_delta=None):
    """Submit each query at its arrival round and step the frontend until
    it drains.  `deltas` maps a round to `(kind, delta, policy)`, applied
    at the first round from it where that batcher holds a resident, then
    `on_delta(batcher, policy)`.  Returns `(queries, rounds, wall s,
    partition each query ran on)`."""
    pending = list(stream)
    deltas = dict(deltas or {})
    queries, ran_on = [], {}
    rnd = 0
    t0 = time.perf_counter()
    while pending or not frontend.idle:
        while pending and pending[0][0] <= rnd:
            _, kind, s = pending.pop(0)
            queries.append(frontend.submit(kind, s))
        for at in [r for r in deltas if r <= rnd]:
            kind, delta, policy = deltas[at]
            b = frontend.batchers[kind]
            if b.busy:
                b.apply_delta(delta, policy=policy)
                del deltas[at]
                if on_delta:
                    on_delta(b, policy)
                if policy == "reseed":
                    for q in b._lane_query:
                        if q is not None:
                            ran_on[id(q)] = b._part
        frontend.step()
        for b in frontend.batchers.values():
            for q in b._lane_query:
                if q is not None and id(q) not in ran_on:
                    ran_on[id(q)] = getattr(b, "_part", None)
        rnd += 1
    torch.cuda.synchronize()
    if deltas:
        raise AssertionError(f"deltas never landed mid-flight: {deltas}")
    return queries, rnd, time.perf_counter() - t0, ran_on


def serving_record(name, queries, rounds, wall_s, batchers):
    """Latency percentiles, queries a second, ticks, supersteps and host
    reads a tick of one served stream (host clock)."""
    from repro_torch.core.frontier import HOST_READS as FRONTIER_READS
    from repro_torch.kernels.segment_combine import HOST_READS
    from repro_torch.serving.graph_scheduler import _percentile
    lat = sorted(q.latency_s for q in queries)
    ticks = sum(b.ticks for b in batchers)
    reads = (sum(b.host_reads for b in batchers)
             + FRONTIER_READS["frontier_counts"] + HOST_READS["compact_total"])
    rec = {"stream": name, "queries": len(queries), "rounds": rounds,
           "wall_s": wall_s, "queries_per_s": len(queries) / wall_s,
           "latency_p50_ms": 1e3 * _percentile(lat, 0.50),
           "latency_p99_ms": 1e3 * _percentile(lat, 0.99),
           "ticks": ticks, "supersteps": sum(b.supersteps for b in batchers),
           "host_reads_per_tick": reads / max(ticks, 1),
           "batcher_reads": sum(b.host_reads for b in batchers),
           "frontier_reads": FRONTIER_READS["frontier_counts"],
           "compact_total_reads": HOST_READS["compact_total"]}
    return rec


def graph_serving_phase(graph, part, seed=0):
    """Graph-query serving at the main path's scale: a `ServingFrontend`
    over 8-lane BFS, SSSP and PPR batchers (4 supersteps a tick) answers
    SERVE_QUERIES queries arriving by `poisson_ticks`; one small delta
    lands mid-flight on the BFS batcher under "finish" and one on the SSSP
    batcher under "reseed".  Every BFS and SSSP answer must equal a fresh
    single-source run on the graph its query ran on, bitwise; the last PPR
    answer (a recycled lane) a fresh PPR batcher's, bitwise.  Before that,
    the combine calls of each batcher's first tick are held on their own
    inputs against the plain version (`hold_block`).  Returns the
    record, the stream and fresh BFS answers on the unchanged graph for
    the stacked run (step 3e)."""
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    from repro_torch.core.frontier import HOST_READS as FRONTIER_READS
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.serving import GraphQueryBatcher, ServingFrontend
    t_phase = time.perf_counter()
    stream = serving_stream(graph, seed)
    factories = {"bfs": algorithms.bfs_program,
                 "sssp": algorithms.sssp_program,
                 "ppr": algorithms.ppr_push_program}

    def batcher(kind):
        return GraphQueryBatcher(
            GREEngine(factories[kind](SERVE_LANES),
                      frontier=SERVE_FRONTIER[kind]), part,
            steps_per_tick=SERVE_STEPS_PER_TICK)

    def frontend():
        return ServingFrontend({kind: batcher(kind) for kind in SERVE_KINDS})

    deltas = {at: (kind, churn_delta(graph, 1e-4, seed + 1 + i), policy)
              for i, (policy, (kind, at)) in enumerate(
                  sorted(SERVE_DELTA_ROUNDS.items()))}
    swaps = {}

    def on_delta(b, policy):
        swaps[policy] = time.perf_counter()

    single = {kind: GREEngine(factories[kind]()) for kind in ("bfs", "sssp")}
    old_bfs = {}

    def fresh_single(kind, target, source):
        eng = single[kind]
        return eng.run(target, eng.init_state(target, source=source),
                       10_000).vertex_data.cpu().numpy()

    def check(name, queries, ran_on):
        """Every BFS and SSSP answer against a fresh single-source run on
        its graph, bitwise; the last PPR answer (a recycled lane) against
        a fresh PPR batcher's, bitwise.  Returns the count held."""
        if not all(q.status == "done" for q in queries):
            raise AssertionError(f"serving {name}: a query did not finish")
        held = 0
        for q in queries:
            if q.kind == "ppr":
                continue
            target = ran_on[id(q)]
            want = fresh_single(q.kind, target, q.source)
            if not np.array_equal(q.result, want):
                raise AssertionError(f"serving {name} {q.kind} source "
                                     f"{q.source}: differs from a fresh "
                                     "single run")
            held += 1
            if q.kind == "bfs" and target is part:
                old_bfs[q.source] = want
        ppr = [q for q in queries if q.kind == "ppr"]
        if len(ppr) <= SERVE_LANES:
            return held             # no lane recycled yet (the warm-up)
        last = ppr[-1]
        fresh = GraphQueryBatcher(GREEngine(factories["ppr"](SERVE_LANES)),
                                  ran_on[id(last)])
        fresh.submit(last.source)
        (ref,) = fresh.run()
        if not np.array_equal(ref.result, last.result):
            raise AssertionError(f"serving {name}: a recycled PPR lane "
                                 "differs from a fresh PPR run")
        return held + 1

    # the combine calls of each batcher's first tick over its first
    # SERVE_LANES queries, held on their own inputs: PPR's multi-lane sum
    # and SSSP's min on the dense scan, BFS's min on the tile route
    held = {}
    for kind in SERVE_KINDS:
        b = batcher(kind)
        for src in [x[2] for x in stream if x[1] == kind][:SERVE_LANES]:
            b.submit(src)
        b.pump()
        held[kind] = hold_block(f"serving {kind} tick 1", b.tick)
        del b
    log("graph_serving_held", json.dumps(held))
    for kind, want in (("ppr", f"dense:sum:D{SERVE_LANES}:"),
                       ("sssp", ":min:"), ("bfs", f"tile:min:D{SERVE_LANES}:")):
        if not any(want in key for key in held[kind]):
            raise AssertionError(f"serving {kind}: no {want} call held "
                                 f"{held[kind]}")
    # an untimed pass of the stream's first queries (first-use costs), the
    # timed pass, then the stream again with one delta landing under each
    # policy
    records = {}
    for name, sub, mid in (("warm_up", stream[:SERVE_WARMUP], None),
                           ("timed", stream, None),
                           ("deltas", stream, deltas)):
        fe = frontend()
        sc.reset_launches()
        FRONTIER_READS["frontier_counts"] = 0
        queries, rounds, wall_s, ran_on = drive_stream(fe, sub, mid,
                                                       on_delta)
        rec = serving_record(name, queries, rounds, wall_s,
                             list(fe.batchers.values()))
        rec["launches"] = dict(sc.LAUNCHES)
        rec["held_bitwise"] = check(name, queries, ran_on)
        rec["ran_on_mutated_graph"] = sum(
            ran_on[id(q)] is not part for q in queries)
        rec["metrics"] = fe.metrics()
        log("graph_serving", json.dumps(rec))
        records[name] = rec
        for route in ("dense", "tile"):
            if rec["launches"][route] <= 0:
                raise AssertionError(f"serving {name}: no {route}-route "
                                     f"launch {rec['launches']}")
    if sorted(swaps) != ["finish", "reseed"] or \
            not records["deltas"]["ran_on_mutated_graph"]:
        raise AssertionError(f"serving: the deltas did not land mid-flight "
                             f"{sorted(swaps)}")
    for q_src in [s for _, kind, s in stream if kind == "bfs"]:
        if q_src not in old_bfs:
            old_bfs[q_src] = fresh_single("bfs", part, q_src)
    log(f"graph_serving_phase_s={time.perf_counter() - t_phase:.3f}")
    return records, stream, old_bfs


# ----------------------------------------------------- distributed phase
DIST_K = 8                          # shards, as the paper's 8 machines
# (program, exchange, options) of the distributed phase, in run order;
# exchange="async" refuses PageRank, which the phase checks apart
DIST_RUNS = (("pagerank", "agent", {}), ("pagerank", "agent", {"overlap": True}),
             ("pagerank", "dense", {}), ("pagerank", "pipelined", {}),
             ("sssp", "agent", {}), ("sssp", "agent", {"overlap": True}),
             ("sssp", "dense", {}), ("sssp", "pipelined", {}),
             ("sssp", "async", {"staleness": 2}),
             ("bfs_compact", "agent", {}), ("bfs_compact", "pipelined", {}),
             ("bfs_compact", "async", {"staleness": 2}),
             ("cc", "agent", {}), ("cc", "async", {"staleness": 2}))


# The pad multiple of the directed graph's second agent graph (step 3e):
# room in every pad for a 1% churn delta.  At scale 22 and k = 8 it divides
# the master capacity 2**19, so both agent graphs share `cap` and
# `old2new`; at small scales it pads `cap` too.
SLACK_PAD = 1 << 18


def dist_ingress(conn, src: str, scale: int, k: int, key: str) -> None:
    """Host ingress of the distributed phase, run in a child process while
    the parent drives the single-shard phases: the same R-MAT graph as
    `build_inputs` (`key` "directed") or its undirected form (CC), HDRF
    placement onto `k` shards (the JAX package's default partitioner), the
    agent graph and `partition_quality`.  For the directed graph it also
    builds the agent graph of the same placement with head-room in every
    pad (`pad_multiple=SLACK_PAD`), which a 1% churn delta fits without a
    rebuild (step 3e).  Sends `(AgentGraph fields, figures, slack fields or
    None)` back through `conn`."""
    sys.path.insert(0, src)
    try:
        from repro_torch.core.agent_graph import build_agent_graph
        from repro_torch.core.partition import partition_quality
        from repro_torch.core.partition_stream import partition_edges
        from repro_torch.graph.generators import rmat_edges
        t0 = time.perf_counter()
        g = rmat_edges(scale, 16, seed=0, weights=True).dedup()
        if key == "undirected":
            g = g.as_undirected()
        t1 = time.perf_counter()
        part = partition_edges(g, k, method="hdrf")
        t2 = time.perf_counter()
        ag = build_agent_graph(g, part, k, partitioner="hdrf")
        t3 = time.perf_counter()
        q = partition_quality(g, part, k=k)
        t4 = time.perf_counter()
        slack = None
        if key == "directed":
            slack = vars(build_agent_graph(g, part, k, partitioner="hdrf",
                                           pad_multiple=SLACK_PAD))
        t5 = time.perf_counter()
        conn.send(("ok", (vars(ag), {
            "E": g.num_edges, "graph_s": t1 - t0, "hdrf_s": t2 - t1,
            "ingress_agent_graph_s": t3 - t2, "quality_s": t4 - t3,
            "slack_agent_graph_s": t5 - t4,
            "replication_factor": q.replication_factor,
            "remote_dst_edge_fraction": q.remote_dst_edge_fraction,
            "edge_balance": q.edge_balance, "agent_comm": q.agent_comm,
            "vertexcut_comm": q.vertexcut_comm}, slack)))
    except Exception as exc:            # the parent raises it
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def start_dist_ingress(scale: int, k: int,
                       keys=("directed", "undirected")):
    """Start one `dist_ingress` a graph, each in a spawned process (numpy
    only, no CUDA).  Returns `[(key, process, connection)]`."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    children = []
    for key in keys:
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=dist_ingress,
                           args=(send, str(ROOT / "src"), scale, k, key),
                           daemon=True)
        proc.start()
        send.close()
        children.append((key, proc, recv))
    return children


def stop_dist_ingress(children) -> None:
    """Join the ingress processes, ending any still running."""
    for _, proc, _ in children:
        proc.join(timeout=5)
        if proc.is_alive():
            proc.terminate()
            proc.join()


def tensor_bytes(obj) -> int:
    """Bytes of the distinct tensors reachable from a topology's fields."""
    seen, total, stack = set(), 0, [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def dist_inputs(children):
    """Receive the children's agent graphs, print the ingress figures and
    build the two stacked topologies of each graph on the card: the sync
    one (edge columns, flush route; the dense backend's route for the
    directed graph) and the split tiles of the pipelined and async
    backends.  Returns `{key: (ag, {"sync": topo, "tiles": topo}, fig)}`
    and, under "slack", the directed graph's agent graph with head-room in
    its pads (no topology)."""
    from repro_torch.core import algorithms
    from repro_torch.core.agent_graph import AgentGraph
    from repro_torch.core.dist_engine import DistGREEngine
    out = {}
    prog = algorithms.bfs_program()
    for key, proc, recv in children:
        t0 = time.perf_counter()
        status, payload = recv.recv()
        proc.join()
        log(f"dist_ingress_wait_s={time.perf_counter() - t0:.3f} {key}")
        if status != "ok":
            raise RuntimeError(f"distributed ingress failed: {payload}")
        fields, fig, slack = payload
        ag = AgentGraph(**fields)
        if slack is not None:
            out["slack"] = AgentGraph(**slack)
        topos = {}
        t0 = time.perf_counter()
        sync = "dense" if key == "directed" else "agent"
        for name, exchange in (("sync", sync), ("tiles", "pipelined")):
            eng = DistGREEngine(prog, ag.k, exchange=exchange)
            topos[name] = eng.device_topology(ag)
        torch.cuda.synchronize()
        fig.update({
            "graph": key, "k": ag.k, "V": ag.num_vertices, "cap": ag.cap,
            "V_s": int(ag.num_scatter.sum()),
            "V_c": int(ag.num_combiner.sum()),
            "s_x_pad": ag.s_x_pad, "c_x_pad": ag.c_x_pad, "e_pad": ag.e_pad,
            "topology_s": time.perf_counter() - t0,
            "topology_bytes": {n: tensor_bytes(t) for n, t in topos.items()}})
        log("dist_ingress", json.dumps(fig))
        out[key] = (ag, topos, fig)
    return out


# program -> (`algorithms` factory, seeded at the source, frontier, graph,
# superstep limit)
DIST_PROGRAMS = {
    "pagerank": ("pagerank_program", False, "auto", "directed", 30),
    "sssp": ("sssp_program", True, "auto", "directed", 10_000),
    "bfs_compact": ("bfs_program", True, "compact", "directed", 10_000),
    "cc": ("cc_program", False, "auto", "undirected", 10_000),
}


def dist_setup(name, exchange, opts, inputs, source):
    """The engine, agent graph, stacked topology, initial state, ingress
    figures and superstep limit of one program under one exchange."""
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    factory, seeded, frontier, key, steps = DIST_PROGRAMS[name]
    ag, topos, fig = inputs[key]
    eng = DistGREEngine(getattr(algorithms, factory)(), ag.k,
                        exchange=exchange, frontier=frontier, **opts)
    topo = topos["sync" if eng.plan.phases == "sync" else "tiles"]
    st = eng.init_state(ag, source=source if seeded else None)
    return eng, ag, topo, st, fig, steps


def dist_run(name, exchange, opts, inputs, ref, source, single_steps,
             checked):
    """One program under one exchange on the stacked shards: the run, its
    oracle check, its superstep count against the single-shard run and its
    launch counts; returns the `dist_run` record and the result in original
    order."""
    from repro_torch.core.frontier import HOST_READS as FRONTIER_READS
    from repro_torch.kernels.segment_combine import HOST_READS, LAUNCHES
    eng, ag, topo, st, fig, steps = dist_setup(name, exchange, opts, inputs,
                                               source)
    before = dict(LAUNCHES)
    reads = (HOST_READS["compact_total"], FRONTIER_READS["frontier_counts"])
    eng.comm.values = 0
    out, ms = timed(lambda: eng.make_run(ag, steps)(topo, st))
    launches = {r: LAUNCHES[r] - before[r] for r in LAUNCHES}
    compact_reads = HOST_READS["compact_total"] - reads[0]
    frontier_reads = FRONTIER_READS["frontier_counts"] - reads[1]
    result = eng.original_order(ag, out.vertex_data)
    if not checked:
        return None, None
    ref_name = "bfs" if name == "bfs_compact" else name
    if name == "pagerank":
        np.testing.assert_allclose(result, ref["pagerank"], rtol=1e-4,
                                   atol=1e-4)
    else:
        assert_exact(f"dist {name} {exchange}", torch.from_numpy(result),
                     ref[ref_name])
    if exchange != "async" and out.step != single_steps[name]:
        raise AssertionError(f"dist {name} {exchange}: {out.step} "
                             f"supersteps, single shard "
                             f"{single_steps[name]}")
    if launches["dense"] <= 0:
        raise AssertionError(f"dist {name} {exchange}: no dense-route "
                             f"combine launch {launches}")
    if name == "bfs_compact" and launches["tile"] <= 0:
        raise AssertionError(f"dist {name} {exchange}: no tile-route "
                             f"combine launch {launches}")
    if compact_reads:   # every tile route passes its valid-lane count
        raise AssertionError(f"dist {name} {exchange}: {compact_reads} "
                             "host reads of a compaction's valid total")
    vs_vc = fig["V_s"] + fig["V_c"]
    per_step = {"agent": vs_vc, "pipelined": vs_vc,
                "async": vs_vc / opts.get("staleness", 1),
                "dense": fig["V_s"] + ag.k * ag.k * ag.cap}[exchange]
    e = fig["E"]
    rec = {"program": name, "exchange": exchange, **opts, "k": ag.k,
           "supersteps": out.step, "wall_ms": ms,
           "edges_per_s": e * out.step / (ms / 1e3) if out.step else 0.0,
           "launches": launches, "compact_total_reads": compact_reads,
           "frontier_reads": frontier_reads,
           "values_per_superstep": per_step, "comm_values": eng.comm.values,
           "comm_values_per_superstep": eng.comm.values / max(out.step, 1)}
    log("dist_run", json.dumps(rec))
    return rec, result


def dist_phase(inputs, ref, source, single_steps):
    """The distributed phase: async refuses PageRank, one untimed pass of
    every run of DIST_RUNS, then the timed pass with the combine and
    compaction counts set to 0 just before and read just after, then the
    kernels held at the path's shapes (`dist_hold_phase`).  Returns the
    records, the launches and each run's `(record, result)` by
    `run_key`."""
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.kernels import segment_combine as sc
    try:
        DistGREEngine(algorithms.pagerank_program(), DIST_K,
                      exchange="async")
    except ValueError as exc:
        log(f"dist async pagerank refused: {exc}")
    else:
        raise AssertionError("exchange='async' accepted PageRank")
    log("dist warm-up pass (untimed, unchecked):")
    for name, exchange, opts in DIST_RUNS:
        dist_run(name, exchange, opts, inputs, ref, source, single_steps,
                 False)
    log("dist timed pass:")
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    t0 = time.perf_counter()
    finals = {run_key(name, exchange, opts): dist_run(
        name, exchange, opts, inputs, ref, source, single_steps, True)
        for name, exchange, opts in DIST_RUNS}
    runs = [rec for rec, _ in finals.values()]
    launches = dict(sc.LAUNCHES)
    log(f"dist_path_s={time.perf_counter() - t0:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    log("dist_launches", json.dumps(launches))
    log("dist_compact_total_reads", sc.HOST_READS["compact_total"])
    dist_hold_phase(inputs, source)
    return runs, launches, finals


def run_key(name, exchange, opts) -> str:
    return " ".join([name, exchange] + [f"{k}={v}" for k, v in
                                        sorted(opts.items())])


# (program, exchange) whose first DIST_HOLD_STEPS supersteps have every
# combine-kernel call held: each route of the distributed path, in sums
# and in min (async runs the pipelined backend's tile routes)
DIST_HOLDS = (("pagerank", "agent"), ("pagerank", "dense"),
              ("pagerank", "pipelined"), ("sssp", "agent"), ("sssp", "dense"),
              ("sssp", "pipelined"), ("bfs_compact", "agent"),
              ("bfs_compact", "pipelined"), ("cc", "agent"))
DIST_HOLD_STEPS = 3


@contextlib.contextmanager
def recorded_combines(on_call):
    """Pass `(route, inputs)` of every combine-wrapper call
    (`repro_torch.kernels.ops`) made inside the block to `on_call`, right
    after the call returns; the calls still launch their kernels."""
    from repro_torch.kernels import ops
    dense, tile = ops.segment_combine, ops.tile_segment_combine

    def dense_rec(msgs, dst, num_segments, op="sum", seg_ptr=None):
        out = dense(msgs, dst, num_segments, op, seg_ptr)
        on_call("dense", {"msgs": msgs, "dst": dst, "op": op,
                          "num_segments": num_segments, "seg_ptr": seg_ptr})
        return out

    def tile_rec(msgs, dst, num_segments, op="sum", valid=None):
        out = tile(msgs, dst, num_segments, op, valid)
        on_call("tile", {"msgs": msgs, "dst": dst, "op": op,
                         "num_segments": num_segments, "valid": valid})
        return out

    ops.segment_combine, ops.tile_segment_combine = dense_rec, tile_rec
    try:
        yield
    finally:
        ops.segment_combine, ops.tile_segment_combine = dense, tile


def hold_recorded(name, route, args):
    """One recorded wrapper call's kernels, launched twice on its inputs,
    against the plain versions: the dense route's combine over the call's
    row pointer, or the tile route's compaction and whole route.  Returns
    the combine's errors."""
    from repro_torch.kernels import segment_combine as sc
    dst, nseg, op = args["dst"], args["num_segments"], args["op"]
    msgs = args["msgs"]
    msgs = msgs.reshape(msgs.shape[0], -1).to(torch.float32).contiguous()
    if route == "dense":
        ptr = args["seg_ptr"][:nseg + 1]

        def run():
            return sc.segment_combine_cuda(msgs, dst, ptr, nseg, op,
                                           route="dense")
        return hold_combine(name, op, run(), run(), msgs, dst, nseg)
    valid = args["valid"]
    hold_compaction(name, dst, nseg, valid)
    keep = dst < nseg

    def run():
        return sc.tile_segment_combine_cuda(msgs, dst, nseg, op, valid)
    return hold_combine(name, op, run(), run(), msgs[keep], dst[keep], nseg)


# the largest error of every combine-wrapper call held on the path's own
# inputs (`hold_block`), by route, and the (route, op, width) of the held
# calls: the kernels line reports both
HELD_ERRS = {"dense": 0.0, "tile": 0.0}
# the same calls' largest error over the float64 sum of the terms'
# magnitudes (what SUM_RTOL bounds): the absolute error grows with the
# values summed (DimeNet's gradients reach ~1e10 at random init)
HELD_MAG_ERRS = {"dense": 0.0, "tile": 0.0}
HELD_WIDTHS = set()


@contextlib.contextmanager
def held_combines(name, active=lambda: True, uncounted=False):
    """Hold each combine-wrapper call made inside the block, while
    `active()`, on its own inputs against the plain version
    (`hold_recorded`) as the call returns (so a call's inputs are freed
    with its caller's): min/max bitwise, sums within SUM_RTOL of the
    float64 sum of the terms' magnitudes (`hold_combine`).  Yields the
    calls held by `route:op:D<lanes>:<segments>`; the errors go to
    HELD_ERRS.  With `uncounted`, the holds' own launches are taken back
    out of the launch counts."""
    from repro_torch.kernels import segment_combine as sc
    seen = {}

    def hold(route, args):
        if not active():
            return
        counts = dict(sc.LAUNCHES)
        with torch.no_grad():    # a held call may come from a backward
            e = hold_recorded(f"{name} call {sum(seen.values())}", route,
                              args)
        if uncounted:
            sc.LAUNCHES.update(counts)
        HELD_ERRS[route] = max(HELD_ERRS[route], e["max_abs_err"])
        HELD_MAG_ERRS[route] = max(HELD_MAG_ERRS[route], e["mag_rel_err"])
        m = args["msgs"]
        d = int(np.prod(m.shape[1:])) if m.dim() > 1 else 1
        HELD_WIDTHS.add((route, args["op"], d))
        key = f"{route}:{args['op']}:D{d}:{args['num_segments']}"
        seen[key] = seen.get(key, 0) + 1

    with recorded_combines(hold):
        yield seen
    torch.cuda.synchronize()


def hold_block(name, fn):
    """Run `fn()` with each of its combine-wrapper calls held
    (`held_combines`); returns the calls held."""
    with held_combines(name) as seen:
        fn()
    return seen


def dist_hold_phase(inputs, source):
    """Every combine-wrapper call of the first DIST_HOLD_STEPS supersteps
    of each DIST_HOLDS run, held on its own inputs against the plain
    version (`hold_block`): min/max bitwise, sums within SUM_RTOL of the
    float64 sum.  Each run must reach its backend's segment spaces (agent:
    the stacked slots; dense: those and the `[k, k·cap]` vectors;
    pipelined: the compact combiner and master spaces) and the compacted
    BFS the tile route."""
    held = 0
    for name, exchange in DIST_HOLDS:
        eng, ag, topo, st, _, _ = dist_setup(name, exchange, {}, inputs,
                                             source)
        k, ns, cap = ag.k, ag.num_slots, ag.cap
        want = {"agent": {k * ns}, "dense": {k * ns, k * k * cap},
                "pipelined": {k * (ag.c_pad + 1), k * (cap + 1)}}[exchange]
        seen = hold_block(f"dist {name} {exchange}", lambda: eng.make_run(
            ag, DIST_HOLD_STEPS)(topo, st))
        held += sum(seen.values())
        log("dist_hold", json.dumps({"program": name, "exchange": exchange,
                                     "supersteps": DIST_HOLD_STEPS,
                                     "held": seen}))
        spaces = {int(key.rsplit(":", 1)[1]) for key in seen}
        if not want <= spaces:
            raise AssertionError(f"dist {name} {exchange}: held segment "
                                 f"spaces {sorted(spaces)}, expected "
                                 f"{sorted(want)}")
        if name == "bfs_compact" and not any(key.startswith("tile")
                                             for key in seen):
            raise AssertionError(f"dist {name} {exchange}: no tile-route "
                                 "call to hold")
    log(f"dist_calls_held={held} max_abs_err={json.dumps(HELD_ERRS)}")


def dist_tuned_phase(inputs, ref, source, plan, cache_path):
    """The tuning phase's SSSP winner stored with `phases="pipelined"`
    under the k = 8 agent graph's key: `DistGREEngine(plan="auto-tuned")`
    must adopt it and select the pipelined exchange, and its SSSP must
    equal the default (agent) engine's and the oracle bitwise."""
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.tuning import PlanCache, plan_cache_key
    ag, topos, _ = inputs["directed"]
    prog = algorithms.sssp_program()
    key = plan_cache_key(agent_graph=ag, program=prog, mesh_size=ag.k)
    PlanCache(cache_path).store(key, dataclasses.replace(
        plan, phases="pipelined"))
    eng = DistGREEngine(prog, ag.k, plan="auto-tuned", plan_cache=cache_path)
    st = eng.init_state(ag, source=source)
    if eng.exchange != "pipelined" or eng.plan.phases != "pipelined":
        raise AssertionError(f"dist auto-tuned: exchange {eng.exchange}, "
                             f"plan {eng.plan}")
    default = DistGREEngine(prog, ag.k)
    dst0 = default.init_state(ag, source=source)
    runs = {}
    for name, e, topo, s0 in (("auto-tuned", eng, topos["tiles"], st),
                              ("default", default, topos["sync"], dst0)):
        e.make_run(ag, 10_000)(topo, s0)               # untimed
        out, ms = timed(lambda: e.make_run(ag, 10_000)(topo, s0))
        runs[name] = (e.original_order(ag, out.vertex_data), out.step, ms)
    if not np.array_equal(runs["auto-tuned"][0], runs["default"][0]):
        raise AssertionError("dist auto-tuned SSSP != the default engine's")
    assert_exact("dist auto-tuned sssp",
                 torch.from_numpy(runs["auto-tuned"][0]), ref["sssp"])
    log("dist_tuned", json.dumps({
        "key": key, "exchange": eng.exchange,
        "plan": plan_label(eng.plan), "local_frontier_cap":
        eng.local.frontier_cap,
        **{f"{n}_{f}": v for n, r in runs.items()
           for f, v in (("supersteps", r[1]), ("wall_ms", r[2]))}}))


# ------------------------------------- distributed incremental and serving
def dist_incremental_phase(inputs, delta, source, sssp_cold):
    """SSSP under agent on the k = 8 stacked shards: `rerun_incremental`
    with the 1% churn delta of step 3c on the directed graph's agent graph
    with head-room in its pads (the fast path: tombstones, adds on
    owner(dst), fresh scatter agents), from the fixed point of the step-3b
    agent graph's run where the two agent graphs share `cap` and `old2new`
    (scale 22), else from a run on the head-room graph itself; held
    bitwise against a cold stacked run on a topology built anew and
    against the single shard's cold result.  The combine counts are set to
    0 just before the rerun and read just after; the combine calls of the
    first warm superstep are then held on their own inputs.  Then the compaction
    fallback on a small graph built here (R-MAT scale 16, hash partition,
    tight pads).  Returns the record."""
    from repro_torch.core import algorithms
    from repro_torch.core.agent_graph import build_agent_graph
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.graph.generators import rmat_edges
    from repro_torch.kernels import segment_combine as sc
    t_phase = time.perf_counter()
    ag, topos, _ = inputs["directed"]
    slack = inputs["slack"]
    eng = DistGREEngine(algorithms.sssp_program(), ag.k, exchange="agent")
    shared = slack.cap == ag.cap and np.array_equal(slack.old2new,
                                                    ag.old2new)
    if shared:   # the same master rows: the step-3b graph's fixed point
        prev = eng.make_run(ag, 10_000)(topos["sync"],
                                        eng.init_state(ag, source=source))
    else:
        _, prev = eng.run(slack, source=source, max_steps=10_000)
    sc.reset_launches()
    new_ag, warm, out, report = eng.rerun_incremental(
        slack, prev, delta, source=source, max_steps=10_000)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    stages = dict(eng.last_rerun_s)
    if report.compacted:
        raise AssertionError("the 1% delta overflowed the slack pads")
    t0 = time.perf_counter()
    topo = eng.device_topology(new_ag)
    torch.cuda.synchronize()
    topo_s = time.perf_counter() - t0
    # the combine calls of the first warm superstep, held on their inputs
    warm0 = eng.warm_start_state(new_ag, prev, report, source=source)
    held = hold_block("dist incremental warm superstep 1",
                      lambda: eng.make_run(new_ag, 1)(topo, warm0))
    if not held:
        raise AssertionError("dist incremental: no combine call held")
    del warm0
    cold_state, ms = timed(lambda: eng.make_run(new_ag, 10_000)(
        topo, eng.init_state(new_ag, source=source)))
    cold = eng.original_order(new_ag, cold_state.vertex_data)
    if not (np.array_equal(warm, cold) and np.array_equal(warm, sssp_cold)):
        raise AssertionError("dist incremental: warm != cold")
    if launches["dense"] <= 0:
        raise AssertionError(f"dist incremental: no dense launch {launches}")
    rec = {"program": "sssp", "exchange": "agent", "k": ag.k,
           "pad_multiple_slack": SLACK_PAD, "prev_from_step_3b": shared,
           "host_s": stages, "warm_supersteps": out.step,
           "cold_supersteps": cold_state.step, "cold_wall_ms": ms,
           "cold_topology_s": topo_s, "launches": launches,
           "held": held,
           "V_s_added": int(new_ag.num_scatter.sum()
                            - slack.num_scatter.sum()),
           "removed": report.num_removed, "added": report.num_adds}
    del topo
    # the compaction fallback, on a small graph: tight pads overflow
    g = rmat_edges(16, 16, seed=1, weights=True).dedup()
    small = build_agent_graph(g, "hash", ag.k)
    sdelta = churn_delta(g, INC_CHURN, INC_SEED)
    src = int(np.argmax(g.out_degree()))
    _, sprev = eng.run(small, source=src, max_steps=10_000)
    new_small, swarm, _, sreport = eng.rerun_incremental(
        small, sprev, sdelta, source=src, max_steps=10_000)
    scold, _ = eng.run(new_small, source=src, max_steps=10_000)
    if not (sreport.compacted and np.array_equal(swarm, scold)
            and np.array_equal(new_small.old2new, small.old2new)):
        raise AssertionError("dist incremental: the compaction fallback "
                             "failed its checks")
    rec["compaction"] = {"scale": 16, "partition": "hash",
                         "host_s": dict(eng.last_rerun_s),
                         "e_pad": [small.e_pad, new_small.e_pad],
                         "s_pad": [small.s_pad, new_small.s_pad]}
    log("dist_incremental", json.dumps(rec))
    log(f"dist_incremental_phase_s={time.perf_counter() - t_phase:.3f}")
    return rec


def dist_serving_phase(inputs, stream, old_bfs):
    """The serving stream's BFS queries through an 8-lane BFS batcher on
    the k = 8 stacked shards under agent (no delta; an untimed pass of the
    first SERVE_WARMUP queries, then all of them), each answer held
    bitwise against the fresh single-shard run of step 3d, with the
    combine counts set to 0 just before and read just after.  First the
    combine calls of one tick over SERVE_LANES queries are held on their
    own inputs (`hold_block`), and the batcher drains."""
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.core.frontier import HOST_READS as FRONTIER_READS
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.serving import GraphQueryBatcher, ServingFrontend
    t_phase = time.perf_counter()
    ag = inputs["directed"][0]
    bfs = [x for x in stream if x[1] == "bfs"]

    def frontend():
        eng = DistGREEngine(algorithms.bfs_program(SERVE_LANES), ag.k,
                            exchange="agent", frontier=SERVE_FRONTIER["bfs"])
        return ServingFrontend({"bfs": GraphQueryBatcher(
            eng, ag, steps_per_tick=SERVE_STEPS_PER_TICK)})

    t0 = time.perf_counter()
    fe = frontend()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = fe.batchers["bfs"]
    # the combine calls of the first tick, held on their own inputs
    for _, _, src in bfs[:SERVE_LANES]:
        b.submit(src)
    b.pump()
    held = hold_block("dist serving bfs tick 1", b.tick)
    fe.run()                                      # drain, untimed
    drive_stream(fe, bfs[:SERVE_WARMUP])          # untimed pass
    b.ticks = b.supersteps = b.host_reads = 0
    sc.reset_launches()
    FRONTIER_READS["frontier_counts"] = 0
    queries, rounds, wall_s, _ = drive_stream(fe, bfs)
    rec = serving_record("dist_bfs_agent", queries, rounds, wall_s, [b])
    rec.update({"k": ag.k, "setup_s": setup_s,
                "launches": dict(sc.LAUNCHES), "held": held})
    for q in queries:
        if q.status != "done" or not np.array_equal(q.result,
                                                    old_bfs[q.source]):
            raise AssertionError(f"dist serving: BFS source {q.source} "
                                 "differs from the single shard")
    if rec["launches"]["dense"] <= 0:
        raise AssertionError(f"dist serving: no dense launch "
                             f"{rec['launches']}")
    rec["held_bitwise"] = len(queries)
    log("dist_serving", json.dumps(rec))
    log(f"dist_serving_phase_s={time.perf_counter() - t_phase:.3f}")
    return rec


# -------------------------------------------- distributed, one shard a rank
# (program, exchange, options) of the world of DIST_K ranks, in run order:
# each is a run of DIST_RUNS, whose stacked result and count it is held to
RANK_RUNS = (("pagerank", "agent", {}), ("pagerank", "dense", {}),
             ("sssp", "agent", {}), ("sssp", "pipelined", {}),
             ("sssp", "async", {"staleness": 2}),
             ("bfs_compact", "agent", {}), ("cc", "agent", {}))
# seconds: the world's join and every collective's; the world takes about
# 53 s on the H100, and a hung rank must fail the phase well inside the
# script's limit
RANK_TIMEOUT = 240.0
RANK_PR_RTOL = 1e-5      # PageRank over ranks against the stacked run


def save_agent_graph(ag, path: Path) -> None:
    """An AgentGraph's fields as `.npy` files (a dict field one file a
    key) and `meta.json` (the scalars), for `load_agent_graph`."""
    path.mkdir(parents=True)
    meta = {}
    for f in dataclasses.fields(ag):
        v = getattr(ag, f.name)
        if isinstance(v, np.ndarray):
            np.save(path / f"{f.name}.npy", v)
        elif isinstance(v, dict):
            meta[f.name] = {"keys": sorted(v)}
            for n, a in v.items():
                np.save(path / f"{f.name}.{n}.npy", a)
        else:
            meta[f.name] = list(v) if isinstance(v, tuple) else v
    (path / "meta.json").write_text(json.dumps(
        meta, default=lambda o: o.item()))


def load_agent_graph(path: Path):
    """`save_agent_graph`'s AgentGraph, its arrays memory-mapped (copy on
    write): a rank reads the pages it touches."""
    from repro_torch.core.agent_graph import AgentGraph
    meta = json.loads((path / "meta.json").read_text())
    fields = {}
    for f in dataclasses.fields(AgentGraph):
        m = meta.get(f.name)
        if isinstance(m, dict):
            fields[f.name] = {n: np.load(path / f"{f.name}.{n}.npy",
                                         mmap_mode="c") for n in m["keys"]}
        elif f.name in meta:
            fields[f.name] = tuple(m) if isinstance(m, list) else m
        else:
            fields[f.name] = np.load(path / f"{f.name}.npy", mmap_mode="c")
    return AgentGraph(**fields)


def write_gcn_inputs(graph, work: Path) -> None:
    """`full_graph_batch`'s node rows for gcn-cora (planted labels, train
    mask and `[V, 100]` features, seed 0) and the graph's out- and
    in-degrees (its sym norm), as `.npy` files a rank memory-maps."""
    from repro_torch.configs import get_config
    cfg = get_config("gcn-cora")[0]
    n = graph.num_vertices
    labels, train = planted_labels(n, cfg.n_classes, 0)
    feats = planted_features(labels, GNN_D_FEAT, 0)
    np.save(work / "gcn_feats.npy", feats.cpu().numpy())
    del feats
    np.save(work / "gcn_labels.npy", labels.astype(np.int64))
    np.save(work / "gcn_train.npy", train)
    np.save(work / "gcn_dout.npy", np.bincount(graph.src, minlength=n))
    np.save(work / "gcn_din.npy", np.bincount(graph.dst, minlength=n))


def tree_numpy(tree):
    """A parameter tree's leaves as numpy arrays, in its structure."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_numpy(v) for v in tree]
    return None if tree is None else tree.detach().cpu().numpy()


def rank_runs(comm, ags, work: Path, source):
    """A rank's RANK_RUNS on the shard it holds: per run the combine calls
    of the first DIST_HOLD_STEPS supersteps held on their own inputs
    (`hold_block`), then the run with the combine counts and `values` set
    to 0 just before and read just after, between two barriers (the wall
    is the barrier-to-barrier time); rank 0 writes the all-gathered result
    to `work`.  Returns one record a run."""
    import hashlib
    import torch.distributed as dist
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.kernels import segment_combine as sc
    dev, topos, recs = comm.device, {}, []
    for name, exchange, opts in RANK_RUNS:
        factory, seeded, frontier, key, steps = DIST_PROGRAMS[name]
        ag = ags[key]
        eng = DistGREEngine(getattr(algorithms, factory)(), ag.k,
                            exchange=exchange, frontier=frontier, device=dev,
                            comm=comm, **opts)
        t0 = time.perf_counter()
        tkey = (key, "tiles" if eng.plan.phases != "sync" else exchange)
        if tkey not in topos:
            topos[tkey] = eng.device_topology(ag)
        topo = topos[tkey]
        torch.cuda.synchronize(dev)
        topo_s = time.perf_counter() - t0
        st = eng.init_state(ag, source=source if seeded else None)
        held = hold_block(f"rank {comm.rank} {name} {exchange}",
                          lambda: eng.make_run(ag, DIST_HOLD_STEPS)(topo, st))
        torch.cuda.reset_peak_memory_stats(dev)
        sc.reset_launches()
        comm.values = 0
        dist.barrier()
        t0 = time.perf_counter()
        out = eng.make_run(ag, steps)(topo, st)
        torch.cuda.synchronize(dev)
        dist.barrier()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches, values = dict(sc.LAUNCHES), comm.values
        peak = torch.cuda.max_memory_allocated(dev)
        result = eng.original_order(ag, out.vertex_data)
        run = run_key(name, exchange, opts)
        if comm.rank == 0:
            np.save(work / f"result {run}.npy", result)
        recs.append({"run": run, "supersteps": out.step, "wall_ms": wall_ms,
                     "launches": launches, "values": values,
                     "max_memory_allocated": peak, "topology_s": topo_s,
                     "held": held,
                     "digest": hashlib.sha1(result.tobytes()).hexdigest()})
        del out, st
    del topos
    torch.cuda.empty_cache()
    return recs


def rank_gcn(comm, ag, work: Path, params_np):
    """A rank's GCN gradient pass through `propagate_sharded`: its node
    rows from `write_gcn_inputs`' files, the loss over every shard's
    training nodes, backward, the gradients and the loss summed over the
    ranks in rank order (`gnn.psum_grads`, `gnn.psum_shares`).  The K1
    counts are set to 0 just before the loss and read after the sums."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import gnn
    cfg = get_config("gcn-cora")[0]
    dev = comm.device
    t0 = time.perf_counter()
    topo = DistGREEngine(algorithms.bfs_program(), ag.k, exchange="agent",
                         device=dev, comm=comm).device_topology(ag)

    def arr(name):
        return torch.from_numpy(np.load(work / f"gcn_{name}.npy",
                                        mmap_mode="c"))

    batch, prop_fn = gnn.shard_node_rows(
        ag, topo, comm, arr("feats"), arr("labels"), arr("train"),
        degrees=(arr("dout"), arr("din")))
    params = gnn.params_from_numpy(params_np, cfg, device=dev)
    torch.cuda.synchronize(dev)
    layout_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    sc.reset_launches()
    comm.values = 0
    dist.barrier()
    t0 = time.perf_counter()
    loss = gnn.gnn_loss(params, batch, cfg, prop_fn=prop_fn, comm=comm)
    fwd = dict(sc.LAUNCHES)
    loss.backward()
    gnn.psum_grads(params, comm)
    total = gnn.psum_shares(comm, loss.detach())
    torch.cuda.synchronize(dev)
    dist.barrier()
    ms = (time.perf_counter() - t0) * 1e3
    return {"loss": float(total), "ms": ms, "layout_s": layout_s,
            "grads": [p.grad.cpu().numpy() for p in gnn.parameters(params)],
            "launches_forward": fwd["dense"],
            "launches_backward": sc.LAUNCHES["dense"] - fwd["dense"],
            "launches": dict(sc.LAUNCHES), "values": comm.values,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def rank_main(comm, work, source, gcn_params, stream):
    """One rank of the `dist_ranks` world: the programs, the GCN pass,
    then this slice's DimeNet pass, AutoInt lookup and serving stream
    (`rank_models`); returns their records and this process's held-call
    errors."""
    work = Path(work)
    free, total = torch.cuda.mem_get_info(comm.device)
    ags = {key: load_agent_graph(work / key)
           for key in ("directed", "undirected")}
    t0 = time.perf_counter()
    runs = rank_runs(comm, ags, work, source)
    t1 = time.perf_counter()
    gcn = rank_gcn(comm, ags["directed"], work, gcn_params)
    del ags
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    models = rank_models(comm, work, stream)
    return {"runs": runs, "gcn": gcn, "models": models,
            "device_free_at_start": free, "device_total": total,
            "held_errs": dict(HELD_ERRS), "held_widths": sorted(HELD_WIDTHS),
            "held_mag_errs": dict(HELD_MAG_ERRS),
            "phase_s": {"runs": t1 - t0, "gcn": t2 - t1,
                        "models": time.perf_counter() - t2}}


def nccl_calls(comm):
    """Every `ProcessGroupComm` call on a world of one NCCL rank against
    `StackedComm(1)` on the same inputs on the card (numpy seed 0), and
    `all_to_all`'s backward: the names of the calls that differ."""
    from repro_torch.dist.comm import StackedComm
    dev, stacked = comm.device, StackedComm(1)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    rows = t(rng.normal(size=(1, 1000, 3)).astype(np.float32))
    lanes = t(rng.random((1, 8)) < 0.5)
    send = t(rng.normal(size=(1, 1, 500, 2)).astype(np.float32))
    cot = t(rng.normal(size=(1, 1, 500, 2)).astype(np.float32))
    flags = t(np.array([[False, True, False]]))
    got, want = {}, {}
    for out, c in ((got, comm), (want, stacked)):
        for op in ("psum", "pmin", "pmax", "all_gather"):
            out[op] = getattr(c, op)(rows)
        out["pmax_bool"] = c.pmax(lanes)
        out["all_to_all_bool"] = c.all_to_all(flags.reshape(1, 1, 3))
        x = send.clone().requires_grad_(True)
        y = c.all_to_all(x)
        (y * cot).sum().backward()
        out["all_to_all"], out["all_to_all_grad"] = y.detach(), x.grad
        out["any"] = torch.tensor([c.any(flags), c.any(~flags.any(
            dim=1, keepdim=True))])
    failed = [n for n in want
              if not (got[n].dtype == want[n].dtype
                      and got[n].shape == want[n].shape
                      and torch.equal(got[n].cpu(), want[n].cpu()))]
    return {"calls": sorted(want), "failed": failed, "device": str(dev)}


def dist_ranks_phase(ags, graph, ref, source, finals, gcn_stacked,
                     gcn_params0, work: Path, stream, stacked_models):
    """The distributed path on DIST_K processes, one shard a rank
    (`repro_torch.dist.world`, gloo over CUDA tensors on the one card):
    the agent graphs and GCN's node rows go to `.npy` files once, each
    rank memory-maps them; RANK_RUNS (`rank_runs`) and the GCN pass
    (`rank_gcn`) run in every rank.  Held here: min programs bitwise
    against the stacked run of `dist_phase` and the host oracle, PageRank
    within RANK_PR_RTOL of the stacked run (bitwise or not, printed) and
    1e-4 of the oracle, every rank's result equal (a digest), supersteps
    equal to the stacked run's, the ranks' `values` adding up to the
    stacked count, K1 launched on every rank (K2 on some rank of the
    compacted BFS), every rank's held calls; the GCN loss and gradients
    against `gnn_dist_run`'s within GNN_LOSS_RTOL / GNN_GRAD_TOL; then
    `rank_models`' records against `stacked_models` (`check_rank_models`).
    `work` holds this slice's inputs already (`dimenet_sharded_phase`,
    `autoint_phase`).  Then an NCCL world of one rank (`nccl_calls`).
    Returns the ranks' combine launches, summed by route."""
    from repro_torch.dist.world import run_world
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    for key, ag in ags.items():
        save_agent_graph(ag, work / key)
    write_gcn_inputs(graph, work)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    parent = {"allocated": torch.cuda.memory_allocated(),
              "reserved": torch.cuda.memory_reserved(),
              "device_free": free, "device_total": total}
    t0 = time.perf_counter()
    done = run_world(rank_main, DIST_K,
                     (str(work), source, tree_numpy(gcn_params0),
                      stream),
                     backend="gloo", device="cuda", timeout=RANK_TIMEOUT)
    world_s = time.perf_counter() - t0
    results = {run_key(*r): np.load(work / f"result {run_key(*r)}.npy")
               for r in RANK_RUNS}
    ranks = [r.value for r in done]
    peaks = [max([x["max_memory_allocated"] for x in v["runs"]]
                 + [v["gcn"]["max_memory_allocated"]]) for v in ranks]
    log("dist_ranks_world", json.dumps({
        "ranks": DIST_K, "backend": "gloo", "write_inputs_s": write_s,
        "world_s": world_s, "spawn_s": [r.spawn_s for r in done],
        "init_s": [r.init_s for r in done], "parent_memory": parent,
        "rank_phase_s": [v["phase_s"] for v in ranks],
        "rank_device_free_at_start": [v["device_free_at_start"]
                                      for v in ranks],
        "rank_max_memory_allocated": peaks,
        "parent_reserved_plus_rank_peaks": parent["reserved"] + sum(peaks)}))
    launches = {"dense": 0, "tile": 0, "compact": 0}
    for i, (name, exchange, opts) in enumerate(RANK_RUNS):
        key = run_key(name, exchange, opts)
        srec, stacked = finals[key]
        recs = [v["runs"][i] for v in ranks]
        got = results[key]
        ref_name = "bfs" if name == "bfs_compact" else name
        if name == "pagerank":
            np.testing.assert_allclose(got, stacked, rtol=RANK_PR_RTOL,
                                       atol=0)
            np.testing.assert_allclose(got, ref["pagerank"], rtol=1e-4,
                                       atol=1e-4)
        else:
            if not np.array_equal(got, stacked):
                raise AssertionError(f"ranks {key}: != the stacked run")
            assert_exact(f"ranks {key}", torch.from_numpy(got),
                         ref[ref_name])
        if len({r["digest"] for r in recs}) != 1:
            raise AssertionError(f"ranks {key}: the ranks' results differ")
        steps = [r["supersteps"] for r in recs]
        if set(steps) != {srec["supersteps"]}:
            raise AssertionError(f"ranks {key}: supersteps {steps}, "
                                 f"stacked {srec['supersteps']}")
        values = sum(r["values"] for r in recs)
        if values != srec["comm_values"]:
            raise AssertionError(f"ranks {key}: values {values}, stacked "
                                 f"{srec['comm_values']}")
        per_rank = [r["launches"] for r in recs]
        if min(n["dense"] for n in per_rank) <= 0 or (
                name == "bfs_compact" and not any(n["tile"] for n in
                                                  per_rank)):
            raise AssertionError(f"ranks {key}: launches {per_rank}")
        if not all(r["held"] for r in recs):
            raise AssertionError(f"ranks {key}: a rank held no call")
        for n in per_rank:
            for route in launches:
                launches[route] += n[route]
        log("dist_rank_run", json.dumps({
            "run": key, "ranks": DIST_K, "supersteps": steps[0],
            "wall_ms_rank0": recs[0]["wall_ms"],
            "stacked_wall_ms": srec["wall_ms"],
            "bitwise_vs_stacked": bool(np.array_equal(got, stacked)),
            "values": values, "launches": per_rank,
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in recs],
            "topology_s": [r["topology_s"] for r in recs],
            "held": [sum(r["held"].values()) for r in recs]}))
    for v in ranks:
        for route, e in v["held_errs"].items():
            HELD_ERRS[route] = max(HELD_ERRS[route], e)
        for route, e in v["held_mag_errs"].items():
            HELD_MAG_ERRS[route] = max(HELD_MAG_ERRS[route], e)
        HELD_WIDTHS.update(tuple(w) for w in v["held_widths"])
    gcn = [v["gcn"] for v in ranks]
    loss0, grads0 = gcn_stacked
    loss_err = abs(gcn[0]["loss"] - float(loss0)) / abs(float(loss0))
    errs = leaf_errors([torch.from_numpy(g) for g in gcn[0]["grads"]],
                       [g.double().cpu() for g in grads0])
    same = all(g["loss"] == gcn[0]["loss"] and all(
        np.array_equal(a, b) for a, b in zip(g["grads"], gcn[0]["grads"]))
        for g in gcn)
    for g in gcn:
        launches["dense"] += g["launches"]["dense"]
    log("dist_rank_gcn", json.dumps({
        "ranks": DIST_K, "loss": gcn[0]["loss"],
        "stacked_loss": float(loss0), "loss_rel_err": loss_err,
        "grad_max_err": max(errs), "ranks_agree": same,
        "ms_rank0": gcn[0]["ms"], "layout_s": [g["layout_s"] for g in gcn],
        "launches_forward": [g["launches_forward"] for g in gcn],
        "launches_backward": [g["launches_backward"] for g in gcn],
        "values": sum(g["values"] for g in gcn),
        "max_memory_allocated": [g["max_memory_allocated"] for g in gcn]}))
    if (loss_err > GNN_LOSS_RTOL or max(errs) > GNN_GRAD_TOL or not same
            or min(g["launches_backward"] for g in gcn) <= 0):
        raise AssertionError(f"ranks GCN against the stacked pass: loss "
                             f"{loss_err}, per leaf {errs}, agree {same}")
    for route, n in check_rank_models([v["models"] for v in ranks],
                                      stacked_models).items():
        launches[route] += n
    t0 = time.perf_counter()
    nccl = run_world(nccl_calls, 1, backend="nccl", device="cuda",
                     timeout=RANK_TIMEOUT)[0]
    log("dist_nccl_world", json.dumps({**nccl.value, "world_s":
                                       time.perf_counter() - t0}))
    if nccl.value["failed"]:
        raise AssertionError(f"NCCL world of one: {nccl.value['failed']} "
                             "differ from StackedComm(1)")
    log(f"dist_ranks_phase_s={time.perf_counter() - t_phase:.3f} "
        f"launches={json.dumps(launches)}")
    return launches


# ------------------------------------------ equivariant GNNs and AutoInt
# GNN_SHAPES' molecule: 128 graphs of 30 atoms and 64 edges; the sharded
# pass takes 1024 of them (30,720 atoms, 65,536 edges) on DIST_K shards
EQ_GRAPHS, EQ_ATOMS, EQ_EDGES, EQ_SPECIES = 128, 30, 64, 16
EQ_SHARDED_GRAPHS = 1024
EQ_TARGET_SEED = 5
EQ_TIMED_STEPS = 3
EQ_LR = 1e-3
# rotation and translation invariance of the summed outputs, the JAX
# package's own bounds (tests/test_equivariant.py): |Σo - Σo'| below
# tol·(|Σo| + 1)
EQ_INVARIANCE_TOL = {"dimenet": 1e-4, "mace": 1e-3}
AUTOINT_SEED = 7
AUTOINT_REPS = 10
AUTOINT_CANDIDATES = 1_000_000
DEV = "cuda"                 # the device of this section's phases


def molecule_union(n_graphs):
    """`n_graphs` `random_geometric_molecule`s (numpy seeds 0..n-1) laid
    out one after another, species in [0, EQ_SPECIES) and planted targets
    (a per-species value plus noise, numpy seed EQ_TARGET_SEED), and the
    union's triplets (`build_triplets`, no padding): numpy arrays."""
    from repro_torch.graph.generators import random_geometric_molecule
    from repro_torch.models import dimenet
    pos, src, dst = [], [], []
    for g in range(n_graphs):
        p, s, d = random_geometric_molecule(EQ_ATOMS, EQ_EDGES, seed=g)
        pos.append(p)
        src.append(s + g * EQ_ATOMS)
        dst.append(d + g * EQ_ATOMS)
    v = n_graphs * EQ_ATOMS
    rng = np.random.default_rng(EQ_TARGET_SEED)
    species = rng.integers(0, EQ_SPECIES, v).astype(np.int32)
    per_species = rng.normal(size=EQ_SPECIES).astype(np.float32)
    target = (per_species[species]
              + 0.1 * rng.normal(size=v).astype(np.float32))[:, None]
    src, dst = np.concatenate(src), np.concatenate(dst)
    t0 = time.perf_counter()
    kj, ji, tm = dimenet.build_triplets(src, dst, v)
    return {"pos": np.concatenate(pos), "species": species, "src": src,
            "dst": dst, "edge_mask": np.ones(src.shape[0], bool),
            "tri_kj": kj, "tri_ji": ji, "tri_mask": tm,
            "target": target.astype(np.float32),
            "triplets_s": time.perf_counter() - t0}


MOL_KEYS = ("pos", "species", "src", "dst", "edge_mask", "tri_kj", "tri_ji",
            "tri_mask", "target")


def mol_tensors(mol, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(mol[k])).to(dev)
            for k in MOL_KEYS}


def eq_model(arch):
    """`(cfg, forward(params, m, routes, pos=None), routes(m), init)` of
    the dimenet or mace config at full width over molecule tensors `m`."""
    from repro_torch.configs import get_config
    from repro_torch.models import dimenet, mace
    cfg = get_config(arch)[0]
    if arch == "dimenet":
        def fwd(params, m, routes, pos=None):
            return dimenet.dimenet_forward(
                params, m["pos"] if pos is None else pos, m["species"],
                m["src"], m["dst"], m["edge_mask"], m["tri_kj"],
                m["tri_ji"], m["tri_mask"], cfg, routes=routes)

        def routes(m):
            return dimenet.DimeNetRoutes.build(
                m["species"], m["src"], m["dst"], m["tri_kj"], m["tri_ji"],
                m["tri_mask"], m["pos"].shape[0], EQ_SPECIES)
        return cfg, fwd, routes, dimenet.init_dimenet

    def fwd(params, m, routes, pos=None):
        return mace.mace_forward(params, m["pos"] if pos is None else pos,
                                 m["species"], m["src"], m["dst"],
                                 m["edge_mask"], cfg, routes=routes)

    def routes(m):
        return mace.MaceRoutes.build(m["species"], m["src"], m["dst"],
                                     m["pos"].shape[0], EQ_SPECIES)
    return cfg, fwd, routes, mace.init_mace


def expected_eq_launches(arch, cfg):
    """K1 launches of one step, forward and backward.  DimeNet: forward two
    sums a block (triplet → edge, edge → node); backward the checkpointed
    block's recomputed triplet sum, the `m[tri_kj]` gather's and the two
    embedding gathers'.  MACE: forward one sum a path a layer; backward
    each path's sum once more (the checkpointed layer's recompute; the
    path's own checkpoint inside it does not run it a third time), the
    `h[src]` gathers of the paths whose input needs a gradient (l_in = 0
    only, in the first layer: h[1], h[2] start at zero) and the
    embedding's."""
    from repro_torch.nn.equivariant import valid_paths
    L = cfg.n_layers
    if arch == "dimenet":
        return 2 * L, 2 * L + 2
    paths = valid_paths(cfg.l_max)
    P = len(paths)
    first = sum(l1 == 0 for l1, _, _ in paths)
    return L * P, L * P + (L - 1) * P + first + 1


def eq_step(fwd, params, m, routes):
    """MSE of the node outputs against the targets and its backward;
    `(loss, forward K1 launches, all K1 launches)`, the counts set to 0
    just before."""
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import gnn
    for p in gnn.parameters(params):
        p.grad = None
    sc.reset_launches()
    loss = ((fwd(params, m, routes) - m["target"]) ** 2).mean()
    f = sc.LAUNCHES["dense"]
    loss.backward()
    return loss.detach(), f, dict(sc.LAUNCHES)


def eq_molecule_run(arch, mol, counted):
    """One equivariant model at full width on the molecule batch: a first
    step with every combine call (forward and backward) held against the
    plain version, then EQ_TIMED_STEPS timed steps (forward, MSE,
    backward, AdamW; K1 launches against `expected_eq_launches`, peak
    memory), then the invariance of the summed outputs under a rotation
    and a translation (EQ_INVARIANCE_TOL)."""
    from repro_torch.models import gnn
    from repro_torch.nn.equivariant import _random_rotation
    from repro_torch.optim import AdamW
    t0 = time.perf_counter()
    cfg, fwd, make_routes, init = eq_model(arch)
    m = mol_tensors(mol, DEV)
    routes = make_routes(m)
    gen = torch.Generator(device=DEV).manual_seed(6)
    params = init(gen, cfg, n_species=EQ_SPECIES, device=DEV)
    opt = AdamW(gnn.parameters(params), lr=EQ_LR)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    box = []
    held = hold_block(f"{arch} step 0", lambda: box.append(
        eq_step(fwd, params, m, routes)))
    loss0, _, _ = box.pop()
    opt.step()
    torch.cuda.empty_cache()
    want = expected_eq_launches(arch, cfg)
    steps = []
    for i in range(EQ_TIMED_STEPS):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, f, total = eq_step(fwd, params, m, routes)
        opt.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = (f, total["dense"] - f)
        rec = {"run": arch, "step": i, "loss": float(loss), "ms": ms,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches_forward": got[0], "launches_backward": got[1],
               "expected_forward": want[0], "expected_backward": want[1]}
        log("eq_step", json.dumps(rec))
        if got != want or total["tile"] or total["compact"]:
            raise AssertionError(f"{arch}: K1 launches {got}, expected "
                                 f"{want}; counts {total}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{arch}: loss {rec['loss']}")
        counted[arch] += total["dense"]
        steps.append(rec)
    with torch.no_grad():
        R = torch.from_numpy(_random_rotation(np.random.default_rng(3))).to(
            DEV, torch.float32)
        a = fwd(params, m, routes).sum()
        b = fwd(params, m, routes, pos=m["pos"] @ R.T - 1.0).sum()
        inv = float((a - b).abs() / (a.abs() + 1.0))
    rec = {"run": arch, "graphs": EQ_GRAPHS, "atoms": int(m["pos"].shape[0]),
           "edges": int(m["src"].shape[0]),
           "triplets": int(m["tri_mask"].sum()), "layers": cfg.n_layers,
           "d_hidden": cfg.d_hidden, "setup_s": setup_s,
           "loss0": float(loss0), "held": held,
           "ms": [s["ms"] for s in steps],
           "max_memory_allocated": max(s["max_memory_allocated"]
                                       for s in steps),
           "launches_a_step": list(want),
           "invariance_rel_err": inv,
           "invariance_tol": EQ_INVARIANCE_TOL[arch]}
    log(f"{arch}_molecule", json.dumps(rec))
    if not math.isfinite(inv) or inv > EQ_INVARIANCE_TOL[arch]:
        raise AssertionError(f"{arch}: rotation/translation changed the "
                             f"summed output by {inv} (relative)")
    del params, opt, routes, m
    torch.cuda.empty_cache()
    return rec


def sum_leaf_grads(params):
    from repro_torch.models import gnn
    return [p.grad.detach().clone() for p in gnn.parameters(params)]


def dimenet_sharded_pass(params_np, mol, comm, dev):
    """A DimeNet gradient pass through `dimenet_forward_sharded` over the
    shards `comm` holds: the MSE over every atom (each process's share
    summed in rank order), gradients summed over the processes.  Returns
    `(loss, grads, record)`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import dimenet, gnn
    cfg = get_config("dimenet")[0]
    t0 = time.perf_counter()
    sh = dimenet.shard_molecule_graph(
        *(mol[k] for k in MOL_KEYS[:-1]), cfg, comm, n_species=EQ_SPECIES,
        device=dev)
    params = dimenet.params_from_numpy(params_np, cfg, device=dev)
    target = sh.node_rows(torch.from_numpy(mol["target"]).to(dev))
    real = sh.node_masters[:, None]
    torch.cuda.synchronize(dev)
    layout_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    sc.reset_launches()
    comm.values = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = dimenet.dimenet_forward_sharded(params, sh, cfg)
    share = torch.where(real, (out - target) ** 2, 0.0).sum() / \
        mol["pos"].shape[0]
    fwd = sc.LAUNCHES["dense"]
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    share.backward()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    gnn.psum_grads(params, comm)
    loss = gnn.psum_shares(comm, share.detach())
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    ms = (t3 - t0) * 1e3
    rec = {"k": comm.k, "layout_s": layout_s, "ms": ms,
           "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
           "psum_ms": (t3 - t2) * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "launches_forward": fwd,
           "launches_backward": sc.LAUNCHES["dense"] - fwd,
           "values": comm.values,
           "V_c_tri": int(sh.ag_tri.num_combiner.sum()),
           "V_c_node": int(sh.ag_node.num_combiner.sum()),
           "triplets": int(sh.tri_mask.sum())}
    return loss, sum_leaf_grads(params), rec


def dimenet_sharded_phase(work: Path):
    """DimeNet on EQ_SHARDED_GRAPHS molecules: one gradient pass through
    the port's single-card `dimenet_forward` (from parameters drawn on the
    card, seed 8), then the same through `dimenet_forward_sharded` on
    DIST_K HDRF shards stacked on the card (`StackedComm`): loss within
    GNN_LOSS_RTOL and gradients within GNN_GRAD_TOL of each leaf's largest
    magnitude.  Writes the union and the parameters to `work` for the
    pass over ranks; returns the stacked loss and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.dist.comm import StackedComm
    from repro_torch.models import dimenet
    t_phase = time.perf_counter()
    mol = molecule_union(EQ_SHARDED_GRAPHS)
    cfg = get_config("dimenet")[0]
    params = dimenet.init_dimenet(torch.Generator(device=DEV).manual_seed(8),
                                  cfg, n_species=EQ_SPECIES, device=DEV)
    params_np = tree_numpy(params)
    _, fwd, make_routes, _ = eq_model("dimenet")
    m = mol_tensors(mol, DEV)
    torch.cuda.reset_peak_memory_stats()
    (loss1, _, _), single_ms = timed(lambda: eq_step(
        fwd, params, m, make_routes(m)))
    grads1 = sum_leaf_grads(params)
    single_peak = torch.cuda.max_memory_allocated()
    del m, params
    torch.cuda.empty_cache()
    loss_first, _, first = dimenet_sharded_pass(params_np, mol,
                                                StackedComm(DIST_K), DEV)
    loss, grads, rec = dimenet_sharded_pass(params_np, mol,
                                            StackedComm(DIST_K), DEV)
    rec.update({"first_pass_ms": first["ms"],
                "repeats_bitwise": bool(torch.equal(loss, loss_first))})
    loss_err = abs(float(loss) - float(loss1)) / abs(float(loss1))
    errs = leaf_errors(grads, [g.double() for g in grads1])
    rec.update({"graphs": EQ_SHARDED_GRAPHS, "atoms": mol["pos"].shape[0],
                "edges": int(mol["src"].shape[0]), "loss": float(loss),
                "single_card_loss": float(loss1), "loss_rel_err": loss_err,
                "grad_max_err": max(errs), "single_card_ms": single_ms,
                "single_card_max_memory_allocated": single_peak,
                "triplets_s": mol["triplets_s"]})
    log("dimenet_sharded", json.dumps(rec))
    if (loss_err > GNN_LOSS_RTOL or max(errs) > GNN_GRAD_TOL
            or not rec["repeats_bitwise"]):
        raise AssertionError(f"DimeNet on {DIST_K} stacked shards against "
                             f"the single card: {rec}, per leaf {errs}")
    np.savez(work / "dimenet_mol.npz", **{k: mol[k] for k in MOL_KEYS})
    with open(work / "dimenet_params.pkl", "wb") as f:
        pickle.dump(params_np, f)
    torch.cuda.empty_cache()
    log(f"dimenet_sharded_phase_s={time.perf_counter() - t_phase:.3f}")
    return loss, grads, rec


def autoint_phase(work: Path):
    """AutoInt at full width: the `[37,020,000, 16]` f32 table (2.37 GB,
    `init_autoint` from a CUDA generator, seed AUTOINT_SEED) with
    RECSYS_SHAPES' batches from `synth_batch`.  serve_p99 (B = 512): the
    logits (finite), their CUDA-event median; train_batch (B = 65,536):
    one step with every combine call held (the table gradient's K1), then
    EQ_TIMED_STEPS timed steps of AdamW (one K1 launch each);
    retrieval_cand: one query against AUTOINT_CANDIDATES candidates; and
    `sharded_embedding_lookup` over `StackedComm(DIST_K)` (4,627,500 rows a
    shard) bitwise equal to the whole-table lookup at both batch sizes.
    Writes the table and the serve batch to `work` for the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.dist.comm import StackedComm
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import autoint, gnn
    from repro_torch.nn.embedding import (embedding_lookup,
                                          sharded_embedding_lookup)
    from repro_torch.optim import AdamW
    t_phase = time.perf_counter()
    cfg = get_config("autoint")[0]
    shapes = {s.name: s for s in RECSYS_SHAPES}
    gen = torch.Generator(device=DEV).manual_seed(AUTOINT_SEED)
    t0 = time.perf_counter()
    params = autoint.init_autoint(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve = autoint.synth_batch(gen, cfg, shapes["serve_p99"].batch)
    train = autoint.synth_batch(gen, cfg, shapes["train_batch"].batch)
    rec = {"rows": cfg.total_rows(), "embed_dim": cfg.embed_dim,
           "table_bytes": params["table"].numel() * 4, "init_s": init_s}
    with torch.no_grad():
        logits = autoint.autoint_logits(params, serve["ids"], cfg)
        if logits.shape != (serve["ids"].shape[0],) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"autoint serve logits {logits.shape}")
        rec["serve_p99_ms"] = cuda_ms(
            lambda: autoint.autoint_logits(params, serve["ids"], cfg),
            AUTOINT_REPS)
        # the row-sharded lookup: DIST_K stacked shards of the table
        shards = params["table"].detach().reshape(DIST_K, -1, cfg.embed_dim)
        comm = StackedComm(DIST_K)
        for name, b in (("serve_p99", serve), ("train_batch", train)):
            whole = embedding_lookup(params["table"].detach(), b["ids"])
            got = sharded_embedding_lookup(shards, b["ids"], comm)
            if not torch.equal(got, whole):
                raise AssertionError(f"sharded lookup at {name} differs "
                                     "from the whole table's")
            rec[f"sharded_lookup_{name}_bitwise"] = True
            del whole, got
        rec["sharded_lookup_serve_ms"] = cuda_ms(
            lambda: sharded_embedding_lookup(shards, serve["ids"], comm),
            AUTOINT_REPS)
        del shards
        # retrieval: one query against a million candidates
        rg = torch.Generator(device=DEV).manual_seed(AUTOINT_SEED + 1)
        cand = torch.randn((AUTOINT_CANDIDATES, cfg.d_attn), generator=rg,
                           device=DEV)
        proj = torch.randn((cfg.n_sparse * cfg.d_attn, cfg.d_attn),
                           generator=rg, device=DEV) * 0.05
        q = serve["ids"][:1]
        scores = autoint.retrieval_scores(params, q, cand, proj, cfg)
        if scores.shape != (AUTOINT_CANDIDATES,) or not bool(
                torch.isfinite(scores).all()):
            raise AssertionError("autoint retrieval scores")
        rec["retrieval_ms"] = cuda_ms(
            lambda: autoint.retrieval_scores(params, q, cand, proj, cfg),
            AUTOINT_REPS)
        del cand, proj, scores
    np.save(work / "autoint_table.npy", params["table"].detach().cpu().numpy())
    np.save(work / "autoint_serve_ids.npy", serve["ids"].cpu().numpy())
    np.save(work / "autoint_serve_logits.npy", logits.cpu().numpy())
    with open(work / "autoint_params.pkl", "wb") as f:
        pickle.dump({k: tree_numpy(v) for k, v in params.items()
                     if k != "table"}, f)
    # training: one held step, then timed AdamW steps
    opt = AdamW(gnn.parameters(params), lr=EQ_LR)

    def step():
        for p in gnn.parameters(params):
            p.grad = None
        sc.reset_launches()
        loss = autoint.autoint_loss(params, train, cfg)
        loss.backward()
        return loss.detach()

    rec["held"] = hold_block("autoint train step 0", step)
    opt.step()
    torch.cuda.empty_cache()
    steps = []
    for i in range(EQ_TIMED_STEPS):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        opt.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(sc.LAUNCHES)
        steps.append({"step": i, "loss": float(loss), "ms": ms,
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated(),
                      "launches": launches})
        if launches != {"dense": 1, "tile": 0, "compact": 0} or \
                not math.isfinite(float(loss)):
            raise AssertionError(f"autoint train step {i}: {steps[-1]}")
    rec["train_steps"] = steps
    rec["train_ms"] = [s["ms"] for s in steps]
    log("autoint", json.dumps(rec))
    del params, opt, train, serve
    torch.cuda.empty_cache()
    log(f"autoint_phase_s={time.perf_counter() - t_phase:.3f}")
    return rec, len(steps)


SERVE_RANK_QUERIES = 16
SERVE_RANK_KINDS = ("bfs", "sssp")


def rank_serving_stream(stream):
    """The first SERVE_RANK_QUERIES queries of the serving stream whose
    kind is BFS or SSSP, in order."""
    return [x for x in stream
            if x[1] in SERVE_RANK_KINDS][:SERVE_RANK_QUERIES]


def serve_ranks_stream(name, ag, stream, comm, dev):
    """BFS x8 and SSSP x8 batchers (SERVE_STEPS_PER_TICK supersteps a tick,
    agent exchange) on the shards `comm` holds, driven through the stream
    by arrival rounds: `(per-query sha1 of the answer in submission order,
    serving record)`."""
    import hashlib
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.core.frontier import HOST_READS as FRONTIER_READS
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.serving import GraphQueryBatcher, ServingFrontend
    factories = {"bfs": algorithms.bfs_program,
                 "sssp": algorithms.sssp_program}
    t0 = time.perf_counter()
    fe = ServingFrontend({
        kind: GraphQueryBatcher(
            DistGREEngine(factories[kind](SERVE_LANES), ag.k,
                          exchange="agent", frontier=SERVE_FRONTIER[kind],
                          device=dev, comm=comm),
            ag, steps_per_tick=SERVE_STEPS_PER_TICK)
        for kind in SERVE_RANK_KINDS})
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    sc.reset_launches()
    FRONTIER_READS["frontier_counts"] = 0
    sc.HOST_READS["compact_total"] = 0
    queries, rounds, wall_s, _ = drive_stream(fe, stream)
    rec = serving_record(name, queries, rounds, wall_s,
                         list(fe.batchers.values()))
    rec.update({"k": ag.k, "setup_s": setup_s,
                "launches": dict(sc.LAUNCHES)})
    digests = []
    for q in queries:
        if q.status != "done":
            raise AssertionError(f"serving over shards: query {q.uid} "
                                 f"{q.status}")
        digests.append(hashlib.sha1(
            str(q.result.dtype).encode() + q.result.tobytes()).hexdigest())
    return digests, rec


def rank_models(comm, work: Path, stream):
    """A rank's part of this slice's rank phases, in the `dist_ranks`
    world: the DimeNet gradient pass over the ranks
    (`dimenet_sharded_pass` on `dimenet_sharded_phase`'s union and
    parameters), AutoInt's serve_p99 batch through
    `sharded_embedding_lookup` on the rank's 4,627,500 table rows (read
    from `autoint_phase`'s file), and the BFS x8 / SSSP x8 serving stream
    (`serve_ranks_stream`).  Returns their records; rank 0 also the
    DimeNet gradients."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.models import autoint, gnn
    from repro_torch.nn.embedding import sharded_embedding_lookup
    dev = comm.device
    out = {}
    with np.load(work / "dimenet_mol.npz") as z:
        mol = dict(z)
    with open(work / "dimenet_params.pkl", "rb") as f:
        params_np = pickle.load(f)
    # an untimed first pass (first-use costs), then the timed one, which
    # must repeat it bitwise
    loss1, _, rec1 = dimenet_sharded_pass(params_np, mol, comm, dev)
    loss, grads, rec = dimenet_sharded_pass(params_np, mol, comm, dev)
    rec.update({"loss": float(loss), "first_pass_ms": rec1["ms"],
                "first_pass_split_ms": {k: rec1[k] for k in (
                    "forward_ms", "backward_ms", "psum_ms")},
                "repeats_bitwise": bool(torch.equal(loss, loss1))})
    rec["digest"] = hashlib.sha1(b"".join(
        g.cpu().numpy().tobytes() for g in grads)).hexdigest()
    if comm.rank == 0:
        rec["grads"] = [g.cpu().numpy() for g in grads]
    out["dimenet"] = rec
    del grads
    torch.cuda.empty_cache()
    # AutoInt: the rank's rows of the table, the serve batch
    cfg = get_config("autoint")[0]
    table = np.load(work / "autoint_table.npy", mmap_mode="r")
    rows = table.shape[0] // comm.k
    mine = torch.from_numpy(np.array(
        table[comm.rank * rows:(comm.rank + 1) * rows])).to(dev)
    ids_np = np.load(work / "autoint_serve_ids.npy")
    ids = torch.from_numpy(ids_np).to(dev)
    with open(work / "autoint_params.pkl", "rb") as f:
        params = gnn.leaves_from_numpy(pickle.load(f), dev)
    params["table"] = None           # the lookup reads the rank's rows
    shard = mine.reshape(1, rows, -1)
    sc.reset_launches()
    with torch.no_grad():
        got = sharded_embedding_lookup(shard, ids, comm)
        want = np.asarray(table[ids_np.reshape(-1)]).reshape(
            tuple(ids_np.shape) + (cfg.embed_dim,))
        logits = autoint.autoint_logits(
            params, ids, cfg,
            lookup_fn=lambda _, i: sharded_embedding_lookup(shard, i, comm))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sharded_embedding_lookup(shard, ids, comm)
        torch.cuda.synchronize(dev)
        lookup_ms = (time.perf_counter() - t0) * 1e3
    ref = np.load(work / "autoint_serve_logits.npy")
    lg = logits.cpu().numpy()
    out["autoint"] = {
        "rows": rows, "lookup_bitwise": bool(np.array_equal(
            got.cpu().numpy(), want)),
        "logits_max_rel_err": float(np.max(np.abs(lg - ref))
                                    / np.max(np.abs(ref))),
        "logits_bitwise": bool(np.array_equal(lg, ref)),
        "lookup_ms": lookup_ms}
    del mine, shard, got, logits, table
    torch.cuda.empty_cache()
    # serving: BFS x8 and SSSP x8 over the directed agent graph
    ag = load_agent_graph(work / "directed")
    digests, rec = serve_ranks_stream("ranks", ag, stream, comm, dev)
    rec["digests"] = digests
    out["serving"] = rec
    return out


RANK_AUTOINT_RTOL = 1e-5   # logits over ranks against the card's own


def check_rank_models(models, stacked):
    """Hold `rank_models`' records of every rank against the stacked
    passes: DimeNet's loss within GNN_LOSS_RTOL and gradients within
    GNN_GRAD_TOL of each leaf's largest (the GCN pass's bounds; the
    measured errors printed), every rank's loss and gradients the same;
    AutoInt's lookup bitwise the whole table's on every rank, the logits
    within RANK_AUTOINT_RTOL; every served answer's digest equal to the
    stacked batcher's.  Returns the ranks' K1 launches of these passes."""
    launches = {"dense": 0, "tile": 0, "compact": 0}
    d = [m["dimenet"] for m in models]
    loss0, grads0, srec = stacked["dimenet"]
    loss_err = abs(d[0]["loss"] - float(loss0)) / abs(float(loss0))
    errs = leaf_errors([torch.from_numpy(g) for g in d[0]["grads"]],
                       [g.double().cpu() for g in grads0])
    same = len({(r["loss"], r["digest"]) for r in d}) == 1
    log("dist_rank_dimenet", json.dumps({
        "ranks": len(d), "loss": d[0]["loss"], "stacked_loss": float(loss0),
        "loss_rel_err": loss_err, "loss_bitwise": d[0]["loss"] ==
        float(loss0), "grad_max_err": max(errs), "ranks_agree": same,
        "ms_rank0": d[0]["ms"], "stacked_ms": srec["ms"],
        "split_ms_rank0": {k: d[0][k] for k in ("forward_ms", "backward_ms",
                                                "psum_ms")},
        "first_pass_ms_rank0": d[0]["first_pass_ms"],
        "first_pass_split_ms_rank0": d[0]["first_pass_split_ms"],
        "repeats_bitwise": [r["repeats_bitwise"] for r in d],
        "layout_s": [r["layout_s"] for r in d],
        "launches_forward": [r["launches_forward"] for r in d],
        "launches_backward": [r["launches_backward"] for r in d],
        "values": sum(r["values"] for r in d),
        "stacked_values": srec["values"],
        "max_memory_allocated": [r["max_memory_allocated"] for r in d]}))
    if (loss_err > GNN_LOSS_RTOL or max(errs) > GNN_GRAD_TOL or not same
            or min(r["launches_backward"] for r in d) <= 0
            or not all(r["repeats_bitwise"] for r in d)):
        raise AssertionError(f"ranks DimeNet against the stacked pass: "
                             f"loss {loss_err}, per leaf {errs}, agree "
                             f"{same}")
    launches["dense"] += sum(r["launches_forward"] + r["launches_backward"]
                             for r in d)
    a = [m["autoint"] for m in models]
    log("dist_rank_autoint", json.dumps({
        "ranks": len(a), "rows_a_rank": a[0]["rows"],
        "lookup_bitwise": [r["lookup_bitwise"] for r in a],
        "logits_max_rel_err": max(r["logits_max_rel_err"] for r in a),
        "logits_bitwise": [r["logits_bitwise"] for r in a],
        "lookup_ms": [r["lookup_ms"] for r in a]}))
    if not all(r["lookup_bitwise"] for r in a) or max(
            r["logits_max_rel_err"] for r in a) > RANK_AUTOINT_RTOL:
        raise AssertionError(f"ranks AutoInt: {a}")
    digests, srec = stacked["serving"]
    sv = [m["serving"] for m in models]
    bad = [r for r, v in enumerate(sv) if v["digests"] != digests]
    rec = {k: v for k, v in sv[0].items() if k != "digests"}
    rec.update({"ranks": len(sv), "held_bitwise": len(digests),
                "ranks_differing": bad,
                "stacked": {k: srec[k] for k in (
                    "wall_s", "queries_per_s", "latency_p50_ms",
                    "latency_p99_ms", "ticks", "host_reads_per_tick")}})
    log("graph_serving_ranks", json.dumps(rec))
    if bad or len(digests) != SERVE_RANK_QUERIES:
        raise AssertionError(f"ranks serving: ranks {bad} differ from the "
                             f"stacked batcher's answers")
    for v in sv:
        for route in launches:
            launches[route] += v["launches"][route]
    return launches


# ------------------------------------------------------- attention phase
def attention_error_ratio(got, want) -> float:
    """Worst |got - want| over its limit (step 4 of the docstring); above
    1 fails."""
    w = want.float()
    if want.dtype == torch.float32:
        limit = F32_ATTN_TOL * (1.0 + w.abs())
    else:
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        limit = BF16_RTOL * w.abs() + BF16_ROW_ATOL * rms
    return float(((got.float() - w).abs() / limit.clamp(min=1e-30)).max())


def masked_plain(q, k, v, mask):
    """`flash_attention_plain` under an explicit [Sq, Sk] mask."""
    from repro_torch.kernels.flash_attention import NEG_INF
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = torch.where(mask, s * (1.0 / math.sqrt(q.shape[-1])), NEG_INF)
    return torch.einsum("bkgqs,bskh->bqkgh",
                        torch.softmax(s, dim=-1).to(q.dtype), v)


def planted_fault_ratios(q, k, v, plain):
    """Error ratios of two causal-kernel faults planted in the plain
    version's last query tile, where a row averages the most keys and its
    outputs are smallest."""
    sq = q.shape[1]
    pos = torch.arange(sq, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    if not torch.equal(masked_plain(q, k, v, causal), plain):
        raise AssertionError("masked_plain differs from the plain version")
    last = pos[:, None] >= sq - 64
    kv_tile = (pos[None, :] >= 64) & (pos[None, :] < 128)
    faults = {"skip_kv_tile": causal & ~(last & kv_tile),
              "mask_leak": causal | (last & (pos[None, :] == pos[:, None] + 1))}
    return {name: attention_error_ratio(masked_plain(q, k, v, mask), plain)
            for name, mask in faults.items()}


ATTN_CASES = (  # name, B, Sq, Sk, Kv, G, H, causal, dtype
    ("smollm_prefill", 4, 2048, 2048, 3, 3, 64, True, torch.bfloat16),
    ("ragged_causal", 1, 1000, 1000, 3, 3, 64, True, torch.bfloat16),
    ("f32", 2, 512, 512, 2, 2, 64, True, torch.float32),
    ("noncausal_sq_ne_sk", 1, 64, 192, 2, 2, 32, False, torch.float32),
    ("h128", 2, 1024, 1024, 2, 4, 128, True, torch.bfloat16),
    ("bf16_noncausal_sq_ne_sk", 2, 300, 1000, 2, 3, 64, False,
     torch.bfloat16),
    ("h16", 2, 512, 512, 2, 2, 16, True, torch.bfloat16),
    ("h32", 2, 512, 512, 2, 2, 32, True, torch.bfloat16),
    ("g1", 2, 1024, 1024, 4, 1, 64, True, torch.bfloat16),
    ("g8", 1, 1024, 1024, 2, 8, 64, True, torch.bfloat16),
    ("ragged_b2", 2, 1000, 1000, 3, 3, 64, True, torch.bfloat16),
)


def attention_inputs(b, sq, sk, kv, g, h, dt):
    """q, k, v of an attention case, from a CUDA generator seeded by its
    shape."""
    gen = torch.Generator("cuda").manual_seed(sq + sk + h)
    q = torch.randn((b, sq, kv, g, h), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, sk, kv, h), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, sk, kv, h), generator=gen, device="cuda").to(dt)
    return q, k, v


def attention_kernel_phase(reps, cases=ATTN_CASES):
    """The attention kernel against its plain version at every case of
    `cases`; returns the case records."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    records = []
    for name, b, sq, sk, kv, g, h, causal, dt in cases:
        q, k, v = attention_inputs(b, sq, sk, kv, g, h, dt)
        first = fa.flash_attention_cuda(q, k, v, causal)
        second = fa.flash_attention_cuda(q, k, v, causal)
        plain = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"attention {name}: two launches differ")
        if not torch.isfinite(first).all():
            raise AssertionError(f"attention {name}: non-finite output")
        err = (first.float() - plain.float()).abs()
        ratio = attention_error_ratio(first, plain)
        if ratio > 1.0:
            raise AssertionError(f"attention {name}: error {ratio} x its "
                                 "limit")
        faults = {}
        if name == "smollm_prefill":
            faults = planted_fault_ratios(q, k, v, plain)
            if min(faults.values()) <= 1.0:
                raise AssertionError(f"attention {name}: a planted fault "
                                     f"passes the check {faults}")
        # the library call's own layout: [B, heads, S, H]
        lq = q.reshape(b, sq, kv * g, h).transpose(1, 2).contiguous()
        lk = k.transpose(1, 2).contiguous()
        lv = v.transpose(1, 2).contiguous()
        lib = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                             enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).reshape(first.shape).float()
                         - plain.float()).abs().max())
        launches_before = fa.LAUNCHES
        kernel_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal),
                            reps)
        bound, bound_by = attention_bound(b, sq, sk, kv, g, h, causal, dt)
        rec = {
            "case": name, "B": b, "Sq": sq, "Sk": sk, "Kv": kv, "G": g,
            "H": h, "causal": causal, "dtype": str(dt).split(".")[-1],
            "max_abs_err": float(err.max()), "err_ratio": ratio,
            "fault_ratios": faults,
            "library_max_abs_err": lib_err,
            "kernel_ms": kernel_ms,
            "launches": fa.LAUNCHES - launches_before,
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal), reps),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, enable_gqa=True), reps),
            "bound_ms": bound, "bound_by": bound_by,
        }
        log("attention_case", json.dumps(rec))
        records.append(rec)
        del q, k, v, first, second, plain, err, lq, lk, lv, lib
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------ attention backward phase
ATTN_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
ATTN_BWD_REPLACES = "src/repro/nn/attention.py:90"
BWD_F32_RTOL = 1e-4          # of |ref|: f32 sums in another order
BWD_BF16_RTOL = 2.0 ** -7    # one bf16 ulp: both round the same f32 sum
BWD_ATOL = 1e-4              # of the row's plus the tensor's RMS
BWD_BF16_FLIPS = 2.0 ** -6   # of the rounded terms' l2 norm (bf16)
LSE_TOL = 1e-4           # of 1 + |lse|: the forward's row statistic
_BWD_SMALL = (  # name, B, Sq, Sk, Kv, G, H, causal: each in f32 and bf16
    ("causal_g3_h64", 2, 256, 256, 2, 3, 64, True),
    ("noncausal_sq_lt_sk", 2, 100, 300, 2, 3, 32, False),
    ("causal_sq_gt_sk", 2, 300, 100, 2, 1, 32, True),
    ("ragged_1000", 2, 1000, 1000, 1, 3, 64, True),
    ("g8_h128", 2, 200, 200, 1, 8, 128, True),
    ("g1_h16", 2, 130, 130, 3, 1, 16, True),
)
ATTN_BWD_CASES = (  # the training shapes first
    ("smollm_train", 4, 4096, 4096, 3, 3, 64, True, torch.bfloat16),
    ("granite_train", 2, 4096, 4096, 8, 2, 64, True, torch.bfloat16),
    ("qwen3_train", 1, 2048, 2048, 4, 8, 128, True, torch.bfloat16),
) + tuple(c + (dt,) for dt in (torch.float32, torch.bfloat16)
          for c in _BWD_SMALL)


def bwd_error_ratio(got, want, terms=None) -> float:
    """Worst |got - want| over its limit; above 1 fails.  The relative
    part: 1e-4 of |want| in float32 (the sums run in another order), one
    bf16 ulp in bf16 (kernel and plain both round a float32 sum of the
    same terms).  The absolute part, 1e-4 of the row's RMS plus the whole
    tensor's: dS = p·(dO·vᵀ − δ) cancels to rounding noise where a row's
    probabilities are one-hot (query row 0 sees key 0 alone), and there a
    row's exact value is 0 and the noise depends on the sum order.  In
    bf16, `terms` (the l2 norm of the terms each output sums, from
    `masked_bwd_plain`) adds BWD_BF16_FLIPS of it: p and dS are rounded to
    bf16 before their products, as JAX rounds them (`_flash_bwd_rule`'s
    `astype(q.dtype)`), from float32 values that kernel and plain compute
    in another order, so a share of those roundings (0.1-0.4% measured in
    a CPU emulation of the kernel's arithmetic) go the other way, each
    moving one term by at most 2^-8 of it; up to 16 such flips of one sum,
    signs aligned, stay within 2^-6 of the terms' l2 norm."""
    w = want.float()
    rms = (w.pow(2).mean(-1, keepdim=True).sqrt()
           + w.pow(2).mean().sqrt())
    rtol = BWD_F32_RTOL if want.dtype == torch.float32 else BWD_BF16_RTOL
    limit = rtol * w.abs() + BWD_ATOL * rms
    if terms is not None and want.dtype != torch.float32:
        limit = limit + BWD_BF16_FLIPS * terms
    return float(((got.float() - w).abs() / limit.clamp(min=1e-30)).max())


def masked_bwd_plain(q, k, v, o, lse, dout, mask, keep_delta=None,
                     norms=False):
    """`flash_attention_bwd_plain` under an explicit [Sq, Sk] mask, with δ
    times `keep_delta` [Sq] where given; with `norms`, also the l2 norm of
    the (rounded) terms that each of dQ, dK and dV sums, in float32."""
    from repro_torch.kernels.flash_attention import NEG_INF
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, dof = q.float(), k.float(), dout.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    del s
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, v.float())
    delta = torch.einsum("bqkgh,bqkgh->bkgq", dof, o.float())
    if keep_delta is not None:
        delta = delta * keep_delta
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    del dp
    p = p.to(q.dtype).float()
    out = (torch.einsum("bkgqs,bskh->bqkgh", ds, kf).to(q.dtype),
           torch.einsum("bkgqs,bqkgh->bskh", ds, qf).to(k.dtype),
           torch.einsum("bkgqs,bqkgh->bskh", p, dof).to(v.dtype))
    if not norms:
        return out
    ds, p = ds.square_(), p.square_()
    return out, (
        torch.einsum("bkgqs,bskh->bqkgh", ds, kf.square()).sqrt_(),
        torch.einsum("bkgqs,bqkgh->bskh", ds, qf.square()).sqrt_(),
        torch.einsum("bkgqs,bqkgh->bskh", p, dof.square()).sqrt_())


def bwd_planted_fault_ratios(q, k, v, o, lse, dout, want, terms):
    """Error ratios (the worst of dQ, dK, dV) of three causal-kernel
    faults planted in the plain backward: one kv tile skipped for the last
    query tile, key i + 1 leaking into row i there, and δ dropped for that
    tile.  Modelled on the forward's `planted_fault_ratios`."""
    sq = q.shape[1]
    pos = torch.arange(sq, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    got = masked_bwd_plain(q, k, v, o, lse, dout, causal)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("masked_bwd_plain differs from the plain "
                             "backward")
    last = pos[:, None] >= sq - 64
    kv_tile = (pos[None, :] >= 64) & (pos[None, :] < 128)
    faults = {
        "skip_kv_tile": (causal & ~(last & kv_tile), None),
        "mask_leak": (causal | (last & (pos[None, :] == pos[:, None] + 1)),
                      None),
        "drop_delta": (causal, (pos < sq - 64).float())}
    ratios = {}
    for name, (mask, keep) in faults.items():
        planted = masked_bwd_plain(q, k, v, o, lse, dout, mask, keep)
        ratios[name] = max(bwd_error_ratio(a, w, t)
                           for a, w, t in zip(planted, want, terms))
        del planted
    return ratios


def hold_attention_backward(name, q, k, v, o, lse, dout, causal,
                            faults=False):
    """The backward kernel against the plain version on one call's
    inputs, and two launches bitwise equal; returns its record.  With
    `faults` (causal, Sq = Sk), also the planted faults' ratios, each of
    which must exceed the limit."""
    from repro_torch.kernels import flash_attention as fa
    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal)
    terms = (None, None, None)
    if q.dtype != torch.float32:
        sq, sk = q.shape[1], k.shape[1]
        mask = fa._visible(sq, sk, causal, q.device)
        _, terms = masked_bwd_plain(q, k, v, o, lse, dout, mask, norms=True)
    torch.cuda.synchronize()
    rec = {"max_abs_err": 0.0, "err_ratio": 0.0}
    for label, a, b2, want, t in zip(("dq", "dk", "dv"), first, second,
                                     plain, terms):
        if not torch.equal(a, b2):
            raise AssertionError(f"attention backward {name}: two launches "
                                 f"differ in {label}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"attention backward {name}: non-finite "
                                 f"{label}")
        ratio = bwd_error_ratio(a, want, t)
        if ratio > 1.0:
            raise AssertionError(f"attention backward {name}: {label} error "
                                 f"{ratio} x its limit")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(
            (a.float() - want.float()).abs().max()))
        rec["err_ratio"] = max(rec["err_ratio"], ratio)
    if faults:
        rec["fault_ratios"] = bwd_planted_fault_ratios(
            q, k, v, o, lse, dout, plain, terms)
        if min(rec["fault_ratios"].values()) <= 1.0:
            raise AssertionError(f"attention backward {name}: a planted "
                                 f"fault passes the check "
                                 f"{rec['fault_ratios']}")
    return rec


def attention_backward_phase(reps, cases=ATTN_BWD_CASES, profile=False):
    """The backward kernel against its plain version at every case of
    `cases` (the forward kernel's `lse` against the plain one first);
    returns the case records.  Times are CUDA-event medians;
    `library_ms` is SDPA's backward through `autograd.grad` at every case,
    and with `profile` the profiler's device times of the kernel and of
    that call are added at the LM training shapes (a fresh process: late in the
    smoke run the profiler has recorded no device time)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    records = []
    for name, b, sq, sk, kv, g, h, causal, dt in cases:
        q, k, v = attention_inputs(b, sq, sk, kv, g, h, dt)
        gen = torch.Generator("cuda").manual_seed(sq * 7 + h)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        o_serve = fa.flash_attention_cuda(q, k, v, causal)
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal,
                                                return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(o, o_serve):
            raise AssertionError(f"attention backward {name}: the forward's "
                                 "output changes with return_lse")
        lse_ratio = float(((lse - lse_plain).abs()
                           / (LSE_TOL * (1 + lse_plain.abs()))).max())
        if not lse_ratio <= 1.0:
            raise AssertionError(f"attention backward {name}: lse error "
                                 f"{lse_ratio} x its limit")
        rec = {"case": name, "B": b, "Sq": sq, "Sk": sk, "Kv": kv, "G": g,
               "H": h, "causal": causal, "dtype": str(dt).split(".")[-1],
               "lse_err_ratio": lse_ratio}
        rec.update(hold_attention_backward(name, q, k, v, o, lse, dout,
                                           causal,
                                           faults=name == "smollm_train"))

        def kernel():
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal)

        launches_before = fa.LAUNCHES_BWD
        rec["kernel_ms"] = cuda_ms(kernel, reps)
        rec["launches"] = fa.LAUNCHES_BWD - launches_before
        rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(
            b, sq, sk, kv, g, h, causal, dt)
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, dout, causal), max(1, reps // 5))
        # the yardstick at every case: SDPA's backward in its own layout
        # (its causal mask is top-left aligned, as K3's: query i sees keys
        # 0..i when Sq != Sk)
        lq = q.reshape(b, sq, kv * g, h).transpose(1, 2).contiguous()
        lk = k.transpose(1, 2).contiguous()
        lv = v.transpose(1, 2).contiguous()
        lq, lk, lv = (t.requires_grad_(True) for t in (lq, lk, lv))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                            enable_gqa=True)
        ldo = dout.reshape(b, sq, kv * g, h).transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                       retain_graph=True)

        rec["library_ms"] = cuda_ms(library, reps)
        if profile and name.endswith("_train"):
            rec["device_ms"], rec["device_by_kernel"] = device_ms(
                kernel, reps)
            rec["library_device_ms"], _ = device_ms(library, reps)
        del lq, lk, lv, lo, ldo
        log("attention_backward_case", json.dumps(rec))
        records.append(rec)
        del q, k, v, o, lse, dout
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------ LM serving phase
def serve_flow(params, cfg, batch, prompt_len, gen):
    """The `launch/serve.py` flow at full width; returns its record and
    the prompts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import greedy_generate
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (batch,
                                                           prompt_len)))
    prompts = prompts.cuda()
    before = fa.LAUNCHES
    tokens, times = greedy_generate(params, cfg, prompts, gen)
    launches = fa.LAUNCHES - before
    if launches != cfg.n_layers:
        raise AssertionError(f"serve flow: {launches} attention launches, "
                             f"want {cfg.n_layers} (one prefill)")
    steps = gen - 1
    rec = {"B": batch, "prompt_len": prompt_len, "decode_steps": steps,
           "prefill_ms": times["prefill_s"] * 1e3,
           "decode_ms_per_step": times["decode_s"] * 1e3 / steps,
           "prefill_tokens_per_s": batch * prompt_len / times["prefill_s"],
           "decode_tokens_per_s": batch * steps / times["decode_s"],
           "tokens_per_s": batch * gen / (times["prefill_s"]
                                          + times["decode_s"]),
           "attention_launches": launches}
    log("serve_flow", json.dumps(rec))
    if tokens.shape != (batch, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve flow: bad tokens {tokens.shape}")
    return rec, prompts


def batcher_run(params, cfg, n_requests, slots, max_len, lo, hi, max_new):
    """`ContinuousBatcher` serving `n_requests` prompts of uniform length in
    [lo, hi]; time to first token is read after each `step()`, so it
    includes that step's decode."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import ContinuousBatcher, Request
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n_requests)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new=max_new) for i, n in enumerate(lens)]
    sched = ContinuousBatcher(params, cfg, batch_slots=slots,
                              max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fa.LAUNCHES
    ttft = {}
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    steps = 0
    while True:
        active = sched.step()
        steps += 1
        now = time.perf_counter()
        for r in reqs:
            if r.out and r.uid not in ttft:
                ttft[r.uid] = now - t0
        if active == 0 and not sched.queue:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES - before
    if launches != cfg.n_layers * n_requests:
        raise AssertionError(f"batcher: {launches} attention launches, want "
                             f"{cfg.n_layers} x {n_requests} prefills")
    if not all(r.done and len(r.out) == max_new for r in reqs):
        raise AssertionError("batcher: a request did not finish")
    generated = sum(len(r.out) for r in reqs)
    rec = {"requests": n_requests, "slots": slots, "max_len": max_len,
           "prompt_tokens": int(lens.sum()), "generated": generated,
           "steps": steps, "wall_ms": wall * 1e3,
           "generated_tokens_per_s": generated / wall,
           "mean_ttft_ms": 1e3 * float(np.mean(list(ttft.values()))),
           "max_ttft_ms": 1e3 * max(ttft.values()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "attention_launches": launches}
    log("batcher", json.dumps(rec))
    return rec


def check_logits(params, cfg, prompts, label="logit_check"):
    """Prefill's last-position logits against `lm_forward`'s on the same
    tokens, bitwise (a plumbing check: the same kernels at the same
    shapes), and one decode step's logits against `lm_forward` at that
    position (bf16, LOGIT_RTOL of the largest reference logit), over the
    vocab's columns (a padded vocab's extra columns are masked)."""
    from repro_torch.models import transformer as tfm
    out = {}
    with torch.no_grad():
        logits, cache = tfm.prefill(params, prompts, cfg,
                                    max_len=prompts.shape[1] + 1)
        full = tfm.lm_forward(params, prompts, cfg)[0][:, -1]
        out["prefill"] = (logits, full)
        tok = torch.argmax(logits, -1).to(torch.int32)
        step, _ = tfm.decode_step(params, cache, tok, cfg)
        longer = torch.cat([prompts, tok[:, None].to(prompts.dtype)], 1)
        out["decode"] = (step, tfm.lm_forward(params, longer, cfg)[0][:, -1])
    rec = {}
    for name, (got, want) in out.items():
        # the vocab's own columns: the padding ones hold the float32 minimum
        got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        rec[name] = {"max_abs_err": err, "max_abs_ref": scale,
                     "argmax_agree": agree}
        limit = 0.0 if name == "prefill" else LOGIT_RTOL * scale
        if not (torch.isfinite(got).all() and err <= limit):
            raise AssertionError(f"{name} logits vs lm_forward: {err} > "
                                 f"{limit}")
    log(label, json.dumps(rec))
    return rec


def check_f32_batcher(cfg):
    """Full width in float32, TF32 off: three short requests through the
    batcher give exactly the tokens of offline greedy generation through
    `lm_forward` (the invariant of tests/test_serving.py)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ContinuousBatcher, Request
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tfm.init_lm(cfg32, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 7)]
    sched = ContinuousBatcher(params, cfg32, batch_slots=2, max_len=32)
    reqs = [Request(uid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    for r, p in zip(reqs, prompts):
        toks = p.tolist()
        with torch.no_grad():
            for _ in range(6):
                logits, _ = tfm.lm_forward(params, torch.tensor(
                    [toks], device="cuda"), cfg32)
                toks.append(int(torch.argmax(logits[0, -1])))
        if r.out != toks[len(p):]:
            raise AssertionError(f"f32 batcher request {r.uid}: {r.out} != "
                                 f"offline {toks[len(p):]}")
    log(f"f32_batcher: {len(reqs)} requests equal to offline greedy "
        "generation")
    del params, sched
    torch.cuda.empty_cache()


def lm_serving_phase():
    """Full-width smollm-135m through the serve flow and the batcher; the
    attention kernel's count is set to 0 just before and read just after,
    and returned."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as tfm
    cfg, _ = get_config("smollm-135m")
    params = tfm.init_lm(cfg, generator=torch.Generator("cuda").manual_seed(0))
    # warm-up at the serve flow's shape, outside the counted run: allocator
    # blocks and cuBLAS choices, so the timed prefill is the steady state
    greedy_generate(params, cfg, torch.zeros((4, 2048), dtype=torch.int64,
                                             device="cuda"), 3)
    t0 = time.perf_counter()
    fa.reset_launches()
    _, prompts = serve_flow(params, cfg, batch=4, prompt_len=2048, gen=33)
    batcher_run(params, cfg, n_requests=16, slots=8, max_len=2112, lo=128,
                hi=2048, max_new=32)
    launches = fa.LAUNCHES
    log(f"lm_path_s={time.perf_counter() - t0:.3f} "
        f"attention_launches={launches}")
    if launches != cfg.n_layers * (1 + 16):
        raise AssertionError(f"LM path: {launches} attention launches")
    check_logits(params, cfg, prompts)
    del params
    torch.cuda.empty_cache()
    check_f32_batcher(cfg)
    return launches


# ------------------------------------------------------ MoE serving phase
QWEN3_LAYERS = 4          # of 48: 4 layers' bf16 weights are 6.2 GB


@contextlib.contextmanager
def counted_steps(counts):
    """Count `prefill` and `decode_step` calls into `counts` while the
    block runs (the launchers and the batcher call them through the
    module)."""
    from repro_torch.models import transformer as tfm
    originals = {name: getattr(tfm, name) for name in ("prefill",
                                                       "decode_step")}

    def wrap(name):
        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return originals[name](*args, **kw)
        return call

    try:
        for name in originals:
            setattr(tfm, name, wrap(name))
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(tfm, name, fn)


def no_drop(cfg):
    """`cfg` with a capacity factor that keeps every hit (cap = T): the
    MoE output of a token then depends on no other token, so decode and a
    full forward see the same sums."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def check_moe_launches(name, cfg, counts, k3, k1):
    """K3 once a layer a prefill; K1 (the MoE combine) once a layer a
    prefill or decode step."""
    calls = counts.get("prefill", 0) + counts.get("decode_step", 0)
    want = {"k3": cfg.n_layers * counts.get("prefill", 0),
            "k1": cfg.n_layers * calls}
    got = {"k3": k3, "k1": k1}
    log(f"{name}_launches", json.dumps({"got": got, "want": want,
                                         "calls": counts}))
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")


def hold_moe_layer(params, cfg, tokens, seed=0):
    """Layer 0's `moe_ffn` at ample capacity against `moe_ffn_reference`
    (the `[T, E, D]` oracle), and the expert-sharded form on
    `StackedComm(4)` against the local call at the config's capacity,
    on one batch of normed random tokens; bf16, held with
    `attention_error_ratio`'s limit (two bf16 ulps plus 3% of the row's
    RMS: the two paths round the expert products and, sharded, the four
    partials to bf16 at different points)."""
    from repro_torch.dist.comm import StackedComm
    from repro_torch.nn.layers import rmsnorm
    from repro_torch.nn.moe import moe_ffn, moe_ffn_reference
    m = cfg.moe
    layer = dict(params.layers[0].moe)
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device="cuda")
    rec = {}
    with torch.no_grad():
        x = rmsnorm(x.to(cfg.param_dtype), params.layers[0].ln_ffn)
        ample, _ = moe_ffn(layer, x, m.top_k, m.n_experts,
                           capacity_factor=float(m.n_experts))
        ref = moe_ffn_reference(layer, x, m.top_k, m.n_experts)
        rec["oracle_err_ratio"] = attention_error_ratio(ample, ref)
        del ref
        local, aux = moe_ffn(layer, x, m.top_k, m.n_experts,
                             m.capacity_factor)
        e_loc = m.n_experts // 4
        shards = [{k: (w if k == "router" else w[i * e_loc:(i + 1) * e_loc])
                   for k, w in layer.items()} for i in range(4)]
        sharded, aux4 = moe_ffn(shards, x, m.top_k, m.n_experts,
                                m.capacity_factor, comm=StackedComm(4))
        rec["sharded_err_ratio"] = attention_error_ratio(sharded, local)
        rec["aux_equal"] = bool(torch.equal(aux, aux4))
    rec["finite"] = bool(torch.isfinite(ample).all()
                         and torch.isfinite(sharded).all())
    log("moe_hold", json.dumps({"tokens": tokens, **rec}))
    if not (rec["finite"] and rec["aux_equal"]
            and max(rec["oracle_err_ratio"], rec["sharded_err_ratio"])
            <= 1.0):
        raise AssertionError(f"MoE layer hold failed: {rec}")
    return rec


def moe_model_run(cfg, batch, prompt_len, gen, batcher=None):
    """One MoE config through the serve flow (and the batcher), its
    logits held, its launches counted; returns the record."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as tfm
    params = tfm.init_lm(cfg, generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    # the warm-up, a prefill and two decode steps at the serve flow's
    # shapes, with every K1 call held on its own inputs
    warm = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, prompt_len))).cuda()
    held = hold_block(f"{cfg.name} serve warm-up",
                      lambda: greedy_generate(params, cfg, warm, 3))
    if sum(held.values()) != 3 * cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {held} K1 calls held, want "
                             f"{3 * cfg.n_layers}")
    del warm
    t0 = time.perf_counter()
    fa.reset_launches()
    sc.reset_launches()
    with counted_steps({}) as counts:
        flow, prompts = serve_flow(params, cfg, batch, prompt_len, gen)
        if batcher is not None:
            batcher_run(params, cfg, **batcher)
    torch.cuda.synchronize()
    check_moe_launches(cfg.name, cfg, counts, fa.LAUNCHES,
                       sc.LAUNCHES["dense"])
    rec = {"name": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "path_s": time.perf_counter() - t0,
           "k3_launches": fa.LAUNCHES, "k1_launches": sc.LAUNCHES["dense"],
           "held": held}
    rec["logits"] = check_logits(params, no_drop(cfg), prompts,
                                 label=f"logit_check_{cfg.name}")
    rec["hold"] = hold_moe_layer(params, cfg, batch * prompt_len)
    log("moe_model", json.dumps(rec))
    rec["flow"] = flow
    del params
    torch.cuda.empty_cache()
    return rec


def moe_serving_phase():
    """granite-moe-1b-a400m at full width and depth through the serve
    flow and the batcher, and qwen3-moe-30b-a3b at full width, 4 of its
    48 layers, through the serve flow; returns (records, K3 launches, K1
    launches) of the counted runs."""
    from repro_torch.configs import get_config
    granite, _ = get_config("granite-moe-1b-a400m")
    qwen3, _ = get_config("qwen3-moe-30b-a3b")
    qwen3 = dataclasses.replace(qwen3, n_layers=QWEN3_LAYERS)
    recs = [moe_model_run(granite, 4, 2048, 33, batcher=dict(
                n_requests=16, slots=8, max_len=2112, lo=128, hi=2048,
                max_new=32)),
            moe_model_run(qwen3, 1, 2048, 9)]
    return (recs, sum(r["k3_launches"] for r in recs),
            sum(r["k1_launches"] for r in recs))


# ------------------------------------------------------ LM training phase
TRAIN_SEQ = 4096          # LM_SHAPES train_4k
GRANITE_ARGV = ["--arch", "granite-moe-1b-a400m", "--full-size", "--seq",
                str(TRAIN_SEQ), "--batch", "2", "--steps", "4", "--seed", "0"]
# the mesh run's final parameters (`launch.train.main`'s `final_params`),
# under the phase's work directory
MESH_FINAL = "granite_mesh_final.pt"


def half_batch(argv):
    """`argv` with its `--batch` halved."""
    i = argv.index("--batch") + 1
    return argv[:i] + [str(int(argv[i]) // 2)] + argv[i + 1:]


@contextlib.contextmanager
def recorded_backward(store):
    """The first `flash_attention_bwd_cuda` call of the block: its inputs
    kept in `store` (the call itself runs unchanged)."""
    from repro_torch.kernels import flash_attention as fa
    original = fa.flash_attention_bwd_cuda

    def call(*args):
        if not store:
            store["args"] = [a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args]
        return original(*args)

    fa.flash_attention_bwd_cuda = call
    try:
        yield store
    finally:
        fa.flash_attention_bwd_cuda = original


def k1_per_step(cfg) -> int:
    """K1 launches of a training step: the embedding gradient (the
    backward of `gather_rows`), and for an MoE layer its combine forward
    and its dispatch gather's backward.  The checkpointed recompute stops
    once the layer's saved tensors are back (torch's non-reentrant early
    stop), before the combine, which saves none."""
    return 1 + (2 * cfg.n_layers if cfg.moe is not None else 0)


@contextlib.contextmanager
def recorded_params(store):
    """The parameters that `launch.train.main` draws in the block (its
    `transformer.init_lm` result, which the run updates in place), kept in
    `store["params"]`."""
    from repro_torch.models import transformer as tfm
    original = tfm.init_lm

    def init(*args, **kwargs):
        store["params"] = original(*args, **kwargs)
        return store["params"]

    tfm.init_lm = init
    try:
        yield store
    finally:
        tfm.init_lm = original


def train_run(arch, argv, hold=None, keep=None):
    """`launch.train.main` on `argv`; returns its record: each step's
    loss and wall seconds, its K3 forward and backward launches (held at
    2·L and L a step: every layer checkpointed) and its K1 launches (held
    at `k1_per_step`), the peak memory and the final loss (None when the
    run exits).  With `hold`, every K1 call of the first step is held on
    its own inputs (`held_combines`; the first step is untimed, and the
    holds' launches are not counted).  `keep`, a dict, gets the final
    parameters (name → tensor on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_combine as sc
    from repro_torch.launch import train
    cfg = get_config(arch)[0]
    want = (2 * cfg.n_layers, cfg.n_layers, k1_per_step(cfg))
    steps = []
    last = {"fwd": 0, "bwd": 0, "k1": 0}

    def on_step(step, loss, seconds):
        got = (fa.LAUNCHES - last["fwd"], fa.LAUNCHES_BWD - last["bwd"],
               sc.LAUNCHES["dense"] - last["k1"])
        last.update(fwd=fa.LAUNCHES, bwd=fa.LAUNCHES_BWD,
                    k1=sc.LAUNCHES["dense"])
        steps.append({"step": step, "loss": loss, "s": seconds,
                      "k3_fwd": got[0], "k3_bwd": got[1], "k1": got[2]})
        if got != want:
            raise AssertionError(f"{arch} step {step}: K3 forward, K3 "
                                 f"backward, K1 launches {got}, want "
                                 f"{want}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    sc.reset_launches()
    code, final = 0, None
    t0 = time.perf_counter()
    drawn = {}
    with held_combines(hold or "", active=lambda: hold and not steps,
                       uncounted=True) as held, recorded_params(drawn):
        try:
            final = train.main(argv, on_step=on_step)
        except SystemExit as exc:
            code = exc.code
    if keep is not None:
        keep.update((n, p.detach()) for n, p in
                    drawn["params"].named_parameters())
    del drawn
    rec = {"arch": arch, "argv": argv, "exit": code, "steps": steps,
           "final_loss": final, "wall_s": time.perf_counter() - t0,
           "k1_launches": sc.LAUNCHES["dense"], "held": held,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if len(steps) > 1:                      # the first step untimed
        rec["ms_per_step"] = 1e3 * float(np.mean([st["s"]
                                                  for st in steps[1:]]))
    log("train_run", json.dumps(rec))
    if not all(math.isfinite(st["loss"]) for st in steps):
        raise AssertionError(f"{arch}: a non-finite loss {steps}")
    if hold and sum(held.values()) != want[2]:
        raise AssertionError(f"{arch}: {held} K1 calls held in step 0, "
                             f"want {want[2]}")
    return rec


def first_difference(dir_a: Path, dir_b: Path, step: int):
    """The first array (by name) that differs between two training
    snapshots, with its largest difference; None when all are equal."""
    with np.load(dir_a / f"step-{step}" / "state.npz") as a, \
            np.load(dir_b / f"step-{step}" / "state.npz") as b:
        for key in sorted(a.files):
            if not np.array_equal(a[key], b[key]):
                return key, float(np.abs(a[key] - b[key]).max())
    return None


def lm_training_phase(work: Path):
    """smollm-135m and granite-moe-1b-a400m `--full-size` training through
    `launch.train.main`, the smollm run again crashed at step 4 and
    resumed; each uninterrupted run's first step has its K1 calls held.
    Returns (records, K3 forward launches, K3 backward launches, K1
    launches) of the uninterrupted runs."""
    recs = {}
    base = ["--arch", "smollm-135m", "--full-size", "--seq", str(TRAIN_SEQ),
            "--batch", "4", "--steps", "6", "--seed", "0"]
    full_dir, crash_dir = work / "train_full", work / "train_crash"
    held = {}
    with recorded_backward(held):
        recs["smollm"] = train_run("smollm-135m", base + [
            "--ckpt", str(full_dir), "--ckpt-every", "100"],
            hold="smollm train step 0")
    fwd = sum(st["k3_fwd"] for st in recs["smollm"]["steps"])
    bwd = sum(st["k3_bwd"] for st in recs["smollm"]["steps"])
    recs["smollm"]["backward_hold"] = hold_attention_backward(
        "smollm_training_layer", *held["args"])
    del held
    resume = base + ["--ckpt", str(crash_dir), "--ckpt-every", "4"]
    crash = train_run("smollm-135m", resume + ["--fail-at", "4"])
    if crash["exit"] != 42 or len(crash["steps"]) != 4:
        raise AssertionError(f"the crash run: {crash}")
    resumed = train_run("smollm-135m", resume)
    if [st["step"] for st in resumed["steps"]] != [4, 5]:
        raise AssertionError(f"the resumed run took {resumed['steps']}")
    diff = first_difference(full_dir, crash_dir, 6)
    rec = {"full_final": recs["smollm"]["final_loss"],
           "resumed_final": resumed["final_loss"],
           "bitwise": resumed["final_loss"] == recs["smollm"]["final_loss"]
           and diff is None, "first_difference": diff}
    log("train_resume", json.dumps(rec))
    if not rec["bitwise"]:
        raise AssertionError(f"the resumed run differs: {rec}")
    recs["resume"] = rec
    shutil.rmtree(full_dir)
    shutil.rmtree(crash_dir)
    held = {}
    states = {"one": {}, "init": {}, "half": {}}
    with recorded_backward(held):
        recs["granite"] = train_run("granite-moe-1b-a400m", GRANITE_ARGV,
                                    hold="granite train step 0",
                                    keep=states["one"])
    fwd += sum(st["k3_fwd"] for st in recs["granite"]["steps"])
    bwd += sum(st["k3_bwd"] for st in recs["granite"]["steps"])
    recs["granite"]["backward_hold"] = hold_attention_backward(
        "granite_training_layer", *held["args"])
    del held
    # the mesh holds' planted faults, run (uncounted): an update that is
    # never applied (whose parameters stay the initial ones), and a
    # gradient of other tokens (half the batch)
    recs["granite_frozen"] = train_run("granite-moe-1b-a400m",
                                       GRANITE_ARGV + ["--lr", "0"],
                                       keep=states["init"])
    recs["granite_half"] = train_run("granite-moe-1b-a400m",
                                     half_batch(GRANITE_ARGV),
                                     keep=states["half"])
    recs["granite_states"] = states
    torch.cuda.empty_cache()
    k1 = recs["smollm"]["k1_launches"] + recs["granite"]["k1_launches"]
    return recs, fwd, bwd, k1


# ---------------------------------------------------- LM mesh phase
MESH = "2x2"                # ("data", "model"): 4 gloo ranks on the card
# The mesh run against the 1x1 run.  Both train the same bf16 model on
# the same batches; the mesh sums its tp partials (attention's and the
# experts' outputs, the vocab blocks) and its dp gradient shares in
# another order, so its bf16 roundings differ, and AdamW's first steps
# (near sign(g)) turn a small gradient's rounding into a whole update of
# the other sign.  Two holds, each with a planted fault run in
# `lm_training_phase` that must fail it:
#  * the loss at each step, relative to the 1x1 run's: on an H100 the
#    sound run reads 4.0e-5 at most, the same bits in every run; an
#    update never applied (`--lr 0`) reads 9.2e-4 and must read more than
#    the limit.
#  * the final parameters leaf by leaf, ‖P_mesh − P_1x1‖ / ‖P_1x1 − P_0‖
#    (the distance over the 1x1 run's own update; `update_readings`):
#    the sound run reads 0.44 at most (a router; the median leaf 0.14); a
#    frozen update reads exactly 1 on every moved leaf, and a gradient of
#    other tokens (the 1x1 run at half the batch, as a lost dp sum gives
#    each dp rank) reads 1.37 on the median leaf, and its largest leaf
#    must read more than the limit.  A mesh run that skips `reduce_grads`
#    fails it too (checked at a reduced bf16 config on the CPU).
MESH_LOSS_RTOL = 2.0e-4
MESH_PARAM_LIMIT = 0.7
# the dry run's peak a device against the card's: the accounting is
# wrong outside this band
PEAK_BAND = (0.67, 1.5)
DRYRUN_CELLS = (("smollm", "smollm-135m", 4, (1, 1)),
                ("granite", "granite-moe-1b-a400m", 2, (2, 2)))


@contextlib.contextmanager
def mesh_rank_holds(rank, current_step):
    """On a rank of the mesh run: every K1 call of its first step held on
    its own inputs (`held_combines`, uncounted); yields a dict that gets
    the held calls and the rank's held errors."""
    first = current_step()
    out = {}
    with held_combines(f"lm_mesh rank {rank} step {first}",
                       active=lambda: current_step() == first,
                       uncounted=True) as seen:
        yield out
    out.update(held=dict(seen), errs=dict(HELD_ERRS),
               mag=dict(HELD_MAG_ERRS), widths=sorted(HELD_WIDTHS))


def start_lm_mesh(work: Path):
    """Start granite-moe-1b-a400m at full width and depth through
    `launch.train.main` with `--mesh 2x2` (`lm_training`'s granite argv
    and weights; 4 gloo ranks sharing the card) from a thread of this
    process, so that it runs while the card waits for the ingress
    children; its final parameters go to `work / MESH_FINAL`.  Returns
    (the thread, the box its record lands in)."""
    import threading
    from repro_torch.launch import train
    box = {}

    def run():
        ranks = []
        t0 = time.perf_counter()
        try:
            train.main(GRANITE_ARGV + ["--mesh", MESH], ranks_out=ranks,
                       rank_context=mesh_rank_holds,
                       final_params=work / MESH_FINAL)
        except BaseException as exc:      # raised by lm_mesh_phase
            box["error"] = exc
        box.update(ranks=ranks, wall_s=time.perf_counter() - t0)

    thread = threading.Thread(target=run, name="lm_mesh", daemon=True)
    thread.start()
    return thread, box


def update_readings(final, ref, init):
    """Each parameter's distance from the 1x1 run's final value over the
    1x1 run's own update, ‖P − P_ref‖ / ‖P_ref − P_0‖ (float32 norms on the
    card; `final`, `ref`, `init`: name → tensor): 0 for an equal leaf, inf
    for one that the 1x1 run left unchanged and this run moved."""
    out = {}
    for name, r in ref.items():
        r = r.cuda().float()
        num = float(torch.linalg.vector_norm(final[name].cuda().float() - r))
        den = float(torch.linalg.vector_norm(r - init[name].float()))
        out[name] = 0.0 if num == 0 else num / den if den > 0 else math.inf
    return out


def mesh_state_hold(states, work: Path, errs, frozen_errs):
    """The mesh run's final parameters against the 1x1 run's
    (`update_readings`, held at MESH_PARAM_LIMIT) and the planted faults
    against both limits (`states`: the final parameters of the 1x1 run,
    the frozen run (the initial ones) and the half-batch run); returns the
    record (its `mesh_state` line)."""
    one, init, half = states["one"], states["init"], states["half"]
    mesh = torch.load(work / MESH_FINAL, map_location="cpu", mmap=True,
                      weights_only=True)
    if sorted(mesh) != sorted(one) or any(
            mesh[n].shape != one[n].shape for n in one):
        raise AssertionError("lm_mesh: the gathered parameters are not "
                             "the 1x1 run's names and shapes")
    moved = math.sqrt(sum(float(torch.linalg.vector_norm(
        one[n].cuda().float() - init[n].float())) ** 2 for n in one))
    size = math.sqrt(sum(float(torch.linalg.vector_norm(
        init[n].float())) ** 2 for n in one))
    if not 0 < moved < 0.5 * size:     # the 1x1 run moved, by a step
        raise AssertionError(f"lm_mesh: the 1x1 update's norm {moved} "
                             f"against the weights' {size}")
    sound = update_readings(mesh, one, init)
    faulty = update_readings(half, one, init)
    del one, mesh, half, init
    states.clear()
    (work / MESH_FINAL).unlink()
    torch.cuda.empty_cache()
    worst = max(sound, key=sound.get)
    least = max(faulty, key=faulty.get)
    rec = {"leaves": len(sound), "update_rel_norm": moved / size,
           "max_reading": sound[worst], "max_leaf": worst,
           "median_reading": float(np.median(list(sound.values()))),
           "top": sorted(sound.items(), key=lambda kv: -kv[1])[:5],
           "limit": MESH_PARAM_LIMIT,
           "half_batch_max_reading": faulty[least],
           "half_batch_max_leaf": least,
           "half_batch_median_reading": float(np.median(
               list(faulty.values()))),
           "frozen_reading": 1.0,
           "loss_max_rel_err": max(errs), "loss_rtol": MESH_LOSS_RTOL,
           "frozen_loss_max_rel_err": max(frozen_errs)}
    log("mesh_state", json.dumps(rec))
    if not sound[worst] <= MESH_PARAM_LIMIT:
        raise AssertionError(f"lm_mesh: {worst} reads {sound[worst]} of "
                             f"the 1x1 update, limit {MESH_PARAM_LIMIT}")
    if not faulty[least] > MESH_PARAM_LIMIT:
        raise AssertionError(f"lm_mesh: the half-batch run reads at most "
                             f"{faulty[least]}: the parameter hold at "
                             f"{MESH_PARAM_LIMIT} cannot tell it")
    if not max(frozen_errs) > MESH_LOSS_RTOL:
        raise AssertionError(f"lm_mesh: the frozen run's losses read at "
                             f"most {max(frozen_errs)}: the loss hold at "
                             f"{MESH_LOSS_RTOL} cannot tell it")
    return rec


def lm_mesh_phase(recs, started, work: Path):
    """The mesh run `start_lm_mesh` started, held: one `lm_mesh_step` line
    a rank and step (loss, ms, peak, launches); each step's launches held
    at K3 forward 2·L, K3 backward L and K1 `k1_per_step` a rank, every K1
    call of each rank's first step held on its own inputs, rank 0's loss
    at each step within MESH_LOSS_RTOL of the 1x1 granite run's and the
    final parameters within MESH_PARAM_LIMIT (`mesh_state_hold`; `recs`:
    `lm_training_phase`'s records).  Returns (its record, K3 forward, K3
    backward and K1 launches summed over the ranks and steps)."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-1b-a400m")[0]
    granite = recs["granite"]
    argv = GRANITE_ARGV + ["--mesh", MESH]
    if list(granite["argv"]) != GRANITE_ARGV:
        raise AssertionError(f"the 1x1 reference ran {granite['argv']}")
    thread, box = started
    thread.join()
    if "error" in box:
        raise box["error"]
    ranks, wall = box["ranks"], box["wall_s"]
    want = {"k3_fwd": 2 * cfg.n_layers, "k3_bwd": cfg.n_layers,
            "k1": k1_per_step(cfg)}
    totals = dict.fromkeys(want, 0)
    for r in ranks:
        for st in r["steps"]:
            got = {k: st[k] for k in want}
            log("lm_mesh_step", json.dumps({
                "rank": r["rank"], "coords": r["coords"], "step": st["step"],
                "loss": st["loss"], "ms": st["s"] * 1e3,
                "peak_bytes": st["peak"], **got}))
            if got != want:
                raise AssertionError(f"lm_mesh rank {r['rank']} step "
                                     f"{st['step']}: launches {got}, want "
                                     f"{want}")
            for k in want:
                totals[k] += got[k]
        ctx = r["context"]
        if sum(ctx["held"].values()) != want["k1"]:
            raise AssertionError(f"lm_mesh rank {r['rank']}: {ctx['held']} "
                                 f"K1 calls held in its first step, want "
                                 f"{want['k1']}")
        for route in HELD_ERRS:
            HELD_ERRS[route] = max(HELD_ERRS[route], ctx["errs"][route])
            HELD_MAG_ERRS[route] = max(HELD_MAG_ERRS[route],
                                       ctx["mag"][route])
        HELD_WIDTHS.update(tuple(w) for w in ctx["widths"])
    ref = {st["step"]: st["loss"] for st in granite["steps"]}
    errs = [abs(st["loss"] - ref[st["step"]]) / abs(ref[st["step"]])
            for st in ranks[0]["steps"]]
    frozen_errs = [abs(st["loss"] - ref[st["step"]]) / abs(ref[st["step"]])
                   for st in recs["granite_frozen"]["steps"]]
    peaks = [st["peak"] for r in ranks for st in r["steps"][1:]]
    rec = {"argv": argv, "ranks": len(ranks), "wall_s": wall,
           "losses": [st["loss"] for st in ranks[0]["steps"]],
           "losses_1x1": [ref[st["step"]] for st in ranks[0]["steps"]],
           "loss_rel_err": errs, "loss_rtol": MESH_LOSS_RTOL,
           "ms_per_step": 1e3 * float(np.mean(
               [st["s"] for st in ranks[0]["steps"][1:]])),
           "peak_bytes": max(peaks), "launches_per_rank_step": want,
           "held_per_rank": [sum(r["context"]["held"].values())
                             for r in ranks]}
    log("lm_mesh", json.dumps(rec))
    if len(ranks[0]["steps"]) != len(granite["steps"]):
        raise AssertionError(f"lm_mesh ran {len(ranks[0]['steps'])} steps")
    rec["state"] = mesh_state_hold(recs.pop("granite_states"), work, errs,
                                   frozen_errs)
    if not max(errs) <= MESH_LOSS_RTOL:
        raise AssertionError(f"lm_mesh: losses {rec['losses']} against the "
                             f"1x1 run's {rec['losses_1x1']}")
    return rec, totals["k3_fwd"], totals["k3_bwd"], totals["k1"]


def dryrun_child(conn) -> None:
    """The dry run of `DRYRUN_CELLS` (the training steps of `lm_training`'s
    smollm run at 1x1 and of the mesh phase's granite run at 2x2, each on
    a fake mesh of that shape), in a child process that sees no card
    (fake tensors on the meta device); sends back each cell's record."""
    try:
        from repro_torch.configs import get_config
        from repro_torch.launch import cells, dryrun
        out = {}
        for name, arch, batch, shape in DRYRUN_CELLS:
            cfg = get_config(arch)[0]
            with dryrun.fake_world(shape, ("data", "model")) as mesh:
                run_s, lower_s, counter, args = dryrun.run_fake(
                    cells.lm_train_setup(cfg, batch, TRAIN_SEQ, mesh))
                out[name] = dryrun.record(arch, f"train_b{batch}",
                                          "train", mesh, {}, counter, args,
                                          lower_s, run_s)
        conn.send(("ok", out))
    except BaseException as exc:
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def start_dryrun_child():
    """Start `dryrun_child` with the card hidden from it (it is host work
    beside the card's phases)."""
    import multiprocessing
    import os
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        proc = ctx.Process(target=dryrun_child, args=(child,), daemon=True)
        proc.start()
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    child.close()
    return proc, parent


def dryrun_hold(child, measured):
    """The dry run's predicted peak a device against the peak the card
    measured in this run (`measured[name]`: bytes, ms a step), held within
    PEAK_BAND; its bound beside the measured step time (printed only)."""
    proc, conn = child
    status, out = conn.recv()
    proc.join(timeout=60)
    if status != "ok":
        raise AssertionError(f"the dry run failed: {out}")
    recs = {}
    for name, (peak, ms) in measured.items():
        r = out[name]
        rl = r["roofline"]
        rec = {"cell": name, "mesh": r["mesh"],
               "predicted_peak_bytes": r["memory"]["peak_bytes"],
               "measured_peak_bytes": peak,
               "peak_ratio": r["memory"]["peak_bytes"] / peak,
               "predicted_bound_ms": rl["bound_time_s"] * 1e3,
               "dominant": rl["dominant"], "measured_ms_per_step": ms,
               "compute_ms": rl["compute_time_s"] * 1e3,
               "memory_ms": rl["memory_time_s"] * 1e3,
               "collective_ms": rl["collective_time_s"] * 1e3,
               "kernel_calls": rl["kernel_calls"],
               "dryrun_s": r["lower_s"] + r["compile_s"]}
        log("dryrun_hold", json.dumps(rec))
        if not PEAK_BAND[0] <= rec["peak_ratio"] <= PEAK_BAND[1]:
            raise AssertionError(f"dry run {name}: predicted peak "
                                 f"{rec['predicted_peak_bytes']} against "
                                 f"{peak} measured")
        recs[name] = rec
    return recs


# ------------------------------------------------ graph checkpoint phase
def graph_checkpoint_phase(part, source, ref, work: Path):
    """The main path's SSSP (frontier "auto") on its partition: 3
    supersteps, `graph_engine_snapshot` into a synchronous
    `CheckpointManager`, a restore onto fresh agent slots, then the run to
    its end; its state must equal the uninterrupted run's bit for bit and
    the oracle exactly."""
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                graph_engine_restore,
                                                graph_engine_snapshot)
    from repro_torch.core import algorithms
    from repro_torch.core.engine import GREEngine
    prog = algorithms.sssp_program()
    eng = GREEngine(prog, frontier="auto")
    full, full_ms = timed(lambda: eng.run(
        part, eng.init_state(part, source=source), 10_000))
    early = eng.run(part, eng.init_state(part, source=source), 3)
    mgr = CheckpointManager(work / "graph_ckpt", async_write=False)
    t0 = time.perf_counter()
    snap = graph_engine_snapshot(early, part.num_masters)
    mgr.save(early.step, snap)
    like = {k: (torch.empty_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in snap.items()}
    restored, step = mgr.restore(like)
    state = graph_engine_restore(restored, part.num_slots,
                                 prog.monoid.identity)
    ckpt_s = time.perf_counter() - t0
    resumed, resumed_ms = timed(lambda: eng.run(part, state, 10_000))
    same = {f: bool(torch.equal(getattr(resumed, f), getattr(full, f)))
            for f in ("vertex_data", "scatter_data", "active_scatter")}
    rec = {"snapshot_step": step, "supersteps": full.step,
           "resumed_supersteps": resumed.step, "bitwise": same,
           "full_ms": full_ms, "resumed_ms": resumed_ms,
           "save_restore_s": ckpt_s,
           "snapshot_bytes": sum(v.numel() * v.element_size()
                                 for v in snap.values()
                                 if isinstance(v, torch.Tensor))}
    log("graph_checkpoint", json.dumps(rec))
    if step != 3 or resumed.step != full.step or not all(same.values()):
        raise AssertionError(f"graph checkpoint: {rec}")
    assert_exact("sssp_resumed", resumed.vertex_data, ref["sssp"])
    shutil.rmtree(work / "graph_ckpt")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="log2 |V| of the R-MAT graph (<= 24: CC labels and "
                         "SSSP sums are exact in f32 below 2**24)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if args.scale > 24:
        raise SystemExit("--scale must be <= 24")
    # the distributed phase's host ingress runs beside the phases before it
    ingress = start_dist_ingress(args.scale, DIST_K)
    try:
        with tempfile.TemporaryDirectory() as tmp:   # the plan caches'
            return run_phases(args, ingress, Path(tmp))
    finally:
        stop_dist_ingress(ingress)


PHASE_S = {}


@contextlib.contextmanager
def phase(name):
    """Time one phase of `run_phases`: a `phase_s` line at its end."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"phase_s {name}={PHASE_S[name]:.3f}")


def run_phases(args, ingress, cache_dir) -> int:
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_combine as sc

    from repro_torch.kernels import flash_attention as fa
    # float32 parity is asserted below: no TF32 anywhere (the defaults, set)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = cache_dir / "ranks"            # the rank world's input files
    work.mkdir()

    smi = nvidia_smi_line()
    log("device:", torch.cuda.get_device_name(0), "|", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    with phase("build"):
        names = ("segment_combine", "flash_attention", "embedding_bag",
                 "flash_attention_bwd")
        with ThreadPoolExecutor(len(names)) as pool:   # one nvcc a source
            list(pool.map(_build.load, names))

    with phase("inputs"):
        graph, ugraph, part, upart, source, sources = build_inputs(
            args.scale)
        ref = host_oracles(graph, ugraph, source)

    with phase("kernel_cases"):
        records = kernel_phase(part, source, args.reps)
        torch.cuda.empty_cache()
        adversarial_phase()
        torch.cuda.empty_cache()

    with phase("main_path"):
        # one untimed pass first, so the timed pass reads the steady
        # state, not first-use costs (allocator growth, lazy kernel loads)
        log("main_path warm-up pass (untimed, uncounted):")
        main_path(graph, part, upart, source, sources, ref)
        log("main_path timed pass:")
        torch.cuda.reset_peak_memory_stats()
        sc.reset_launches()
        t0 = time.perf_counter()
        runs, multi, single0 = main_path(graph, part, upart, source,
                                         sources, ref)
        launches = dict(sc.LAUNCHES)
        log(f"main_path_s={time.perf_counter() - t0:.3f} "
            f"launches={launches} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        for route, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the {route} route launched no "
                                     "kernel")
        check_lanes(part, sources, multi, single0)
        log("main_path", json.dumps(runs))
        del multi, single0
        torch.cuda.empty_cache()
    # plan autotuning, multi-stage BC and embedding_bag
    with phase("tuning"):
        sssp_plan, tune_launches = tuning_phase(graph, part, source, ref,
                                                cache_dir)
    with phase("bc"):
        bc_launches = bc_phase(graph, part)
    with phase("embedding_bag"):
        t0 = time.perf_counter()
        emb = embedding_phase(args.reps)
        t1 = time.perf_counter()
        emb["edge_cases_held"] = embedding_edge_phase()
        t2 = time.perf_counter()
        emb["gcn"] = [{k: r[k] for k in ("d", "ms", "device_ms", "bound_ms",
                                         "today_ms", "library_ms")}
                      for r in embedding_gcn_phase(part, args.reps)]
        log(f"embedding_phase_s={t1 - t0:.3f} embedding_edge_phase_s="
            f"{t2 - t1:.3f} embedding_gcn_phase_s="
            f"{time.perf_counter() - t2:.3f}")
    # GNN training: full graph, the float64 check, minibatches, molecules
    with phase("gnn"):
        gnn_launches, gcn_ref = gnn_phase(graph,
                                          min(args.scale, GNN_F64_SCALE))
    # the equivariant GNNs and AutoInt, at full width
    eq_counted = {"dimenet": 0, "mace": 0}
    eq_mol = molecule_union(EQ_GRAPHS)
    with phase("dimenet_molecule"):
        eq_molecule_run("dimenet", eq_mol, eq_counted)
    with phase("mace_molecule"):
        eq_molecule_run("mace", eq_mol, eq_counted)
    with phase("autoint"):
        autoint_rec, autoint_launches = autoint_phase(work)
    with phase("dimenet_sharded"):
        dimenet_stacked = dimenet_sharded_phase(work)
    # incremental re-convergence and graph serving on the single shard
    with phase("incremental"):
        _, delta, sssp_cold = incremental_phase(graph, ugraph, part, upart,
                                                source)
    with phase("graph_serving"):
        _, stream, old_bfs = graph_serving_phase(graph, part)
    with phase("graph_checkpoint"):
        graph_checkpoint_phase(part, source, ref, cache_dir)
    # the distributed phase: the single-shard partitions go first
    del part, upart
    torch.cuda.empty_cache()
    single_steps = {r["program"]: r["supersteps"] for r in runs}
    # the mesh run's 4 ranks use the idle card (and free cores) while the
    # ingress children finish; it is held after the 1x1 run (lm_mesh)
    mesh_run = start_lm_mesh(cache_dir)
    with phase("dist_ingress_wait"):
        inputs = dist_inputs(ingress)
        mesh_run[0].join()
    with phase("dist"):
        _, _, finals = dist_phase(inputs, ref, source, single_steps)
    with phase("dist_tuned"):
        dist_tuned_phase(inputs, ref, source, sssp_plan,
                         cache_dir / "dist.json")
    with phase("dist_incremental"):
        dist_incremental_phase(inputs, delta, source, sssp_cold)
    with phase("dist_serving"):
        dist_serving_phase(inputs, stream, old_bfs)
        # the rank serving stream's reference: the stacked k = 8 batchers
        rank_stream = rank_serving_stream(stream)
        from repro_torch.dist.comm import StackedComm
        serving_stacked = serve_ranks_stream(
            "stacked", inputs["directed"][0], rank_stream,
            StackedComm(DIST_K), "cuda")
        log("graph_serving_stacked", json.dumps(serving_stacked[1]))
    ags = {key: inputs[key][0] for key in ("directed", "undirected")}
    # GCN through propagate_sharded: only the directed sync topology stays
    inputs.pop("undirected")
    inputs.pop("slack", None)
    inputs["directed"][1].pop("tiles")
    torch.cuda.empty_cache()
    with phase("gnn_dist"):
        gcn_stacked = gnn_dist_run(graph, inputs, gcn_ref)
    # one shard a process: the card holds only the ranks' shards
    del inputs, old_bfs, sssp_cold
    torch.cuda.empty_cache()
    with phase("dist_ranks"):
        rank_launches = dist_ranks_phase(
            ags, graph, ref, source, finals, gcn_stacked, gcn_ref[0], work,
            rank_stream, {"dimenet": dimenet_stacked,
                          "serving": serving_stacked})
    log(f"held_max_abs_err={json.dumps(HELD_ERRS)} "
        f"held_mag_rel_err={json.dumps(HELD_MAG_ERRS)}")
    del graph, ugraph, ref, ags, finals, gcn_stacked, gcn_ref
    torch.cuda.empty_cache()

    dry = start_dryrun_child()      # host work beside the phases below
    with phase("attention"):
        attn = attention_kernel_phase(args.reps)
    with phase("attention_backward"):
        attn_bwd = attention_backward_phase(args.reps)
    with phase("lm_serving"):
        attn_launches = lm_serving_phase()
    with phase("moe_serving"):
        _, moe_k3, moe_k1 = moe_serving_phase()
    with phase("lm_training"):
        train_recs, train_fwd, train_bwd, train_k1 = lm_training_phase(
            cache_dir)
    with phase("lm_mesh"):
        mesh_rec, mesh_fwd, mesh_bwd, mesh_k1 = lm_mesh_phase(
            train_recs, mesh_run, cache_dir)
    with phase("dryrun_hold"):
        dryrun_hold(dry, {
            "smollm": (train_recs["smollm"]["max_memory_allocated"],
                       train_recs["smollm"]["ms_per_step"]),
            "granite": (mesh_rec["peak_bytes"], mesh_rec["ms_per_step"])})
    log("phase_s", json.dumps(PHASE_S))

    kernels = []
    paths = {"tuning": tune_launches, "bc": bc_launches,
             "dist_ranks": rank_launches,
             **{f"gnn_{k}": {"dense": n, "tile": 0, "compact": 0}
                for k, n in gnn_launches.items()},
             **{k: {"dense": n, "tile": 0, "compact": 0}
                for k, n in eq_counted.items()},
             "autoint": {"dense": autoint_launches, "tile": 0, "compact": 0},
             "moe_serving": {"dense": moe_k1, "tile": 0, "compact": 0},
             "lm_training": {"dense": train_k1, "tile": 0, "compact": 0},
             "lm_mesh": {"dense": mesh_k1, "tile": 0, "compact": 0},
             "dimenet_sharded": {
                 "dense": dimenet_stacked[2]["launches_forward"]
                 + dimenet_stacked[2]["launches_backward"],
                 "tile": 0, "compact": 0}}
    for name, route, case in (
            ("segment_combine_dense", "dense", "dense_D1_sum"),
            ("segment_combine_tile", "tile", "tile_D1_min"),
            ("compact_lanes", "compact", "tile_compact")):
        rec = next(r for r in records if r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES["dense" if route == "dense" else "tile"],
            "launches": launches[route],
            "path_launches": {p: n[route] for p, n in paths.items()},
            "max_abs_err": max([r["max_abs_err"] for r in records
                                if r["route"] == route]
                               + [HELD_ERRS.get(route, 0.0)]),
            "held_mag_rel_err": HELD_MAG_ERRS.get(route, 0.0),
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": rec["library_ms"],
            "held_widths": sorted(f"{op}:D{d}" for r, op, d in HELD_WIDTHS
                                  if r == ("dense" if route == "dense"
                                           else "tile"))})
    kernels.append(emb)
    rec = attn[0]                      # smollm-135m's prefill shape
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": attn_launches,
        "path_launches": {"lm_serving": attn_launches,
                          "moe_serving": moe_k3, "lm_training": train_fwd,
                          "lm_mesh": mesh_fwd},
        "max_abs_err": max(r["max_abs_err"] for r in attn),
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"]})
    rec = attn_bwd[0]                  # smollm-135m's training shape
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": ATTN_BWD_SOURCE, "replaces": ATTN_BWD_REPLACES,
        "launches": train_bwd,
        "path_launches": {"lm_training": train_bwd, "lm_mesh": mesh_bwd},
        "max_abs_err": max(r["max_abs_err"] for r in attn_bwd),
        "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
