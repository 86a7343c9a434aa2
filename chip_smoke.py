#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                         # RMAT n=2^22, 2^25 edges;
                                                  # DLRM-RM2 at full width
    python3 chip_smoke.py --log-n 14 --log-m 17   # a short compile check
                                                  # (DLRM vocab, batches and
                                                  # candidates cut to 2^14)
    python3 chip_smoke.py --ranks 4               # only the placements and
                                                  # the sharded cells, on 4
                                                  # cards, a rank each
    python3 chip_smoke.py --parent build/parent/src/repro_torch
                                                  # also time a parent's bag
                                                  # forward and backward, DLRM
                                                  # steps, GIN step and
                                                  # segment kernel, in turns

Phases, in order; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc
              (one process per source, all at once) into build/kernels/,
              with each kernel's registers, shared memory and spills;
  3. graph    an RMAT graph, paper parameters (a,b,c) = (0.5, 0.1, 0.1),
              generated on the host from the seed and built on the card;
  4. kernels  each kernel at the main paths' shapes against its plain
              PyTorch version on the same inputs (the int32 kernels exactly,
              embedding_bag within BAG_TOL), with its time, the plain
              version's, one PyTorch call's where one computes the same
              function (scatter_reduce for scatter_min; for pointer_jump at
              k = 1 and edge_rewrite, gathers through the labels with a -1
              slot appended), and the bound. The connectivity kernels also
              run on what the paths really hand them: the hook of
              hook_compress on the graph edges with (a) the phase's labels,
              (b) all labels -1 (the pass's floor), (c) identity labels, and
              (d) the first round of the sampler, of the compacted finish
              and of the fused finish, at k = 0 and 3; scatter_min on
              uniform targets, on a synthetic hub taking ~98% of them, on
              min_vertex_labels' call after the main path; edge_relabel and
              edge_rewrite on the graph edges with the phase's labels and
              with ~10% -1 endpoints; pointer_jump on the phase's labels at
              k = 1 and 3. Then every call, recorded from real runs
              (RECORDED) and timed as one run's calls back to back:
              scatter_min's finish calls of kout_hybrid_k2+liu_tarjan_CRFA
              and kout_hybrid_k2+label_prop, compacted and fused, and both
              passes of every round of a none+uf_sync_full spanning forest;
              edge_relabel's of kout_hybrid_k2+liu_tarjan_PUFA, compacted
              and fused (3 each), and of none+stergiou (4, on the rewritten
              endpoints), with their count of live proposals;
              pointer_jump's of the main path, compacted and fused (12
              each); edge_rewrite's of kout_hybrid_k2+liu_tarjan_PUFA (3)
              and _CRFA (4), compacted and fused, of none+stergiou (4, on
              the graph edges) and of the main variant's first 8 stream
              batches of 2^20 edges, with their count of non-negative ends;
              the ingest phase's calls: edge_rewrite's and hook_compress's
              of the main variant on the graph's edges in 8 chunks, and
              every kernel's of kout_afforest_k2+uf_sync_full on the
              power-law stream of 2^25 edges over 2^24 vertices; an
              evenly spaced sample (4 to 7 calls) of scatter_min's and
              pointer_jump's in the main variant's amsf; and the same sample
              of the serve phase's closed loops: edge_rewrite's,
              hook_compress's and pointer_jump's of the static server
              (commits of at most 32,768 directed entries against the
              preloaded 2^22 + 1 labels), scatter_min's and pointer_jump's
              of the dynamic server; and every call but the
              canonicalization's of the placements phase's one-rank runs:
              the main variant's under sharded(x) (scatter_min's into the
              label window plus one appended dump slot, hook_compress's,
              pointer_jump's) and under sharded(x):overlap (scatter_min's,
              hook_compress's on the two half-blocks), and
              kout_hybrid_k2+liu_tarjan_PUFA's edge_relabel and
              edge_rewrite calls under sharded(x); and, one run at a time
              (LATE_RUNS), the connectit cells' calls at their published
              sizes: the first and last hook_compress round of
              static_1b_edges (2^30 edges on 2^26 + 1 labels) with the
              pointer_jump call of its exactness check's compression (run
              kind "cell"), of ingest_256m_batch (its batch mirrored to
              2^29 entries) with its stream's pointer_jump ("cell
              ingest"), and of static_8b_edges_sharded at one rank (2^31
              edges on 2^28 + 1 labels) with its 7 scatter_min frontier
              applies into the window plus a dump slot ("cell sharded").
              The plain hook proposes 2^26 edges a pass, so it fits beside
              2^31 edges.
              Bounds count the bytes this run's data needs (edge_rewrite:
              the label slots its non-negative ends read). embedding_bag
              (one launch for T tables, embedding_bags) on a 1,000,448 x
              64 table (T = 1) at RM2's serve_bulk shape (B=262144, L=1,
              zipfian ids) and a multi-hot one (B=65536, L=8, ~10% on the
              dump row, and with wrapped and clamped ids), sum / mean /
              max, float32 / bfloat16; then on 26 RM2 tables: the grouped
              call of one serve_p99, serve_bulk, retrieval_cand and
              train_batch step, recorded from a full-width DLRM-RM2
              (RECORDED's run kind "bags"; serve_bulk's also on bfloat16
              copies of the tables), and 26-table multi-hot and wrapped
              ids, each mode, float32 and bfloat16; each within BAG_TOL of
              the plain version (a call a table; float32 L=1 exact), with
              its CUDA-event ms and the host wall of a synchronized call,
              both bounds (each distinct row once; every gathered row) and
              one F.embedding_bag a table beside it; with --parent each
              also the parent's (a launch a table), in turns, the same
              bits;
              embedding_bag_backward (float32, no TPU counterpart; one
              call for T tables, embedding_bags_backward) on the same table
              for each mode: RM2's train shape (B=65536, L=1, zipfian), a
              hub (half the bags on row 0), the multi-hot and the wrapped
              ids, each against the plain version (index_add_ of each
              position's share) within the worst case of two float32 sums
              of the same terms in other orders, the same bits on a second
              run, beside index_add_ (sum, L=1) and the zeroing of the
              gradient alone; then the grouped call of 26 tables recorded
              from the same train_batch step (RECORDED's run kind
              "train"); with --parent PKG (a parent commit's
              src/repro_torch, git archive'd into build/) each of these
              also times the parent's backward, in turns: parent, change,
              change, parent; threefry_randint (the main path's k-out
              column: randint over the graph's degrees under PRNGKey(0)'s
              column key) and threefry_bits (2^22 words) against their
              plain versions, bit for bit, their operations bound from
              cuobjdump -sass of the built library (each pipe at its rate:
              SASS_ALU, SASS_IMAD, SASS_XU);
  5. small    every variant of enumerate_variants() (148) on a small graph,
              compacted and fused, on the card, against the CPU path and
              scipy; the spanning forest of its 28 forest-capable variants,
              valid on the card and the CPU path, and equal row for row on
              the deterministic samplings;
  7b. threefry repro_torch.random on the card against the CPU: keys, bits and
              randint with the graph's degrees as maxval, bit for bit; the
              graph's k-out selection under PRNGKey(0) (the main path's
              draw) on the card against the same on a CPU copy; the main
              path's wall with the default key beside the same path drawing
              from a torch.Generator (the port's draws before), and the
              column draw alone each way;
  6. oracle   scipy's labels of the big graph and its sorted edge keys
              (each scipy oracle's CSR input is sorted, counted and, for
              components, deduplicated on the card);
  7. paths    on the big graph, each against the scipy oracle, with wall
              time, stats, peak memory and each kernel's launch count; each
              path names its launches per kernel and finish rounds on the
              default graph, asserted there (every sampler draws
              jax.random's numbers from PRNGKey(0), LDD's too); the main
              path's k-out column is one threefry_randint launch:
                kout_hybrid_k2+uf_sync_full      compacted, fused (the main path)
                kout_hybrid_k2+liu_tarjan_PUFA   compacted, fused
                kout_hybrid_k2+liu_tarjan_CRFA   compacted, fused
                none+stergiou
                ldd_b0.2+uf_sync_full
  8. forest   ConnectIt(v).spanning_forest(g) for the FOREST_PATHS variants
              on the big graph, each forest checked on the host: n -
              #components edges, the graph's components, every edge in the
              graph; wall time, peak memory, launches and finish rounds
              (asserted on the default graph);
  9. stream   the graph's undirected edges permuted by --seed through
              ConnectIt(MAIN_VARIANT).stream(n) in batches of 2^20 and, for
              the first 2^22, of 2^16, with 2^16 query pairs a batch: labels
              against scipy's, the queries of batch 8 and of the last batch
              against scipy on the prefix; inserted edges/s, per-batch p50
              and p99; launches and rounds asserted on the default graph;
 10. dynamic  (a) the same 2^20 batches through stream(n, dynamic=True,
              log=2^26): labels and forest against the graph's; (b) 8 steps
              of sliding_window(n, batch=2^20, window=4, queries=2^16) on a
              fresh stream(n, dynamic=True, log=2^23): each step's answers
              against scipy on the live multiset, the final forest within
              the survivors; updates/s, rounds, fallback rebuilds;
 11. serve    ConnectIt(MAIN_VARIANT).serve(n) at benchmarks/serve_bench.py's
              full-scale settings (max_batch_edges 16384, max_batch_queries
              8192, flush_ms 0.5, warmup "all"): the static server preloaded
              with the stream phase's edges in commits of 2^20, an untimed
              closed-loop pass, a closed loop of 16 clients x 48 requests
              (1024 query pairs each, 4096 insert edges every 4th) and open
              loops at 0.25, 0.5 and 0.75 of its QPS (256 requests), each
              LoadResult row and the server's stats; epochs in commit order,
              every submitted edge committed, the final partition and the
              answers of 4 evenly spaced epochs against scipy on their prefix
              of the commit log, edge_rewrite once a commit; then the dynamic
              server (log 2^23) preloaded with 4 commits of 2^20 and a closed
              loop of 16 x 16 with delete_frac 0.25: its labels against scipy
              on the live multiset replayed from the commit log;
 12. ingest   ConnectIt(v).from_chunks on the graph's undirected edges in
              the stream phase's order, a host ArrayEdgeSource of 8 chunks
              (2^22 each), for kout_hybrid_k2+, kout_afforest_k2+ and
              none+uf_sync_full: labels against scipy and .connectivity,
              chunks, edges streamed, survivors, spills, rounds, edges/s,
              peak memory beside the one-shot path's; the same edges as
              CompressedEdgeBlocks (2^16 a block) decoded on the card;
              powerlaw_chunks(4n, m, seed=7) at m = 2^25 and 2^27 (labels
              against scipy at 2^27), whose peaks must agree within 5% and
              print beside the analytic resident bytes; edge_rewrite once a
              chunk;
 13. apps     with_weights(g, seed=0): amsf, amsf(skip=lmax), amsf(mode=coo)
              and msf with the main variant, each a spanning forest (checked
              as in the forest phase) whose weight is within 1.25x of scipy's
              minimum spanning tree (msf: equal to float32 rounding);
              scan(eps=0.6,mu=3) and scan(eps=0.3,mu=3) on seeded symmetric
              similarities against a numpy/scipy restatement of the
              sequential query, and scan(eps=0.1,mu=3), scan(eps=0.3,mu=3)
              on rmat(2^13, 12*2^13, seed=4) with build_index's
              similarities against gs_query_sequential;
 14. placements the replicated and sharded placements on the graph, each
              against scipy's labels: (a) one rank over NCCL in this
              process: the main variant under replicated(x), sharded(x),
              sharded(x):frontier=0, sharded(x):fused, sharded(x):overlap
              and sharded(x,y), none+uf_sync_full under replicated(x) and
              sharded(x), and kout_hybrid_k2+liu_tarjan_PUFA under
              sharded(x), each also against the single path's labels, with
              its median wall of 5, rounds, launches (asserted on the
              default graph), host waits an outer round from one traced
              run (the sharded(x) main run's trace printed whole) and peak
              memory; (b) the stream phase's 2^20-edge batches under
              sharded(x): labels, the last batch's answers, edges/s, p50;
              (c) scan(eps=0.6,mu=3) under sharded(x) against the single
              path on the apps phase's similarities; (e) the dynamic
              phase's 8 sliding_window steps under replicated(x) and
              sharded(x): each step's answers, the final labels and rounds
              against the single path's, the forest n - #components edges
              of the live graph, with updates/s, per-step p50/p99,
              fallbacks and a traced ninth step; (f) amsf and
              amsf(skip=lmax) under both on the apps phase's weights: a
              spanning forest within 1.25x of scipy's MST weight, buckets
              and edges per bucket the single path's, and one traced
              sharded(x) run; (g) the serve phase's static and dynamic
              servers under sharded(x), same caps and traffic without the
              open loops, answers at 2 epochs and the final labels against
              scipy, a traced closed-loop window; (d) two processes
              sharing the card over gloo (this script with --mesh-rank),
              reading the graph and scipy's labels this process writes once
              to a temporary directory: replicated(x), sharded(x),
              sharded(x):frontier=0, each against scipy's labels (which
              (a)'s equal), with wall and rounds;
 15. tune     the tuning loop on the card, each part in a cache file of its
              own: (a) the five connectivity kernels at every block size
              of the ladder (256 threads, the one they are built for)
              against the plain versions bit for bit on tune_block_m's
              problem (n = 2^22 parents, 2^24 uniform edges), and refusing
              any other; each point's time_fn median beside a CUDA-event
              mean of 20 launches, then tune_block_m; (b) tune_variant over
              the seven fast variants on the graph, each variant's median
              and the winner; (c) ConnectIt("auto") on that cache runs the
              winner: labels equal scipy's, finish rounds the winner's
              explicit run's; (d) ConnectIt("auto", exec="single:tune") on
              a fresh cache measures once for two calls; (e) python -m
              repro_torch.launch.tune --smoke exits 0, then the full CLI
              on its proxies, whose device-global winner is printed beside
              (b)'s; (f) the cold cache resolves 256 threads again;
 16. cells    the connectit cells (launch.steps.build_cell, CONNECTIT_SHAPES)
              at their published sizes on a one-rank (data, model) mesh
              over NCCL, each on a planted graph generated on the card
              (2^20 blocks: a random tree in each, the rest of the edges
              uniform inside a block; exact iff every edge's ends share a
              root and the roots number the blocks): static_1b_edges
              (2^26 vertices, 2^30 edges; wall of the counted run and
              median of CELL_TIMING_REPEATS after it), ingest_256m_batch
              (one 2^28-edge batch, 2^20 uniform query pairs against block
              identity; batch edges/s), static_8b_edges_sharded and
              static_8b_sharded_fused (2^28 vertices, 2^31 edges), each
              with its peak above the inputs, outer rounds and launches
              (CELL_COUNTS, asserted on the default graph); the legacy
              shims on the graph (connectivity(g, sample="kout",
              finish="uf_sync"), get_finish("liu_tarjan_CRFA") through
              run_connectivity, make_replicated_connectivity at one rank)
              against scipy; every wall so far timed with nothing else
              running; then python -m repro_torch.launch.dryrun --all
              --mesh both beside python -m repro_torch.launch.ingest on an
              rmat of a quarter of the graph's size each way (CLI_LOG_CUT:
              n = 2^20, 2^23 edges, batches of 2^18): plain, stopped after
              CLI_STOP_STEPS batches with --ckpt-dir and resumed, each
              against scipy on its edges, and --chunked (chunks of 2^20)
              against scipy on its stream;
 17. dlrm     DLRM-RM2 built on the card from the seed (26 x 1,000,448 x 64
              float32 tables, 6.66 GB); serve_p99 (B=512), serve_bulk
              (B=262144) and retrieval_cand (10^6 candidates), each through
              the embedding_bag kernel (one launch a step) and held
              against the same model through the plain version, with step
              times, peak memory and launches per step; with --parent the
              same model through the parent's bags, the same bits, p50s in
              turns;
 18. profile  where the compacted main path's time goes: wall time per
              driver step, device time per kernel and the device's busy
              share (torch.profiler); then the same trace of none+stergiou,
              of kout_hybrid_k2+liu_tarjan_PUFA fused (its per-round state
              compares run over the whole edge list), of one stream batch
              and one dynamic step, of one ingest of the ingest phase's
              8-chunk source, one amsf(skip=lmax) with the main variant and
              one msf, one closed-loop window of the serve phase's static
              server (with the host's waits a commit), and of one DLRM-RM2
              serve_bulk and one serve_p99 step;
 19. train    DLRM-RM2 training at full width, after the serve model is
              freed: the train_batch cell (B=65536, 26 x 1,000,448 x 64
              float32 tables, AdamW with the reference's OptimizerConfig)
              from init_dlrm(key=PRNGKey(seed)) on RecsysStream batches:
              one warm step, one counted step (1 embedding_bag launch
              and 1 call of embedding_bag_backward, all 26 tables in each,
              3 threefry_bits, nothing else), TRAIN_STEPS
              timed steps (step wall p50, samples/s, the peak above the
              model and optimizer state, first and last loss, finite), one
              traced step; one step twice from the same state (saved to the
              host), the parameters and moments equal bit for bit, after a
              diagnostic step under torch.use_deterministic_algorithms
              (warn_only) that names any op without a deterministic kernel;
              with --parent the same step through the parent's bags equal
              bit for bit (loss and leaves), then step p50s in turns;
              one step through the kernels against the same step through
              the plain versions at TRAIN_CHECK_VOCAB rows a table (the
              loss equal, each leaf within TRAIN_LEAF_TOL of its largest
              magnitude); python -m repro_torch.launch.train --arch dlrm-rm2
              --device cuda stopped by --simulate-failure and rerun, its
              final checkpoint equal leaf for leaf to an uninterrupted
              run's.

 20. lm       the LM family (LM_ARCHS) on the card, each run listing its
              cuts: (e) the five smoke configs in float32, TF32 off,
              against the same calls on the CPU from the same weights
              (logits, aux, lm_loss, one train step's moments and
              parameters, prefill and decode; LM_SMOKE_TOL); (f) python -m
              repro_torch.launch.train --arch stablelm-3b stopped by
              --simulate-failure and resumed bit-exact, beside python -m
              repro_torch.launch.legacy.serve (its ids equal serve()'s);
              then at full width and depth (but (a) at LM_SERVE_LAYERS and
              (d) at LM_TRAIN_LAYERS layers), bf16 activations over float32
              weights, each model drawn from PRNGKey(seed) on the card
              (its threefry_bits launches asserted from the shapes, a
              TokenStream batch's two threefry_randint): (c) h2o-danube-3-4b
              x long_500k uncut, a prefill of LM_LONG_PREFILL tokens and
              LM_LONG_DECODE decode steps through the cell, each against
              the full forward (LM_BF16_TOL); (b) granite-moe-3b-a800m
              prefill at LM_MOE_SEQ x LM_MOE_BATCH and decode, layer 0's
              capacity and dropped share; (a) qwen3-4b prefill_32k at
              LM_PREFILL_BATCH, traced (attention, GEMMs, weight casts),
              decode steps from its cache (one traced), decode_32k at
              LM_DECODE_BATCH over a full cache, prefill and decode from
              an empty cache against the forward on LM_CHECK_TOKENS tokens,
              F.scaled_dot_product_attention beside chunked_attention on
              layer 0's q/k/v; (d) stablelm-3b train_4k with remat at
              LM_TRAIN_BATCH: a counted step, LM_TRAIN_STEPS timed, one
              traced, AdamW alone against its bytes bound, one step twice
              from one state equal bit for bit (the state page-locked on
              the host).
 21. lm mesh  the LM cells on a mesh: LM_MESH_WORLD processes of this script
              (--mesh-rank) on a 2 x 2 (data, model) DeviceMesh sharing the
              card over gloo (its all_to_all on CUDA tensors checked first,
              the transport printed), each run listing its cuts and printing
              its wall, tokens/s, per-rank peak and the collectives' share
              of an instrumented run: (a) qwen3-4b at full width, depth
              LM_MESH_QWEN_LAYERS, a prefill of LM_MESH_PREFILL, decode
              steps from its sequence-sharded cache and decode_32k at
              LM_MESH_DECODE_BATCH over a full random cache, logits and the
              cache against the one-rank path in this process (LM_BF16_TOL
              of the largest magnitude); (b) deepseek-moe-16b train_4k and
              train_4k_int8a2a at depth LM_MESH_MOE_LAYERS and
              LM_MESH_TRAIN: the exact step's loss against a one-rank step
              with moe_groups = 2 (LM_MESH_BF16_LOSS_TOL), every layer's
              routing against the one-rank path's, every gradient leaf in
              float32 activations at depth LM_MESH_GRAD_LAYERS against the
              one-rank path's with every token routed alike
              (LM_MESH_F32_GRAD_TOL; the parent's gradients stay on the
              card, mapped by the ranks through CUDA IPC), layer 0's MoE
              output through the int8
              all_to_all within LM_MESH_INT8_TOL of the exact one, a timed
              step of each; (c) the deepseek and qwen3 smoke cells in
              float32 on the card's mesh against the same cells on a CPU
              mesh of the same ranks (LM_SMOKE_TOL).
 22. gnn      the GNN family (GIN, PNA, EGNN) and NequIP on one rank
              (GNN_ARCHS), every aggregation and gather backward through
              the segment_sum kernel, GIN's aggregation and its gradient
              through gather_sum: (a) each arch's full_graph_sm cell
              config at the published widths and depths, and the smoke
              configs in float32 and bfloat16, on the card against the CPU
              from the same weights (the output, the loss, every gradient
              leaf, one AdamW step; GNN_TOL, GNN_PNA_GRAD_TOL,
              LM_BF16_SMOKE_TOL); (b) the molecule batch (128 graphs of 30
              nodes: a spanning tree and 35 more edges each, ids permuted)
              whose graph ids come from ConnectIt(GNN_CC_VARIANT) on the
              card, its kernels' launches asserted and its components
              equal to the generator's, then each arch's molecule cell
              step on them (graph readout, NequIP's per-graph energy), the
              same bits twice; (c) minibatch_lg: the CSR of 114,615,892
              RMAT edges drawn and sorted on the card, GraphNodeStream's
              seeds and sample_subgraph on the card equal to the CPU's bit
              for bit, GIN's cell step at 602 features (sampling inside the
              step), the same bits twice; with --parent the parent's step
              from the same parameters (its first loss against this one's,
              its p50 in turns); (d) ogb_products: each arch's train step at the cell's
              config (bf16; NequIP with remat, at depth GNN_OGB_LAYERS), GIN uncut
              through its cell
              (its launches of both segment kernels asserted, no
              index_select gather in its trace), the others with the node
              and edge counts cut by GNN_OGB_CUT: GNN_TIMED_STEPS timed,
              edges x layers / s, the peak, a traced step (after one that
              warms the profiler; its traced segment kernels must equal the
              wrappers' launch counts) split into gather_sum, segment_sum,
              gathers, GEMMs and the rest, the same bits twice; with --parent the parent's GIN step from
              the same parameters (its first loss and grad norm equal to
              this one's bit for bit, its peak, trace and p50 in turns);
              (e) segment_sum and gather_sum
              on every call recorded from (a)-(d) (RECORDED's run kinds
              "gnn ...", GNN_OGB_CALLS of the uncut GIN step) against the
              plain version in float64 within the float32 reordering
              bound, the same bits twice, gather_sum the same bits as
              index_select, where and segment_sum, with the time (and with
              --parent the parent's segment_sum, or its three-op path, in
              turns), the plain version's, index_add_'s or
              torch.sparse.mm's, and both bytes bounds.
 23. gnn mesh the GNN cells on a mesh: GNN_MESH_WORLD processes of this
              script (--mesh-rank) on a 2 x 2 (data, model) DeviceMesh
              sharing the card over gloo, each rank drawing the graph from
              the seed and keeping its blocks (node features over data,
              edges over both axes): GNN_MESH_RUNS, GIN's ogb_products and
              ogb_products_spmd cells uncut, PNA's two, EGNN's and
              NequIP's at the gnn phase's cuts (GNN_OGB_CUT), each arch at
              its depth GNN_MESH_LAYERS, each through its cell's own step
              (build_cell at the run's sizes, the published shape's config
              forced); each run's first cell step against the one-rank
              cell's step in this process: the loss, the gradient norm and
              every first moment (bf16: LM_BF16_SMOKE_TOL; NequIP in
              float32: GNN_MESH_F32_TOL), then one more cell step with its
              collectives timed (wall, the collectives' seconds and count),
              the per-rank peak above the inputs and each rank's
              segment_sum and gather_sum launches (GIN's asserted: 1 and
              2 x depth - 1).

With --ranks N (N > 1) it runs device, build, graph and oracle, then
only the placements across N cards: the runs of (a) and the stream of (b)
on N processes of this script, one rank a card over NCCL, each rank's
labels against scipy's, the ranks' rounds and stats equal, with each run's
wall, rounds, edges per rank and launches; then (e) and amsf(skip=lmax)
under sharded(x), against the single path's runs in this process, and one
served closed loop under sharded(x), rank 0 serving and the other ranks
following its commits, every rank's final labels equal to rank 0's and to
scipy's on rank 0's commit log; last ConnectIt("auto",
exec="sharded(x):tune"), each rank on a cache file of its own: every rank
elects rank 0's winner, only rank 0's file is written, and every rank's
labels equal scipy's. Then the two sharded cells at their published sizes
on a (data, model) mesh of N processes, one rank a card: each rank
generates only its edge block and label window, and the gathered labels
pass the planted check on every rank. Last the lm mesh phase and the gnn
mesh phase on a 2 x 2 mesh of the N = 4 processes, one rank a card over
NCCL: the lm mesh at the same cut depths, the gnn mesh uncut but NequIP
(GNN_MESH_RANKS_CUT; its one-rank checks only for GIN, which one card
holds).

The whole script reads a tuning cache of its own, an empty file under a
temporary directory (REPRO_TORCH_TUNE_CACHE, printed first), so every
kernel launches 256 threads a block outside the tune phase whatever a
cache in the home directory holds. Each phase prints its seconds.
The line before the last holds the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_VARIANT = "kout_hybrid_k2+uf_sync_full"
UF_KERNELS = ("hook_compress", "pointer_jump", "scatter_min")
PATH_KERNELS = UF_KERNELS + ("edge_relabel", "edge_rewrite")
# (variant, fused modes, launches of PATH_KERNELS per run and finish rounds
# on the default graph, which no change inside a kernel may alter); the
# first is the main path, whose launches the per-kernel JSON
# reports for its three kernels. A run must launch each kernel with a count
# above 0, at any size.
PATHS = (
    (MAIN_VARIANT, (False, True), (7, 12, 1, 0, 0), 3),
    ("kout_hybrid_k2+liu_tarjan_PUFA", (False, True), (4, 14, 1, 3, 3), 3),
    ("kout_hybrid_k2+liu_tarjan_CRFA", (False, True), (4, 15, 9, 0, 4), 4),
    ("none+stergiou", (False,), (0, 5, 1, 4, 4), 4),
    ("ldd_b0.2+uf_sync_full", (False,), (3, 5, 81, 0, 0), 3),
)
DEFAULT_GRAPH = (22, 25, 0)  # log n, log m, seed
# the path whose compacted run reports the two edge kernels' launches
EDGE_PATH = "kout_hybrid_k2+liu_tarjan_PUFA"
# spanning forests on the big graph: (variant, (launches of PATH_KERNELS,
# finish rounds) on the default graph), asserted there. Every sampler draws
# jax.random's numbers from PRNGKey(0), so the sampled runs are asserted too
FOREST_PATHS = (
    (MAIN_VARIANT, ((0, 18, 14, 0, 0), 3)),
    ("none+uf_sync_full", ((0, 11, 8, 0, 0), 4)),
    ("kout_afforest_k2+uf_sync_full", ((0, 16, 12, 0, 0), 2)),
    ("bfs_c3+uf_sync_full", ((0, 9, 19, 0, 0), 4)),
    ("ldd_b0.2+uf_sync_full", ((0, 5, 166, 0, 0), 3)),
    ("kout_hybrid_k2+shiloach_vishkin", ((0, 18, 14, 0, 0), 3)),
)
# the stream phase's launches of PATH_KERNELS and finish rounds per batch
# size, and the dynamic phase's for (a) and (b), on the default graph
STREAM_COUNTS = {1 << 20: ((103, 145, 0, 0, 32), 103),
                 1 << 16: ((209, 290, 0, 0, 64), 209)}
DYNAMIC_COUNTS = {"a": ((0, 251, 206, 0, 0), 103),
                  "b": ((0, 200, 122, 0, 0), 61)}
# the placements phase's one-rank runs over NCCL: (variant, exec), and
# their launches of PATH_KERNELS and finish rounds on the default graph
PLACEMENT_RUNS = (
    (MAIN_VARIANT, "replicated(x)"), (MAIN_VARIANT, "sharded(x)"),
    (MAIN_VARIANT, "sharded(x):frontier=0"), (MAIN_VARIANT, "sharded(x):fused"),
    (MAIN_VARIANT, "sharded(x):overlap"), (MAIN_VARIANT, "sharded(x,y)"),
    ("none+uf_sync_full", "replicated(x)"), ("none+uf_sync_full", "sharded(x)"),
    (EDGE_PATH, "sharded(x)"),
)
PLACEMENT_COUNTS = {
    (MAIN_VARIANT, "replicated(x)"): ((8, 13, 1, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x)"): ((8, 13, 3, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):frontier=0"): ((8, 13, 1, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):fused"): ((8, 13, 3, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):overlap"): ((12, 17, 3, 0, 0), 5),
    (MAIN_VARIANT, "sharded(x,y)"): ((8, 13, 3, 0, 0), 2),
    ("none+uf_sync_full", "replicated(x)"): ((5, 8, 1, 0, 0), 2),
    ("none+uf_sync_full", "sharded(x)"): ((5, 8, 2, 0, 0), 2),
    (EDGE_PATH, "sharded(x)"): ((4, 16, 3, 5, 5), 2),
}
# the placements phase's stream under sharded(x), 2^20-edge batches
PLACEMENT_STREAM_COUNTS = ((135, 177, 63, 0, 0), 64)
# the placements phase's (e) dynamic streams (the dynamic phase's
# sliding_window) and (f) AMSF under each placement, one rank over NCCL;
# their launches of PATH_KERNELS and rounds on the default graph
PLACEMENT_DYN_EXECS = ("replicated(x)", "sharded(x)")
AMSF_SPECS = ("amsf", "amsf(skip=lmax)")
PLACEMENT_DYNAMIC_COUNTS = {"replicated(x)": ((0, 188, 159, 0, 0), 61),
                            "sharded(x)": ((0, 188, 159, 0, 0), 61)}
PLACEMENT_AMSF_COUNTS = {
    (e, spec): ((0, 332 if spec == "amsf" else 423, 535, 0, 0), 239)
    for e in PLACEMENT_DYN_EXECS for spec in AMSF_SPECS}
# (g): the serve phase's servers under this placement
SERVE_EXEC = "sharded(x)"
# the placements the two gloo ranks sharing the card run (MAIN_VARIANT)
GLOO_EXECS = ("replicated(x)", "sharded(x)", "sharded(x):frontier=0")
# the cells phase: the connectit cells (CONNECTIT_SHAPES) on planted graphs
# of CELL_BLOCKS components, generated CELL_CHUNK edge slots at a time;
# static_1b_edges timed CELL_TIMING_REPEATS times after its counted run; the
# ingest CLI stopped after CLI_STOP_STEPS batches and resumed; the legacy
# replicated factory's fixed rounds on the graph phase's graph
CELL_BLOCKS = 1 << 20
CELL_CHUNK = 1 << 26
CELL_TIMING_REPEATS = 3
CLI_STOP_STEPS = 20
# the ingest CLIs run at n = 2^(log_n - CLI_LOG_CUT) and 2^(log_m -
# CLI_LOG_CUT) edges: their host generation took 120 s at the graph
# phase's 2^22 / 2^25 (the script's time limit, since the lm mesh phase)
CLI_LOG_CUT = 2
SHIM_MESH_ROUNDS = 64
# each cell's launches of PATH_KERNELS in one run and its outer rounds, at
# the published sizes (the sharded cells at one rank)
CELL_COUNTS = {
    "static_1b_edges": ((12, 0, 0, 0, 0), 8),
    "ingest_256m_batch": ((8, 1, 0, 0, 0), 4),
    "static_8b_edges_sharded": ((13, 0, 7, 0, 0), 8),
    "static_8b_sharded_fused": ((13, 0, 7, 0, 0), 8),
}
# the connectit cells' finish (ConnectItConfig.finish, no sampling). Their
# recorded run kinds, at the published sizes: "cell" (static_1b_edges, then
# the exactness check's compression: 2^30 edges, 2^26 + 1 labels), "cell
# ingest" (ingest_256m_batch: its batch mirrored to 2^29 entries) and "cell
# sharded" (static_8b_edges_sharded at one rank: 2^31 edges, 2^28 + 1
# labels, frontier applies into the window plus a dump slot). Each keeps
# the first and the last call of CELL_FIRST_LAST's kernels and every call
# of the others.
CELL_VARIANT = "none+uf_sync_naive"
CELL_FIRST_LAST = ("hook_compress", "pointer_jump")
# recorded runs whose calls the kernels phase compares last, one run at a
# time with every other input freed: a cell's calls and their plain
# versions would not fit beside the other runs' calls
LATE_RUNS = ("cell", "cell ingest", "cell sharded")
# the tune phase: launches each block size is timed over with CUDA events
TUNE_EVENT_ITERS = 20
# samplings whose stats take no random draw, so the card's equal the CPU's
DETERMINISTIC_SAMPLINGS = ("none", "kout_afforest_k2")
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # float32 FLOP/s outside the tensor cores (FMA)
INT32_MAX = 2**31 - 1
# DLRM-RM2 (src/repro_torch/configs/legacy/dlrm_rm2.py) at full width, and
# its steps whose bags RECORDED's "bags" keeps
RM2_VOCAB = 1_000_000
DLRM_STEPS = ("serve_p99", "serve_bulk", "retrieval_cand", "train_batch")
BAG_MODES = ("sum", "mean", "max")
# embedding_bag against its plain version: a one-row float32 bag is a copy
# (exact); longer bags sum in another order (the reference test's
# tolerances, rtol = atol)
BAG_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
# the train phase: timed steps at full width; the vocab of its kernels-vs-
# plain step; that step's tolerance per leaf, relative to the leaf's largest
# magnitude (the table gradients are float32 sums of up to ~4,000 terms in
# another order: the kernel's runs against index_add_'s atomics), moments
# and parameters; and the CLI run's steps, checkpoint interval and failure
TRAIN_STEPS = 10
TRAIN_CHECK_VOCAB = 1 << 16
TRAIN_LEAF_TOL = {"moments": 1e-4, "params": 1e-6}
TRAIN_CLI = dict(steps=8, every=4, fail=6)


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2,
            budget_ms: float = 200.0) -> float:
    """Mean ms of one call over ``iters`` back-to-back calls (CUDA events).
    A call whose last warm-up took longer than ``budget_ms / iters`` (the
    plain versions and library calls on whole edge lists, 0.1-0.5 s each)
    is timed over fewer calls, at least 3, and a call of half a second or
    more (the plain versions on the cells' 2^29-2^31 edges) is that last
    warm-up's wall, the card synchronized around it."""
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    last = (time.perf_counter() - t0) * 1e3
    if last >= 500:
        return last
    iters = max(3, min(iters, int(budget_ms / max(last, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> dict:
    print(_card_line())
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] torch.cuda.get_device_name(0)={kind!r} count={count} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return {"platform": "gpu", "kind": kind, "count": count}


def _card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    records = _build.build_all()
    print(f"[build] {len(records)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for rec in records.values():
        print(f"[build] {rec.name}: {rec.seconds:.2f} s -> {rec.path.name}")
        for entry in _ptxas_summary(rec.ptxas):
            print(f"[build]   {entry}")
    for name in _build.SIGNATURES:
        _build.load(name)


def _ptxas_summary(lines) -> list:
    """One line per compiled kernel of ``nvcc -Xptxas -v``'s output:
    registers, shared memory and spills."""
    import re
    out, kernel, spills = [], None, "spills not reported"
    for line in lines:
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = re.search(r"\d([a-z_]+_kernel)", m.group(1))
            vec = re.search(r"ILi(\d+)E", m.group(1))
            kernel = ((name.group(1) if name else m.group(1))
                      + (f"<{vec.group(1)}>" if vec else ""))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kernel}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} bytes shared memory, "
                       f"{spills}")
            kernel, spills = None, "spills not reported"
    return out


def phase_graph(torch, log_n: int, log_m: int, seed: int):
    from repro_torch.graphs.containers import build_graph
    from repro_torch.graphs.generators import rmat_edges
    n, m = 1 << log_n, 1 << log_m
    t0 = time.perf_counter()
    edges = rmat_edges(n, m, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_graph(edges, n, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del edges
    print(f"[graph] rmat n=2^{log_n} edges=2^{log_m} seed={seed}: "
          f"m={g.m} directed (m_pad={g.m_pad}); host generation "
          f"{t_gen:.2f} s, build_graph on the card {t_build:.3f} s")
    return g


def _labels_with_virtual_min(torch, L: int, gen):
    """Chains, roots, and ~10% sprinkled -1 virtual minimums."""
    lab = torch.randint(0, L, (L,), generator=gen, device="cuda")
    lab = torch.minimum(lab, torch.arange(L, device="cuda"))
    lab[torch.rand(L, generator=gen, device="cuda") < 0.1] = -1
    return lab.to(torch.int32)


def _max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over the (tuple of) outputs; -1 if any output's
    shape or dtype differs from the plain version's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _main_path_inputs(torch, g) -> dict:
    """What the main path really hands its two accumulating kernels:
    hook_compress's first round in the sampler (identity labels, the ~2n
    k-out edges), in the compacted finish (the kept edges on relabel_lmax's
    output) and in the fused finish (all edges on the pinned labels); and
    scatter_min's call in min_vertex_labels (every vertex's id to its
    component's slot)."""
    from repro_torch import ConnectIt
    from repro_torch.core import driver
    from repro_torch.core.primitives import init_labels
    from repro_torch.core.sampling import _select_kout_edges

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    s_k, r_k = _select_kout_edges(g, gen, 2, "hybrid")
    gen.manual_seed(0)
    P_sampled = session._sampler(g, gen)
    P_pinned, keep, _, _ = driver._prep_sampled(P_sampled, g.senders,
                                                g.receivers)
    s_c, r_c, _ = driver._compact(g.senders, g.receivers, keep, g.n,
                                  pad="pow2")
    labels = session.connectivity(g)
    n = labels.shape[0]
    ext = torch.cat([labels, labels.new_tensor([n])])
    ids = torch.arange(n + 1, dtype=torch.int32, device="cuda")
    canon = (torch.full_like(ext, n), torch.where(ids < n, ext, n),
             torch.where(ids < n, ids, INT32_MAX))
    top = int(torch.bincount(labels.long()).max())
    print(f"[kernels] main-path inputs: sampled {s_k.shape[0]} k-out edges; "
          f"compacted {s_c.shape[0]} edges ({int(keep.sum())} kept); fused "
          f"{g.m_pad} edges, {int((P_pinned < 0).sum())} of {n + 1} labels "
          f"pinned to -1; canonicalization {top} of {n} vertices in one "
          f"component")
    return {"sampled": (init_labels(g.n, device="cuda"), s_k, r_k),
            "compacted": (P_pinned, s_c, r_c),
            "fused": (P_pinned, g.senders, g.receivers),
            "canonicalization": canon}


# runs whose calls of a kernel are recorded, and the kernel is timed on
# them: scatter_min on the heaviest finish traffic, Liu-Tarjan connect's
# write_min over the edge list (8 of CRFA's 9 launches) and label
# propagation's, and both passes of the spanning forest's hook_and_record
# (the labels, then edge ids into an INT_MAX buffer) in each round of a
# none+uf_sync_full forest run; edge_relabel on Liu-Tarjan PUFA's connect
# rounds (fused: the whole edge list, mostly -1 endpoints) and Stergiou's
# rounds (the rewritten endpoints prev[s], prev[r]); pointer_jump on the
# main path's calls; edge_rewrite on every path that calls it: the alter
# steps of Liu-Tarjan PUFA and CRFA (compacted: the kept edges; fused: the
# whole edge list, whose ends turn -1 round by round), Stergiou's endpoint
# rewrites (the original graph edges, every end live), and the main
# variant's first RECORDED_STREAM_BATCHES stream batches of STREAM_BATCH
# edges. The ingest phase's sources: the graph's edges in 8 chunks
# ("ingest": a rewrite a chunk, the head's k-out hooks and the finalize's
# hooks over the 2 x (2^24 + 1)-entry survivor buffer) and the power-law
# stream at 2^(log_m) edges over 4n vertices ("ingest powerlaw": every
# kernel on labels larger than the card's L2). The apps phase's amsf
# ("amsf": both forest passes a round and the compressions, each on the
# whole edge list; an evenly spaced sample of its calls, see
# RECORDED_SAMPLED_CALLS). The serve phase's servers ("serve": the static
# server's commits of at most SERVE_CAPS' 16,384 edges, 32,768 directed
# entries, against the preloaded 2^22 + 1 labels; "serve dynamic": the
# dynamic server's forest rounds, deletes included): an evenly spaced
# sample of the closed loop's calls, none of the preload's. The placements
# phase's one-rank runs ("placement sharded": sharded(x), whose frontier
# merge scatters into the label window plus one appended dump slot, and
# the PUFA run's calls on the edge block; "placement overlap":
# sharded(x):overlap, its finishes on the two half-blocks): every call but
# the canonicalization's. (kernel, variant, runs: "compacted" and "fused"
# connectivity, "forest", "stream", "ingest", "ingest powerlaw", "amsf",
# "serve", "serve dynamic", "placement sharded", "placement overlap",
# "placement dynamic", "placement amsf"). The placements phase's (e) and
# (f) under sharded(x) ("placement dynamic": RECORDED_DYNAMIC_STEPS steps of
# the sliding window; "placement amsf": amsf): an evenly spaced sample of
# their calls, the merged forest round's third scatter_min pass (into the
# stacked endpoint buffer of 2 (n + 1) + 1 slots) sampled apart.
GNN_RUNS = ("gnn full_graph_sm", "gnn molecule", "gnn minibatch_lg",
            "gnn ogb_products")
RECORDED = (
    ("scatter_min", "kout_hybrid_k2+liu_tarjan_CRFA", ("compacted", "fused")),
    ("scatter_min", "kout_hybrid_k2+label_prop", ("compacted", "fused")),
    ("scatter_min", "none+uf_sync_full", ("forest",)),
    ("scatter_min", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("scatter_min", MAIN_VARIANT, ("amsf", "serve dynamic",
                                   "placement sharded", "placement overlap",
                                   "placement dynamic", "placement amsf")),
    ("edge_relabel", "kout_hybrid_k2+liu_tarjan_PUFA", ("compacted", "fused",
                                                        "placement sharded")),
    ("edge_relabel", "none+stergiou", ("compacted",)),
    ("pointer_jump", MAIN_VARIANT, ("compacted", "fused", "amsf", "serve",
                                    "serve dynamic", "placement sharded",
                                    "placement dynamic", "placement amsf")),
    ("pointer_jump", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("edge_rewrite", "kout_hybrid_k2+liu_tarjan_PUFA", ("compacted", "fused",
                                                        "placement sharded")),
    ("edge_rewrite", "kout_hybrid_k2+liu_tarjan_CRFA", ("compacted", "fused")),
    ("edge_rewrite", "none+stergiou", ("compacted",)),
    ("edge_rewrite", MAIN_VARIANT, ("stream", "ingest", "serve")),
    ("edge_rewrite", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("hook_compress", MAIN_VARIANT, ("ingest", "serve", "placement sharded",
                                     "placement overlap")),
    ("hook_compress", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("hook_compress", CELL_VARIANT, LATE_RUNS),
    ("pointer_jump", CELL_VARIANT, ("cell", "cell ingest")),
    ("scatter_min", CELL_VARIANT, ("cell sharded",)),
    # DLRM-RM2 at full width: the grouped forward's call of one step of
    # each DLRM_STEPS ("bags"), and the train_batch step's grouped backward
    # call ("train")
    ("embedding_bag", "dlrm-rm2", ("bags",)),
    ("embedding_bag_backward", "dlrm-rm2", ("train",)),
    # the GNN family (phase gnn): GIN's train steps on full_graph_sm, the
    # molecule batch (every arch), minibatch_lg and ogb_products
    # (GNN_OGB_CALLS of its calls); gather_sum: GIN's aggregations and
    # their gradients in the same steps
    ("segment_sum", "gnn", GNN_RUNS),
    ("gather_sum", "gnn", GNN_RUNS),
)
# the placement a recorded run's session takes
RECORDED_EXEC = {"placement sharded": "sharded(x)",
                 "placement overlap": "sharded(x):overlap",
                 "placement dynamic": "sharded(x)",
                 "placement amsf": "sharded(x)"}
# the recorded runs that are one connectivity call (whose last scatter_min
# call, the canonicalization's, is left out)
CONNECTIVITY_RUNS = ("compacted", "fused", "placement sharded",
                     "placement overlap")
RECORDED_DYNAMIC_STEPS = 5
STREAM_BATCH = 1 << 20
RECORDED_STREAM_BATCHES = 8
# an amsf run makes ~480 scatter_min calls, each with two arrays of the
# whole edge list, and a served closed loop a few hundred small ones: in
# these runs a kernel keeps from RECORDED_SAMPLED_CALLS to twice that many
# of its calls, evenly spaced over the run (every 2^j-th call)
RECORDED_SAMPLED_CALLS = 4
SAMPLED_RUNS = ("amsf", "serve", "serve dynamic", "placement dynamic",
                "placement amsf")
# the serve phase: benchmarks/serve_bench.py's server settings and traffic
# at its full scale (_scale), over the §4 graph's vertices
SERVE_CAPS = dict(max_batch_edges=16384, max_batch_queries=8192,
                  flush_ms=0.5)
SERVE_TRAFFIC = dict(query_pairs=1024, insert_every=4, insert_edges=4096)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_OPEN_REQUESTS = 16, 48, 256
SERVE_LOADS = (0.25, 0.5, 0.75)
SERVE_PRELOAD = 1 << 20          # edges a preload commit
SERVE_DYNAMIC_PRELOAD = 4        # preload commits of the dynamic server
SERVE_DYNAMIC_LOG = 1 << 23
SERVE_DYNAMIC_REQUESTS = 16
SERVE_DELETE_FRAC = 0.25


def stream_edges(torch, g, seed: int) -> tuple:
    """The graph's undirected edges (s < r) on the card, permuted by
    ``seed``: what the stream and dynamic phases insert."""
    s, r = g.senders[: g.m], g.receivers[: g.m]
    keep = s < r
    s, r = s[keep], r[keep]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    perm = torch.randperm(s.shape[0], generator=gen, device="cuda")
    return s[perm], r[perm]


def sliding_batch_log(n: int) -> tuple:
    """The dynamic phase's sliding_window batch (2^20 at n = 2^22) and the
    edge-log capacity it runs with (2^23)."""
    batch = min(1 << 20, n // 4)
    return batch, 1 << (8 * batch - 1).bit_length()


def sliding_steps(torch, n: int, seed: int, steps: int = 8):
    """sliding_window(n, steps, batch, window=4, queries=2^16, seed): each
    step's (inserts, deletes, queries) host arrays and the process()
    arguments on the card."""
    import numpy as np

    from repro_torch.graphs.generators import sliding_window
    batch, _ = sliding_batch_log(n)
    for ins, dels, q in sliding_window(n, steps=steps, batch=batch,
                                       window=4, queries=1 << 16, seed=seed):
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (dels[:, 0], dels[:, 1], ins[:, 0], ins[:, 1],
                          q[:, 0], q[:, 1])]
        yield ins, dels, q, args


def ingest_chunk(log_m: int) -> int:
    """The ingest phase's chunk: 2^22 edges at the default 2^25."""
    return 1 << (log_m - 3)


def ingest_source(torch, g, seed: int, log_m: int):
    """The ingest phase's first source: the stream phase's edges as a host
    ArrayEdgeSource in chunks of ingest_chunk(log_m)."""
    from repro_torch.graphs import ArrayEdgeSource
    u, v = stream_edges(torch, g, seed)
    E = torch.stack([u, v], 1).cpu().numpy()
    return ArrayEdgeSource(E, g.n, chunk=ingest_chunk(log_m))


def powerlaw_source(g, lm: int, log_m: int):
    """powerlaw_chunks over 4n vertices, 2^lm edges, the ingest chunk."""
    from repro_torch.graphs.generators import powerlaw_chunks
    return powerlaw_chunks(4 * g.n, 1 << lm, chunk=ingest_chunk(log_m), seed=7)


def _recorded_calls(torch, g, names: tuple, variant: str, run: str,
                    log_m: int, seed: int = 0) -> dict:
    """{kernel: (calls, made, stride)} for each kernel of ``names`` in one
    ``run``
    of ``variant``: the arguments of its calls as ops hands them to the
    kernel's wrapper, (labels, senders, receivers, k) for hook_compress,
    (labels, idx, vals) for scatter_min, (labels, senders, receivers) for
    edge_relabel and edge_rewrite, (labels, k) for pointer_jump; ``made``
    the calls the run made. A SAMPLED_RUNS run keeps every
    ``stride``-th call (RECORDED_SAMPLED_CALLS); every other run keeps every
    call. A "serve" run records its closed loop only. A "placement" run
    runs on its RECORDED_EXEC placement, in a one-rank group made for it:
    one connectivity call, or the placements phase's dynamic steps or amsf,
    whose scatter_min calls into the stacked endpoint buffer are kept apart
    as "scatter_min stacked". The last scatter_min call of a connectivity
    run, the canonicalization's, is left out (it has its own input)."""
    from collections import defaultdict
    from contextlib import ExitStack
    from types import SimpleNamespace
    from unittest import mock

    from repro_torch import ConnectIt
    from repro_torch.graphs.generators import with_weights
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    calls = defaultdict(list)
    made = defaultdict(int)
    stride = defaultdict(lambda: 1)
    # a serve run records from its closed loop on, not its preload
    live = [not run.startswith("serve")]
    forest_rounds = run in ("placement dynamic", "placement amsf")

    def recorder(name):
        launch = ops.KERNELS[name]

        def record(*args, **kw):
            if not live[0]:
                return launch(*args, **kw)
            key = name
            if (forest_rounds and name == "scatter_min"
                    and args[0].shape[0] > 2 * (g.n + 1)):
                key = "scatter_min stacked"
            if (run in LATE_RUNS and name in CELL_FIRST_LAST
                    and len(calls[key]) == 2):
                calls[key][1] = (*args, *kw.values())  # the newest
            elif made[key] % stride[key] == 0:
                calls[key].append((*args, *kw.values()))
                if (run in SAMPLED_RUNS
                        and len(calls[key]) == 2 * RECORDED_SAMPLED_CALLS):
                    del calls[key][1::2]
                    stride[key] *= 2
            made[key] += 1
            return launch(*args, **kw)
        return record

    placement = run in RECORDED_EXEC
    session = ConnectIt(variant, exec=RECORDED_EXEC.get(run, "single"),
                        device="cuda")
    # ops reaches each wrapper through its module at call time: ops's name
    # for that module is patched, so the wrapper itself, and its launch
    # count, stay as they are
    with ExitStack() as stack:
        if placement or run in LATE_RUNS:
            stack.callback(multihost.shutdown)
        for module in {sys.modules[ops.KERNELS[x].__module__] for x in names}:
            attr = next(k for k, v in vars(ops).items() if v is module)
            patched = {x: recorder(x) for x in names
                       if ops.KERNELS[x].__module__ == module.__name__}
            stack.enter_context(mock.patch.object(
                ops, attr, SimpleNamespace(**{**vars(module), **patched})))
        if run == "forest":
            session.spanning_forest(g)
        elif run == "stream":
            u, v = stream_edges(torch, g, seed)
            st = session.stream(g.n)
            for i in range(RECORDED_STREAM_BATCHES):
                lo = i * STREAM_BATCH
                st.insert(u[lo: lo + STREAM_BATCH], v[lo: lo + STREAM_BATCH])
        elif run == "ingest":
            session.from_chunks(ingest_source(torch, g, seed, log_m))
        elif run == "ingest powerlaw":
            session.from_chunks(powerlaw_source(g, log_m, log_m))
        elif run in LATE_RUNS:
            _record_cell(torch, run, g.n.bit_length() - 1, seed)
        elif run in ("amsf", "placement amsf"):
            session.amsf(g, with_weights(g, seed=0), "amsf")
        elif run == "placement dynamic":
            st = session.stream(g.n, dynamic=True,
                                log=sliding_batch_log(g.n)[1])
            for *_, args in sliding_steps(torch, g.n, seed,
                                          RECORDED_DYNAMIC_STEPS):
                st.process(*args)
        elif run.startswith("serve"):
            dynamic = run == "serve dynamic"
            server = serve_server(session, g, dynamic, warmup=False)
            serve_preload(torch, server, g, seed, dynamic)
            live[0] = True
            serve_closed_loop(server, dynamic, seed)
        else:
            session.connectivity(g, fused=run == "fused")
    if "scatter_min" in names and run in CONNECTIVITY_RUNS:
        calls["scatter_min"] = calls["scatter_min"][:-1]
        made["scatter_min"] -= 1
    kept = [x for x in (*names, "scatter_min stacked") if x in calls]
    return {x: (tuple(calls[x]), made[x], stride[x]) for x in kept}


def _record_cell(torch, run: str, log_n: int, seed: int) -> None:
    """A recorded cell run (LATE_RUNS) on its planted graph at one rank:
    "cell" runs static_1b_edges, then the exactness check's compression;
    "cell ingest" ingest_256m_batch's batch and queries; "cell sharded"
    static_8b_edges_sharded on the whole label window."""
    from repro_torch.core.primitives import full_compress
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell

    arch = cell_arch(log_n)
    multihost.initialize()
    shape = {"cell": "static_1b_edges", "cell ingest": "ingest_256m_batch",
             "cell sharded": "static_8b_edges_sharded"}[run]
    n = arch.shapes[shape]["n"]
    cell = build_cell(arch, shape, make_smoke_mesh("cuda"), device="cuda")
    perm, starts = planted_structure(torch, n, cell_blocks(n), seed)
    ingest = run == "cell ingest"
    s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0],
                         seed + ingest, symmetric=not ingest)
    del perm, starts
    P0 = torch.arange(cell.args[0].shape[0], dtype=torch.int32,
                      device="cuda")
    if ingest:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        q = [torch.randint(0, n, (cell.args[3].shape[0],), generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(2)]
        cell.fn(P0, s, r, *q)
        return
    P, _ = cell.fn(P0, s, r)
    if run == "cell":
        full_compress(P)


def run_calls(name: str, fn, calls) -> tuple:
    """``fn``, a kernel's wrapper or its plain version, on each of
    ``calls`` in turn (pointer_jump's and hook_compress's hop count is a
    call's last item; edge_rewrite's two outputs a call are flattened)."""
    if name in ("pointer_jump", "hook_compress"):
        return tuple(fn(*c[:-1], k=c[-1]) for c in calls)
    if name == "edge_rewrite":
        return tuple(x for c in calls for x in fn(*c))
    return tuple(fn(*c) for c in calls)


def _recorded_sets(torch, g, log_m: int, seed: int,
                   late: str | None = None) -> list:
    """``[(kernel, key, calls)]`` of the RECORDED runs not in LATE_RUNS, or
    of the one LATE_RUNS run ``late``, each run once, recording every kernel
    RECORDED asks of it; a line each on what the calls hold."""
    from repro_torch.kernels.edge_relabel.ref import edge_rewrite_ref

    out = []
    wanted = {}
    # the DLRM run is recorded apart (_embedding_bag_backward_cases)
    connectivity = [x for x in RECORDED if x[0] in PATH_KERNELS]
    for name, variant, runs in connectivity:
        for run in runs:
            if (run == late) if late else run not in LATE_RUNS:
                wanted.setdefault((variant, run), []).append(name)
    recorded = {key: _recorded_calls(torch, g, tuple(names), *key, log_m,
                                     seed)
                for key, names in wanted.items()}
    for name, variant, runs in connectivity:
        finish = variant.split("+")[1]
        for run, part in ((run, part) for run in runs
                          if (variant, run) in recorded
                          for part in (name, f"{name} stacked")
                          if part in recorded[variant, run]):
            calls, made, stride = recorded[variant, run][part]
            key = f"{finish} {run}" + (" stacked" if part != name else "")
            if name == "hook_compress":
                what = (f"on labels ({calls[0][0].shape[0]},), edges per "
                        f"call {[c[1].shape[0] for c in calls]}, k = "
                        f"{sorted({c[3] for c in calls})}")
            elif name == "scatter_min":
                live = sum(int((v != INT32_MAX).sum()) for _, _, v in calls)
                what = (f"into ({calls[0][0].shape[0]},) of "
                        f"{calls[0][1].shape[0]} entries each, {live} "
                        f"entries not dumped in all")
            elif name == "edge_relabel":
                # live proposals: edges whose ends' labels disagree
                ends = [edge_rewrite_ref(*c) for c in calls]
                live = [int((a != b).sum()) for a, b in ends]
                neg = [int(((a < 0) & (b < 0)).sum()) for _, a, b in calls]
                what = (f"of {calls[0][1].shape[0]} edges each; live "
                        f"proposals {sum(live)} in all, per call {live}; "
                        f"edges with both ends -1 per call {neg}")
            elif name == "edge_rewrite":
                # the ends that gather a label (a -1 end is kept as it is)
                live = [int((a >= 0).sum()) + int((b >= 0).sum())
                        for _, a, b in calls]
                what = (f"of {calls[0][1].shape[0]} entries each, "
                        f"non-negative ends (of {2 * calls[0][1].shape[0]}) "
                        f"per call {live}")
                if run in ("stream", "serve"):
                    real = [int((a < g.n).sum()) for _, a, _ in calls]
                    what += (f"; the symmetrized pow2 batch, real entries "
                             f"per call {real}")
            else:
                what = (f"on labels ({calls[0][0].shape[0]},), k = "
                        f"{sorted({k for _, k in calls})}")
            kept = (f"{len(calls)}" if stride == 1 else
                     f"{len(calls)} of {made} (1 in {stride})")
            print(f"[kernels] {key} ({variant}): {kept} {name} calls {what}")
            out.append((name, key, calls))
    return out


def kernel_inputs(torch, g, gen, log_m: int, seed: int = 0) -> tuple:
    """(P, sets): the phase's labels P (chains, roots, ~10% -1) and, per
    kernel, the named tuples of calls it is timed on. hook_compress at k =
    0 and 3 (and 1 on the graph) on one (labels, senders, receivers) each:
    (a) "graph", P on the graph edges; (b) "floor", all labels -1 (a
    streamed read and one gather, no hook); (c) "identity", each edge
    proposing to its own sender with no slot contended; (d) the main
    path's first rounds. scatter_min on (n+1,) sanitized targets, ~10% carrying the
    dump sentinel as masked entries do: "uniform"; a synthetic "hub" taking
    ~98% of them with random values, which no path produces (the worst case
    for one slot); the canonicalization's own call. edge_relabel on the
    graph edges with P ("graph") and with ~10% of the endpoints -1 ("neg",
    as the alter step leaves them), and edge_rewrite on both. pointer_jump
    on P at k = 1 and 3. Then the calls of the RECORDED runs but
    LATE_RUNS' (``seed`` permutes the stream's and the ingest's edges;
    ``log_m`` sizes the ingest's chunks and power-law stream). Also used by
    compare_kernels.py."""
    L = g.n + 1
    m = g.m_pad
    P = _labels_with_virtual_min(torch, L, gen)
    idx = torch.randint(0, L, (L,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.randint(-1, L, (L,), generator=gen, device="cuda",
                         dtype=torch.int32)
    dumped = torch.rand(L, generator=gen, device="cuda") < 0.1
    idx[dumped] = L - 1
    vals[dumped] = INT32_MAX
    hub = torch.where(torch.rand(L, generator=gen, device="cuda") < 0.98,
                      L // 3, idx).to(torch.int32)
    hub[dumped] = L - 1
    s, r = g.senders, g.receivers
    s_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, s).to(torch.int32)
    r_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, r).to(torch.int32)
    main = _main_path_inputs(torch, g)
    hook = {"graph": (P, s, r), "floor": (torch.full_like(P, -1), s, r),
            "identity": (torch.arange(L, dtype=torch.int32, device="cuda"),
                         s, r),
            **{x: main[x] for x in ("sampled", "compacted", "fused")}}
    sets = {
        "hook_compress": {f"{x} k={k}": ((*args, k),)
                          for x, args in hook.items()
                          for k in ((0, 1, 3) if x == "graph" else (0, 3))},
        "scatter_min": {"uniform": ((P, idx, vals),), "hub": ((P, hub, vals),),
                        "canonicalization": (main["canonicalization"],)},
        "edge_relabel": {"graph": ((P, s, r),), "neg": ((P, s_neg, r_neg),)},
        "edge_rewrite": {"graph": ((P, s, r),), "neg": ((P, s_neg, r_neg),)},
        "pointer_jump": {"k=1": ((P, 1),), "k=3": ((P, 3),)},
    }
    for name, key, calls in _recorded_sets(torch, g, log_m, seed):
        sets[name][key] = calls
    return P, sets


def phase_kernels(torch, g, cap: int, log_m: int, seed: int = 0,
                  parent=None) -> dict:
    """Each kernel against its plain version at the main paths' shapes,
    and on the calls the paths really make (kernel_inputs); with
    ``parent``, the bag backward's cases also time the parent's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_relabel.ref import (
        edge_relabel_ref,
        edge_rewrite_ref,
    )
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    P, sets = kernel_inputs(torch, g, gen, log_m, seed)
    hook_sets, scatter_sets = sets["hook_compress"], sets["scatter_min"]
    relabel_sets, jump_sets = sets["edge_relabel"], sets["pointer_jump"]
    rewrite_sets = sets["edge_rewrite"]

    def hook_bytes(x):
        # per call: labels read and the result written once, every sender
        # read, and a receiver only where its sender's label is a slot that
        # can take a hook (a -1 label never hooks)
        total = 0
        for lab, e, _, _ in hook_sets[x]:
            hooks = 0
            for lo in range(0, e.shape[0], CELL_CHUNK):
                pu = lab[e[lo: lo + CELL_CHUNK].long()]
                hooks += int(((pu >= 0) & (pu < lab.shape[0])).sum())
            total += 4 * (2 * lab.shape[0] + e.shape[0] + hooks)
        return total

    def scatter_live(x):
        return sum(int((v != INT32_MAX).sum()) for _, _, v in scatter_sets[x])

    def scatter_bytes(x):
        # per call: labels read and written once, every value read, and an
        # index only where its value is not the dump sentinel
        return sum(4 * (2 * lab.shape[0] + v.shape[0])
                   for lab, _, v in scatter_sets[x]) + 4 * scatter_live(x)

    def gathered_slots(lab, a, b):
        # the distinct label slots that the call's non-negative ends read
        # (an end at or past L reads the last slot)
        ends = torch.cat([a[a >= 0], b[b >= 0]]).clamp_max(lab.shape[0] - 1)
        return int(torch.unique(ends).numel())

    def extended(lab):
        # labels with a -1 slot appended: a -1 index wraps onto it, so one
        # gather keeps -1 fixed (built outside the timed window)
        return torch.cat([lab, lab.new_tensor([-1])])

    def jump_library(x):
        # at k = 1 a call is one gather P <- Pe[P]
        if any(k != 1 for _, k in jump_sets[x]):
            return None
        ext = [(extended(lab), lab) for lab, _ in jump_sets[x]]
        return lambda: tuple(e[lab] for e, lab in ext)

    def rewrite_library(x):
        # two gathers a call, Pe[s] and Pe[r]
        calls = [(extended(lab), a, b) for lab, a, b in rewrite_sets[x]]
        return lambda: tuple(y for e, a, b in calls for y in (e[a], e[b]))

    def scatter_library(x):
        calls = [(base, i.long(), v) for base, i, v in scatter_sets[x]]
        return lambda: tuple(base.scatter_reduce(0, i, v, "amin",
                                                 include_self=True)
                             for base, i, v in calls)

    # per kernel: the settings swept (input sets and hop counts; "main" is
    # the one the JSON's top-level numbers report, as earlier runs did), the
    # CUDA wrapper and the plain version, bytes and operations for the
    # bound, and the one PyTorch call that computes the same function,
    # where there is one
    cases = {
        "hook_compress": {
            "sweep": tuple(hook_sets), "main": "graph k=3",
            "kernel": lambda x: run_calls("hook_compress",
                                          ops.KERNELS["hook_compress"],
                                          hook_sets[x]),
            "plain": lambda x: run_calls("hook_compress", hook_compress_ref,
                                         hook_sets[x]),
            "bytes": hook_bytes,
            "ops": lambda x: sum(4 * e.shape[0] + k * lab.shape[0]
                                 for lab, e, _, k in hook_sets[x]),
            "library": None,
            "source": "src/repro_torch/kernels/csrc/hook_compress.cu",
            "replaces": "src/repro/kernels/hook_compress/kernel.py:68",
            "shapes": lambda x: (f"{len(hook_sets[x])} x labels "
                                 f"({hook_sets[x][0][0].shape[0]},) edges "
                                 f"({hook_sets[x][0][1].shape[0]},)"),
        },
        "pointer_jump": {
            "sweep": tuple(jump_sets), "main": "k=1",
            "kernel": lambda x: run_calls("pointer_jump",
                                          ops.KERNELS["pointer_jump"],
                                          jump_sets[x]),
            "plain": lambda x: run_calls("pointer_jump", pointer_jump_ref,
                                         jump_sets[x]),
            # each call reads its labels and writes its result once
            "bytes": lambda x: sum(8 * lab.shape[0] for lab, _ in jump_sets[x]),
            "ops": lambda x: sum(k * lab.shape[0] for lab, k in jump_sets[x]),
            "library": jump_library,
            "source": "src/repro_torch/kernels/csrc/pointer_jump.cu",
            "replaces": "src/repro/kernels/pointer_jump/kernel.py:38",
            "shapes": lambda x: (f"{len(jump_sets[x])} x labels "
                                 f"({jump_sets[x][0][0].shape[0]},)"),
        },
        "scatter_min": {
            "sweep": tuple(scatter_sets), "main": "uniform",
            "kernel": lambda x: run_calls("scatter_min",
                                          ops.KERNELS["scatter_min"],
                                          scatter_sets[x]),
            "plain": lambda x: run_calls("scatter_min", scatter_min_ref,
                                         scatter_sets[x]),
            "bytes": scatter_bytes,
            "ops": scatter_live,
            "library": scatter_library,
            "source": "src/repro_torch/kernels/csrc/scatter_min.cu",
            "replaces": "src/repro/kernels/scatter_min/kernel.py:45",
            "shapes": lambda x: (f"{len(scatter_sets[x])} x labels "
                                 f"({scatter_sets[x][0][0].shape[0]},) "
                                 f"idx/vals ({scatter_sets[x][0][1].shape[0]},)"),
        },
        "edge_relabel": {
            "sweep": tuple(relabel_sets), "main": "graph",
            "kernel": lambda x: run_calls("edge_relabel",
                                          ops.KERNELS["edge_relabel"],
                                          relabel_sets[x]),
            "plain": lambda x: run_calls("edge_relabel", edge_relabel_ref,
                                         relabel_sets[x]),
            # per call: the label copy (read and written once) and both
            # endpoint arrays read once
            "bytes": lambda x: sum(4 * (2 * lab.shape[0] + 2 * a.shape[0])
                                   for lab, a, _ in relabel_sets[x]),
            "ops": lambda x: sum(4 * a.shape[0] for _, a, _ in relabel_sets[x]),
            "library": None,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:63",
            "shapes": lambda x: (f"{len(relabel_sets[x])} x labels "
                                 f"({relabel_sets[x][0][0].shape[0]},) edges "
                                 f"({relabel_sets[x][0][1].shape[0]},)"),
        },
        "edge_rewrite": {
            "sweep": tuple(rewrite_sets), "main": "graph",
            "kernel": lambda x: run_calls("edge_rewrite",
                                          ops.KERNELS["edge_rewrite"],
                                          rewrite_sets[x]),
            "plain": lambda x: run_calls("edge_rewrite", edge_rewrite_ref,
                                         rewrite_sets[x]),
            # per call: two endpoint arrays read and two written, and each
            # label slot a non-negative end reads, once
            "bytes": lambda x: sum(4 * (gathered_slots(*c) + 4 * c[1].shape[0])
                                   for c in rewrite_sets[x]),
            "ops": lambda x: sum(2 * a.shape[0] for _, a, _ in rewrite_sets[x]),
            "library": rewrite_library,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:96",
            "shapes": lambda x: (f"{len(rewrite_sets[x])} x labels "
                                 f"({rewrite_sets[x][0][0].shape[0]},) edges "
                                 f"({rewrite_sets[x][0][1].shape[0]},), two "
                                 f"outputs"),
        },
    }
    results = {}

    def measure(name, x) -> None:
        c = cases[name]
        got = c["kernel"](x)
        want = c["plain"](x)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        require(err == 0, f"{name} {x}: kernel disagrees with its plain "
                f"version (max_abs_err={err}; -1 is a shape or dtype "
                f"mismatch)")
        ms = time_ms(torch, lambda: c["kernel"](x), iters=20)
        # the check's call above is the plain version's first warm-up
        plain_ms = time_ms(torch, lambda: c["plain"](x), iters=5, warmup=1)
        lib_ms = None
        lib = c["library"](x) if c["library"] is not None else None
        if lib is not None:
            require(_max_abs_err(torch, lib(), want) == 0,
                    f"{name} {x}: the library call differs from the "
                    f"plain version")
            lib_ms = time_ms(torch, lib, iters=20)
        del got, want
        nbytes = c["bytes"](x)
        b_ms, b_by = bound_ms(nbytes, c["ops"](x))
        print(f"[kernels] {name} {x} {c['shapes'](x)}: exact match; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes} bytes at "
              f"3.35 TB/s) kernel/bound={ms / b_ms:.2f}")
        results.setdefault(name, {"inputs": {}})["inputs"][x] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        if x == c["main"]:
            results[name].update({
                "name": name, "route": "cuda", "source": c["source"],
                "replaces": c["replaces"], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "main": x})

    for name, c in cases.items():
        for x in c["sweep"]:
            measure(name, x)
    # the recorded calls of LATE_RUNS last, one run at a time, with every
    # other input freed: one cell's calls hold up to 2^31 edges (16 GiB)
    for d in sets.values():
        d.clear()
    del P
    for late in LATE_RUNS:
        torch.cuda.empty_cache()
        recorded = _recorded_sets(torch, g, log_m, seed, late)
        while recorded:
            name, key, calls = recorded.pop(0)
            sets[name][key] = calls
            del calls
            measure(name, key)
            sets[name].clear()
    torch.cuda.empty_cache()
    hook = results["hook_compress"]["inputs"]
    a, b, c0 = (hook[f"{x} k=0"]["ms"] for x in ("graph", "floor", "identity"))
    print(f"[kernels] hook pass (k=0: copy + hook) on the graph edges: "
          f"(a) phase labels {a:.4f} ms, (b) all -1 {b:.4f} ms, (c) identity "
          f"{c0:.4f} ms; (c) - (b) = {c0 - b:.4f} ms of label gathers and "
          f"uncontended proposals, (a) - (c) = {a - c0:.4f} ms of what the "
          f"phase labels add")
    bags, backward = _record_dlrm(torch, cap, seed)
    results["embedding_bag"] = _embedding_bag_cases(torch, cap, bags, parent)
    results["embedding_bag_backward"] = _embedding_bag_backward_cases(
        torch, cap, backward, parent)
    del bags, backward
    torch.cuda.empty_cache()
    results.update(_threefry_cases(torch, g))
    return results


def _wall_ms(torch, fn, n: int) -> float:
    """Median host wall of ``n`` synchronized calls of ``fn`` (after one
    warm call): what a caller that waits for its answer pays."""
    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[n // 2]


def _embedding_bag_cases(torch, cap: int, recorded: dict,
                         parent=None) -> dict:
    """embedding_bag (one launch for T tables, the dispatcher's
    embedding_bags) against its plain version, a call a table, on: one
    RM2-width table (T = 1) with synthetic ids; RECORDED's "bags" calls
    (``recorded``: the (T, B, L) ids of one serve_p99, serve_bulk,
    retrieval_cand and train_batch step over 26 float32 RM2 tables;
    serve_bulk's also on bfloat16 copies of the tables); and 26-table
    multi-hot and wrapped ids, each mode, float32 and bfloat16. Each case:
    CUDA-event ms and the host wall of a synchronized call, with ``parent``
    (--parent) the parent's embedding_bags in turns (parent, change,
    change, parent) and its output the same bits; the plain version's ms;
    the library's (one F.embedding_bag a table: no one PyTorch call
    computes the grouped function); the bound on each distinct row read
    once and on every gathered row. The JSON row is the recorded
    serve_bulk call."""
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.kernels.legacy.embedding_bag.ref import wrap_and_clamp
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models.dlrm import table_rows

    copies = {"change": repro_torch.kernels.legacy.embedding_bags}
    if parent is not None:
        copies = {"parent": parent.kernels.legacy.embedding_bags, **copies}

    def measure(tag: str, tables: list, idx, mode: str) -> dict:
        T, B, L = idx.shape
        D = tables[0].shape[1]
        size = tables[0].element_size()
        dtype = str(tables[0].dtype).removeprefix("torch.")
        tol = BAG_TOL[dtype]
        got = copies["change"](tables, idx, mode=mode)
        want = _plain_bags(tables, idx, mode)
        torch.cuda.synchronize()
        err = 0.0
        for t, (a, w) in enumerate(zip(got, want, strict=True)):
            require(a.shape == w.shape and a.dtype == w.dtype,
                    f"embedding_bag {tag}: table {t}'s bags' shape or dtype "
                    f"differ from the plain version's")
            err = max(err, float((a.float() - w.float()).abs().max()))
            if dtype == "float32" and L == 1:
                require(torch.equal(a, w), f"embedding_bag {tag}: table "
                        f"{t}'s one-row bags are not copies ({err})")
            else:
                require(torch.allclose(a.float(), w.float(), rtol=tol,
                                       atol=tol),
                        f"embedding_bag {tag}: table {t} disagrees with the "
                        f"plain version (max_abs_err={err}, rtol=atol={tol})")
        if parent is not None:
            for t, (a, p) in enumerate(zip(
                    got, copies["parent"](tables, idx, mode=mode))):
                require(torch.equal(a, p), f"embedding_bag {tag}: table {t} "
                        f"differs from the parent's bits")
        del got, want
        turns = {n: [] for n in copies}
        walls = {n: [] for n in copies}
        for n in list(copies) + list(copies)[::-1]:
            turns[n].append(time_ms(
                torch, lambda: copies[n](tables, idx, mode=mode), iters=20))
            walls[n].append(_wall_ms(
                torch, lambda: copies[n](tables, idx, mode=mode), 20))
        ms, wall = (sum(x["change"]) / 2 for x in (turns, walls))
        plain_ms = time_ms(torch, lambda: _plain_bags(tables, idx, mode),
                           iters=5)
        # F.embedding_bag skips padding_idx rows, so it computes this
        # function where every id lies in [0, rows) and the dump row is
        # zero, in sum and mean (max differs on all-dump bags)
        lib_ms = None
        in_range = all(bool(((i >= 0) & (i < t.shape[0])).all())
                       and not bool(t[-1].any())
                       for t, i in zip(tables, idx))
        if mode != "max" and in_range:
            src = [(i.long(), t, t.shape[0] - 1) for t, i in zip(tables, idx)]

            def lib():
                return [F.embedding_bag(i, t, mode=mode, padding_idx=p)
                        for i, t, p in src]
            for a, w in zip(lib(), _plain_bags(tables, idx, mode)):
                require(torch.allclose(a.float(), w.float(), rtol=tol,
                                       atol=tol),
                        f"F.embedding_bag {tag} differs from the plain "
                        f"version")
            lib_ms = time_ms(torch, lib, iters=20)
        # bytes: each distinct row the bags read once (zipfian ids repeat),
        # the ids and the outputs; beside it every gathered row
        distinct = sum(int(torch.unique(wrap_and_clamp(i, t.shape[0])).numel())
                       for t, i in zip(tables, idx))
        io = T * B * L * 4 + T * B * D * size
        nbytes = distinct * D * size + io
        gathered_ms = (T * B * L * D * size + io) / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = bound_ms(nbytes, T * B * L * D)
        out = {"max_abs_err": err, "ms": ms, "wall_ms": wall,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "gathered_rows_bound_ms": gathered_ms}
        vs = ""
        if parent is not None:
            out["parent_ms"], out["parent_wall_ms"] = (
                sum(x["parent"]) / 2 for x in (turns, walls))
            vs = (f" (parent {out['parent_ms']:.4f} -> change {ms:.4f}, "
                  f"host wall {out['parent_wall_ms']:.4f} -> {wall:.4f}, in "
                  f"turns)")
        print(f"[kernels] embedding_bag {tag}: {T} x table "
              f"{tuple(tables[0].shape)} {dtype} ids {(T, B, L)} {mode}: "
              f"max_abs_err={err} kernel_ms={ms:.4f} wall_ms={wall:.4f}{vs} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} (one "
              f"F.embedding_bag a table) bound_ms={b_ms:.4f} ({b_by}, "
              f"{nbytes} bytes at 3.35 TB/s: {distinct} distinct rows) "
              f"kernel/bound={ms / b_ms:.2f} gathered_rows_bound_ms="
              f"{gathered_ms:.4f}")
        return out

    inputs = {}
    # one table (T = 1), synthetic zipfian ids
    vocab = min(RM2_VOCAB, cap)
    rows, D = table_rows(vocab), 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    table = torch.randn(rows, D, generator=gen, device="cuda") / 8.0
    table[vocab:] = 0.0  # RM2's zero pad rows; the last is the dump row

    def zipf_ids(batch: int, bag: int, n_sparse: int = 1):
        s = RecsysStream(batch=batch, n_dense=13, n_sparse=n_sparse,
                         vocab=vocab, multi_hot=bag, seed=2).batch_at(
                             0, device="cuda")
        return s["sparse"].transpose(0, 1).contiguous()  # (T, B, L)

    def dumped_and_wrapped(ids):
        multi = ids.clone()
        multi[torch.rand(multi.shape, generator=gen, device="cuda") < 0.1] = (
            rows - 1)
        wrapped = multi.clone()
        u = torch.rand(wrapped.shape, generator=gen, device="cuda")
        wrapped[u < 0.01] = -1
        wrapped[(u >= 0.01) & (u < 0.02)] = -rows - 2
        wrapped[(u >= 0.02) & (u < 0.03)] = rows + 3
        return multi, wrapped

    with torch.inference_mode():
        multi, wrapped = dumped_and_wrapped(zipf_ids(min(65536, cap), 8))
        one = {"serve_bulk": zipf_ids(min(262144, cap), 1),
               "multi_hot": multi, "wrapped": wrapped}
        for dtype, tab in (("float32", table),
                           ("bfloat16", table.to(torch.bfloat16))):
            for ids_name, ids in one.items():
                for mode in BAG_MODES:
                    key = f"one table {ids_name} {dtype} {mode}"
                    inputs[key] = measure(key, [tab], ids, mode)
        del table, tab, one, multi, wrapped
        # 26 tables: the recorded calls, then multi-hot and wrapped ids
        for run, call in recorded.items():
            inputs[f"recorded {run}"] = measure(f"recorded {run}", *call)
        tables, idx, mode = recorded["serve_bulk"]
        halves = [t.to(torch.bfloat16) for t in tables]
        inputs["recorded serve_bulk bfloat16"] = measure(
            "recorded serve_bulk bfloat16", halves, idx, mode)
        multi, wrapped = dumped_and_wrapped(
            zipf_ids(min(65536, cap), 8, len(tables)))
        for dtype, tabs in (("float32", tables), ("bfloat16", halves)):
            for ids_name, ids in (("multi_hot", multi), ("wrapped", wrapped)):
                for mode in BAG_MODES:
                    key = f"{len(tabs)} tables {ids_name} {dtype} {mode}"
                    inputs[key] = measure(key, tabs, ids, mode)
        del halves, tables, tabs, multi, wrapped
    torch.cuda.empty_cache()
    main = inputs["recorded serve_bulk"]
    row = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/legacy/embedding_bag/kernel.py:47",
           "launches": 0, **{k: main[k] for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")},
           "inputs": inputs, "main": "recorded serve_bulk"}
    if parent is not None:
        row["parent_ms"] = main["parent_ms"]
    return row


# SASS opcodes by the SM pipe that runs them, and each pipe's results a
# clock on an SM of compute capability 9.0 (the CUDA C++ Programming
# Guide's table of arithmetic instruction throughput): 64 for 32-bit
# integer add, compare, shift and logic (the ALU pipe) and 64 for 32-bit
# integer multiply-add (IMAD, on the FMA pipe beside it), 16 for
# conversions and special functions; 4 schedulers issue 128 lanes' worth of
# instructions. The per-second rates scale SCALAR_OPS_PER_S, 128 float32
# FMA lanes x 2 FLOPs a clock on 132 SMs at 1.98 GHz.
SASS_ALU = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "IABS", "IMNMX",
            "VIMNMX", "VIADD", "PRMT", "POPC", "FLO", "BREV", "SGXT")
SASS_IMAD = ("IMAD", "IMUL")
SASS_XU = ("MUFU", "I2F", "F2I", "F2F", "FRND", "I2FP", "F2IP")
INT32_OPS_PER_S = SCALAR_OPS_PER_S / 4
XU_OPS_PER_S = SCALAR_OPS_PER_S / 16
ISSUE_PER_S = SCALAR_OPS_PER_S / 2


def sass_counts(lib: Path, fragment: str) -> dict:
    """Instructions of the kernel in ``lib`` whose name holds
    ``fragment`` (cuobjdump -sass, NOPs left out): ``{"alu", "imad", "xu",
    "all", "ops"}``, ``ops`` the opcodes and their counts."""
    import re
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ops, inside = Counter(), False
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            inside = fragment in head.group(1)
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if inside and op and op.group(1) != "NOP":
            ops[op.group(1)] += 1
    require(sum(ops.values()) > 0, f"cuobjdump: no kernel {fragment} in {lib}")
    return {"alu": sum(v for k, v in ops.items() if k in SASS_ALU),
            "imad": sum(v for k, v in ops.items() if k in SASS_IMAD),
            "xu": sum(v for k, v in ops.items() if k in SASS_XU),
            "all": sum(ops.values()), "ops": dict(ops.most_common())}


def sass_bound_ms(n: int, counts: dict) -> tuple:
    """The least time of n threads that each run ``counts`` once: the
    slowest of the pipes (each at its own rate) and the issue rate."""
    return max((n * counts["alu"] / INT32_OPS_PER_S * 1e3, "int32 ALU pipe"),
               (n * counts["imad"] / INT32_OPS_PER_S * 1e3, "IMAD pipe"),
               (n * counts["xu"] / XU_OPS_PER_S * 1e3, "conversion pipe"),
               (n * counts["all"] / ISSUE_PER_S * 1e3, "issue"))


def _threefry_cases(torch, g) -> dict:
    """The threefry kernels against their plain versions, bit for bit, at
    the main path's shapes: randint over the graph's n degrees (the k-out
    column of PRNGKey(0), as the main path draws it) and 2^22 bits (an
    LDD shift draw over n vertices, a DLRM table's slice)."""
    from repro_torch import random as trandom
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.threefry.ref import (
        threefry_bits_ref,
        threefry_randint_ref,
    )

    n = g.n
    lib = _build.build_all(names=("threefry",))["threefry"].path
    span = (g.indptr[1: n + 1] - g.indptr[:n]).clamp_min(1).contiguous()
    column = trandom.split(trandom.PRNGKey(0, device="cuda"), 1)[0]
    keys = [tuple(k) for k in trandom.split(column, 2).tolist()]
    words = tuple(trandom.PRNGKey(0, device="cuda").tolist())
    cases = {
        "threefry_randint": dict(
            kernel=lambda: ops.KERNELS["threefry_randint"](span, 0, *keys),
            plain=lambda: threefry_randint_ref(span, 0, *keys),
            nbytes=8 * n, n=n, fn="randint_kernel",
            shape=f"maxval ({n},) int32, the graph's degrees"),
        "threefry_bits": dict(
            kernel=lambda: ops.KERNELS["threefry_bits"](
                torch.empty(1 << 22, dtype=torch.int64, device="cuda"),
                *words, 0),
            plain=lambda: threefry_bits_ref(
                torch.empty(1 << 22, dtype=torch.int64, device="cuda"),
                *words, 0),
            nbytes=8 << 22, n=1 << 22, fn="bits_kernel",
            shape="2^22 int64 words"),
    }
    out = {}
    for name, c in cases.items():
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{name}: kernel disagrees with its "
                f"plain version")
        ms = time_ms(torch, c["kernel"], iters=20)
        plain_ms = time_ms(torch, c["plain"], iters=5)
        # operations: one thread an element (the grid covers n), each
        # running its kernel's SASS once
        sass = sass_counts(lib, c["fn"])
        o_ms, o_by = sass_bound_ms(c["n"], sass)
        b_ms, b_by = bound_ms(c["nbytes"], 0)
        if o_ms > b_ms:
            b_ms, b_by = o_ms, "operations"
        print(f"[kernels] {name} {c['shape']}: exact match; kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms=null (torch's "
              f"generators draw other numbers) bound_ms={b_ms:.4f} ({b_by}; "
              f"operations {o_ms:.4f} at the {o_by} rate) kernel/bound="
              f"{ms / b_ms:.2f}; SASS a thread: {sass['all']} instructions "
              f"(issue at {ISSUE_PER_S / 1e12:.2f} T/s), {sass['alu']} on "
              f"the int32 ALU pipe and {sass['imad']} IMAD, each at "
              f"{INT32_OPS_PER_S / 1e12:.2f} TOP/s, {sass['xu']} "
              f"conversions and special functions at "
              f"{XU_OPS_PER_S / 1e12:.2f} TOP/s; opcodes {sass['ops']}")
        out[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": "none: no Pallas kernel (jax.random's threefry2x32, "
                        "plain jnp that XLA fuses)",
            "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return out


def _bag_backward_tol(torch, table, idx, grad_out, mode: str):
    """Per element, the worst case of two float32 sums of the same k terms
    in different orders: 2 (k - 1) 2^-24 sum|term|, k the positions that
    read the row (the plain version's atomics add in any order, the
    kernel's in its runs' order)."""
    from repro_torch.kernels.legacy.embedding_bag.ref import (
        embedding_bag_backward_ref,
        wrap_and_clamp,
    )
    mag = embedding_bag_backward_ref(table, idx, grad_out.abs(), mode)
    k = torch.bincount(wrap_and_clamp(idx, table.shape[0]).flatten(),
                       minlength=table.shape[0]).to(torch.float32)
    return 2 * (k[:, None] - 1).clamp(min=0) * 2.0 ** -24 * mag


def _plain_bags(tables, idx, mode: str = "sum") -> list:
    """DLRM's grouped bags through the plain version, table by table."""
    from repro_torch.kernels.legacy.embedding_bag.ref import embedding_bag_ref
    return [embedding_bag_ref(t, i, mode) for t, i in zip(tables, idx)]


def load_package(name: str, path: Path):
    """Import the package directory ``path`` as the module ``name`` (a
    parent commit's repro_torch beside this checkout's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def bag_backward_of(pkg):
    """A repro_torch copy's grouped bag backward as ``f(tables, idx,
    grad_outs, mode)`` → the T gradients."""
    import importlib
    k = importlib.import_module(
        f"{pkg.__name__}.kernels.legacy.embedding_bag.kernel")
    return lambda tables, idx, gs, mode: k.embedding_bags_backward(
        tables, idx, gs, mode=mode)


class _BagRecorder:
    """The grouped bag kernels' calls made while it is entered, each still
    launched as it was: ``forward[tag]`` the (tables, idx, mode) of every
    grouped forward (embedding_bags) made under the ``tag`` set last,
    ``backward`` the (tables, idx, grad_outs, mode) of every grouped
    backward (embedding_bags_backward)."""

    def __init__(self):
        self.tag = None
        self.forward = {}
        self.backward = []

    def __enter__(self):
        from types import SimpleNamespace

        import repro_torch.kernels.legacy as legacy

        # the dispatcher reaches the wrappers through the legacy package's
        # name for their module: that name is patched, so the wrappers
        # themselves, and their launch counts, stay as they are
        self._legacy, self._module = legacy, legacy._embedding_bag_kernel
        fwd = self._module.embedding_bags
        bwd = self._module.embedding_bags_backward

        def forward(tables, idx, *, mode="sum"):
            self.forward.setdefault(self.tag, []).append(
                (list(tables), idx.clone(), mode))
            return fwd(tables, idx, mode=mode)

        def backward(tables, idx, grad_outs, *, mode="sum"):
            # grad_outs are the rows of the interaction's input, a stride
            # apart: the clones are contiguous
            self.backward.append((list(tables), idx.clone(),
                                  [g.clone() for g in grad_outs], mode))
            return bwd(tables, idx, grad_outs, mode=mode)
        legacy._embedding_bag_kernel = SimpleNamespace(
            **{**vars(self._module), "embedding_bags": forward,
               "embedding_bags_backward": backward})
        return self

    def __exit__(self, *exc):
        self._legacy._embedding_bag_kernel = self._module


def _rm2_config(cap: int, vocab: int = RM2_VOCAB):
    """DLRM-RM2's config, its vocab cut to ``min(vocab, cap)``."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch("dlrm-rm2").model
    v = min(vocab, cap)
    if v < RM2_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_sizes=(v,) * cfg.n_sparse)
    return cfg


def _record_dlrm(torch, cap: int, seed: int) -> tuple:
    """RECORDED's "bags" and "train" runs, on one full-width DLRM-RM2 from
    init_dlrm(key=PRNGKey(seed)): the grouped forward's call of one
    serve_p99, serve_bulk and retrieval_cand step (each on RecsysStream's
    batch 0 at its cell's shape, as the dlrm phase's) and of one
    train_batch step, whose grouped backward call is recorded too. Returns
    ``({step: (tables, idx, mode)}, [backward calls])``; the calls keep the
    tables referenced, the rest is freed."""
    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell, train_step
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models import dlrm as dlrm_mod

    arch = get_arch("dlrm-rm2")
    cfg = _rm2_config(cap)
    model = dlrm_mod.init_dlrm(cfg, key=trandom.PRNGKey(seed, device="cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with _BagRecorder() as rec:
        # the train step last: it updates the tables in place
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand",
                      "train_batch"):
            cell = build_cell(arch, shape)
            b = RecsysStream(batch=min(cell.args[0].shape[0], cap),
                             n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                             vocab=cfg.vocab_sizes[0],
                             multi_hot=cfg.multi_hot,
                             seed=seed).batch_at(0, device="cuda")
            rec.tag = shape
            if shape == "train_batch":
                train_step(model, optim.init_adam(model.params()),
                           b["dense"], b["sparse"], b["labels"])
            elif shape == "retrieval_cand":
                cand = torch.randn(min(cell.args[2].shape[0], cap),
                                   cfg.embed_dim, generator=gen,
                                   device="cuda")
                cell.fn(model, b["dense"], b["sparse"], cand)
            else:
                cell.fn(model, b["dense"], b["sparse"])
    torch.cuda.synchronize()
    require(all(len(rec.forward.get(x, ())) == 1 for x in DLRM_STEPS),
            f"bags: forward calls a step "
            f"{ {k: len(v) for k, v in rec.forward.items()} }, want one of "
            f"each of {DLRM_STEPS}")
    require(len(rec.backward) == 1 and len(rec.backward[0][0]) == 26,
            f"train: {len(rec.backward)} grouped backward calls of "
            f"{[len(c[0]) for c in rec.backward]} tables, want 1 of 26")
    forward = {x: rec.forward[x][0] for x in DLRM_STEPS}
    for x, (tables, idx, mode) in forward.items():
        print(f"[kernels] recorded bags {x}: one grouped forward call, "
              f"{len(tables)} tables {tuple(tables[0].shape)} "
              f"{str(tables[0].dtype).removeprefix('torch.')}, ids "
              f"{tuple(idx.shape)}, {mode}")
    backward = rec.backward
    del model, rec, cand, b
    torch.cuda.empty_cache()
    return forward, backward


def _embedding_bag_backward_cases(torch, cap: int, recorded: list,
                                  parent=None) -> dict:
    """The bag backward against its plain version: synthetic ids on one
    RM2-width table for each mode (one-table calls), then ``recorded``, the
    grouped call of one full-width train step (RECORDED's "train": 26
    tables; the JSON's row).
    The plain version on the card is index_add_ of each position's share, a
    table at a time; the library call, where one computes the function
    (sum, L = 1), index_add_ into a zeroed gradient a table. With
    ``parent`` (a repro_torch copy: --parent) each case also times the
    parent's backward in turns, parent, change, change, parent."""
    import repro_torch
    from repro_torch.kernels.legacy.embedding_bag.ref import (
        embedding_bag_backward_ref,
        wrap_and_clamp,
    )
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models.dlrm import table_rows

    copies = {"change": bag_backward_of(repro_torch)}
    if parent is not None:
        copies = {"parent": bag_backward_of(parent), **copies}
    launch = copies["change"]
    vocab = min(RM2_VOCAB, cap)
    rows, D = table_rows(vocab), 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    table = torch.randn(rows, D, generator=gen, device="cuda") / 8.0
    table[vocab:] = 0.0

    def zipf_ids(batch: int, bag: int):
        s = RecsysStream(batch=batch, n_dense=13, n_sparse=1, vocab=vocab,
                         multi_hot=bag, seed=4).batch_at(0, device="cuda")
        return s["sparse"][:, 0].contiguous()

    B = min(65536, cap)
    train_ids = zipf_ids(B, 1)
    hub = train_ids.clone()
    hub[torch.rand(hub.shape, generator=gen, device="cuda") < 0.5] = 0
    multi = zipf_ids(B, 8)
    multi[torch.rand(multi.shape, generator=gen, device="cuda") < 0.1] = (
        rows - 1)
    wrapped = multi.clone()
    u = torch.rand(wrapped.shape, generator=gen, device="cuda")
    wrapped[u < 0.01] = -1
    wrapped[(u >= 0.01) & (u < 0.02)] = -rows - 2
    wrapped[(u >= 0.02) & (u < 0.03)] = rows + 3
    synthetic = {"train_shape": train_ids, "hub": hub, "multi_hot": multi,
                 "wrapped": wrapped}
    zero_ms = time_ms(torch, lambda: torch.zeros_like(table), iters=20)
    print(f"[kernels] embedding_bag_backward: zeroing one ({rows}, {D}) "
          f"float32 gradient alone {zero_ms:.4f} ms (bound "
          f"{rows * D * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")

    def measure(tag: str, call: tuple) -> dict:
        """call: (tables, idx (T, B, L), grad_outs, mode), one grouped
        backward; timed back to back."""
        tables, idx, gs, mode = call
        per_table = list(zip(tables, idx, gs))
        got, again = launch(*call), launch(*call)
        want = [embedding_bag_backward_ref(t, i, g, mode)
                for t, i, g in per_table]
        torch.cuda.synchronize()
        err = 0.0
        for (t, i, g), a, b, w in zip(per_table, got, again, want):
            require(torch.equal(a, b), f"embedding_bag_backward {tag}: two "
                    f"runs of one call differ")
            over = (a - w).abs() - _bag_backward_tol(torch, t, i, g, mode)
            require(bool((over <= 0).all()),
                    f"embedding_bag_backward {tag}: kernel disagrees with "
                    f"its plain version beyond the reordering bound "
                    f"(by {float(over.max())})")
            err = max(err, float((a - w).abs().max()))
        del got, again
        if parent is not None:
            for (t, i, g), a, w in zip(per_table, copies["parent"](*call),
                                       want):
                over = (a - w).abs() - _bag_backward_tol(torch, t, i, g, mode)
                require(bool((over <= 0).all()), f"the parent's backward "
                        f"{tag} disagrees with the plain version")
        del want
        names = list(copies)
        turns = {n: [] for n in names}
        for n in names + names[::-1]:
            turns[n].append(time_ms(torch, lambda: copies[n](*call),
                                    iters=10))
        ms = sum(turns["change"]) / 2
        parent_ms = sum(turns["parent"]) / 2 if parent is not None else None
        plain_ms = time_ms(torch, lambda: [
            embedding_bag_backward_ref(t, i, g, mode)
            for t, i, g in per_table], iters=5)
        lib_ms = None
        # index_add_ computes the function where every bag is one id inside
        # its table, summed
        if mode == "sum" and idx.shape[2] == 1 and all(
                bool(((i >= 0) & (i < t.shape[0])).all())
                for t, i, _ in per_table):
            src = [(t, i.long().flatten(), g) for t, i, g in per_table]

            def lib():
                return [torch.zeros_like(t).index_add_(0, i, g)
                        for t, i, g in src]
            for a, (t, i, g) in zip(lib(), per_table):
                over = (a - embedding_bag_backward_ref(t, i, g, mode)).abs() \
                    - _bag_backward_tol(torch, t, i, g, mode)
                require(bool((over <= 0).all()),
                        f"index_add_ {tag} differs from the plain version")
            lib_ms = time_ms(torch, lib, iters=10)
        # bytes: each table's ids and grad_out read once, its whole
        # gradient written once (the zeros, ~all of it), and for max the
        # distinct table rows read; the touched rows alone beside it
        total = touched = 0
        for t, i, g in per_table:
            u = int(torch.unique(wrap_and_clamp(i, t.shape[0])).numel())
            own = i.numel() * 4 + g.numel() * 4 + (
                u * t.shape[1] * 4 if mode == "max" else 0)
            total += own + t.numel() * 4
            touched += own + u * t.shape[1] * 4
        b_ms, b_by = bound_ms(total, idx.numel() * D)
        vs = "" if parent_ms is None else (
            f" (parent {parent_ms:.4f} -> change {ms:.4f} in turns: "
            f"{parent_ms / ms:.2f}x)")
        print(f"[kernels] embedding_bag_backward {tag}: {len(tables)} x "
              f"table {tuple(tables[0].shape)} ids {tuple(idx.shape)}: "
              f"within the reordering bound (max_abs_err={err:.3e}), the "
              f"same bits twice; kernel_ms={ms:.4f}{vs} plain_ms="
              f"{plain_ms:.4f} library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms="
              f"{b_ms:.4f} ({b_by}, {total} bytes at 3.35 TB/s) "
              f"kernel/bound={ms / b_ms:.2f} touched_rows_bound_ms="
              f"{touched / HBM_BYTES_PER_S * 1e3:.4f} zeroing_ms="
              f"{zero_ms * len(tables):.4f}")
        out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "zeroing_ms": zero_ms * len(tables)}
        if parent_ms is not None:
            out["parent_ms"] = parent_ms
        return out

    inputs = {}
    for ids_name, ids in synthetic.items():
        g = torch.randn(ids.shape[0], D, generator=gen, device="cuda") / B
        for mode in BAG_MODES:
            inputs[f"{ids_name} {mode}"] = measure(
                f"{ids_name} {mode}", ([table], ids[None], [g], mode))
    del table, synthetic
    torch.cuda.empty_cache()
    inputs["train"] = main = measure("recorded train", recorded[0])
    row = {"name": "embedding_bag_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "replaces": "none: no Pallas kernel (the reference's gradient "
                       "is XLA's transpose of the gather at "
                       "src/repro/kernels/legacy/embedding_bag/ref.py:20)",
           "launches": 0, "max_abs_err": main["max_abs_err"],
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"], "inputs": inputs,
           "main": "train"}
    if parent is not None:
        row["parent_ms"] = main["parent_ms"]
    return row


def phase_small(torch) -> None:
    """The whole variant grid on a small graph: card vs CPU vs scipy."""
    import numpy as np

    from repro_torch import ConnectIt, enumerate_variants
    from repro_torch.graphs import components_oracle, generators as gen
    g_cpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cpu")
    g_gpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cuda")
    expect = components_oracle(g_cpu)
    variants = [str(v) for v in enumerate_variants()]
    t0 = time.perf_counter()
    for variant in variants:
        deterministic = variant.split("+")[0] in DETERMINISTIC_SAMPLINGS
        for fused in (False, True):
            a, sa = ConnectIt(variant, device="cpu").connectivity(
                g_cpu, fused=fused, return_stats=True)
            b, sb = ConnectIt(variant, device="cuda").connectivity(
                g_gpu, fused=fused, return_stats=True)
            require(np.array_equal(a.numpy(), expect),
                    f"small {variant} fused={fused}: CPU path != scipy")
            require(np.array_equal(b.cpu().numpy(), expect),
                    f"small {variant} fused={fused}: card != scipy")
            # the random draws (k-out columns, BFS sources, LDD shifts) of
            # the CPU and CUDA generators differ, and so may those stats
            require(not deterministic or sa == sb,
                    f"small {variant} fused={fused}: stats differ: cpu {sa} "
                    f"card {sb}")
    print(f"[small] all {len(variants)} variants of enumerate_variants() x "
          f"compacted/fused on rmat n=2^12: card == CPU path == scipy, stats "
          f"equal on the deterministic ones ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    keys = (g_cpu.senders[: g_cpu.m].numpy().astype(np.int64) * (g_cpu.n + 1)
            + g_cpu.receivers[: g_cpu.m].numpy())
    forest = [v for v in enumerate_variants() if v.forest_capable]
    for spec in forest:
        variant = str(spec)
        a = ConnectIt(variant, device="cpu").spanning_forest(g_cpu)
        b = ConnectIt(variant, device="cuda").spanning_forest(g_gpu)
        for edges, where in ((a, "CPU path"), (b, "card")):
            check_forest(edges, g_cpu.n, expect, keys,
                         f"small forest {variant} ({where})")
        require(variant.split("+")[0] not in DETERMINISTIC_SAMPLINGS
                or np.array_equal(a, b),
                f"small forest {variant}: the card's edges differ from the "
                f"CPU path's")
    print(f"[small] spanning_forest of all {len(forest)} forest-capable "
          f"variants on rmat n=2^12: valid forests on the card and the CPU "
          f"path, equal row for row on the deterministic samplings "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_oracle(g) -> tuple:
    """scipy's labels of the big graph (min vertex ids) and its sorted edge
    keys s * (n + 1) + r, both on the host."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    _, lab = _scipy_labels(g.n, torch.stack([g.senders[: g.m],
                                             g.receivers[: g.m]], 1))
    expect = canonical(lab)
    # build_graph orders the edges by this key, so the keys are sorted
    keys = (g.senders[: g.m].cpu().numpy().astype(np.int64) * (g.n + 1)
            + g.receivers[: g.m].cpu().numpy())
    print(f"[oracle] scipy oracle on the host: {time.perf_counter() - t0:.2f} "
          f"s, {len(np.unique(expect))} components")
    return expect, keys


def phase_paths(torch, g, expect, results: dict, exact: bool) -> None:
    """Each path of PATHS on the big graph against the scipy oracle, with
    the kernels it must launch; on the default graph (``exact``) also its
    launch counts and finish rounds."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    for variant, modes, want_counts, want_rounds in PATHS:
        session = ConnectIt(variant, device="cuda")
        for fused in modes:
            path = "fused" if fused else "compacted"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            labels, stats = session.connectivity(g, fused=fused,
                                                 return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            require(labels.shape == (g.n,) and labels.dtype == torch.int32,
                    f"{variant} {path}: labels shape {tuple(labels.shape)}")
            require(np.array_equal(labels.cpu().numpy(), expect),
                    f"{variant} {path}: labels differ from the scipy oracle")
            got_counts = tuple(counts[k] for k in PATH_KERNELS)
            for name, want in zip(PATH_KERNELS, want_counts):
                require(want == 0 or counts[name] > 0,
                        f"{variant} {path}: kernel {name} never launched")
            same = (got_counts == want_counts
                    and stats.finish_rounds == want_rounds)
            if exact:
                require(same, f"{variant} {path}: launches {got_counts} and "
                        f"finish_rounds {stats.finish_rounds}, want "
                        f"{want_counts} and {want_rounds}")
            elif not same:
                print(f"[paths] {variant} {path}: launches {got_counts} and "
                      f"finish_rounds {stats.finish_rounds} differ from the "
                      f"default graph's {want_counts} and {want_rounds} "
                      f"(not asserted: another graph)")
            print(f"[paths] {variant} {path}: labels == scipy oracle; "
                  f"wall {wall:.4f} s; finish_rounds {stats.finish_rounds}; "
                  f"peak device memory {peak} bytes; launches "
                  f"{json.dumps(counts)}")
            print(f"[paths]   stats {stats}")
            if not fused and variant == MAIN_VARIANT:
                require(counts["threefry_randint"] > 0,
                        f"{variant}: the k-out column was not drawn by the "
                        f"threefry_randint kernel")
                for name in (*UF_KERNELS, "threefry_randint"):
                    results[name]["launches"] = counts[name]
            if not fused and variant == EDGE_PATH:
                for name in ("edge_relabel", "edge_rewrite"):
                    results[name]["launches"] = counts[name]


def phase_threefry(torch, g, card: str) -> None:
    """repro_torch.random on the card against the CPU, bit for bit; the
    main path's k-out selection under PRNGKey(0) on the card against a CPU
    copy of the graph; the main path's wall with its default key beside the
    same path drawing from a torch.Generator, and each column draw alone."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch import random as trandom
    from repro_torch.core.sampling import _random_offsets, _select_kout_edges
    from repro_torch.graphs import graph_from_arrays

    n = g.n
    deg = g.indptr[1: n + 1] - g.indptr[:n]
    span, span_cpu = deg.clamp_min(1), deg.cpu().clamp_min(1)
    for seed in (0, 1, 2**31 - 1):
        ck = trandom.PRNGKey(seed, device="cpu")
        gk = trandom.PRNGKey(seed, device="cuda")
        pairs = (("split", lambda k: trandom.split(k, 7)),
                 ("fold_in", lambda k: trandom.fold_in(k, 123)),
                 ("bits", lambda k: trandom.bits(k, (1 << 20,))),
                 ("randint", lambda k: trandom.randint(
                     k, (n,), 0, span if k.is_cuda else span_cpu)))
        for what, fn in pairs:
            require(torch.equal(fn(gk).cpu(), fn(ck)),
                    f"threefry {what} of seed {seed}: the card's differ "
                    f"from the CPU's")
    print(f"[threefry] keys (split, fold_in), 2^20 bits and randint over "
          f"the graph's {n} degrees as maxval: the card's equal the CPU's "
          f"for seeds 0, 1, 2^31 - 1")
    host = graph_from_arrays(*(x.cpu().numpy() for x in (
        g.senders, g.receivers, g.indptr, g.indices)), n, g.m, device="cpu")
    t0 = time.perf_counter()
    want = _select_kout_edges(host, trandom.PRNGKey(0, device="cpu"), 2,
                              "hybrid")
    cpu_s = time.perf_counter() - t0
    got = _select_kout_edges(g, trandom.PRNGKey(0, device="cuda"), 2,
                             "hybrid")
    require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
            "threefry: the graph's k-out selection on the card differs "
            "from the CPU's")
    del host, want, got
    print(f"[threefry] kout_hybrid_k2 selection of the graph under "
          f"PRNGKey(0) ({2 * n} directed edges): the card's equals the "
          f"CPU's ({cpu_s:.2f} s there)")
    session = ConnectIt(MAIN_VARIANT, device="cuda")
    gen = torch.Generator(device="cuda")
    walls = {"key": [], "generator": []}
    for draw in ("key", "generator", "generator", "key") * 2:
        kw = {} if draw == "key" else {"generator": gen.manual_seed(0)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.connectivity(g, **kw)
        torch.cuda.synchronize()
        walls[draw].append(time.perf_counter() - t0)
    key = trandom.split(trandom.PRNGKey(0, device="cuda"), 1)[0]
    key_ms = time_ms(torch, lambda: trandom.randint(key, (n,), 0, span),
                     iters=10)
    gen_ms = time_ms(torch, lambda: _random_offsets(n, deg,
                                                    gen.manual_seed(0)),
                     iters=10)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[threefry] {MAIN_VARIANT} compacted, median of 4 each in turns: "
          f"wall {med['key']:.4f} s with the default key (jax.random's "
          f"draws) beside {med['generator']:.4f} s drawing from a "
          f"torch.Generator; the random column alone {key_ms:.4f} ms "
          f"(threefry randint over {n} rows) beside {gen_ms:.4f} ms "
          f"(torch.randint); card {card}")


def canonical(labels):
    """Min-vertex-id labels of the partition that ``labels`` (n,) gives:
    the first vertex of a label is its component's smallest."""
    import numpy as np
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


def check_forest(edges, n: int, expect, keys, what: str) -> None:
    """A spanning forest of the graph whose scipy labels are ``expect`` and
    sorted edge keys ``keys``, on the host without a Python loop: n -
    #components edges, whose components are the graph's (so, with that
    size, acyclic), each an edge of the graph."""
    import numpy as np

    ncomp = int((expect == np.arange(n)).sum())
    require(edges.ndim == 2 and edges.shape == (n - ncomp, 2),
            f"{what}: forest of shape {edges.shape}, want ({n - ncomp}, 2)")
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    require(bool(((u >= 0) & (u < n) & (v >= 0) & (v < n)).all()),
            f"{what}: a forest endpoint is not a vertex")
    _, lab = _scipy_labels(n, edges)
    require(np.array_equal(canonical(lab), expect),
            f"{what}: the forest's components differ from the graph's")
    key = np.sort(u * (n + 1) + v)  # sorted: the search walks keys in order
    at = np.searchsorted(keys, key).clip(0, len(keys) - 1)
    require(bool((keys[at] == key).all()),
            f"{what}: a forest edge is not an edge of the graph")


def _check_counts(what: str, counts: dict, rounds: int, want, exact: bool,
                  kernels=PATH_KERNELS) -> None:
    """Assert launches per kernel and rounds on the default graph, where
    ``want`` = (launches, rounds) is known; print them otherwise."""
    got = tuple(counts[k] for k in kernels)
    if exact and want is not None:
        require((got, rounds) == want,
                f"{what}: launches {got} and rounds {rounds}, want "
                f"{want[0]} and {want[1]} ({kernels})")
    elif want is not None and (got, rounds) != want:
        print(f"[check] {what}: launches {got} and rounds {rounds} differ "
              f"from the default graph's {want} (not asserted here)")


def phase_forest(torch, g, expect, keys, exact: bool) -> None:
    """Each spanning forest of FOREST_PATHS on the big graph, checked on the
    host against the graph and its scipy labels."""
    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    for variant, want in FOREST_PATHS:
        session = ConnectIt(variant, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        edges = session.spanning_forest(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        check_forest(edges, g.n, expect, keys, f"forest {variant}")
        t_check = time.perf_counter() - t0
        stats = session.stats
        for name in ("pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"forest {variant}: kernel {name} "
                    f"never launched")
        _check_counts(f"forest {variant}", counts, stats.finish_rounds, want,
                      exact)
        print(f"[forest] {variant}: {len(edges)} edges, a spanning forest "
              f"(size, components, edges checked on the host in "
              f"{t_check:.2f} s); wall {wall:.4f} s (to the host array); "
              f"finish_rounds {stats.finish_rounds}; lmax_count "
              f"{stats.lmax_count}; edges_finish {stats.edges_finish}; peak "
              f"device memory {peak} bytes; launches {json.dumps(counts)}")


def _prefix_answers(n: int, u, v, hi: int, q):
    """scipy's IsConnected for the query pairs ``q`` (2, k) after the first
    ``hi`` stream edges."""
    import numpy as np
    edges = np.stack([u[:hi].cpu().numpy(), v[:hi].cpu().numpy()], 1)
    _, lab = _scipy_labels(n, edges)
    return lab[q[0]] == lab[q[1]]


def _pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_stream(torch, g, expect, seed: int, exact: bool, card: str) -> None:
    """The graph's undirected edges, permuted by ``seed``, inserted through
    ConnectIt(MAIN_VARIANT).stream(n) in batches of STREAM_BATCH (all of
    them, the last batch ragged) and of 2^16 (the first 2^22), each batch
    with 2^16 uniform query pairs; the labels at the end against scipy's,
    the queries of batch 8 and of the last batch against scipy on the edges
    inserted by then."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    u, v = stream_edges(torch, g, seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for batch, total in ((STREAM_BATCH, u.shape[0]),
                         (1 << 16, min(1 << 22, u.shape[0]))):
        nb = -(-total // batch)
        queries = torch.randint(0, g.n, (nb, 2, 1 << 16), generator=gen,
                                device="cuda", dtype=torch.int32)
        st = ConnectIt(MAIN_VARIANT, device="cuda").stream(g.n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        walls, kept = [], {}
        for i in range(nb):
            lo, hi = i * batch, min((i + 1) * batch, total)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = st.process(u[lo:hi], v[lo:hi], queries[i, 0], queries[i, 1])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i in (7, nb - 1):
                kept[i] = (hi, ans.cpu().numpy(), queries[i].cpu().numpy())
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = st.stats
        what = f"stream batch={batch}"
        require(stats.edges_total == total and counts["edge_rewrite"] == nb,
                f"{what}: {stats.edges_total} edges in "
                f"{counts['edge_rewrite']} rewrites, want {total} in {nb}")
        for name in ("hook_compress", "pointer_jump"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        _check_counts(what, counts, stats.finish_rounds,
                      STREAM_COUNTS.get(batch), exact)
        for i, (hi, ans, q) in kept.items():
            require(np.array_equal(ans, _prefix_answers(g.n, u, v, hi, q)),
                    f"{what}: the queries of batch {i + 1} differ from "
                    f"scipy's on the first {hi} edges")
        if total == u.shape[0]:
            labels = st.labels.cpu().numpy()
            require(np.array_equal(canonical(labels), expect),
                    f"{what}: the stream's components differ from the "
                    f"static path's")
            same = np.array_equal(labels, expect)
            end = (f"labels' partition == scipy's (labels themselves "
                   f"{'==' if same else '!='} the static path's)")
        else:
            end = "prefix run"
        ms = [w * 1e3 for w in walls]
        print(f"[stream] {what}: {nb} batches, {total} edges, 2^16 queries "
              f"a batch; queries of batches {sorted(k + 1 for k in kept)} == "
              f"scipy on the prefix; {end}; {total / sum(walls):.1f} inserted "
              f"edges/s; per batch p50 {_pct(ms, 0.5):.4f} ms, p99 "
              f"{_pct(ms, 0.99):.4f} ms, max {max(ms):.4f} ms; finish_rounds "
              f"{stats.finish_rounds}; batch_shapes {stats.batch_shapes}; peak "
              f"device memory {peak} bytes; launches {json.dumps(counts)}; "
              f"card {card}")


def _live_keys(live, n: int):
    import numpy as np
    lo = np.minimum(live[:, 0], live[:, 1]).astype(np.int64)
    return lo * n + np.maximum(live[:, 0], live[:, 1])


def phase_dynamic(torch, g, expect, keys, seed: int, exact: bool,
                  card: str) -> None:
    """(a) The stream phase's batches of STREAM_BATCH through a dynamic
    stream (log 2^26): labels and forest against the graph's. (b) 8 steps
    of sliding_window on a fresh dynamic stream (log 2^23 at n = 2^22):
    each step's answers against scipy on the live multiset, the final
    forest a subset of the survivors. Fallback rebuilds are counted.
    Returns (b)'s answers a step, its final labels, the live graph's
    component count and the live edge keys, for the placements phase."""
    from unittest import mock

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.dynamic import engine
    from repro_torch.kernels import ops

    fallbacks = []
    rebuild = engine.uf_sync_forest

    def counted(*a, **kw):
        fallbacks.append(1)
        return rebuild(*a, **kw)

    n = g.n
    u, v = stream_edges(torch, g, seed)
    nb = -(-u.shape[0] // STREAM_BATCH)
    with mock.patch.object(engine, "uf_sync_forest", counted):
        d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
            n, dynamic=True, log=1 << 26)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        walls = []
        for i in range(nb):
            lo = i * STREAM_BATCH
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.insert(u[lo: lo + STREAM_BATCH], v[lo: lo + STREAM_BATCH])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = d.stats
        what = "dynamic (a) inserts"
        require(np.array_equal(canonical(d.labels.cpu().numpy()), expect),
                f"{what}: components differ from the static path's")
        check_forest(d.forest_edges(), n, expect, keys, what)
        require(d.log_used() == u.shape[0],
                f"{what}: {d.log_used()} live log entries, want {u.shape[0]}")
        _check_counts(what, counts, stats.finish_rounds, DYNAMIC_COUNTS["a"],
                      exact)
        ms = [w * 1e3 for w in walls]
        print(f"[dynamic] {what}: {nb} batches of {STREAM_BATCH}, "
              f"{u.shape[0]} edges; components == scipy's, forest checked; "
              f"{u.shape[0] / sum(walls):.1f} updates/s; per batch p50 "
              f"{_pct(ms, 0.5):.4f} ms, p99 {_pct(ms, 0.99):.4f} ms; "
              f"finish_rounds {stats.finish_rounds}; fallbacks "
              f"{len(fallbacks)}; peak device memory {peak} bytes; launches "
              f"{json.dumps(counts)}; card {card}")
        del d

        batch, log = sliding_batch_log(n)
        d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
            n, dynamic=True, log=log)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        live = np.zeros((0, 2), np.int32)
        steps, answers = [], []
        for step, (ins, dels, q, args) in enumerate(
                sliding_steps(torch, n, seed)):
            before, k0 = d._rounds, len(fallbacks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = d.process(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the live multiset: a delete removes every copy of its pair,
            # then the batch's non-loop inserts join
            if len(dels):
                live = live[~np.isin(_live_keys(live, n),
                                     _live_keys(dels, n))]
            live = np.concatenate([live, ins[ins[:, 0] != ins[:, 1]]])
            ncomp, lab = _scipy_labels(n, live)
            answers.append(ans.cpu().numpy())
            require(np.array_equal(answers[-1],
                                   lab[q[:, 0]] == lab[q[:, 1]]),
                    f"dynamic (b) step {step}: answers differ from scipy's "
                    f"on the live multiset")
            steps.append((wall, len(ins) + len(dels), d._rounds - before,
                          len(fallbacks) - k0))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        forest = d.forest_edges()
        require(bool(np.isin(_live_keys(forest, n), _live_keys(live, n)).all()),
                "dynamic (b): a forest edge is not a surviving edge")
        require(d.log_used() == len(live),
                f"dynamic (b): {d.log_used()} live log entries, want "
                f"{len(live)}")
        rounds = d.stats.finish_rounds
        _check_counts("dynamic (b) sliding_window", counts, rounds,
                      DYNAMIC_COUNTS["b"], exact)
    total = sum(x[1] for x in steps)
    print(f"[dynamic] (b) sliding_window(n={n}, steps=8, batch={batch}, "
          f"window=4, queries=2^16, seed={seed}), log {log}: answers == scipy "
          f"on the live multiset at every step, final forest ({len(forest)} "
          f"edges) within the {len(live)} survivors; "
          f"{total / sum(x[0] for x in steps):.1f} updates/s; finish_rounds "
          f"{rounds}; steps that fell back "
          f"{sum(1 for x in steps if x[3])} of 8; peak device memory {peak} "
          f"bytes; launches {json.dumps(counts)}; card {card}")
    for i, (wall, ups, r, fb) in enumerate(steps):
        print(f"[dynamic]   step {i}: {ups} updates, wall {wall * 1e3:.4f} "
              f"ms, rounds {r}, fallback rebuilds {fb}")
    return {"answers": answers, "labels": canonical(d.labels.cpu().numpy()),
            "ncomp": int(ncomp), "live": _live_keys(live, n),
            "used": len(live), "rounds": [x[2] for x in steps]}


def serve_server(session, g, dynamic: bool, warmup="all"):
    """The serve phase's server over the graph's vertices: the static one,
    or the dynamic one with a log of SERVE_DYNAMIC_LOG."""
    kw = dict(dynamic=True, log=SERVE_DYNAMIC_LOG) if dynamic else {}
    return session.serve(g.n, warmup=warmup, **SERVE_CAPS, **kw)


def serve_preload(torch, server, g, seed: int, dynamic: bool) -> list:
    """commit_now the stream phase's edges in commits of SERVE_PRELOAD: all
    of them (static), or the first SERVE_DYNAMIC_PRELOAD commits' (dynamic).
    Returns each commit's wall seconds."""
    u, v = stream_edges(torch, g, seed)
    total = u.shape[0]
    if dynamic:
        total = min(total, SERVE_DYNAMIC_PRELOAD * SERVE_PRELOAD)
    u, v = u[:total].cpu().numpy(), v[:total].cpu().numpy()
    walls = []
    for lo in range(0, total, SERVE_PRELOAD):
        t0 = time.perf_counter()
        server.commit_now(u[lo: lo + SERVE_PRELOAD], v[lo: lo + SERVE_PRELOAD])
        walls.append(time.perf_counter() - t0)
    return walls


def serve_closed_loop(server, dynamic: bool, seed: int, requests=None):
    """serve_bench's full-scale closed loop (16 clients); the dynamic
    server's has SERVE_DYNAMIC_REQUESTS requests a client and deletes."""
    from repro_torch.serve import closed_loop, run_sync
    if requests is None:
        requests = SERVE_DYNAMIC_REQUESTS if dynamic else SERVE_REQUESTS
    kw = dict(delete_frac=SERVE_DELETE_FRAC) if dynamic else {}
    return run_sync(server, closed_loop, clients=SERVE_CLIENTS,
                    requests_per_client=requests, seed=seed,
                    **SERVE_TRAFFIC, **kw)


class _ServeLog:
    """What the serve phase records of one server: each commit's edges (and
    deletes) in commit order, its epoch and wall time (begin + wait, in the
    insert loop's worker thread), every commit-program call (warmup's
    included), and every query dispatch's ids, answers and epoch."""

    def __init__(self, server):
        import numpy as np
        self.commits, self.walls, self.answers = [], [], []
        self.calls = 0
        store = server.store
        begin, query, work = store.begin_commit, store.query, \
            server._commit_work
        commit = store._ops.commit

        def logged(u, v, du=None, dv=None):
            pending = begin(u, v, du, dv)
            self.commits.append((pending.epoch, np.asarray(u, np.int32),
                                 np.asarray(v, np.int32),
                                 np.asarray(du if du is not None else [],
                                            np.int32),
                                 np.asarray(dv if dv is not None else [],
                                            np.int32)))
            return pending

        def counted(*args):
            self.calls += 1
            return commit(*args)

        def timed(*args):
            t0 = time.perf_counter()
            out = work(*args)
            self.walls.append(time.perf_counter() - t0)
            return out

        def kept(qa, qb):
            ans, epoch = query(qa, qb)
            self.answers.append((epoch, np.asarray(qa), np.asarray(qb), ans))
            return ans, epoch

        store.begin_commit, store.query = logged, kept
        store._ops = store._ops._replace(commit=counted)
        server._commit_work = timed


def _serve_row(pre: str, tag: str, res) -> str:
    return f"{pre} {tag} LoadResult {json.dumps(res.row())}"


def phase_serve(torch, g, seed: int, card: str):
    """ConnectIt(MAIN_VARIANT).serve over the graph's vertices at
    serve_bench's full-scale settings: the static server preloaded with the
    stream phase's edges in commits of 2^20, an untimed closed-loop pass,
    the closed loop (saturation) and open loops at SERVE_LOADS of it;
    scipy on the final labels and on 4 evenly spaced epochs' answers. Then
    the dynamic server: SERVE_DYNAMIC_PRELOAD commits, a closed loop with
    deletes, scipy on the live multiset. Returns the static server."""
    from repro_torch import ConnectIt

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    server = serve_static(torch, g, session, seed, card, "[serve]",
                          open_loops=True, epochs=4)
    serve_dynamic(torch, g, session, seed, card, "[serve]")
    return server


def serve_static(torch, g, session, seed: int, card: str, pre: str, *,
                 open_loops: bool, epochs: int):
    """The static server of ``session`` (the serve phase's, or (g)'s under
    a placement): preload, warm pass, the closed loop, with ``open_loops``
    the open loops at SERVE_LOADS; the commit log's linearization, the
    final labels and the answers of ``epochs`` evenly spaced epochs against
    scipy. ``pre`` heads each printed line. Returns the server."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import open_loop, run_sync

    n = g.n
    ops.reset_launch_counts()
    server = serve_server(session, g, dynamic=False)
    log = _ServeLog(server)
    pre_walls = serve_preload(torch, server, g, seed, dynamic=False)
    preloaded = server.epoch_edges[-1]
    print(f"{pre} static server n={n} exec={server.exec_str}, {SERVE_CAPS}, "
          f"warmup='all': preloaded {preloaded} edges in {len(pre_walls)} "
          f"commits of {SERVE_PRELOAD}, {sum(pre_walls):.3f} s "
          f"({preloaded / sum(pre_walls):.1f} edges/s, commit p50 "
          f"{_pct(pre_walls, 0.5) * 1e3:.3f} ms)")
    warm = serve_closed_loop(server, False, seed + 1,
                             requests=SERVE_REQUESTS // 4)
    print(_serve_row(pre, "warm pass (untimed)", warm))
    walls0 = len(log.walls)
    sat = serve_closed_loop(server, False, seed)
    loop_walls = log.walls[walls0:]
    results = [("closed", sat)]
    print(_serve_row(pre, f"closed {SERVE_CLIENTS}x{SERVE_REQUESTS}", sat))
    for frac in SERVE_LOADS if open_loops else ():
        qps = max(sat.achieved_qps * frac, 1.0)
        res = run_sync(server, open_loop, qps=qps,
                       requests=SERVE_OPEN_REQUESTS, seed=seed,
                       **SERVE_TRAFFIC)
        results.append((f"open {frac}", res))
        print(_serve_row(pre, f"open {frac} of saturation", res))
    counts = ops.launch_counts()
    st = server.stats()
    print(f"{pre} stats {st}")
    ms = [w * 1e3 for w in loop_walls]
    print(f"{pre} closed loop: {len(ms)} commits, commit wall (begin + "
          f"wait, worker thread) p50 {_pct(ms, 0.5):.4f} ms, p99 "
          f"{_pct(ms, 0.99):.4f} ms, mean {sum(ms) / len(ms):.4f} ms; "
          f"saturation {sat.achieved_qps:.1f} query requests/s, p99 "
          f"{sat.p99_ms:.4f} ms; committed {sat.edges_per_s:.1f} edges/s; "
          f"launches {json.dumps(counts)}; card {card}")

    # linearization: epochs 1, 2, ... in commit order; every edge submitted
    # was committed; the final labels and the answers of evenly spaced
    # epochs against scipy on their epoch's prefix of the commit log
    epoch_order = [c[0] for c in log.commits]
    require(epoch_order == list(range(1, len(epoch_order) + 1)),
            f"{pre} commits did not become epochs 1, 2, ... in order")
    sizes = np.cumsum([0] + [c[1].shape[0] for c in log.commits])
    require(server.epoch_edges == sizes.tolist(),
            f"{pre} epoch_edges is not the commit log's running total")
    submitted = st.tenants["default"].edges_submitted
    loops = [warm] + [r for _, r in results]
    want = preloaded + sum(r.inserts for r in loops) * \
        SERVE_TRAFFIC["insert_edges"]
    require(server.epoch_edges[-1] == submitted == want,
            f"{pre} {server.epoch_edges[-1]} edges committed, {submitted} "
            f"submitted, want {want}")
    # a single-path commit rewrites its batch once; a placement's does not
    # (its finish takes the raw ends, as the reference's does)
    rewrites = log.calls if session.exec.placement == "single" else 0
    require(counts["edge_rewrite"] == rewrites
            and counts["hook_compress"] > 0 and counts["pointer_jump"] > 0,
            f"{pre} launches {counts}, want edge_rewrite == {rewrites} "
            f"({log.calls} commits, warmup's included) and hook_compress, "
            f"pointer_jump above 0")
    edges = np.stack([np.concatenate([c[1] for c in log.commits]),
                      np.concatenate([c[2] for c in log.commits])], 1)
    t0 = time.perf_counter()
    oracle = {}  # scipy's labels by prefix size: the last epoch's is final

    def prefix_labels(size):
        if size not in oracle:
            oracle[size] = _scipy_labels(n, edges[:size])[1]
        return oracle[size]

    require(np.array_equal(canonical(server.store.labels.cpu().numpy()),
                           canonical(prefix_labels(len(edges)))),
            f"{pre} the final labels' partition differs from scipy's on "
            f"every committed edge")
    seen = sorted({a[0] for a in log.answers if a[0] > len(pre_walls)})
    picks = sorted({seen[round(i * (len(seen) - 1) / (epochs - 1))]
                    for i in range(epochs)})
    checked = 0
    for e in picks:
        lab = prefix_labels(int(sizes[e]))
        for epoch, qa, qb, ans in log.answers:
            if epoch == e:
                require(np.array_equal(ans.cpu().numpy(),
                                       lab[qa] == lab[qb]),
                        f"{pre} answers at epoch {e} differ from scipy's "
                        f"on its {sizes[e]}-edge prefix")
                checked += qa.shape[0]
    require(len(picks) >= epochs or len(seen) < epochs,
            f"{pre} only epochs {picks} answered")
    print(f"{pre} checks: epochs 1..{len(epoch_order)} in commit order; "
          f"{submitted} edges submitted == committed; final partition == "
          f"scipy's; {checked} answers at epochs {picks} == scipy on their "
          f"prefixes ({len(oracle)} scipy runs, "
          f"{time.perf_counter() - t0:.2f} s)")
    return server


def serve_dynamic(torch, g, session, seed: int, card: str, pre: str):
    """The dynamic server of ``session``: SERVE_DYNAMIC_PRELOAD commits, a
    closed loop with deletes, scipy on the live multiset replayed from the
    commit log."""
    import numpy as np

    from repro_torch.kernels import ops

    n = g.n
    ops.reset_launch_counts()
    dserver = serve_server(session, g, dynamic=True)
    dlog = _ServeLog(dserver)
    dpre = serve_preload(torch, dserver, g, seed, dynamic=True)
    dres = serve_closed_loop(dserver, True, seed)
    dcounts = ops.launch_counts()
    dst = dserver.stats()
    print(_serve_row(pre, f"dynamic closed {SERVE_CLIENTS}x"
                     f"{SERVE_DYNAMIC_REQUESTS} delete_frac="
                     f"{SERVE_DELETE_FRAC}", dres))
    print(f"{pre} dynamic stats {dst}")
    # the live multiset, replayed from the commit log: a delete removes
    # every copy of its pair, and within a commit deletes apply before
    # inserts, so an insert of commit i lives iff no commit after i deletes
    # its pair
    ins_key, ins_at, del_key, del_at = [], [], [], []
    for i, (_, u, v, du, dv) in enumerate(dlog.commits):
        keep = u != v
        ins_key.append(_live_keys(np.stack([u[keep], v[keep]], 1), n))
        ins_at.append(np.full(int(keep.sum()), i))
        del_key.append(_live_keys(np.stack([du, dv], 1), n))
        del_at.append(np.full(du.shape[0], i))
    ins_key, ins_at = np.concatenate(ins_key), np.concatenate(ins_at)
    del_key, del_at = np.concatenate(del_key), np.concatenate(del_at)
    last = {}
    for k, at in zip(del_key.tolist(), del_at.tolist()):
        last[k] = max(at, last.get(k, -1))
    dkeys = np.asarray(sorted(last), np.int64)
    dlast = np.asarray([last[k] for k in dkeys.tolist()], np.int64)
    pos = np.searchsorted(dkeys, ins_key).clip(0, max(len(dkeys) - 1, 0))
    hit = (dkeys[pos] == ins_key) if len(dkeys) else np.zeros_like(ins_key,
                                                                   bool)
    live = ins_key[~hit | (dlast[pos] <= ins_at)]
    _, lab = _scipy_labels(n, np.stack([live // n, live % n], 1))
    used = int(dserver.store._ops.used(dserver.store._committed).sum())
    require(np.array_equal(canonical(dserver.store.labels.cpu().numpy()),
                           canonical(lab)),
            f"{pre} dynamic: the final labels differ from scipy's on the "
            "live multiset")
    require(used == len(live),
            f"{pre} dynamic: {used} live log entries, want {len(live)}")
    require(dcounts["scatter_min"] > 0 and dcounts["pointer_jump"] > 0,
            f"{pre} dynamic: launches {dcounts}")
    dms = [w * 1e3 for w in dlog.walls]
    print(f"{pre} dynamic server n={n} exec={dserver.exec_str}, log "
          f"{SERVE_DYNAMIC_LOG}: preload "
          f"{len(dpre)} commits of {SERVE_PRELOAD} in {sum(dpre):.3f} s; "
          f"closed loop {len(dms)} commits, commit wall p50 "
          f"{_pct(dms, 0.5):.4f} ms, p99 {_pct(dms, 0.99):.4f} ms; "
          f"{dst.edges_deleted} deletes committed; final labels == scipy on "
          f"the {len(live)} live edges == the log's live count; launches "
          f"{json.dumps(dcounts)}; card {card}")
    return dserver


# the analytic resident bytes of chunked ingest, as the JAX package's scale
# benchmark states them (benchmarks/scale_bench.py::_analytic_bytes): int32
# labels over n + 1 rows, one dump-padded (u, v) chunk at its pow2 bucket,
# the survivor buffer pair, and the sampling head's graph (4 int32 arrays at
# the head chunk's padded size, freed after sampling)
def _analytic_bytes(n: int, chunk: int, cap: int) -> int:
    from repro_torch.core.driver import bucket_size
    b = bucket_size(chunk, pad="pow2")
    return 4 * (n + 1) + 2 * 4 * b + 2 * 4 * (cap + 1) + 4 * 4 * b + 4 * (n + 2)


INGEST_VARIANTS = (MAIN_VARIANT, "kout_afforest_k2+uf_sync_full",
                   "none+uf_sync_full")
INGEST_PATH = "kout_afforest_k2+uf_sync_full"  # the power-law streams'


class _Timed:
    """A ChunkedEdgeSource wrapper that counts the host seconds its chunks
    take to make and keeps each chunk (for the oracle) if asked."""

    def __init__(self, source, keep: bool = False):
        self.n = source.n
        self._source, self._keep = source, keep
        self.seconds, self.kept = 0.0, []

    def chunks(self):
        it = iter(self._source.chunks())
        while True:
            t0 = time.perf_counter()
            chunk = next(it, None)
            self.seconds += time.perf_counter() - t0
            if chunk is None:
                return
            if self._keep:
                self.kept.append(chunk)
            yield chunk


def _run_ingest(torch, session, source, what: str):
    """One from_chunks run → (labels, stats, wall s, launches, peak bytes
    above what was allocated before it)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    labels, stats = session.from_chunks(source, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(labels.shape == (source.n,) and labels.dtype == torch.int32,
            f"{what}: labels shape {tuple(labels.shape)}")
    require(counts["edge_rewrite"] == stats.chunks,
            f"{what}: {counts['edge_rewrite']} edge_rewrite launches for "
            f"{stats.chunks} chunks")
    for name in ("hook_compress", "pointer_jump", "scatter_min"):
        require(counts[name] > 0, f"{what}: kernel {name} never launched")
    return labels, stats, wall, counts, peak


def phase_ingest(torch, g, expect, seed: int, log_m: int, exact: bool,
                 card: str):
    """Out-of-core ingest (ConnectIt.from_chunks): the graph's undirected
    edges in the stream phase's order as a host ArrayEdgeSource of 8 chunks,
    for INGEST_VARIANTS, against scipy and the one-shot path; the same
    edges as compressed blocks decoded on the card; power-law streams of
    2^(log_m) and 2^(log_m + 2) edges over 4n vertices, whose resident
    peaks must agree. Returns the host edge array (for the profile)."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.graphs import compress_edges

    n = g.n
    src = ingest_source(torch, g, seed, log_m)
    E = src.edges
    m = E.shape[0]
    chunk = ingest_chunk(log_m)
    for variant in INGEST_VARIANTS:
        session = ConnectIt(variant, device="cuda")
        what = f"ingest {variant}"
        labels, stats, wall, counts, peak = _run_ingest(torch, session, src,
                                                        what)
        require(np.array_equal(labels.cpu().numpy(), expect),
                f"{what}: labels differ from the scipy oracle")
        require(stats.chunks == src.num_chunks and stats.edges_total == m,
                f"{what}: {stats.chunks} chunks, {stats.edges_total} edges "
                f"streamed; want {src.num_chunks} and {m}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        one = session.connectivity(g)
        torch.cuda.synchronize()
        one_peak = torch.cuda.max_memory_allocated() - base
        require(torch.equal(one, labels),
                f"{what}: labels differ from .connectivity(g)'s")
        print(f"[ingest] {what}: {stats.chunks} chunks of {chunk}, {m} edges "
              f"streamed; labels == scipy == .connectivity; survivors "
              f"{stats.edges_finish} (ratio {stats.survivor_ratio:.6f}); "
              f"spills {stats.spills}; finish_rounds {stats.finish_rounds}; "
              f"lmax_count {stats.lmax_count}; wall {wall:.4f} s, "
              f"{m / wall:.1f} edges/s; peak device memory above the "
              f"resident graph {peak} bytes (one-shot .connectivity "
              f"{one_peak}); launches {json.dumps(counts)}; card {card}")

    t0 = time.perf_counter()
    blocks = compress_edges(E, n, block_size=1 << 16, device="cuda")
    t_comp = time.perf_counter() - t0
    what = f"ingest {MAIN_VARIANT} compressed"
    labels, stats, wall, counts, peak = _run_ingest(
        torch, ConnectIt(MAIN_VARIANT, device="cuda"), blocks, what)
    require(np.array_equal(labels.cpu().numpy(), expect),
            f"{what}: labels differ from the scipy oracle")
    require(stats.edges_total == m, f"{what}: {stats.edges_total} edges")
    print(f"[ingest] {what}: compress_edges on the host {t_comp:.2f} s, "
          f"{blocks.num_blocks} blocks of 2^16, {blocks.nbytes} bytes "
          f"(ratio {blocks.ratio:.3f} against int32 COO); decoded on the "
          f"card: labels == scipy; spills {stats.spills}; wall {wall:.4f} s, "
          f"{m / wall:.1f} edges/s; peak above the graph {peak} bytes; "
          f"launches {json.dumps(counts)}")
    del blocks

    session = ConnectIt(INGEST_PATH, device="cuda")
    pn = 4 * n
    peaks = []
    for lm in (log_m, log_m + 2):
        stream = _Timed(powerlaw_source(g, lm, log_m), keep=lm > log_m)
        what = f"ingest {INGEST_PATH} powerlaw_chunks(n={pn}, m=2^{lm})"
        labels, stats, wall, counts, peak = _run_ingest(torch, session,
                                                        stream, what)
        peaks.append(peak)
        check = "labels not checked"
        if stream.kept:
            t0 = time.perf_counter()
            _, lab = _scipy_labels(pn, np.concatenate(stream.kept))
            stream.kept.clear()
            require(np.array_equal(labels.cpu().numpy(), canonical(lab)),
                    f"{what}: labels differ from scipy's")
            check = f"labels == scipy ({time.perf_counter() - t0:.1f} s)"
        cap = stats.edges_finish_padded // 2 - 1  # the buffer's capacity
        print(f"[ingest] {what}: {stats.chunks} chunks; {check}; survivors "
              f"{stats.edges_finish}; spills {stats.spills}; finish_rounds "
              f"{stats.finish_rounds}; lmax_count {stats.lmax_count}; wall "
              f"{wall:.4f} s ({stream.seconds:.4f} s of it making chunks on "
              f"the host), {(1 << lm) / wall:.1f} edges/s; peak device "
              f"memory above the resident graph {peak} bytes, analytic "
              f"resident bytes {_analytic_bytes(pn, chunk, cap)}; launches "
              f"{json.dumps(counts)}; card {card}")
    spread = max(peaks) / min(peaks) - 1
    print(f"[ingest] power-law peaks {peaks}: spread {100 * spread:.2f}%")
    if exact:
        require(spread <= 0.05, f"ingest: the power-law peaks {peaks} differ "
                f"by more than 5%")
    return E


def _sym_uniform(torch, g, seed: int):
    """One uniform float32 draw per undirected edge (numpy, ``seed``), given
    to both directions; inf on the padding, as ``with_weights`` pads."""
    import numpy as np
    s, r = g.senders[: g.m].long(), g.receivers[: g.m].long()
    key = torch.minimum(s, r) * (g.n + 1) + torch.maximum(s, r)
    uniq, inv = torch.unique(key, return_inverse=True)
    draw = np.random.default_rng(seed).random(uniq.shape[0]).astype(np.float32)
    out = torch.full((g.m_pad,), float("inf"), device=g.device)
    out[: g.m] = torch.from_numpy(draw).cuda()[inv]
    return out


def _scan_oracle(n: int, s, r, sims, eps: float, mu: int):
    """gs_query_sequential restated with numpy and scipy: cores have at
    least mu similar edges; the core-core similar subgraph's components
    take their min vertex; a non-core vertex takes the min of its own id
    and its similar core neighbours' labels."""
    import numpy as np
    similar = sims >= np.float32(eps)
    core = np.bincount(s[similar], minlength=n) >= mu
    # the similar core-core edges, one direction each (sims are symmetric)
    cc = similar & core[s] & core[r] & (s < r)
    _, lab = _scipy_labels(n, np.stack([s[cc], r[cc]], 1))
    labels = canonical(lab).astype(np.int64)
    att = similar & core[r] & ~core[s]
    np.minimum.at(labels, s[att], labels[r[att]])
    return labels, core


def _mst_weight(g, w) -> tuple:
    """scipy's minimum spanning tree weight (float64) of the graph under
    weights ``w``, the host weights of the graph's edges, and the tree's
    edge count."""
    import numpy as np
    from scipy.sparse.csgraph import minimum_spanning_tree

    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    wh = w[: g.m].cpu().numpy()
    up = s < r
    mst = minimum_spanning_tree(_csr(g.n, s[up], r[up],
                                     wh[up].astype(np.float64)))
    return float(mst.sum()), wh, mst.nnz


def _forest_weight64(edges, n: int, keys, wh) -> float:
    """A forest's weight in float64: each edge's weight found by its key
    among the graph's sorted edge keys."""
    import numpy as np
    at = np.searchsorted(keys, edges[:, 0].astype(np.int64) * (n + 1)
                         + edges[:, 1])
    return float(wh[at].astype(np.float64).sum())


def phase_apps(torch, g, expect, keys, exact: bool, card: str):
    """AMSF (mask, skip=lmax, coo) and exact MSF on the graph with
    with_weights(g, seed=0), against scipy's minimum spanning tree; SCAN at
    full size on seeded symmetric similarities against a numpy/scipy
    restatement of the sequential query, and on a graph small enough for
    build_index against gs_query_sequential. Returns the weights, scipy's
    MST weight and, per AMSF spec, the single path's forest, buckets and
    edges per bucket."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.core.apps import amsf as amsf_impl
    from repro_torch.core.apps import scan as scan_impl
    from repro_torch.graphs.generators import rmat, with_weights
    from repro_torch.kernels import ops

    n = g.n
    t0 = time.perf_counter()
    w = with_weights(g, seed=0)
    torch.cuda.synchronize()
    t_w = time.perf_counter() - t0
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    t0 = time.perf_counter()
    exact_w, wh, nnz = _mst_weight(g, w)
    t_mst = time.perf_counter() - t0
    print(f"[apps] with_weights on the card {t_w:.2f} s; scipy "
          f"minimum_spanning_tree (float64) {t_mst:.2f} s: weight "
          f"{exact_w!r}, {nnz} edges")
    session = ConnectIt(MAIN_VARIANT, device="cuda")
    single = {}
    for spec in ("amsf", "amsf(skip=lmax)", "amsf(mode=coo)", "msf"):
        what = f"apps {MAIN_VARIANT} {spec}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        edges, stats = session.amsf(g, w, spec, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        single[spec] = (edges, stats.buckets, stats.edges_per_bucket)
        for name in ("pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        check_forest(edges, n, expect, keys, what)
        weight = amsf_impl.forest_weight(edges, g, w)
        w64 = _forest_weight64(edges, n, keys, wh)
        if spec == "msf":
            require(abs(w64 - exact_w) <= 1e-9 * exact_w
                    and abs(weight - exact_w) <= 1e-5 * exact_w,
                    f"{what}: weight {w64!r} (float32 sum {weight!r}), "
                    f"scipy's {exact_w!r}")
        else:
            require(exact_w * (1 - 1e-9) <= w64 <= 1.25 * exact_w,
                    f"{what}: weight {w64!r} outside [{exact_w!r}, 1.25 x]")
        print(f"[apps] {what}: {len(edges)} edges, a spanning forest; weight "
              f"{w64!r} ({w64 / exact_w:.6f} x scipy's MST; float32 sum "
              f"{weight!r}); buckets {stats.buckets}; finish_rounds "
              f"{stats.finish_rounds}; wall {wall:.4f} s; peak device "
              f"memory above the graph {peak} bytes; launches "
              f"{json.dumps(counts)}; card {card}")

    sims = _sym_uniform(torch, g, 0)
    sh = sims[: g.m].cpu().numpy()
    for eps, mu in ((0.6, 3), (0.3, 3)):
        what = f"apps {MAIN_VARIANT} scan(eps={eps},mu={mu})"
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, is_core, stats = session.scan(
            g, sims, f"scan(eps={eps},mu={mu})", return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        want, core = _scan_oracle(n, s, r, sh, eps, mu)
        t_ref = time.perf_counter() - t0
        require(np.array_equal(is_core.cpu().numpy(), core),
                f"{what}: is_core differs from the restatement's")
        require(np.array_equal(labels.cpu().numpy(), want),
                f"{what}: labels differ from the restatement's")
        for name in ("hook_compress", "pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        print(f"[apps] {what}: labels, is_core == the numpy/scipy "
              f"restatement ({t_ref:.2f} s on the host); {int(core.sum())} "
              f"cores, {len(np.unique(want))} clusters; core-core edges "
              f"{stats.edges_finish}; finish_rounds {stats.finish_rounds}; "
              f"wall {wall:.4f} s; launches {json.dumps(counts)}")

    small = rmat(1 << 13, 12 << 13, seed=4, device="cuda")
    t0 = time.perf_counter()
    index = scan_impl.build_index(small)
    t_index = time.perf_counter() - t0
    for eps, mu in ((0.1, 3), (0.3, 3)):  # benchmarks/scan_bench.py's
        labels, is_core = session.scan(small, torch.from_numpy(index).cuda(),
                                       f"scan(eps={eps},mu={mu})")
        want, core = scan_impl.gs_query_sequential(small, index, eps, mu=mu)
        require(np.array_equal(labels.cpu().numpy(), want)
                and np.array_equal(is_core.cpu().numpy(), core),
                f"apps scan(eps={eps},mu={mu}) on rmat(2^13): differs from "
                f"gs_query_sequential")
        print(f"[apps] scan(eps={eps},mu={mu}) on rmat(2^13, 12*2^13, seed=4) "
              f"(m={small.m}; build_index on the host {t_index:.2f} s): "
              f"labels, is_core == gs_query_sequential; {int(core.sum())} "
              f"cores")
    return {"weights": w, "exact": exact_w, "wh": wh, "single": single}


def _required_kernels(variant: str) -> tuple:
    """The kernels a run of ``variant`` must launch: those its single-device
    path launches (PATHS), the uf_sync kernels otherwise."""
    for v, _, counts, _ in PATHS:
        if v == variant:
            return tuple(k for k, c in zip(PATH_KERNELS, counts) if c)
    return UF_KERNELS


def phase_placements(torch, g, expect, keys, seed: int, exact: bool,
                     card: str, dyn: dict, apps: dict):
    """The replicated and sharded placements (repro_torch.core.execution)
    at the full size: (a) PLACEMENT_RUNS at one rank over NCCL in this
    process, each against scipy's labels and the single path's, with its
    median wall of 5, rounds, launches, host waits an outer round (one
    traced run) and peak memory; (b) the stream phase's 2^20-edge batches
    under sharded(x); (c) scan(eps=0.6,mu=3) under sharded(x) against the
    single path on the apps phase's similarities; (e) the dynamic phase's
    sliding window, (f) amsf and amsf(skip=lmax), and (g) the serve phase's
    servers, under the placements, each against the single path (``dyn``,
    ``apps``) or scipy; (d) GLOO_EXECS on two processes sharing the card
    over gloo, each against (a)'s labels."""
    import statistics

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    topo = multihost.initialize()  # nothing configured: one rank
    require(topo.num_processes == 1 and "nccl" in topo.backend,
            f"placements: one-rank group expected, got {topo}")
    t_a = time.perf_counter()
    try:
        single = {}
        for variant, exec_str in PLACEMENT_RUNS:
            what = f"placements {variant} {exec_str}"
            if variant not in single:
                single[variant] = ConnectIt(variant, device="cuda") \
                    .connectivity(g).cpu().numpy()
            ci = ConnectIt(variant, exec=exec_str, device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            labels, stats = ci.connectivity(g, return_stats=True)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            got = labels.cpu().numpy()
            require(np.array_equal(got, expect),
                    f"{what}: labels differ from the scipy oracle")
            require(np.array_equal(got, single[variant]),
                    f"{what}: labels differ from the single path's")
            require(stats.exec == exec_str and stats.devices == 1
                    and sum(stats.edges_per_device) == stats.edges_finish
                    and sum(stats.dispatch_sizes)
                    == stats.edges_finish_padded,
                    f"{what}: stats {stats}")
            for name in _required_kernels(variant):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_COUNTS.get((variant, exec_str)), exact)
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ci.connectivity(g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            main = (variant, exec_str) == (MAIN_VARIANT, "sharded(x)")
            calls = _trace(torch, what, lambda: ci.connectivity(g),
                           top=15 if main else 0)
            waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
            print(f"[placements] {what}: labels == scipy == single; median "
                  f"wall of 5 {statistics.median(walls) * 1e3:.4f} ms; "
                  f"finish_rounds {stats.finish_rounds}; host waits "
                  f"{waits} ({waits / stats.finish_rounds:.1f} an outer "
                  f"round); edges_finish {stats.edges_finish} of "
                  f"{stats.edges_finish_padded}; peak device memory above "
                  f"the graph {peak} bytes; launches {json.dumps(counts)}; "
                  f"card {card}")
        print(f"[time] placements (a): {time.perf_counter() - t_a:.1f} s")
        for part, fn, args in (
                ("(b)", _placement_stream, (expect, seed, exact, card)),
                ("(c)", _placement_scan, ()),
                ("(e)", _placement_dynamic, (dyn, seed, exact, card)),
                ("(f)", _placement_amsf, (expect, keys, apps, exact, card)),
                ("(g)", _placement_serve, (seed, card))):
            t0 = time.perf_counter()
            fn(torch, g, *args)
            print(f"[time] placements {part}: {time.perf_counter() - t0:.1f} "
                  f"s")
    finally:
        multihost.shutdown()
    t0 = time.perf_counter()
    _placement_gloo(torch, g, expect, card)
    print(f"[time] placements (d): {time.perf_counter() - t0:.1f} s")


def _placement_stream(torch, g, expect, seed: int, exact: bool, card: str,
                      tag: str = "", want=PLACEMENT_STREAM_COUNTS) -> None:
    """(b): the stream phase's 2^20-edge batches, each with 2^16 query
    pairs, through ConnectIt(MAIN_VARIANT, exec="sharded(x)").stream(n).
    The last batch's prefix is every edge, so its oracle is ``expect``.
    ``want`` holds its launches and rounds at one rank (None elsewhere)."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    u, v = stream_edges(torch, g, seed)
    total, batch = u.shape[0], STREAM_BATCH
    nb = -(-total // batch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    queries = torch.randint(0, g.n, (nb, 2, 1 << 16), generator=gen,
                            device="cuda", dtype=torch.int32)
    st = ConnectIt(MAIN_VARIANT, exec="sharded(x)",
                   device="cuda").stream(g.n)
    ops.reset_launch_counts()
    walls = []
    for i in range(nb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans = st.process(u[i * batch: (i + 1) * batch],
                         v[i * batch: (i + 1) * batch],
                         queries[i, 0], queries[i, 1])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    stats = st.stats
    what = f"placements {tag}stream sharded(x) batch={batch}"
    require(stats.edges_total == total, f"{what}: {stats.edges_total} edges")
    require(np.array_equal(canonical(st.labels.cpu().numpy()), expect),
            f"{what}: the stream's components differ from scipy's")
    q = queries[-1].cpu().numpy()
    require(np.array_equal(ans.cpu().numpy(), expect[q[0]] == expect[q[1]]),
            f"{what}: the last batch's answers differ from scipy's")
    for name in UF_KERNELS:
        require(counts[name] > 0, f"{what}: kernel {name} never launched")
    _check_counts(what, counts, stats.finish_rounds, want, exact)
    ms = [w * 1e3 for w in walls]
    print(f"[placements] {what}: {nb} batches, {total} edges; labels' "
          f"partition == scipy's; the last batch's answers == scipy's; "
          f"{total / sum(walls):.1f} inserted edges/s; per batch p50 "
          f"{_pct(ms, 0.5):.4f} ms, p99 {_pct(ms, 0.99):.4f} ms; "
          f"finish_rounds {stats.finish_rounds}; batch_shapes "
          f"{stats.batch_shapes}; launches {json.dumps(counts)}; card {card}")


def _placement_scan(torch, g) -> None:
    """(c): scan(eps=0.6,mu=3) under sharded(x) against the single path,
    on the apps phase's similarities."""
    from repro_torch import ConnectIt

    sims = _sym_uniform(torch, g, 0)
    spec = "scan(eps=0.6,mu=3)"
    want = ConnectIt(MAIN_VARIANT, device="cuda").scan(g, sims, spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, cores, stats = ConnectIt(
        MAIN_VARIANT, exec="sharded(x)", device="cuda").scan(
        g, sims, spec, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(torch.equal(labels, want[0]) and torch.equal(cores, want[1]),
            f"placements {spec} sharded(x): differs from the single path")
    print(f"[placements] {MAIN_VARIANT} {spec} sharded(x): labels, is_core "
          f"== the single path's; core-core edges {stats.edges_finish}; "
          f"finish_rounds {stats.finish_rounds}; wall {wall:.4f} s")


def _placement_dynamic(torch, g, single: dict, seed: int, exact: bool,
                       card: str, execs=PLACEMENT_DYN_EXECS, tag: str = "",
                       trace: bool = True) -> list:
    """(e): the dynamic phase's sliding window (8 steps, log 2^23) through
    ConnectIt(MAIN_VARIANT, exec=...).stream(n, dynamic=True) for each of
    ``execs``: each step's answers against the single path's (``single``,
    which scipy checked), the final labels' partition equal to its, the
    forest n - #components edges of the live graph; updates/s, the
    per-step wall, rounds, fallback rebuilds, and with ``trace`` the host
    waits of a traced ninth step. Returns each run's rounds and stats."""
    from unittest import mock

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.core import distributed
    from repro_torch.dynamic.engine import DEFAULT_SEARCH_ROUNDS
    from repro_torch.kernels import ops

    n = g.n
    _, log = sliding_batch_log(n)
    fixpoint = distributed.iterate_to_fixpoint
    out = []
    for exec_str in execs:
        what = f"placements {tag}(e) dynamic {exec_str}"
        bounds = []

        def recording(step, state, max_rounds, **kw):
            # an update's insert phase and its search fallback run to the
            # outer cap, its bounded search to DEFAULT_SEARCH_ROUNDS
            bounds.append(max_rounds)
            return fixpoint(step, state, max_rounds, **kw)

        d = ConnectIt(MAIN_VARIANT, exec=exec_str, device="cuda").stream(
            n, dynamic=True, log=log)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        steps = []
        calls = {}
        with mock.patch.object(distributed, "iterate_to_fixpoint",
                               recording):
            gen = sliding_steps(torch, n, seed, 9)
            for step, (ins, dels, q, args) in zip(range(8), gen):
                before, b0 = d._rounds, len(bounds)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ans = d.process(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                require(np.array_equal(ans.cpu().numpy(),
                                       single["answers"][step]),
                        f"{what} step {step}: answers differ from the "
                        f"single path's")
                capped = sum(1 for b in bounds[b0:]
                             if b > DEFAULT_SEARCH_ROUNDS)
                steps.append((wall, len(ins) + len(dels), d._rounds - before,
                              capped - 1))
            counts = ops.launch_counts()
            stats = d.stats
            require(np.array_equal(canonical(d.labels.cpu().numpy()),
                                   single["labels"]),
                    f"{what}: the labels' partition differs from the single "
                    f"path's")
            forest = d.forest_edges()
            require(forest.shape == (n - single["ncomp"], 2)
                    and bool(np.isin(_live_keys(forest, n),
                                     single["live"]).all()),
                    f"{what}: the forest ({forest.shape[0]} edges) is not "
                    f"n - {single['ncomp']} edges of the live graph")
            require(d.log_used() == single["used"],
                    f"{what}: {d.log_used()} live log entries, want "
                    f"{single['used']}")
            require([x[2] for x in steps] == single["rounds"],
                    f"{what}: rounds a step {[x[2] for x in steps]}, the "
                    f"single path's {single['rounds']}")
            for name in ("scatter_min", "pointer_jump"):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_DYNAMIC_COUNTS.get(exec_str) if not tag
                          else None, exact)
            if trace:
                ins, dels, q, args = next(gen)
                calls = _trace(torch, f"{what} step 9 ({len(dels)} deletes, "
                               f"{len(ins)} inserts)",
                               lambda: d.process(*args),
                               top=12 if exec_str == "sharded(x)" else 0)
        ms = [x[0] * 1e3 for x in steps]
        total = sum(x[1] for x in steps)
        waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
        print(f"[placements] {what}: answers == the single path's at every "
              f"step, labels' partition == its, forest {len(forest)} edges "
              f"of the live graph; {total / sum(x[0] for x in steps):.1f} "
              f"updates/s; per-step wall p50 {_pct(ms, 0.5):.4f} ms, p99 "
              f"{_pct(ms, 0.99):.4f} ms; finish_rounds {stats.finish_rounds} "
              f"(a step {[x[2] for x in steps]}); fallback rebuilds a step "
              f"{[x[3] for x in steps]}; host waits of the traced step "
              f"{waits if trace else 'not traced'}; launches "
              f"{json.dumps(counts)}; card {card}")
        out.append({"variant": MAIN_VARIANT, "exec": f"{exec_str} dynamic",
                    "rounds": stats.finish_rounds,
                    "edges_per_device": list(stats.edges_per_device),
                    "dispatch_sizes": list(stats.dispatch_sizes)})
    return out


def _placement_amsf(torch, g, expect, keys, apps: dict, exact: bool,
                    card: str, execs=PLACEMENT_DYN_EXECS, specs=AMSF_SPECS,
                    tag: str = "", trace: bool = True) -> list:
    """(f): ``specs`` under each of ``execs`` on the apps phase's weights:
    a spanning forest within 1.25x of scipy's MST weight, its buckets and
    edges per bucket equal to the single path's (``apps``); wall, rounds,
    launches, and with ``trace`` one traced sharded(x) amsf(skip=lmax)
    (busy share, collectives, host waits a round). Returns each run's
    rounds and stats."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    n, w, exact_w = g.n, apps["weights"], apps["exact"]
    out = []
    for exec_str in execs:
        session = ConnectIt(MAIN_VARIANT, exec=exec_str, device="cuda")
        for spec in specs:
            what = f"placements {tag}(f) {spec} {exec_str}"
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            edges, stats = session.amsf(g, w, spec, return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            s_edges, buckets, per_bucket = apps["single"][spec]
            same = np.array_equal(edges, s_edges)
            if not same:  # the single path's forest was checked already
                check_forest(edges, n, expect, keys, what)
            w64 = _forest_weight64(edges, n, keys, apps["wh"])
            require(exact_w * (1 - 1e-9) <= w64 <= 1.25 * exact_w,
                    f"{what}: weight {w64!r} outside [{exact_w!r}, 1.25 x]")
            require(stats.buckets == buckets
                    and stats.edges_per_bucket == per_bucket,
                    f"{what}: buckets {stats.buckets} "
                    f"{stats.edges_per_bucket}, the single path's {buckets} "
                    f"{per_bucket}")
            for name in ("scatter_min", "pointer_jump"):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_AMSF_COUNTS.get((exec_str, spec))
                          if not tag else None, exact)
            print(f"[placements] {what}: {len(edges)} edges, a spanning "
                  f"forest; weight {w64!r} ({w64 / exact_w:.6f} x scipy's "
                  f"MST); buckets, edges per bucket == the single path's "
                  f"({stats.buckets}); forest {'==' if same else '!='} the "
                  f"single path's{'' if same else ' (checked on the host)'}; "
                  f"finish_rounds {stats.finish_rounds}; wall "
                  f"{wall:.4f} s; launches {json.dumps(counts)}; card {card}")
            out.append({"variant": MAIN_VARIANT, "exec": f"{exec_str} {spec}",
                        "rounds": stats.finish_rounds,
                        "edges_per_device": list(stats.edges_per_device),
                        "dispatch_sizes": list(stats.dispatch_sizes),
                        "edges": len(edges)})
    if trace:
        session = ConnectIt(MAIN_VARIANT, exec="sharded(x)", device="cuda")
        calls = _trace(torch, "placements (f) amsf(skip=lmax) sharded(x)",
                       lambda: session.amsf(g, w, "amsf(skip=lmax)"))
        waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
        rounds = session.stats.finish_rounds
        print(f"[profile]   host waits {waits} ({waits / rounds:.2f} a "
              f"forest round of {rounds})")
    return out


def _placement_serve(torch, g, seed: int, card: str) -> None:
    """(g): the serve phase's static and dynamic servers under SERVE_EXEC
    at one rank, same caps and traffic (no open loops): answers against
    scipy at 2 epochs, the final labels against scipy, and a traced
    closed-loop window for the host waits a commit."""
    from repro_torch import ConnectIt

    session = ConnectIt(MAIN_VARIANT, exec=SERVE_EXEC, device="cuda")
    pre = f"[placements] (g) serve {SERVE_EXEC}"
    server = serve_static(torch, g, session, seed, card, pre,
                          open_loops=False, epochs=2)
    _trace_serve_window(torch, server, seed)
    del server
    serve_dynamic(torch, g, session, seed, card, pre)


def _placement_gloo(torch, g, expect, card: str) -> None:
    """(d): GLOO_EXECS on two processes that share the card over gloo
    (NCCL takes one rank a card)."""
    _run_ranks(torch, g, expect, 0, 2, "gloo",
               [(MAIN_VARIANT, e) for e in GLOO_EXECS], False, card)


def _single_dynamic(torch, n: int, seed: int) -> dict:
    """The single path's run of the dynamic phase's sliding window: each
    step's answers and rounds, the final labels' partition, and scipy's
    component count of the final live graph with its edge keys."""
    import numpy as np

    from repro_torch import ConnectIt

    d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
        n, dynamic=True, log=sliding_batch_log(n)[1])
    live = np.zeros((0, 2), np.int32)
    answers, rounds = [], []
    for ins, dels, q, args in sliding_steps(torch, n, seed):
        before = d._rounds
        answers.append(d.process(*args).cpu().numpy())
        rounds.append(d._rounds - before)
        if len(dels):
            live = live[~np.isin(_live_keys(live, n), _live_keys(dels, n))]
        live = np.concatenate([live, ins[ins[:, 0] != ins[:, 1]]])
    ncomp, lab = _scipy_labels(n, live)
    labels = canonical(d.labels.cpu().numpy())
    require(np.array_equal(labels, canonical(lab)),
            "ranks: the single path's dynamic labels differ from scipy's")
    return {"answers": answers, "labels": labels, "ncomp": int(ncomp),
            "live": _live_keys(live, n), "used": len(live),
            "rounds": rounds}


def phase_ranks(torch, g, expect, seed: int, world: int, card: str) -> None:
    """``--ranks N``: PLACEMENT_RUNS and (b)'s stream on N processes, one
    rank a card over NCCL, each rank's labels against scipy's; then (e)
    under sharded(x), (f)'s amsf(skip=lmax) under sharded(x), each against
    the single path's run here, and one served closed loop under SERVE_EXEC
    with rank 0 serving and the other ranks following."""
    from repro_torch import ConnectIt
    from repro_torch.graphs.generators import with_weights

    require(torch.cuda.device_count() >= world,
            f"ranks: {world} ranks over NCCL need {world} cards, have "
            f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    dyn = _single_dynamic(torch, g.n, seed)
    w = with_weights(g, seed=0)
    exact_w, _, _ = _mst_weight(g, w)
    spec = "amsf(skip=lmax)"
    edges, st = ConnectIt(MAIN_VARIANT, device="cuda").amsf(
        g, w, spec, return_stats=True)
    print(f"[placements] ranks: the single path's dynamic run and {spec}, "
          f"scipy's MST weight {exact_w!r}: {time.perf_counter() - t0:.1f} s")
    extra = {"dyn": dyn, "weights": w.cpu().numpy(),
             "apps": {"exact": exact_w,
                      "single": {spec: (edges, st.buckets,
                                        st.edges_per_bucket)}}}
    _run_ranks(torch, g, expect, seed, world, "cpu:gloo,cuda:nccl",
               list(PLACEMENT_RUNS), True, card, extra)


def _run_ranks(torch, g, expect, seed: int, world: int, backend: str,
               runs: list, stream: bool, card: str,
               extra: dict = None) -> None:
    """Start ``world`` processes of this script (--mesh-rank), one rank
    each of a group over ``backend``. They read the graph and scipy's
    labels, which this process writes once to a temporary directory (not
    generating the graph again), run ``runs`` (and, with ``stream``, (b)'s
    stream; with ``extra``, phase_ranks' single-path results, (e), (f) and
    the served loop) and write what they measured there. Every rank must
    exit 0, the ranks must agree on each run's rounds and stats, and the
    served loop's ranks must end in rank 0's labels, which scipy's on its
    commit log must give."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    try:
        t0 = time.perf_counter()
        for name in ("senders", "receivers", "indptr", "indices"):
            getattr(g, name).cpu().numpy().tofile(tmp / f"{name}.i32")
        expect.astype("int32").tofile(tmp / "expect.i32")
        (tmp / "job.json").write_text(json.dumps(
            {"n": g.n, "m": g.m, "world": world, "backend": backend,
             "runs": runs, "stream": stream, "seed": seed, "card": card,
             "extra": extra is not None, "tune": extra is not None}))
        if extra is not None:
            extra["weights"].tofile(tmp / "weights.f32")
            (tmp / "extra.pkl").write_bytes(pickle.dumps(
                {k: v for k, v in extra.items() if k != "weights"}))
        t_write = time.perf_counter() - t0
        logs = _run_rank_procs(tmp, world, f"placements {backend}")
        for r, log in enumerate(logs):
            for line in log.splitlines():
                if line.startswith(("[placements]", "[check]")):
                    head, rest = line.split("]", 1)
                    print(f"{head}] {backend} rank {r} of {world}:{rest}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(world)]
        for i, run in enumerate(res[0]):
            keys = ("variant", "rounds", "edges_per_device", "dispatch_sizes")
            require(all({k: x[i][k] for k in keys} ==
                        {k: run[k] for k in keys} for x in res),
                    f"placements {backend} {run['variant']} {run['exec']}: "
                    f"the ranks disagree: {[x[i] for x in res]}")
        if extra is not None:
            written = [r for r in range(world)
                       if (tmp / f"tune{r}.json").exists()]
            require(written == [0], f"placements {backend} auto "
                    f"sharded(x):tune: cache files written by ranks "
                    f"{written}, only rank 0's may be")
            print(f"[placements] {backend} {world} ranks auto "
                  f"sharded(x):tune: every rank elected "
                  f"{res[0][-1]['variant']}; only rank 0's cache file "
                  f"written")
            served = [np.fromfile(tmp / f"served{r}.i32", dtype=np.int32)
                      for r in range(world)]
            for r in range(1, world):
                require(np.array_equal(served[r], served[0]),
                        f"placements {backend} serve: rank {r}'s final "
                        f"labels differ from rank 0's")
            log = np.fromfile(tmp / "commits.i32", dtype=np.int32)
            _, lab = _scipy_labels(g.n, log.reshape(-1, 2))
            require(np.array_equal(canonical(served[0]), canonical(lab)),
                    f"placements {backend} serve: rank 0's final labels "
                    f"differ from scipy's on its {log.size // 2} committed "
                    f"edges")
            print(f"[placements] {backend} {world} ranks serve {SERVE_EXEC}: "
                  f"every follower's final labels == rank 0's == scipy on "
                  f"the {log.size // 2} committed edges")
        print(f"[placements] {backend} {world} ranks: the graph written once "
              f"in {t_write:.2f} s; every rank's labels == scipy's; the "
              f"ranks agree on rounds and stats")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_rank_procs(tmp: Path, world: int, what: str) -> list:
    """Run ``world`` processes of this script (--mesh-rank R --mesh-dir
    tmp) to their end; every one must exit 0 → their logs."""
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-rank", str(r), "--mesh-dir", str(tmp)],
                    stdout=f, stderr=subprocess.STDOUT))
        # a rank that fails leaves the others waiting in a collective
        deadline = time.monotonic() + 900
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        log = logs[r].read_text()
        require(p.returncode == 0, f"{what} rank {r} of {world} exited "
                f"{p.returncode}:\n{log[-4000:]}")
        out.append(log)
    return out


def mesh_rank(rank: int, tmp: str) -> int:
    """One rank of _run_ranks: the job in ``tmp``'s job.json."""
    import statistics

    import numpy as np
    import torch

    from repro_torch import ConnectIt
    from repro_torch.graphs import graph_from_arrays
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    d = Path(tmp)
    job = json.loads((d / "job.json").read_text())
    if job.get("cells"):
        return _rank_cells(rank, d, job)
    if job.get("lm_mesh"):
        return _rank_lm_mesh(rank, d, job)
    if job.get("gnn_mesh"):
        return _rank_gnn_mesh(rank, d, job)
    world, tag = job["world"], f"{job['backend']} {job['world']} ranks "
    arrays = [np.fromfile(d / f"{k}.i32", dtype=np.int32)
              for k in ("senders", "receivers", "indptr", "indices")]
    expect = np.fromfile(d / "expect.i32", dtype=np.int32)
    topo = multihost.initialize(init_method=f"file://{d}/rendezvous",
                                num_processes=world, process_id=rank,
                                backend=job["backend"], timeout=300)
    out = []
    try:
        g = graph_from_arrays(*arrays, job["n"], job["m"], device="cuda")
        for variant, exec_str in job["runs"]:
            what = f"{variant} {exec_str}"
            ci = ConnectIt(variant, exec=exec_str, device="cuda")
            ops.reset_launch_counts()
            labels, stats = ci.connectivity(g, return_stats=True)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            require(np.array_equal(labels.cpu().numpy(), expect),
                    f"rank {rank}: {what}: labels differ from scipy's")
            require(stats.devices == world
                    and sum(stats.edges_per_device) == stats.edges_finish
                    and sum(stats.dispatch_sizes)
                    == stats.edges_finish_padded,
                    f"rank {rank}: {what}: stats {stats}")
            for name in _required_kernels(variant):
                require(counts[name] > 0,
                        f"rank {rank}: {what}: kernel {name} never launched")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ci.connectivity(g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls) * 1e3
            out.append({"variant": variant, "exec": exec_str,
                        "rounds": stats.finish_rounds,
                        "edges_per_device": list(stats.edges_per_device),
                        "dispatch_sizes": list(stats.dispatch_sizes),
                        "wall_ms": wall})
            print(f"[placements] {what}: labels == scipy; median wall of 3 "
                  f"{wall:.4f} ms; finish_rounds {stats.finish_rounds}; "
                  f"edges_per_device {stats.edges_per_device}; launches "
                  f"{json.dumps(counts)}; cuda:{torch.cuda.current_device()} "
                  f"of {topo.num_processes} ranks; card {job['card']}",
                  flush=True)
        if job["stream"]:
            _placement_stream(torch, g, expect, job["seed"], False,
                              job["card"], tag, want=None)
        if job["extra"]:
            out += _rank_extra(torch, g, d, job, expect, rank, tag)
        if job.get("tune"):
            out.append(_rank_tune(torch, g, d, expect, rank, tag))
    finally:
        multihost.shutdown()
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def _rank_extra(torch, g, d: Path, job: dict, expect, rank: int,
                tag: str) -> list:
    """One rank's part of phase_ranks' extra runs: (e) under sharded(x) and
    amsf(skip=lmax) under sharded(x) against the single path's results in
    ``d``, then the served closed loop under SERVE_EXEC (rank 0 serves and
    writes its commit log; every rank writes its final labels)."""
    import pickle

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.serve import Follower

    extra = pickle.loads((d / "extra.pkl").read_bytes())
    out = _placement_dynamic(torch, g, extra["dyn"], job["seed"], False,
                             job["card"], execs=("sharded(x)",), tag=tag,
                             trace=False)
    w = np.fromfile(d / "weights.f32", dtype=np.float32)
    apps = dict(extra["apps"], weights=torch.from_numpy(w).cuda(),
                wh=w[: g.m])
    # the graph's sorted edge keys, as phase_oracle's
    keys = (g.senders[: g.m].cpu().numpy().astype(np.int64) * (g.n + 1)
            + g.receivers[: g.m].cpu().numpy())
    out += _placement_amsf(torch, g, expect, keys, apps, False,
                           job["card"], execs=("sharded(x)",),
                           specs=("amsf(skip=lmax)",), tag=tag, trace=False)
    session = ConnectIt(MAIN_VARIANT, exec=SERVE_EXEC, device="cuda")
    server = serve_server(session, g, dynamic=False)
    t0 = time.perf_counter()
    if isinstance(server, Follower):
        replayed = server.run()
        require(not server.errors, f"rank {rank}: the follower's replays "
                f"raised {server.errors}")
        print(f"[placements] {tag}serve {SERVE_EXEC}: rank {rank} followed "
              f"{replayed} operations (warmup and commits) to epoch "
              f"{server.epoch} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        store = server.store
    else:
        log = _ServeLog(server)
        try:
            serve_preload(torch, server, g, job["seed"], dynamic=False)
            res = serve_closed_loop(server, False, job["seed"])
        finally:
            server.stop_followers()
        ms = [w * 1e3 for w in log.walls]
        print(_serve_row(f"[placements] {tag}serve {SERVE_EXEC} rank 0",
                         f"closed {SERVE_CLIENTS}x{SERVE_REQUESTS}", res))
        print(f"[placements] {tag}serve {SERVE_EXEC}: rank 0 served to "
              f"epoch {server.epoch}; closed loop {len(ms)} commits, commit "
              f"wall p50 {_pct(ms, 0.5):.4f} ms; saturation "
              f"{res.achieved_qps:.1f} query requests/s, p99 "
              f"{res.p99_ms:.4f} ms, committed {res.edges_per_s:.1f} "
              f"edges/s; card {job['card']}", flush=True)
        np.concatenate([np.stack([c[1], c[2]], 1).ravel()
                        for c in log.commits]).astype(np.int32).tofile(
            d / "commits.i32")
        store = server.store
    store.labels.cpu().numpy().tofile(d / f"served{rank}.i32")
    out.append({"variant": MAIN_VARIANT, "exec": f"{SERVE_EXEC} serve",
                "rounds": store.rounds_total, "edges_per_device": [],
                "dispatch_sizes": [store.epoch]})
    return out


def phase_tune(torch, g, expect, card: str) -> None:
    """The tuning loop on the card, each part on a cache file of its own
    under a temporary directory: (a) the five connectivity kernels at the
    ladder's block size against their plain versions, timed, then
    tune_block_m; (b) tune_variant on the graph; (c) ConnectIt("auto") on
    that cache; (d) the tune opt on a fresh cache; (e) launch.tune --smoke,
    then on its full proxies; (f) the script's cold cache resolves 256
    threads again."""
    import contextlib
    import functools
    import io
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import ConnectIt, tune
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_relabel.ref import (
        edge_relabel_ref,
        edge_rewrite_ref,
    )
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref
    from repro_torch.launch import tune as tlaunch
    from repro_torch.tune.space import BLOCK_M_FULL

    # the drivers' calls of each primitive (harness.primitive_drivers)
    plain = {"scatter_min": lambda P, s, r, v: scatter_min_ref(P, s, v),
             "pointer_jump": lambda P, s, r, v: pointer_jump_ref(P, k=3),
             "hook_compress": lambda P, s, r, v: hook_compress_ref(P, s, r,
                                                                   k=1),
             "edge_relabel": lambda P, s, r, v: edge_relabel_ref(P, s, r),
             "edge_rewrite": lambda P, s, r, v: edge_rewrite_ref(P, s, r)}

    def same(got, want) -> bool:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(torch.equal(a, b) for a, b in zip(got, want, strict=True))

    cold = os.environ[tune.ENV_VAR]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    try:
        # (a) every block size of the ladder, bit for bit, before any timing
        t0 = time.perf_counter()
        n, m = g.n, 4 * g.n
        problem = tune.primitive_problem(n, m, seed=0, device="cuda")
        drivers = tune.primitive_drivers(n, m, seed=0, device="cuda")
        for name in tune.PRIMITIVES:
            want = plain[name](*problem)
            for b in BLOCK_M_FULL:
                require(same(drivers[name](block_m=b), want),
                        f"tune: {name} at {b} threads differs from its plain "
                        f"version on tune_block_m's problem")
            try:
                drivers[name](block_m=2 * ops.DEFAULT_BLOCK_M)
                refused = False
            except ValueError:
                refused = True
            require(refused, f"tune: {name} launched at a block size off "
                    f"the ladder")
        torch.cuda.synchronize()
        print(f"[tune] (a) the five kernels at {list(BLOCK_M_FULL)} threads "
              f"a block == their plain versions on tune_block_m's problem "
              f"(n = {n}, m = {m}), and refuse "
              f"{2 * ops.DEFAULT_BLOCK_M}: {time.perf_counter() - t0:.1f} s")
        print(f"[tune] (a) ms a call at n = {n}, m = {m}: the time_fn "
              f"median (3 after 1, host clock, synchronized) and the "
              f"CUDA-event mean of {TUNE_EVENT_ITERS}; card {card}")
        for name in tune.PRIMITIVES:
            row = []
            for b in BLOCK_M_FULL:
                med = tune.time_fn(drivers[name], block_m=b, trials=3,
                                   warmup=1, device="cuda") * 1e3
                ev = time_ms(torch, functools.partial(drivers[name],
                                                      block_m=b),
                             iters=TUNE_EVENT_ITERS)
                row.append(f"{b}: median {med:.4f} event {ev:.4f}")
            print(f"[tune]   {name:14s} " + "; ".join(row))
        cache = tune.SelectionCache(str(tmp / "tune.json"))
        rows = tune.tune_block_m(tune.TuneSpec(), cache=cache, n=n, m=m,
                                 device="cuda")
        winners = {r["primitive"]: r["block_m"] for r in rows if r["winner"]}
        print(f"[tune] (a) tune_block_m(TuneSpec()) over "
              f"{list(tune.TuneSpec().block_m_candidates())}: " + "; ".join(
                  f"{r['primitive']} {r['block_m']} "
                  f"{r['time_s'] * 1e3:.4f} ms" + (" *" if r["winner"] else "")
                  for r in rows))
        require(sorted(winners) == sorted(tune.PRIMITIVES),
                f"tune: block winners {winners}")

        # (b) the variant on the graph
        t0 = time.perf_counter()
        fam = tune.fingerprint_graph(g)
        winner = tune.tune_variant(g, tune.TuneSpec(), cache=cache)
        entry = cache.get(tune.make_key("variant", fam, device=g.device))
        print(f"[tune] (b) tune_variant on the graph (family {fam}), median "
              f"ms of 3 after 1: " + "; ".join(
                  f"{v} {t * 1e3:.4f}" for v, t in entry["candidates"].items())
              + f"; winner {winner} ({time.perf_counter() - t0:.1f} s; card "
              f"{card})")
        require(entry["winner"] == winner
                and winner in tune.TuneSpec().variant_candidates(),
                f"tune: variant entry {entry}")

        # (c) the whole loop: persist, reload, resolve, run the winner
        os.environ[tune.ENV_VAR] = cache.path
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        blocks = {p: ops.tuned_block_m(p, g.device) for p in tune.PRIMITIVES}
        require(blocks == winners, f"tune: resolved blocks {blocks}, tuned "
                f"{winners}")
        ci = ConnectIt("auto", device="cuda")
        labels, st = ci.connectivity(g, return_stats=True)
        _, want = ConnectIt(winner, device="cuda").connectivity(
            g, return_stats=True)
        torch.cuda.synchronize()
        require(st.variant == winner, f"tune: auto ran {st.variant}, the "
                f"cache names {winner}")
        require(np.array_equal(labels.cpu().numpy(), expect),
                "tune: auto's labels differ from scipy's")
        require(st.finish_rounds == want.finish_rounds,
                f"tune: auto's finish rounds {st.finish_rounds}, the "
                f"winner's {want.finish_rounds}")
        print(f"[tune] (c) ConnectIt('auto') on that cache: {st.variant} at "
              f"blocks {blocks}; labels == scipy; finish_rounds "
              f"{st.finish_rounds} == the explicit run's")

        # (d) the tune opt on a fresh cache: one measurement, two calls
        os.environ[tune.ENV_VAR] = str(tmp / "fresh.json")
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        ci = ConnectIt("auto", exec="single:tune", device="cuda")
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = ci.connectivity(g)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            require(np.array_equal(labels.cpu().numpy(), expect),
                    "tune: the tune opt's labels differ from scipy's")
        fresh = tune.SelectionCache(str(tmp / "fresh.json"))
        require(ci._tuned_families == {fam}
                and fresh.keys() == [tune.make_key("variant", fam,
                                                   device=g.device)],
                f"tune: the tune opt measured {ci._tuned_families}, cache "
                f"{fresh.keys()}")
        print(f"[tune] (d) ConnectIt('auto', exec='single:tune') on a fresh "
              f"cache: one family measured, winner "
              f"{fresh.winner(fresh.keys()[0])}, ran {ci.stats.variant}; "
              f"two calls {walls[0]:.2f} s (measuring) and "
              f"{walls[1] * 1e3:.2f} ms; labels == scipy")

        # (e) the CLI's smoke on the card
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tune", "--smoke",
             "--cache", str(tmp / "cli.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        require(cli.returncode == 0,
                f"tune: launch.tune --smoke exited {cli.returncode}:\n"
                f"{(cli.stdout + cli.stderr)[-4000:]}")
        print(f"[tune] (e) python -m repro_torch.launch.tune --smoke: exit 0 "
              f"in {time.perf_counter() - t0:.1f} s; "
              f"{cli.stdout.strip().splitlines()[-1]}")
        # the CLI on its full proxies, in this process: is the
        # device-global winner of small graphs the §4 graph's?
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tlaunch.main(["--cache", str(tmp / "full.json")])
        full = tune.SelectionCache(str(tmp / "full.json"))
        star = full.winner(tune.make_key("variant", "*", device=g.device))
        require(rc == 0 and star in tune.TuneSpec().variant_candidates(),
                f"tune: launch.tune exited {rc}, '*' winner {star}")
        for line in out.getvalue().splitlines():
            if line.strip():
                print(f"[tune]   {line}")
        print(f"[tune] (e) python -m repro_torch.launch.tune (full proxies, "
              f"2^11-2^13 vertices): '*' winner {star}, (b)'s on the graph "
              f"{winner}: {'the same' if star == winner else 'they differ'}"
              f"; {time.perf_counter() - t0:.1f} s; card {card}")
    finally:
        os.environ[tune.ENV_VAR] = cold
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        shutil.rmtree(tmp, ignore_errors=True)
    # (f) the script's cold cache again
    blocks = {p: ops.tuned_block_m(p, g.device) for p in tune.PRIMITIVES}
    require(set(blocks.values()) == {ops.DEFAULT_BLOCK_M},
            f"tune: the cold cache resolves {blocks}")
    print(f"[tune] (f) cold cache {cold}: every kernel at "
          f"{ops.DEFAULT_BLOCK_M} threads a block")


def _rank_tune(torch, g, d: Path, expect, rank: int, tag: str) -> dict:
    """phase_ranks' last run: ConnectIt("auto", exec="sharded(x):tune") with
    this rank's own cache file in ``d`` (only rank 0's is written)."""
    import os

    import numpy as np

    from repro_torch import ConnectIt, tune

    cold = os.environ.get(tune.ENV_VAR)
    os.environ[tune.ENV_VAR] = str(d / f"tune{rank}.json")
    tune.reset_default_cache()
    try:
        t0 = time.perf_counter()
        ci = ConnectIt("auto", exec="sharded(x):tune", device="cuda")
        labels, st = ci.connectivity(g, return_stats=True)
        torch.cuda.synchronize()
    finally:
        if cold is None:
            del os.environ[tune.ENV_VAR]
        else:
            os.environ[tune.ENV_VAR] = cold
        tune.reset_default_cache()
    require(np.array_equal(labels.cpu().numpy(), expect),
            f"rank {rank}: auto sharded(x):tune: labels differ from scipy's")
    print(f"[placements] {tag}auto sharded(x):tune: rank {rank} measured "
          f"and ran {st.variant} in {time.perf_counter() - t0:.1f} s; labels "
          f"== scipy", flush=True)
    return {"variant": st.variant, "exec": "sharded(x):tune",
            "rounds": st.finish_rounds,
            "edges_per_device": list(st.edges_per_device),
            "dispatch_sizes": list(st.dispatch_sizes)}


def _csr(n: int, rows, cols, data=None):
    """scipy's (n, n) CSR matrix of the entries (rows, cols, data; data 1.0
    if None; host arrays or card tensors), its rows sorted (stably) and
    counted on the card: scipy's COO conversion would sort and sum them on
    the host, much of an oracle's time. Entries are kept as they are (the
    MST's input has no duplicates)."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    row, order = torch.sort(torch.as_tensor(rows, device="cuda"), stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    del row
    cols = torch.as_tensor(cols, device="cuda")[order]
    data = (np.ones(order.shape[0]) if data is None else
            torch.as_tensor(data, device="cuda")[order].cpu().numpy())
    return csr_matrix((data, cols.to(torch.int32).cpu().numpy(),
                       indptr.to(torch.int32).cpu().numpy()), shape=(n, n))


def _scipy_labels(n: int, edges):
    """scipy's connected components of the host (k, 2) edge list, each
    vertex pair given once (deduplicated on the card)."""
    import torch
    from scipy.sparse.csgraph import connected_components
    e = torch.as_tensor(edges, device="cuda").long()
    key = torch.unique(torch.minimum(e[:, 0], e[:, 1]) * n
                       + torch.maximum(e[:, 0], e[:, 1]))
    del e
    return connected_components(_csr(n, key // n, key % n), directed=False)


# ---------------------------------------------------------------------------
# The connectit production cells (phase "cells") on a planted graph.
# ---------------------------------------------------------------------------

def cell_shapes(log_n: int) -> dict:
    """CONNECTIT_SHAPES at their published sizes on the default graph; a
    short check (--log-n below 22) cuts every count by the same power of
    two."""
    from repro_torch.configs.base import CONNECTIT_SHAPES
    cut = max(0, DEFAULT_GRAPH[0] - log_n)
    return {k: {f: (v >> cut if f in ("n", "m", "batch", "queries") else v)
                for f, v in spec.items()}
            for k, spec in CONNECTIT_SHAPES.items()}


def cell_arch(log_n: int):
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("connectit"),
                               shapes=cell_shapes(log_n))


def cell_blocks(n: int) -> int:
    """The planted components: 2^20 at every published size."""
    return min(CELL_BLOCKS, n // 64)


def planted_structure(torch, n: int, k: int, seed: int) -> tuple:
    """The planted partition of [0, n) into ``k`` blocks, the same on every
    rank for one seed: ``perm`` (n,) int32, a random order of the vertices,
    and ``starts`` (k + 1,) int32, the sorted random cut points (0 first, n
    last). Block b is the vertices perm[starts[b]:starts[b + 1]]."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device="cuda", dtype=torch.int32)
    cuts = torch.randperm(n - 1, generator=gen, device="cuda")[: k - 1] + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                        cuts.sort().values,
                        torch.full((1,), n, dtype=torch.int64,
                                   device="cuda")]).to(torch.int32)
    return perm, starts


def planted_edges(torch, perm, starts, m: int, seed: int, *, shard: int = 0,
                  shards: int = 1, symmetric: bool = True) -> tuple:
    """Block ``shard`` of ``shards`` of an m-slot planted edge list, int32 on
    the card, generated CELL_CHUNK slots at a time from (seed, shard, chunk)
    so that ranks with one data index make the same block. The n - k tree
    edges (every non-first vertex of a block to a uniform earlier vertex of
    its block) are split among the shards by position range and among a
    shard's chunks evenly; the rest are edges with both ends uniform in one
    block (the block drawn by size). ``symmetric`` stores each edge both
    ways (a static cell's list); otherwise once (a stream batch). Each chunk
    is shuffled."""
    n, k = perm.shape[0], starts.shape[0] - 1
    per_edge = 2 if symmetric else 1
    size = m // shards
    require(size * shards == m and size % per_edge == 0,
            f"planted edges: {m} slots over {shards} shards")
    trees = n - k
    t_lo, t_hi = shard * trees // shards, (shard + 1) * trees // shards
    chunk = min(CELL_CHUNK, size)
    nch = -(-size // chunk)
    before = starts[:-1] - torch.arange(k, dtype=torch.int32, device="cuda")
    s_out = torch.empty(size, dtype=torch.int32, device="cuda")
    r_out = torch.empty(size, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    for c in range(nch):
        lo, hi = c * chunk, min((c + 1) * chunk, size)
        und = (hi - lo) // per_edge
        a = t_lo + c * (t_hi - t_lo) // nch
        b = t_lo + (c + 1) * (t_hi - t_lo) // nch
        require(b - a <= und, "planted edges: the tree does not fit")
        gen.manual_seed((seed << 32) + (shard << 16) + c + 1)
        # tree edge t: the (t - before[blk])-th non-first vertex of its block
        t = torch.arange(a, b, dtype=torch.int32, device="cuda")
        blk = torch.searchsorted(before, t, right=True, out_int32=True) - 1
        p = starts[blk] + 1 + (t - before[blk])
        off = (torch.rand(b - a, generator=gen, device="cuda")
               * (p - starts[blk])).to(torch.int32)
        q = starts[blk] + torch.minimum(off, p - starts[blk] - 1)
        # the rest: both ends uniform in the block of a uniform position
        x = torch.randint(0, n, (und - (b - a),), generator=gen,
                          device="cuda", dtype=torch.int32)
        blk = torch.searchsorted(starts, x, right=True, out_int32=True) - 1
        width = starts[blk + 1] - starts[blk]
        off = (torch.rand(x.shape[0], generator=gen, device="cuda")
               * width).to(torch.int32)
        y = starts[blk] + torch.minimum(off, width - 1)
        u = perm[torch.cat([p, x])]
        v = perm[torch.cat([q, y])]
        if symmetric:
            u, v = torch.cat([u, v]), torch.cat([v, u])
        order = torch.randperm(u.shape[0], generator=gen, device="cuda")
        s_out[lo:hi] = u[order]
        r_out[lo:hi] = v[order]
    return s_out, r_out


def block_of(torch, perm, starts):
    """(n,) int32: each vertex's planted block."""
    n = perm.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    out[perm.long()] = torch.searchsorted(starts, pos, right=True,
                                          out_int32=True) - 1
    return out


def planted_misses(torch, labels, s, r, n: int) -> tuple:
    """(edges whose ends' roots differ, distinct roots in [0, n)) of
    ``labels`` (n + 1 slots at least) compressed to roots. Labels are exact
    iff both are (0, k): every block lies in one class, and there are as
    many classes as blocks."""
    from repro_torch.core.primitives import full_compress
    P = full_compress(labels[: n + 1].contiguous())
    require(torch.equal(P[P.long()], P), "cells: labels not compressed")
    miss = 0
    for lo in range(0, s.shape[0], CELL_CHUNK):
        a, b = s[lo: lo + CELL_CHUNK], r[lo: lo + CELL_CHUNK]
        miss += int((P[a] != P[b]).sum())
    roots = int((P[:n] == torch.arange(n, dtype=P.dtype,
                                        device=P.device)).sum())
    return miss, roots


def _cell_run(torch, fn, args, repeats: int = 0) -> tuple:
    """(output, launches, peak bytes above the inputs, wall s of the
    counted run, walls of ``repeats`` more runs)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, counts, peak, wall, walls


def _check_cell_counts(shape: str, counts: dict, rounds: int,
                       exact: bool) -> None:
    got = tuple(counts[x] for x in PATH_KERNELS)
    want = CELL_COUNTS.get(shape)
    require(counts["hook_compress"] > 0,
            f"cells {shape}: hook_compress never launched")
    if exact:
        require(want == (got, rounds), f"cells {shape}: launches {got} and "
                f"rounds {rounds}, want {want}")
    print(f"[cells] {shape}: launches of {'/'.join(PATH_KERNELS)} {got} "
          f"(CELL_COUNTS {want}{'' if exact else ', not asserted'}), "
          f"rounds {rounds}")


def phase_cells(torch, g, expect, seed: int, log_n: int, log_m: int,
                exact: bool, card: str) -> None:
    """The connectit cells through launch.steps.build_cell on a one-rank
    (data, model) mesh over NCCL, at their published sizes on planted
    graphs; then the legacy shims, the dry run and the ingest CLIs."""
    import statistics

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell, local_block

    arch = cell_arch(log_n)
    multihost.initialize()
    clis = None
    try:
        mesh = make_smoke_mesh("cuda")
        # static_1b_edges: replicated labels
        shape = "static_1b_edges"
        spec = arch.shapes[shape]
        t0 = time.perf_counter()
        n, k = spec["n"], cell_blocks(spec["n"])
        perm, starts = planted_structure(torch, n, k, seed)
        cell = build_cell(arch, shape, mesh, device="cuda")
        s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0], seed)
        torch.cuda.synchronize()
        print(f"[cells] {shape}: planted n={n} k={k} m={s.shape[0]} "
              f"generated on the card in {time.perf_counter() - t0:.2f} s")
        P0 = torch.arange(n + 1, dtype=torch.int32, device="cuda")
        args = [local_block(x, sh, mesh)
                for x, sh in zip((P0, s, r), cell.in_shardings)]
        (P, rounds), counts, peak, wall, walls = _cell_run(
            torch, cell.fn, args, repeats=CELL_TIMING_REPEATS)
        miss, roots = planted_misses(torch, P, s, r, n)
        require((miss, roots) == (0, k), f"cells {shape}: {miss} edges "
                f"across classes, {roots} classes for {k} blocks")
        _check_cell_counts(shape, counts, int(rounds), exact)
        inputs = sum(x.numel() * 4 for x in args)
        print(f"[cells] {shape}: exact (every edge inside a class, {roots} "
              f"classes = {k} blocks); wall {wall:.4f} s first, median of "
              f"{len(walls)} after it {statistics.median(walls):.4f} s "
              f"({[round(w, 4) for w in walls]}); peak "
              f"{peak} bytes above the {inputs} bytes of inputs; outer "
              f"rounds {int(rounds)}; card {card}")
        del s, r, P, args, cell
        # ingest_256m_batch: one planted batch and uniform queries
        shape = "ingest_256m_batch"
        spec = arch.shapes[shape]
        cell = build_cell(arch, shape, mesh, device="cuda")
        u, v = planted_edges(torch, perm, starts, cell.args[1].shape[0],
                             seed + 1, symmetric=False)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        qa, qb = (torch.randint(0, n, (cell.args[3].shape[0],),
                                generator=gen, device="cuda",
                                dtype=torch.int32) for _ in range(2))
        args = [local_block(x, sh, mesh)
                for x, sh in zip((P0, u, v, qa, qb), cell.in_shardings)]
        (P, ans, rounds), counts, peak, wall, walls = _cell_run(
            torch, cell.fn, args, repeats=1)
        miss, roots = planted_misses(torch, P, u, v, n)
        require((miss, roots) == (0, k), f"cells {shape}: {miss} edges "
                f"across classes, {roots} classes for {k} blocks")
        bid = block_of(torch, perm, starts)
        want = bid[qa.long()] == bid[qb.long()]
        require(torch.equal(ans, want), f"cells {shape}: answers differ "
                f"from block identity")
        _check_cell_counts(shape, counts, int(rounds), exact)
        print(f"[cells] {shape}: exact; {int(ans.sum())} of {ans.shape[0]} "
              f"query pairs connected, every answer == block identity; "
              f"{u.shape[0] / walls[0]:.4e} batch edges/s (wall "
              f"{walls[0]:.4f} s; first run {wall:.4f} s); peak {peak} "
              f"bytes above the inputs; rounds {int(rounds)}; card {card}")
        del u, v, P, ans, args, cell, bid, want, perm, starts
        # the sharded cells at one rank, on one planted 2^31-slot list
        sharded_cells(torch, arch, mesh, seed, exact, card)
        multihost.shutdown()
        torch.cuda.empty_cache()
        _shims_on_card(torch, g, expect)
        # every wall above is timed alone; the ingest CLIs generate their
        # graphs on the host from here on, beside the dry run (no card)
        cli_n, cli_m = log_n - CLI_LOG_CUT, log_m - CLI_LOG_CUT
        clis = _start_ingest_clis(cli_n, cli_m, seed)
        _dryrun_cli()
        _finish_ingest_clis(clis, cli_n, cli_m, seed)
    finally:
        multihost.shutdown()
        for p in (clis or {}).get("procs", {}).values():
            if p.poll() is None:
                p.kill()
                p.wait()


def sharded_cells(torch, arch, mesh, seed: int, exact: bool,
                  card: str) -> None:
    """static_8b_edges_sharded and static_8b_sharded_fused on ``mesh``:
    each rank generates only its own edge block and label window, and
    checks the gathered labels (its own block's edges, the count reduced
    over the mesh)."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch.shardings import spec_axes
    from repro_torch.launch.steps import build_cell

    shapes = ("static_8b_edges_sharded", "static_8b_sharded_fused")
    spec = arch.shapes[shapes[0]]
    n, k = spec["n"], cell_blocks(spec["n"])
    t0 = time.perf_counter()
    perm, starts = planted_structure(torch, n, k, seed)
    cell = build_cell(arch, shapes[0], mesh, device="cuda")
    eaxes = spec_axes(cell.in_shardings[1][0])
    s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0], seed,
                         shard=coll.shard_index(mesh, eaxes),
                         shards=coll.mesh_size(mesh, eaxes))
    del perm, starts
    torch.cuda.synchronize()
    rank = f"rank {coll.shard_index(mesh, mesh.mesh_dim_names)} of " \
           f"{mesh.size()}"
    print(f"[cells] {shapes[0][:-8]}: {rank} planted n={n} k={k}, its block "
          f"of {s.shape[0]} of {cell.args[1].shape[0]} edge slots generated "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    n1 = cell.args[0].shape[0]
    per = n1 // coll.axis_size(mesh, "model")
    lo = coll.axis_index(mesh, "model") * per
    window = torch.arange(lo, lo + per, dtype=torch.int32, device="cuda")
    for shape in shapes:
        cell = build_cell(arch, shape, mesh, device="cuda")
        (P, rounds), counts, peak, wall, _ = _cell_run(
            torch, cell.fn, (window, s, r))
        full = coll.all_gather(P, mesh, ("model",))
        del P
        miss, roots = planted_misses(torch, full, s, r, n)
        miss = int(coll.pmax(torch.tensor([miss], device="cuda"), mesh,
                             mesh.mesh_dim_names))
        require((miss, roots) == (0, k), f"cells {shape} {rank}: {miss} "
                f"edges across classes, {roots} classes for {k} blocks")
        if mesh.size() == 1:
            _check_cell_counts(shape, counts, int(rounds), exact)
        print(f"[cells] {shape}: {rank} exact (every edge inside a class, "
              f"{roots} classes = {k} blocks); wall {wall:.4f} s; peak "
              f"{peak} bytes above the {(window.numel() + 2 * s.numel()) * 4} "
              f"bytes of inputs; rounds {int(rounds)}; launches "
              f"{json.dumps(counts)}; card {card}", flush=True)
        del full


def _dryrun_cli() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both"], cwd=ROOT, env=_src_env(), capture_output=True,
        text=True, timeout=300)
    require(proc.returncode == 0, f"dryrun exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    summary = [x for x in proc.stdout.splitlines()
               if x.startswith("DRY-RUN SUMMARY")]
    print(f"[cells] python -m repro_torch.launch.dryrun --all --mesh both: "
          f"exit 0 in {time.perf_counter() - t0:.1f} s; {summary[0]}")


def _src_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _ingest_args(log_n: int, log_m: int, seed: int) -> list:
    return ["--n", str(1 << log_n), "--edges", str(1 << log_m),
            "--seed", str(seed)]


def _start_ingest_clis(log_n: int, log_m: int, seed: int) -> dict:
    """Start the plain, the stopped (--ckpt-dir, --max-steps) and the
    chunked ingest CLI, together: each generates its graph on the host."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ingest_"))
    base = [sys.executable, "-m", "repro_torch.launch.ingest"] + \
        _ingest_args(log_n, log_m, seed)
    batch = ["--batch", str(1 << (log_m - 5))]
    runs = {
        "plain": base + batch + ["--out", str(tmp / "plain.npy")],
        "stopped": base + batch + ["--ckpt-dir", str(tmp / "ckpt"),
                                   "--max-steps", str(CLI_STOP_STEPS)],
        "chunked": base + ["--chunked", "--batch", str(1 << (log_m - 3)),
                           "--out", str(tmp / "chunked.npy")],
    }
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=_src_env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, cmd in runs.items()}
    return {"tmp": tmp, "procs": procs, "cmds": runs, "t0": time.perf_counter()}


def _wait_cli(clis: dict, key: str) -> str:
    proc = clis["procs"][key]
    out, _ = proc.communicate(timeout=600)
    require(proc.returncode == 0, f"ingest CLI {key} exited "
            f"{proc.returncode}:\n{out[-3000:]}")
    return out.strip().splitlines()[-1]


def _finish_ingest_clis(clis: dict, log_n: int, log_m: int,
                        seed: int) -> None:
    """Every ingest CLI's labels against scipy: the plain and the resumed
    run's on their rmat's edges, the chunked run's on its own stream's."""
    import shutil

    import numpy as np

    from repro_torch.graphs.generators import rmat_chunks, rmat_edges
    from repro_torch.legacy import checkpoint as ckpt

    tmp = clis["tmp"]
    try:
        # the resumed run starts as soon as the stopped one has ended: the
        # two host generations in a row are the phase's longest chain
        print(f"[cells] ingest CLI stopped: {_wait_cli(clis, 'stopped')}")
        stopped = ckpt.latest_step(str(tmp / "ckpt"))
        require(stopped is not None and stopped > 0,
                "ingest CLI stopped: no checkpoint written")
        resume = clis["cmds"]["stopped"][:-2] + ["--out",
                                                 str(tmp / "resumed.npy")]
        clis["procs"]["resumed"] = subprocess.Popen(
            resume, cwd=ROOT, env=_src_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        # the chunked stream's scipy labels, while the CLIs run
        src = rmat_chunks(1 << log_n, 1 << log_m, chunk=1 << (log_m - 3),
                          seed=seed)
        edges = np.concatenate(list(src.chunks()))
        _, lab = _scipy_labels(1 << log_n, edges)
        chunk_expect = canonical(lab)
        _, lab = _scipy_labels(1 << log_n, rmat_edges(1 << log_n, 1 << log_m,
                                                      seed=seed))
        expect = canonical(lab)
        del edges, lab
        for key in ("plain", "chunked"):
            print(f"[cells] ingest CLI {key}: {_wait_cli(clis, key)}")
        print(f"[cells] ingest CLI resumed from step {stopped}: "
              f"{_wait_cli(clis, 'resumed')}")
        plain = np.load(tmp / "plain.npy")
        resumed = np.load(tmp / "resumed.npy")
        require(np.array_equal(resumed, plain),
                "ingest CLI: the resumed run's labels differ from the "
                "uninterrupted run's")
        require(np.array_equal(canonical(plain), expect),
                "ingest CLI: labels differ from scipy's")
        require(np.array_equal(canonical(np.load(tmp / "chunked.npy")),
                               chunk_expect),
                "ingest CLI --chunked: labels differ from scipy's")
        print(f"[cells] ingest CLIs (n=2^{log_n}, 2^{log_m} edges): plain == "
              f"resumed == scipy's labels; --chunked == scipy's on its "
              f"stream; {time.perf_counter() - clis['t0']:.1f} s in all")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _shims_on_card(torch, g, expect) -> None:
    """The legacy shims on the graph phase's graph, each against scipy,
    with the launches each made."""
    import warnings

    import numpy as np

    from repro_torch.core import distributed as tdist
    from repro_torch.core import driver
    from repro_torch.core.finish import get_finish
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh

    def run(what, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            labels = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        labels = labels.cpu().numpy()[: g.n]
        require(np.array_equal(canonical(labels), expect),
                f"shim {what}: labels differ from scipy's")
        print(f"[cells] shim {what}: labels == scipy's; wall {wall:.4f} s; "
              f"launches {json.dumps(counts)}")
        return counts

    run('connectivity(g, sample="kout", finish="uf_sync")',
        lambda: driver.connectivity(g, sample="kout", finish="uf_sync"))
    run('get_finish("liu_tarjan_CRFA") through run_connectivity',
        lambda: driver.run_connectivity(g, None,
                                        get_finish("liu_tarjan_CRFA"))[0])
    multihost.initialize()
    try:
        mesh = make_smoke_mesh("cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            prog = tdist.make_replicated_connectivity(
                mesh, ("data", "model"), rounds=SHIM_MESH_ROUNDS)
            step = tdist.make_replicated_step(mesh, ("data", "model"))
        P0 = torch.arange(g.n + 1, dtype=torch.int32, device="cuda")
        out = {}

        def legacy():
            out["P"] = prog(P0, g.senders, g.receivers)
            return out["P"]

        counts = run(f"make_replicated_connectivity(rounds="
                     f"{SHIM_MESH_ROUNDS}) at one rank", legacy)
        require(torch.equal(step(out["P"], g.senders, g.receivers),
                            out["P"]),
                "shim make_replicated_connectivity: not at its fixpoint")
        require(counts["scatter_min"] > 0 and counts["pointer_jump"] > 0,
                "shim make_replicated_connectivity: scatter_min or "
                "pointer_jump never launched")
    finally:
        multihost.shutdown()


def phase_cells_ranks(torch, seed: int, world: int, card: str) -> None:
    """``--ranks N``: the two sharded cells at their published sizes on a
    (data, model) mesh over N processes of this script, one rank a card over
    NCCL; every rank generates its own edge block and checks the gathered
    labels."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cells_"))
    try:
        (tmp / "job.json").write_text(json.dumps(
            {"cells": True, "world": world, "backend": "cpu:gloo,cuda:nccl",
             "seed": seed, "card": card, "log_n": DEFAULT_GRAPH[0]}))
        for r, log in enumerate(_run_rank_procs(tmp, world, "cells")):
            for line in log.splitlines():
                if line.startswith("[cells]"):
                    print(f"[cells] {world} ranks, rank {r}:{line[7:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_cells(rank: int, d: Path, job: dict) -> int:
    """One rank of phase_cells_ranks."""
    import torch

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh

    multihost.initialize(init_method=f"file://{d}/rendezvous",
                         num_processes=job["world"], process_id=rank,
                         backend=job["backend"], timeout=300)
    try:
        mesh = make_smoke_mesh("cuda")
        print(f"[cells] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"on cuda:{torch.cuda.current_device()}", flush=True)
        sharded_cells(torch, cell_arch(job["log_n"]), mesh, job["seed"],
                      False, job["card"])
    finally:
        multihost.shutdown()
    return 0


def phase_dlrm(torch, cap: int, seed: int, results: dict, parent=None):
    """DLRM-RM2 serving on the card: each cell through the embedding_bag
    kernel against the same model through the plain version; with
    ``parent`` (--parent) also through the parent's bags, in turns. Returns
    the model and each cell's inputs, for the profile phase."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models import dlrm as dlrm_mod

    arch = get_arch("dlrm-rm2")
    cfg = arch.model
    vocab = min(RM2_VOCAB, cap)
    if vocab < RM2_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_sizes=(vocab,) * cfg.n_sparse)
    precision = torch.get_float32_matmul_precision()
    require(precision == "highest" and not torch.backends.cuda.matmul.allow_tf32,
            f"float32 matmuls must run in full float32, got {precision!r}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dlrm_mod.init_dlrm(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * t.element_size() for t in model.tables)
    print(f"[dlrm] {cfg.name}: {cfg.n_sparse} tables of "
          f"{tuple(model.tables[0].shape)} float32 = {table_bytes} bytes, "
          f"built on the card from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s; float32 matmul precision "
          f"{precision!r}, TF32 off")

    def plain(fn, *args):
        with mock.patch.object(dlrm_mod, "embedding_bags", _plain_bags):
            return fn(model, *args)

    def wall_ms(fn, steps: int) -> list:
        fn()  # warm
        out = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)

    def pct(xs: list, q: float) -> float:
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    serve_inputs = {}
    for shape, steps in (("serve_p99", 50), ("serve_bulk", 10),
                         ("retrieval_cand", 20)):
        cell = build_cell(arch, shape)
        B = min(cell.args[0].shape[0], cap)
        batch = RecsysStream(batch=B, n_dense=cfg.n_dense,
                             n_sparse=cfg.n_sparse, vocab=vocab,
                             multi_hot=cfg.multi_hot,
                             seed=seed).batch_at(0, device="cuda")
        inputs = [batch["dense"], batch["sparse"]]
        if shape == "retrieval_cand":
            n_cand = min(cell.args[2].shape[0], cap)
            inputs.append(torch.randn(n_cand, cfg.embed_dim, generator=gen,
                                      device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        got = cell.fn(model, *inputs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(counts["embedding_bag"] == 1 and sum(counts.values()) == 1,
                f"dlrm {shape}: launches {counts}, want 1 of embedding_bag "
                f"(all {cfg.n_sparse} tables) and nothing else")
        want = plain(cell.fn, *inputs)
        if shape == "retrieval_cand":
            (vals, idx), (want_vals, want_idx) = got, want
            require(vals.shape == (100,) and bool(torch.isfinite(vals).all()),
                    f"dlrm {shape}: top-k values {tuple(vals.shape)}")
            require(torch.equal(idx, want_idx),
                    f"dlrm {shape}: top-100 indices differ from the plain "
                    f"path's")
            err = float((vals - want_vals).abs().max())
            require(err <= 1e-6, f"dlrm {shape}: top-100 values differ by "
                    f"{err}")
            check = f"top-100 indices equal, values within {err}"
        else:
            require(got.shape == (B,) and bool(torch.isfinite(got).all())
                    and bool(((got >= 0) & (got <= 1)).all()),
                    f"dlrm {shape}: probabilities {tuple(got.shape)}")
            with torch.inference_mode():
                logits = model(*inputs)
                want_logits = plain(lambda m, *a: m(*a), *inputs)
            require(torch.equal(logits, want_logits) and torch.equal(got, want),
                    f"dlrm {shape}: logits differ from the plain path's at L=1")
            check = "logits and probabilities equal to the plain path's"
        ms = wall_ms(lambda: cell.fn(model, *inputs), steps)
        plain_ms = wall_ms(lambda: plain(cell.fn, *inputs), 3)
        vs = ""
        if parent is not None:
            # the parent's bags (a launch a table) in the same model, in
            # turns: parent, change, change, parent; the same bits
            with mock.patch.object(dlrm_mod, "embedding_bags",
                                   parent.kernels.legacy.embedding_bags):
                theirs = cell.fn(model, *inputs)
            pairs = (zip(got, theirs) if shape == "retrieval_cand"
                     else [(got, theirs)])
            require(all(torch.equal(a, b) for a, b in pairs),
                    f"dlrm {shape}: the parent's output differs")
            turns = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                with mock.patch.object(
                        dlrm_mod, "embedding_bags",
                        parent.kernels.legacy.embedding_bags
                        if who == "parent" else dlrm_mod.embedding_bags):
                    turns[who] += wall_ms(lambda: cell.fn(model, *inputs),
                                          steps)
            p50 = {k: pct(sorted(v), 0.5) for k, v in turns.items()}
            vs = (f"; in turns, {2 * steps} steps each: p50 parent "
                  f"{p50['parent']:.4f} -> change {p50['change']:.4f} ms "
                  f"({p50['parent'] / p50['change']:.2f}x), the same bits")
        rate = ""
        if shape == "serve_bulk":
            rate = f"; {B / (sum(ms) / len(ms) / 1e3):.1f} samples/s"
            results["embedding_bag"]["launches"] = counts["embedding_bag"]
        serve_inputs[shape] = inputs
        print(f"[dlrm] {shape} B={B}"
              + (f" candidates={inputs[2].shape[0]}" if len(inputs) > 2
                 else "")
              + f": {check}; wall per step over {steps} warm steps p50 "
              f"{pct(ms, 0.5):.4f} ms, p99 {pct(ms, 0.99):.4f} ms, mean "
              f"{sum(ms) / len(ms):.4f} ms{rate}; plain path p50 "
              f"{pct(plain_ms, 0.5):.4f} ms; peak device memory {peak} "
              f"bytes; embedding_bag launches per step "
              f"{counts['embedding_bag']}; cell meta {cell.meta}{vs}")
    return model, serve_inputs


def phase_train(torch, cap: int, seed: int, results: dict, card: str,
                parent=None):
    """DLRM-RM2's train_batch cell at full width on the card, its
    determinism, the kernels against the plain versions on one step, and
    launch.train's simulated failure and resume; with ``parent``
    (--parent) a step through the parent's bags from the same state, the
    same bits, and steps in turns."""
    import warnings
    from unittest import mock

    import numpy as np

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.legacy.embedding_bag.ref import (
        embedding_bag_backward_ref,
        embedding_bag_ref,
    )
    from repro_torch.launch.steps import OPT, build_cell
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models import dlrm as dlrm_mod

    precision = torch.get_float32_matmul_precision()
    require(precision == "highest" and not torch.backends.cuda.matmul.allow_tf32,
            f"float32 matmuls must run in full float32, got {precision!r}")
    arch = get_arch("dlrm-rm2")
    cell = build_cell(arch, "train_batch")
    B = min(cell.args[0].shape[0], cap)

    def setup(cfg):
        model = dlrm_mod.init_dlrm(cfg, key=trandom.PRNGKey(seed,
                                                            device="cuda"))
        stream = RecsysStream(batch=B, n_dense=cfg.n_dense,
                              n_sparse=cfg.n_sparse, vocab=cfg.vocab_sizes[0],
                              multi_hot=cfg.multi_hot, seed=seed)
        return model, [optim.init_adam(model.params())], stream

    def step(model, state, batch) -> dict:
        _, state[0], info = cell.fn(model, state[0], batch["dense"],
                                    batch["sparse"], batch["labels"])
        return info

    def leaves(model, state) -> list:
        return optim.tree_leaves((model.params(), state[0]))

    class PlainBag(torch.autograd.Function):
        """The bag through its plain versions, forward and backward."""

        @staticmethod
        def forward(ctx, table, idx, mode):
            ctx.save_for_backward(table, idx)
            ctx.mode = mode
            return embedding_bag_ref(table, idx, mode)

        @staticmethod
        def backward(ctx, g):
            table, idx = ctx.saved_tensors
            return (embedding_bag_backward_ref(table, idx, g, ctx.mode), None,
                    None)

    @torch.no_grad()
    def load(model, state, saved) -> None:
        for dst, src in zip(leaves(model, state), saved):
            dst.copy_(src)

    cfg = _rm2_config(cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state, stream = setup(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(x.numel() * x.element_size()
                      for x in leaves(model, state))
    print(f"[train] {cfg.name} train_batch B={B}: {cfg.n_sparse} tables of "
          f"{tuple(model.tables[0].shape)} float32; parameters and AdamW "
          f"moments {state_bytes} bytes, drawn on the card from "
          f"PRNGKey({seed}) (jax.random's numbers) in {init_s:.2f} s; "
          f"float32 matmul precision {precision!r}, TF32 off; cell meta "
          f"{cell.meta}, donate {cell.donate}")
    batches = [stream.batch_at(i, device="cuda")
               for i in range(TRAIN_STEPS + 2)]
    losses = [float(step(model, state, batches[0])["loss"])]  # warm
    # the counted step draws its batch too (batches[1] again): RecsysStream's
    # normal and two uniforms, a threefry_bits launch each
    ops.reset_launch_counts()
    info = step(model, state, stream.batch_at(1, device="cuda"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    # one forward launch and one backward call for all the tables
    # (embedding_bags)
    want.update(embedding_bag=1, embedding_bag_backward=1, threefry_bits=3)
    require(counts == want, f"train: launches {counts}, want {want}")
    for name in ("embedding_bag_backward", "threefry_bits"):
        results[name]["launches"] = counts[name]
    losses.append(float(info["loss"]))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(2, TRAIN_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = step(model, state, batches[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(info["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    p50 = float(np.median(walls))
    print(f"[train] {TRAIN_STEPS} timed steps: step wall p50 {p50:.4f} s "
          f"(min {min(walls):.4f}, max {max(walls):.4f}), {B / p50:.1f} "
          f"samples/s; peak above the model, moments and batches {peak} "
          f"bytes; losses first {losses[0]:.6f} last {losses[-1]:.6f} "
          f"({len(losses)} steps, all finite); lr {float(info['lr']):.3e} "
          f"grad_norm {float(info['grad_norm']):.6f}; launches a step "
          f"{json.dumps(counts)}; card {card}")
    _trace(torch, f"dlrm-rm2 train_batch step B={B}",
           lambda: step(model, state, batches[0]))
    # AdamW alone on one step's gradients: its bound reads the parameters,
    # gradients and both moments and writes the parameters and moments
    params = model.params()
    b = batches[0]
    grads = optim.tree_unflatten(params, torch.autograd.grad(
        model.loss(b["dense"], b["sparse"], b["labels"]),
        optim.tree_leaves(params)))
    adam_ms = time_ms(torch, lambda: optim.update(
        OPT, params, grads, state[0]), iters=5, warmup=1)
    adam_bound = 7 * state_bytes / 3 / HBM_BYTES_PER_S * 1e3
    print(f"[train] AdamW alone (optim.update, plain per-leaf ops) on one "
          f"step's gradients: {adam_ms:.4f} ms a step, {adam_ms / adam_bound:.2f}x "
          f"its bytes bound {adam_bound:.4f} ms (7 x {state_bytes // 3} "
          f"bytes at 3.35 TB/s)")
    del grads, params

    # the same step twice from one state saved to the host: the same bits
    saved = [x.detach().cpu() for x in leaves(model, state)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(model, state, batches[1])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print(f"[train] diagnostic step under "
          f"torch.use_deterministic_algorithms(warn_only=True): "
          f"{len(named)} ops named without a deterministic kernel"
          + "".join(f"\n[train]   {x[:200]}" for x in named))
    load(model, state, saved)
    ours = float(step(model, state, batches[1])["loss"])
    first = [x.detach().cpu() for x in leaves(model, state)]
    load(model, state, saved)
    step(model, state, batches[1])
    torch.cuda.synchronize()
    same = [torch.equal(x.cpu(), y) for x, y in zip(leaves(model, state),
                                                    first)]
    require(all(same), f"train: one step twice from the same state gives "
            f"other bits in {same.count(False)} of {len(same)} leaves")
    print(f"[train] one step twice from the same saved state: all "
          f"{len(same)} parameter and moment leaves equal bit for bit")
    if parent is not None:
        # the parent's bags (a forward launch a table, its backward) from
        # the same state and batch: the same loss and leaves, bit for bit;
        # then steps in turns, parent, change, change, parent
        theirs_bags = parent.kernels.legacy.embedding_bags
        load(model, state, saved)
        with mock.patch.object(dlrm_mod, "embedding_bags", theirs_bags):
            theirs = float(step(model, state, batches[1])["loss"])
        torch.cuda.synchronize()
        same = [torch.equal(x.cpu(), y) for x, y in zip(leaves(model, state),
                                                        first)]
        require(theirs == ours and all(same), f"train: the parent's step "
                f"from the same state gives loss {theirs!r} against "
                f"{ours!r}, other bits in {same.count(False)} of "
                f"{len(same)} leaves")
        turns = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            with mock.patch.object(
                    dlrm_mod, "embedding_bags",
                    theirs_bags if who == "parent" else dlrm_mod.embedding_bags):
                for i in range(2, 2 + TRAIN_STEPS // 2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(model, state, batches[i])
                    torch.cuda.synchronize()
                    turns[who].append(time.perf_counter() - t0)
        p50s = {k: float(np.median(v)) for k, v in turns.items()}
        print(f"[train] the parent's bags from the same state: loss "
              f"{theirs!r} and all {len(same)} leaves equal to this step's "
              f"bit for bit; step wall in turns, {TRAIN_STEPS} steps each: "
              f"p50 parent {p50s['parent']:.4f} -> change "
              f"{p50s['change']:.4f} s "
              f"({p50s['parent'] / p50s['change']:.3f}x); card {card}")
    del model, state, batches, saved, first
    torch.cuda.empty_cache()

    # one step through the kernels against the plain versions
    small = _rm2_config(cap, TRAIN_CHECK_VOCAB)
    model, state, stream = setup(small)
    batch = stream.batch_at(0, device="cuda")
    start = [x.detach().clone() for x in leaves(model, state)]
    kinfo = step(model, state, batch)
    kernel = [x.detach().clone() for x in leaves(model, state)]
    load(model, state, start)
    before = ops.launch_counts()
    with mock.patch.object(dlrm_mod, "embedding_bags",
                           lambda tables, idx, mode="sum": [
                               PlainBag.apply(t, i, mode)
                               for t, i in zip(tables, idx)]):
        pinfo = step(model, state, batch)
    torch.cuda.synchronize()
    require(ops.launch_counts() == before,
            "train: the plain step launched a kernel")
    require(float(kinfo["loss"]) == float(pinfo["loss"]),
            f"train: the loss through the kernels {float(kinfo['loss'])!r} "
            f"differs from the plain step's {float(pinfo['loss'])!r}")
    n_params = len(optim.tree_leaves(model.params()))
    worst = {"params": 0.0, "moments": 0.0}
    for i, (k, p) in enumerate(zip(kernel, leaves(model, state))):
        if p.dim() == 0:  # the step
            require(torch.equal(k, p), "train: the steps differ")
            continue
        part = "params" if i < n_params else "moments"
        scale = float(p.abs().max())
        rel = float((k - p).abs().max()) / max(scale, 1e-30)
        worst[part] = max(worst[part], rel)
        require(rel <= TRAIN_LEAF_TOL[part],
                f"train: {part} leaf {i} through the kernels differs from "
                f"the plain step's by {rel:.3e} of its largest magnitude "
                f"(tolerance {TRAIN_LEAF_TOL[part]})")
    print(f"[train] one step at vocab {small.vocab_sizes[0]} through the "
          f"kernels against the plain versions: loss equal "
          f"({float(kinfo['loss']):.6f}); largest leaf difference "
          f"{worst['params']:.3e} of the leaf's magnitude in the parameters, "
          f"{worst['moments']:.3e} in the moments (tolerances "
          f"{TRAIN_LEAF_TOL})")
    del model, state, start, kernel, batch
    torch.cuda.empty_cache()
    _train_cli(seed)


def _train_cli(seed: int, arch: str = "dlrm-rm2", tag: str = "train") -> None:
    """launch.train --arch ``arch`` on the card: a run stopped by
    --simulate-failure, rerun to its end, against an uninterrupted run (the
    two first runs side by side); the final checkpoints equal leaf for
    leaf."""
    import shutil
    import tempfile

    import numpy as np

    c = TRAIN_CLI
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--device", "cuda", "--steps", str(c["steps"]),
           "--ckpt-every", str(c["every"]), "--seed", str(seed)]
    t0 = time.perf_counter()
    try:
        procs = {d: subprocess.Popen(
            cmd + ["--ckpt-dir", str(tmp / d)] + extra, cwd=ROOT,
            env=_src_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
            for d, extra in (("stopped", ["--simulate-failure",
                                          str(c["fail"])]),
                             ("whole", []))}
        out = {d: p.communicate(timeout=300)[0] for d, p in procs.items()}
        require(procs["stopped"].returncode == 42,
                f"launch.train --simulate-failure exited "
                f"{procs['stopped'].returncode}:\n{out['stopped'][-2000:]}")
        require(procs["whole"].returncode == 0,
                f"launch.train exited {procs['whole'].returncode}:\n"
                f"{out['whole'][-2000:]}")
        rerun = subprocess.run(cmd + ["--ckpt-dir", str(tmp / "stopped")],
                               cwd=ROOT, env=_src_env(), capture_output=True,
                               text=True, timeout=300)
        resumed = c["fail"] // c["every"] * c["every"]
        require(rerun.returncode == 0 and
                f"resumed from step {resumed}" in rerun.stdout,
                f"launch.train rerun exited {rerun.returncode}:\n"
                f"{rerun.stdout[-2000:]}{rerun.stderr[-2000:]}")
        name = f"ckpt_{c['steps']:010d}.npz"
        with np.load(tmp / "stopped" / name) as a, \
                np.load(tmp / "whole" / name) as b:
            require(sorted(a.files) == sorted(b.files),
                    "launch.train: the checkpoints hold other leaves")
            bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
            n_leaves = len(a.files)
        require(not bad, f"launch.train: the resumed run's final checkpoint "
                f"differs from the uninterrupted run's in {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{tag}] python -m repro_torch.launch.train --arch {arch} "
          f"--device cuda --steps {c['steps']} --ckpt-every {c['every']}: "
          f"--simulate-failure {c['fail']} exited 42, the rerun resumed from "
          f"step {resumed}, its final checkpoint equal to an uninterrupted "
          f"run's in all {n_leaves} leaves ({time.perf_counter() - t0:.1f} s)")


def _trace(torch, tag: str, fn, top: int = 15) -> dict:
    """One run of ``fn`` under torch.profiler: wall time, the device's busy
    share, the collectives' device time (NCCL's kernels) and the ``top``
    device operations by time. Returns the host-side (CUDA runtime) calls
    by name with their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them report the same time again
    rows = sorted(((ev.device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] {tag}: traced wall {wall:.4f} s; device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%")
    nccl = [r for r in rows if "nccl" in r[1].lower()]
    if nccl:
        print(f"[profile]   collectives: {sum(r[0] for r in nccl) / 1e3:.3f} "
              f"ms of device time in {sum(r[2] for r in nccl)} NCCL kernels")
    for dev_us, key, count in rows[:top]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type != DeviceType.CUDA}


def phase_profile(torch, g, model, serve_inputs, seed: int, edges, weights,
                  log_m: int, server) -> None:
    """Where the compacted main path's time goes: wall time per driver step
    (host clock around synchronized work), then one traced run of it, one of
    none+stergiou, one of the fused PUFA path, one stream batch (the ninth
    of STREAM_BATCH), one dynamic step (sliding_window's fifth, the first
    that deletes), one ingest of the graph's edges (the ingest phase's
    source), one amsf(skip=lmax), one msf, one closed-loop window of the
    serve phase's static server (with its host syncs a commit), and one
    DLRM-RM2 serve_bulk and one serve_p99 step."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import serve_step
    from repro_torch import ConnectIt
    from repro_torch.core import driver

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    P = step("sample (kout + uf_sync_full)",
             lambda: session._sampler(g, None))
    P, keep, _, _ = step("prep (compress, L_max, keep mask)",
                         lambda: driver._prep_sampled(P, g.senders,
                                                      g.receivers))
    s, r, kept = step("compact", lambda: driver._compact(
        g.senders, g.receivers, keep, g.n, pad="pow2"))
    step("finish + canonicalize",
         lambda: driver._finish_phase(P, s, r, session._finish))
    total = sum(steps.values())
    for name, sec in steps.items():
        print(f"[profile] {name}: {sec:.4f} s ({100 * sec / total:.1f}%)")
    print(f"[profile] kept {kept} of {g.m} edges for the finish phase")
    _trace(torch, MAIN_VARIANT, lambda: session.connectivity(g))
    stergiou = ConnectIt("none+stergiou", device="cuda")
    _trace(torch, "none+stergiou", lambda: stergiou.connectivity(g))
    pufa = ConnectIt(EDGE_PATH, device="cuda")
    _trace(torch, f"{EDGE_PATH} fused",
           lambda: pufa.connectivity(g, fused=True))
    _trace_stream_steps(torch, g, seed)
    from repro_torch.graphs import ArrayEdgeSource
    src = ArrayEdgeSource(edges, g.n, chunk=1 << (log_m - 3))
    for tag, fn in ((f"ingest {MAIN_VARIANT}, {src.num_chunks} chunks",
                     lambda: session.from_chunks(src)),
                    (f"amsf(skip=lmax) {MAIN_VARIANT}",
                     lambda: session.amsf(g, weights, "amsf(skip=lmax)")),
                    ("msf", lambda: session.msf(g, weights))):
        ops.reset_launch_counts()
        _trace(torch, tag, fn)
        print(f"[profile]   launches {json.dumps(ops.launch_counts())}")
    _trace_serve_window(torch, server, seed)
    for shape in ("serve_bulk", "serve_p99"):
        inputs = serve_inputs[shape]
        _trace_dlrm_step(torch, f"dlrm-rm2 {shape} B={inputs[0].shape[0]}",
                         lambda: serve_step(model, *inputs), ops)


def _trace_dlrm_step(torch, tag: str, fn, ops, top: int = 15) -> None:
    """One DLRM step traced after a warm one (``_gnn_traced``): wall time,
    the device's busy share and the ``top`` device operations; taken again,
    GNN_TRACE_TRIES times at most, until the trace holds the step's
    embedding_bag launches (a trace can miss a step's first kernels)."""
    from torch.autograd import DeviceType

    for attempt in range(1, GNN_TRACE_TRIES + 1):
        prof, wall, counts = _gnn_traced(torch, fn, ops)
        rows = sorted(((ev.device_time_total, ev.key, ev.count)
                       for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA
                       and not ev.key.startswith("ProfilerStep")),
                      reverse=True)
        traced = sum(c for _, k, c in rows if "embedding_bags_kernel" in k)
        if traced == counts["embedding_bag"]:
            break
        print(f"[profile] {tag}: trace {attempt} holds {traced} "
              f"embedding_bag kernels, the wrapper launched "
              f"{counts['embedding_bag']}")
    require(traced == counts["embedding_bag"], f"profile {tag}: the trace "
            f"holds {traced} embedding_bag kernels, the wrapper launched "
            f"{counts['embedding_bag']}, in {GNN_TRACE_TRIES} traces")
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] {tag}: traced wall {wall:.4f} s; device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%; launches {json.dumps(counts)}")
    for dev_us, key, count in rows[:top]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# the CUDA runtime calls at which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def _trace_serve_window(torch, server, seed: int) -> None:
    """One traced closed-loop window (16 clients x 8 requests) of the serve
    phase's static server, its restart's warmup left out: busy share, the
    largest device operations, and the host's waits on the device a commit
    (a query dispatch waits once, for its answers)."""
    import dataclasses

    from repro_torch.kernels import ops
    server.config = dataclasses.replace(server.config, warmup=False)
    before = server.stats()
    ops.reset_launch_counts()
    calls = _trace(torch, f"serve closed loop {SERVE_CLIENTS}x8 "
                   f"({SERVE_TRAFFIC})",
                   lambda: serve_closed_loop(server, False, seed + 2,
                                             requests=8))
    st = server.stats()
    commits = st.commit_batches - before.commit_batches
    queries = st.query_batches - before.query_batches
    syncs = {k: calls.get(k, 0) for k in SYNC_CALLS}
    rounds = st.finish_rounds - before.finish_rounds
    waits = sum(syncs.values())
    print(f"[profile]   {commits} commits ({rounds} finish rounds), "
          f"{queries} query dispatches; host waits {json.dumps(syncs)}: "
          f"{(waits - queries) / max(commits, 1):.1f} a commit besides one a "
          f"query dispatch; cudaMemcpyAsync "
          f"{calls.get('cudaMemcpyAsync', 0)}; launches "
          f"{json.dumps(ops.launch_counts())}")


def _trace_stream_steps(torch, g, seed: int) -> None:
    """One traced stream batch and one traced dynamic step, each after the
    steps before it, with their launches."""
    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    B = STREAM_BATCH
    u, v = stream_edges(torch, g, seed)
    st = ConnectIt(MAIN_VARIANT, device="cuda").stream(g.n)
    for i in range(8):
        st.insert(u[i * B: (i + 1) * B], v[i * B: (i + 1) * B])
    ops.reset_launch_counts()
    _trace(torch, f"stream batch 9 of {B} edges",
           lambda: st.insert(u[8 * B: 9 * B], v[8 * B: 9 * B]))
    print(f"[profile]   launches {json.dumps(ops.launch_counts())}")
    d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
        g.n, dynamic=True, log=sliding_batch_log(g.n)[1])
    for step, (ins, dels, q, args) in enumerate(
            sliding_steps(torch, g.n, seed, 5)):
        if step < 4:
            d.process(*args)
    ops.reset_launch_counts()
    _trace(torch, f"dynamic step 5 of sliding_window ({len(dels)} deletes, "
           f"{len(ins)} inserts)", lambda: d.process(*args))
    print(f"[profile]   launches {json.dumps(ops.launch_counts())}")


# ---------------------------------------------------------------------------
# The LM family (phase "lm"): the five transformer configs on one card.
# ---------------------------------------------------------------------------

LM_ARCHS = ("h2o-danube-3-4b", "qwen3-4b", "stablelm-3b", "deepseek-moe-16b",
            "granite-moe-3b-a800m")
# (a) qwen3-4b: prefill_32k's batch cut from 32 (to 1 since the lm mesh
# phase: the script's time limit), decode steps from its cache;
# decode_32k's batch cut from 128, over a full 32,768-slot cache
LM_PREFILL_BATCH = 1
LM_DECODE_BATCH = 8
LM_DECODE_STEPS = 8
# the full-width checks: a prompt of this many tokens through prefill and
# through decode from an empty cache, each against the full forward
LM_CHECK_TOKENS = 64
# (b) granite-moe-3b-a800m: prefill at this sequence and batch, then decode
LM_MOE_SEQ = 4096
LM_MOE_BATCH = 8
# (c) h2o-danube-3-4b x long_500k (B = 1): a prefill of two windows, then
# decode steps past it, each slot of the ring overwritten in turn
LM_LONG_PREFILL = 8192
LM_LONG_DECODE = 16
# (d) stablelm-3b x train_4k: batch cut from 256; timed steps cut 10 -> 5
# since the lm mesh phase (the script's time limit)
LM_TRAIN_BATCH = 1
LM_TRAIN_STEPS = 5
# to leave the gnn and gnn mesh phases room in the script's time limit,
# (a) and (d) run their published widths at a cut depth: qwen3-4b 36 ->
# LM_SERVE_LAYERS (at full depth its prefill_32k took 28.8 s of the
# phase's 196.4 on an H100 80GB HBM3 at 700 W; 12 layers until the gnn
# mesh phase, 4 since), stablelm-3b 32 -> LM_TRAIN_LAYERS (74.3 s there at full
# depth; 8 layers until the gnn mesh phase)
LM_SERVE_LAYERS = 4
LM_TRAIN_LAYERS = 4
# two bfloat16 paths at full depth (decode against forward): the largest
# logit difference as a share of the largest |logit|. A bfloat16 rounding
# is 2^-8 of a value; through 24-36 residual layers the two paths' logits
# differ by a few of them
LM_BF16_TOL = 0.05
# (e) the smoke configs in float32 on the card against the CPU: GEMMs of
# another order (cuBLAS without TF32, against the CPU's) through two layers
LM_SMOKE_TOL = dict(rtol=1e-4, atol=1e-4)
# (e)'s train step, at launch.train's schedule (lr 1e-3, 10 warmup steps:
# 1e-4 at step 1): each gradient leaf within LM_GRAD_TOL of the CPU leaf's
# largest magnitude (tests/test_torch_lm.py's bound); the moments within
# 3 LM_GRAD_TOL of their leaf's largest (mu moves by the gradient's
# difference, nu by twice it, both scaled by the leaf's largest); every
# parameter within LM_STEP_TOL (one float32 rounding of it, far below the
# step's 1e-4) plus how far the two gradients move its AdamW step apart
# through AdamW's formula in float64 (tests/test_torch_lm_cells.py)
LM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=1000)
LM_GRAD_TOL = 1e-5
LM_STEP_TOL = dict(rtol=1e-6, atol=1e-7)
# (e) in bfloat16 activations: the card's logits and every lm_loss gradient
# leaf against the CPU's, as a share of the CPU's largest magnitude. Two
# bfloat16 implementations (the port and the reference on the CPU, my CPU
# run, PR 26) differ by at most 0.012 of the logits and 0.032 of a
# gradient leaf; a transposed operand or a lost cast differs by O(1)
LM_BF16_SMOKE_TOL = dict(logits=0.05, grads=0.1)
# bfloat16 dense peak, H100 SXM (NVIDIA data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12


def _lm_init(torch, cfg, seed: int):
    """The model from PRNGKey(seed) on the card: (model, seconds), the
    threefry launches asserted: one threefry_bits a 2^22 slice of each
    drawn leaf, a layer at a time, and no randint."""
    import numpy as np

    from repro_torch import random as trandom
    from repro_torch.kernels import ops
    from repro_torch.legacy.models import transformer as tfm

    def drawn(tree, name=""):
        if isinstance(tree, dict):
            return [n for k, v in tree.items() for n in drawn(v, k)]
        norm = name.startswith("ln_") or name.endswith("_norm")
        return [] if norm else [tree]

    per = trandom._SLICE
    want = cfg.n_layers * sum(-(-int(np.prod(s)) // per)
                              for s in drawn(tfm.layer_shapes(cfg)))
    want += 2 * (-(-cfg.vocab * cfg.d_model // per))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tfm.init_transformer(cfg, key=trandom.PRNGKey(seed,
                                                          device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(counts["threefry_bits"] == want and
            sum(counts.values()) == want,
            f"lm init {cfg.name}: launches {counts}, want threefry_bits="
            f"{want} and nothing else")
    n = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {n} float32 parameters ({4 * n} bytes) drawn "
          f"on the card from PRNGKey({seed}) in {init_s:.2f} s: "
          f"{counts['threefry_bits']} threefry_bits launches (one a 2^22 "
          f"slice of each drawn leaf), as counted from the shapes")
    return model, init_s


def _lm_tokens(torch, cfg, batch: int, seq: int, seed: int) -> dict:
    """TokenStream's batch 0 on the card, its two threefry_randint launches
    (and nothing else) asserted."""
    from repro_torch.kernels import ops
    from repro_torch.legacy.data import TokenStream
    before = ops.launch_counts()
    b = TokenStream(cfg.vocab, batch, seq, seed).batch_at(0, device="cuda")
    after = ops.launch_counts()
    diff = {k: after[k] - before.get(k, 0) for k in after}
    require(diff["threefry_randint"] == 2 and sum(diff.values()) == 2,
            f"lm batch: launches {diff}, want threefry_randint=2")
    return b


def _lm_rel(torch, got, want) -> float:
    """max |got - want| over max |want|, in float64 (0 where they agree)."""
    got, want = got.detach().double(), want.detach().double()
    d = float((got - want).abs().max())
    return d / float(want.abs().max()) if d else 0.0


def _lm_breakdown(torch, tag: str, fn):
    """One run of ``fn`` under torch.profiler → ``(its result, {part: ms,
    "busy", "wall"})``: the kernels' device time split into the per-use
    float32 → bfloat16 weight casts (ops under an ``lm.weight_cast``
    range), the GEMMs (aten::mm / bmm / addmm) and the rest outside the
    ``lm.attention`` ranges, and the attention (what is left)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the ranges' own device spans are annotations, not kernels
    kernels = sum(e.device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("lm.")) / 1e3

    def inside(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False

    # the kernels outside the attention, each on the op that launched it;
    # the attention is the rest of the kernels' own sum (on a prefill's
    # ~10^5 events the ops' attributed times add up to more than the
    # kernels' sum)
    part = dict(attention=0.0, weight_casts=0.0, gemm=0.0, rest=0.0)
    for e in events:
        if e.device_type != DeviceType.CPU or e.name.startswith("lm."):
            continue
        t = e.self_device_time_total / 1e3
        if not t or inside(e, "lm.attention"):
            continue
        if inside(e, "lm.weight_cast"):
            part["weight_casts"] += t
        elif e.name in ("aten::mm", "aten::bmm", "aten::addmm"):
            part["gemm"] += t
        else:
            part["rest"] += t
    part["attention"] = kernels - sum(part.values())
    busy = kernels
    share = "; ".join(f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                      for k, v in part.items())
    print(f"[lm] profile {tag}: traced wall {wall:.4f} s, device busy "
          f"{busy / 1e3:.4f} s ({100 * busy / 1e3 / wall:.1f}%), idle "
          f"{100 * (1 - busy / 1e3 / wall):.1f}%; {share}")
    rows = sorted(((e.device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("lm.")), reverse=True)
    for dev_us, key, count in rows[:8]:
        print(f"[lm]   {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return out, dict(part, busy=busy, wall=wall)


def _adam_moves(grads, ocfg, lr: float) -> list:
    """Each leaf's AdamW step at step 1, ``lr g / (|g| + eps)`` of the
    globally clipped gradient, in float64 (weight decay left out)."""
    import numpy as np
    c = min(1.0, ocfg.grad_clip / float(np.sqrt(sum(
        float((g * g).sum()) for g in grads))))
    return [lr * c * g / ((c * g).abs() + ocfg.eps) for g in grads]


def _lm_grads(torch, model, batch, cfg) -> list:
    """lm_loss's gradient of every leaf, float64 on the host."""
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import transformer as tfm
    params = model.params()
    with torch.enable_grad():
        loss, _ = tfm.lm_loss(params, batch["tokens"], batch["labels"], cfg)
        grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    return [g.detach().cpu().double() for g in grads]


def _card_scores(torch) -> dict:
    """``layers.scores`` of bfloat16 operands on the card (bmm with a
    float32 output and its hand-written backward) against float32 ``bmm``
    autograd of the same values, at one qwen3-4b query chunk's shape
    (8 KV heads x 4 query heads x 1,024 rows against a 1,024-key chunk,
    d_head 128): the forward within 1e-5 of its largest magnitude, each
    gradient element within one bfloat16 rounding (2^-8) of the float32
    gradient's plus 1e-5 of its largest."""
    from repro_torch.legacy.models import layers
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(8, 4096, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(8, 1024, 128, generator=gen, device="cuda").bfloat16()
    w = torch.randn(8, 4096, 1024, generator=gen, device="cuda")
    qb, kb = (t.clone().requires_grad_(True) for t in (q, k))
    got = layers.scores(qb, kb)
    dq, dk = torch.autograd.grad((got * w).sum(), (qb, kb))
    qf, kf = (t.float().requires_grad_(True) for t in (q, k))
    want = torch.bmm(qf, kf.transpose(-1, -2))
    wq, wk = torch.autograd.grad((want * w).sum(), (qf, kf))
    out = {"forward": _lm_rel(torch, got, want)}
    require(got.dtype == torch.float32 and out["forward"] <= 1e-5,
            f"scores on the card: forward {got.dtype}, {out['forward']}")
    for tag, g, f in (("dq", dq, wq), ("dk", dk, wk)):
        bound = 2.0 ** -8 * f.abs() + 1e-5 * f.abs().max()
        out[tag] = _lm_rel(torch, g.float(), f)
        require(g.dtype == torch.bfloat16 and
                bool(((g.float() - f).abs() <= bound).all()),
                f"scores on the card: {tag} beyond one bfloat16 rounding "
                f"of the float32 gradient ({out[tag]} of its largest)")
    return out


def _lm_smoke(torch, seed: int) -> None:
    """(e) The five smoke configs on the card against the same calls on the
    CPU from the same weights. In float32: forward logits, lm_loss, one
    train step (gradients, moments, parameters), prefill then decode. In
    bfloat16 activations: logits and every lm_loss gradient leaf. Then
    ``scores``' bfloat16 product on the card against float32 autograd."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import TokenStream
    from repro_torch import random as trandom
    from repro_torch.legacy.models import transformer as tfm

    precision = torch.get_float32_matmul_precision()
    require(precision == "highest" and
            not torch.backends.cuda.matmul.allow_tf32,
            f"float32 matmuls must run in full float32, got {precision!r}")
    ocfg = optim.OptimizerConfig(**LM_TRAIN_OPT)
    worst, n_wide, n_all = {}, 0, 0
    for name in LM_ARCHS:
        arch = get_arch(name)
        cfg = dataclasses.replace(arch.model, **arch.smoke)
        cpu = tfm.init_transformer(cfg, key=trandom.PRNGKey(
            seed, device="cpu"))
        card = tfm.Transformer(cfg, optim.tree_unflatten(
            cpu.params(), [x.detach().cuda() for x in optim.tree_leaves(
                cpu.params())]))
        stream = TokenStream(cfg.vocab, 2, 32, seed)
        bc, bg = stream.batch_at(0, device="cpu"), stream.batch_at(
            0, device="cuda")
        require(all(torch.equal(bc[k], bg[k].cpu()) for k in bc),
                f"lm smoke {name}: TokenStream on the card differs")
        rel = {}
        with torch.no_grad():
            lc, ac = cpu(bc["tokens"])
            lg, ag = card(bg["tokens"])
            rel["logits"] = _lm_rel(torch, lg.cpu(), lc)
            torch.testing.assert_close(lg.cpu(), lc, **LM_SMOKE_TOL)
            torch.testing.assert_close(ag.cpu(), ac, **LM_SMOKE_TOL)
            # prefill 28 tokens, then decode the last 4
            pc, cc = cpu.prefill(bc["tokens"][:, :28], 32)
            pg, cg = card.prefill(bg["tokens"][:, :28], 32)
            torch.testing.assert_close(pg.cpu(), pc, **LM_SMOKE_TOL)
            for i in range(28, 32):
                pc, cc = cpu.decode_step(cc, bc["tokens"][:, i])
                pg, cg = card.decode_step(cg, bg["tokens"][:, i])
                torch.testing.assert_close(pg.cpu(), pc, **LM_SMOKE_TOL)
            rel["decode"] = _lm_rel(torch, pg.cpu(), pc)
        # bfloat16 activations from the same float32 weights
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        with torch.no_grad():
            lc16, _ = tfm.Transformer(bf, cpu.params())(bc["tokens"])
            lg16, _ = tfm.Transformer(bf, card.params())(bg["tokens"])
        require(lg16.dtype == torch.bfloat16, f"{name}: bf16 logits")
        rel["bf16_logits"] = _lm_rel(torch, lg16.cpu(), lc16)
        g16 = [_lm_rel(torch, a, b) for a, b in zip(
            _lm_grads(torch, tfm.Transformer(bf, card.params()), bg, bf),
            _lm_grads(torch, tfm.Transformer(bf, cpu.params()), bc, bf))]
        rel["bf16_grads"] = max(g16)
        require(rel["bf16_logits"] <= LM_BF16_SMOKE_TOL["logits"] and
                rel["bf16_grads"] <= LM_BF16_SMOKE_TOL["grads"],
                f"lm smoke {name} in bfloat16: logits {rel['bf16_logits']}, "
                f"gradient leaves {g16} of their largest magnitudes, past "
                f"{LM_BF16_SMOKE_TOL}")
        # one train step: the gradients, then the step itself
        gc, gg = _lm_grads(torch, cpu, bc, cfg), _lm_grads(torch, card, bg,
                                                            cfg)
        rel["grads"] = max(_lm_rel(torch, a, b) for a, b in zip(gg, gc))
        require(rel["grads"] <= LM_GRAD_TOL,
                f"lm smoke {name}: a gradient leaf {rel['grads']} of its "
                f"largest magnitude from the CPU's, past {LM_GRAD_TOL}")
        before = [x.detach().clone() for x in optim.tree_leaves(cpu.params())]
        sc, sg = (optim.init_adam(m.params()) for m in (cpu, card))
        _, sc, ic = lm_train_step(cpu, sc, bc["tokens"], bc["labels"], cfg,
                                  ocfg)
        _, sg, ig = lm_train_step(card, sg, bg["tokens"], bg["labels"], cfg,
                                  ocfg)
        torch.testing.assert_close(ig["loss"].cpu(), ic["loss"],
                                   **LM_SMOKE_TOL)
        rel["loss"] = abs(float(ig["loss"]) - float(ic["loss"]))
        rel["moments"] = max(_lm_rel(torch, a.cpu(), b) for a, b in zip(
            optim.tree_leaves((sg.mu, sg.nu)),
            optim.tree_leaves((sc.mu, sc.nu))))
        require(rel["moments"] <= 3 * LM_GRAD_TOL,
                f"lm smoke {name}: a moment leaf {rel['moments']} of its "
                f"largest magnitude from the CPU's")
        lr = float(ic["lr"])
        require(abs(lr / (LM_TRAIN_OPT["lr"] / LM_TRAIN_OPT["warmup_steps"])
                    - 1) < 1e-6,
                f"lm smoke {name}: step 1's learning rate {lr}")
        apart = [(a - b).abs() for a, b in zip(_adam_moves(gg, ocfg, lr),
                                               _adam_moves(gc, ocfg, lr))]
        moved = 0.0
        for a, b, p0, d in zip(optim.tree_leaves(card.params()),
                               optim.tree_leaves(cpu.params()), before,
                               apart):
            a, b = a.detach().cpu().double(), b.detach().double()
            tol = LM_STEP_TOL["atol"] + LM_STEP_TOL["rtol"] * b.abs() + d
            require(bool(((a - b).abs() <= tol).all()),
                    f"lm smoke {name}: a parameter after the step differs "
                    f"from the CPU's by {float((a - b).abs().max())}")
            moved = max(moved, float((b - p0.double()).abs().max()))
            n_wide += int((d > LM_STEP_TOL["atol"]).sum())
            n_all += d.numel()
        require(moved >= 0.5 * lr,
                f"lm smoke {name}: the step moved no parameter by half of "
                f"lr ({moved})")
        worst[name] = rel
        del cpu, card, sc, sg
    cs = _card_scores(torch)
    print(f"[lm] (e) the five smoke configs on the card against the CPU "
          f"from the same weights. float32 (TF32 off): logits, aux, "
          f"lm_loss, prefill and 4 decode steps within {LM_SMOKE_TOL}; one "
          f"train step at lr {LM_TRAIN_OPT['lr']} / "
          f"{LM_TRAIN_OPT['warmup_steps']} warmup steps: gradient leaves "
          f"within {LM_GRAD_TOL} of their largest, moments within "
          f"{3 * LM_GRAD_TOL}, parameters within {LM_STEP_TOL} plus the "
          f"gradients' AdamW divergence (above the atol for {n_wide} of "
          f"{n_all} elements). bfloat16 activations: logits and every "
          f"gradient leaf within {LM_BF16_SMOKE_TOL} of their largest. "
          f"Largest shares (logits, decode, bf16_logits, bf16_grads, grads, "
          f"moments) and the absolute loss difference: "
          + json.dumps({k: {a: float(f"{b:.3g}") for a, b in v.items()}
                        for k, v in worst.items()}))
    print(f"[lm] (e) scores (bfloat16 bmm, float32 out, hand-written "
          f"backward) on the card against float32 bmm autograd at (8, 4096, "
          f"128) x (8, 1024, 128): largest differences as a share of the "
          f"largest magnitude {json.dumps({k: float(f'{v:.3g}') for k, v in cs.items()})}")


def _lm_clis(torch, seed: int) -> None:
    """(f) launch.train on a dense and a MoE arch (each stopped and resumed
    bit-exact) and launch.legacy.serve on the card, the three side by
    side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.legacy import serve as lserve
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.legacy.serve", "--arch",
         "qwen3-4b", "--device", "cuda", "--seed", str(seed)],
        cwd=ROOT, env=_src_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(1) as pool:
            moe = pool.submit(_train_cli, seed, "deepseek-moe-16b", "lm")
            _train_cli(seed, arch="stablelm-3b", tag="lm")
            moe.result()
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                      stderr)
    require(out.returncode == 0,
            f"launch.legacy.serve exited {out.returncode}:\n"
            f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    ids = lserve.serve("qwen3-4b", seed=seed, device="cuda", verbose=False)
    again = lserve.serve("qwen3-4b", seed=seed, device="cuda",
                         verbose=False)
    require(torch.equal(ids, again) and tuple(ids.shape) == (4, 32),
            "serve: two runs on the card generate other ids")
    first = next(x for x in out.stdout.splitlines()
                 if x.startswith("[serve] first sequence:"))
    require(first.endswith(str(ids[0].tolist())),
            f"serve CLI's first sequence differs from serve()'s: {first}")
    print(f"[lm] python -m repro_torch.launch.legacy.serve --arch qwen3-4b "
          f"--device cuda: exit 0, "
          f"{[x for x in out.stdout.splitlines() if 'tok/s' in x][0]}; "
          f"its ids equal serve()'s in this process, twice (with the "
          f"train CLI beside it: {time.perf_counter() - t0:.1f} s)")


def _lm_long(torch, seed: int, card: str) -> None:
    """(c) h2o-danube-3-4b x long_500k uncut (B = 1, a 4,096-slot ring):
    prefill LM_LONG_PREFILL tokens, decode LM_LONG_DECODE steps through the
    cell, each step's logits against the full forward's at its position."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy.models import transformer as tfm

    arch = get_arch("h2o-danube-3-4b")
    cfg = arch.model
    model, _ = _lm_init(torch, cfg, seed)
    cell = build_cell(arch, "long_500k")
    S = arch.shapes["long_500k"]["seq"]
    toks = _lm_tokens(torch, cfg, 1, LM_LONG_PREFILL + LM_LONG_DECODE,
                      seed)["tokens"]
    params = model.params()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = tfm.prefill(params, toks[:, :LM_LONG_PREFILL], cfg,
                                    S)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    require(cache.size == cfg.swa_window == tuple(cell.args[0].k.shape)[2],
            f"long_500k: a ring of {cache.size} slots")
    steps, walls = [], []
    for i in range(LM_LONG_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = cell.fn(model, cache, toks[:, LM_LONG_PREFILL + i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append(logits)
    peak = torch.cuda.max_memory_allocated() - base
    with torch.no_grad():
        full, _ = tfm.forward(params, toks, cfg)
    rel = max(_lm_rel(torch, steps[i][0], full[0, LM_LONG_PREFILL + i])
              for i in range(LM_LONG_DECODE))
    require(all(bool(torch.isfinite(x).all()) for x in steps),
            "long_500k: decode logits not finite")
    require(rel <= LM_BF16_TOL, f"long_500k: decoded logits differ from the "
            f"full forward's by {rel:.4f} of the largest |logit|")
    print(f"[lm] (c) h2o-danube-3-4b x long_500k uncut: B=1, prefill "
          f"{LM_LONG_PREFILL} tokens {pre_s:.3f} s into a {cache.size}-slot "
          f"ring (bf16 activations, float32 weights), then {LM_LONG_DECODE} "
          f"decode steps through the cell past the ring's end: p50 "
          f"{1e3 * float(np.median(walls)):.3f} ms a step; each step's "
          f"logits against the full forward over "
          f"{LM_LONG_PREFILL + LM_LONG_DECODE} tokens: largest difference "
          f"{rel:.4f} of the largest |logit| (gate {LM_BF16_TOL}); peak "
          f"above the model {peak} bytes; card {card}")
    del model, params, cache, full, steps
    torch.cuda.empty_cache()


def _lm_moe(torch, seed: int, card: str) -> None:
    """(b) granite-moe-3b-a800m at full width and depth: prefill at
    LM_MOE_SEQ x LM_MOE_BATCH through the prefill cell, decode steps from
    its cache, layer 0's capacity and dropped share, and layer 0's MoE
    gradients on one sequence twice, bit for bit."""
    import numpy as np

    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import moe as tmoe
    from repro_torch.legacy.models import transformer as tfm

    full = get_arch("granite-moe-3b-a800m")
    cfg = full.model
    arch = dataclasses.replace(full, shapes={
        k: dict(full.shapes[k], seq=LM_MOE_SEQ, batch=LM_MOE_BATCH)
        for k in ("prefill_32k", "decode_32k")})
    model, _ = _lm_init(torch, cfg, seed)
    pre = build_cell(arch, "prefill_32k")
    dec = build_cell(arch, "decode_32k")
    toks = _lm_tokens(torch, cfg, LM_MOE_BATCH, LM_MOE_SEQ, seed)["tokens"]
    params = model.params()
    with torch.no_grad():  # layer 0's routing of the prompt
        lp = tfm.layer_views(params, cfg)[0]
        x = tfm.embed(params, toks, cfg)
        pos = tfm._positions(*toks.shape, toks.device)
        q, k, v = tfm._qkv(lp, x, pos, cfg, tfm.no_shard)
        x = tfm._attn_out(lp, x, q, k, v, cfg, tfm.no_shard)
        h = tfm.rms_norm(x, lp["ln_ffn"]).reshape(-1, cfg.d_model)
        C, share = tmoe.dropped_share(cfg.moe_cfg, h, lp["moe"]["router"])
        h = h[:LM_MOE_SEQ].clone()
        del x, q, k, v
    # layer 0's MoE backward twice on the first sequence's tokens: the same
    # bits (a token's K dispatch copies add up in a fixed order)
    w = torch.randn(h.shape, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in optim.tree_leaves(lp["moe"])]
        hx = h.clone().requires_grad_(True)
        with torch.enable_grad():
            y, aux = tmoe.moe_apply(optim.tree_unflatten(lp["moe"], leaves),
                                    hx, cfg.moe_cfg)
            runs.append(torch.autograd.grad((y.float() * w).sum() + aux,
                                            leaves + [hx]))
    require(all(torch.equal(a, b) for a, b in zip(*runs)),
            "granite layer 0: moe_apply's gradients differ between two runs")
    del h, w, runs, leaves, hx, y
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre.fn(model, toks)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()) and
            tuple(logits.shape) == (LM_MOE_BATCH, cfg.vocab),
            "granite prefill: logits")
    tok = torch.argmax(logits, -1).to(torch.int32)
    walls = []
    for _ in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = dec.fn(model, cache, tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        tok = torch.argmax(logits, -1).to(torch.int32)
    require(bool(torch.isfinite(logits).all()), "granite decode: logits")
    peak = torch.cuda.max_memory_allocated() - base
    n_tok = LM_MOE_BATCH * LM_MOE_SEQ
    print(f"[lm] (b) granite-moe-3b-a800m at full width and depth (E = "
          f"{cfg.n_experts}, {cfg.moe_cfg.n_experts_padded} padded, K = "
          f"{cfg.top_k}, D = {cfg.d_model}): prefill B={LM_MOE_BATCH} x "
          f"S={LM_MOE_SEQ} {pre_s:.3f} s ({n_tok / pre_s:.1f} tokens/s); "
          f"layer 0 on the prompt: capacity C = {C} a group of {n_tok} "
          f"tokens, dropped share {share:.4f} of the {n_tok * cfg.top_k} "
          f"choices; its MoE gradients on one sequence twice: the same "
          f"bits; {LM_DECODE_STEPS} decode steps from the cache: p50 "
          f"{1e3 * float(np.median(walls)):.3f} ms ({LM_MOE_BATCH / float(np.median(walls)):.1f} "
          f"tokens/s); peak above the model {peak} bytes; card {card}")
    del model, params, cache
    torch.cuda.empty_cache()


def _lm_serve(torch, seed: int, card: str) -> None:
    """(a) qwen3-4b at full width, depth LM_SERVE_LAYERS: the prefill_32k
    cell at LM_PREFILL_BATCH, decode steps from its cache, the decode_32k
    cell at LM_DECODE_BATCH over a full cache; prefill and decode against
    the forward on a short prompt; the profile of one prefill and one
    decode step; SDPA on one layer's prefill q/k/v beside
    chunked_attention."""
    import dataclasses

    import numpy as np

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy.models import transformer as tfm
    from repro_torch.legacy.models.layers import chunked_attention

    arch = get_arch("qwen3-4b")
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=LM_SERVE_LAYERS))
    cfg = arch.model
    model, _ = _lm_init(torch, cfg, seed)
    params = model.params()
    pre = build_cell(arch, "prefill_32k")
    dec = build_cell(arch, "decode_32k")
    S = pre.args[0].shape[1]
    # the main path: counts from 0, the batch's draws and the cells
    ops.reset_launch_counts()
    toks = _lm_tokens(torch, cfg, LM_PREFILL_BATCH, S, seed)["tokens"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the prefill runs once, traced (the profiler's cost on an H100 80GB
    # HBM3 at 700 W: 26.82 s traced at B = 1 beside 25.97 s a sequence
    # untraced)
    (logits, cache), prof = _lm_breakdown(
        torch, f"qwen3-4b prefill_32k B={LM_PREFILL_BATCH} S={S}",
        lambda: pre.fn(model, toks))
    pre_s = prof["wall"]
    pre_peak = torch.cuda.max_memory_allocated() - base
    require(bool(torch.isfinite(logits).all()) and
            tuple(logits.shape) == (LM_PREFILL_BATCH, cfg.vocab),
            "qwen3 prefill: logits")
    tok = torch.argmax(logits, -1).to(torch.int32)
    walls = []
    for _ in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = dec.fn(model, cache, tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        tok = torch.argmax(logits, -1).to(torch.int32)
    require(bool(torch.isfinite(logits).all()), "qwen3 decode: logits")
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want.update(threefry_randint=2)
    require(counts == want, f"qwen3 serve: launches {counts}, want {want}")
    kv = cache.k.numel() * cache.k.element_size() * 2
    tflops = pre.meta["model_flops"] / pre.meta["tokens"] * \
        LM_PREFILL_BATCH * S / pre_s / 1e12
    print(f"[lm] (a) qwen3-4b prefill_32k at full width, depth cut 36 -> "
          f"{LM_SERVE_LAYERS}, batch cut 32 -> {LM_PREFILL_BATCH}: "
          f"{pre_s:.3f} s traced "
          f"({LM_PREFILL_BATCH * S / pre_s:.1f} tokens/s, {tflops:.1f} "
          f"model TFLOP/s without attention); KV cache {kv} bytes; peak "
          f"above the model {pre_peak} bytes; then {LM_DECODE_STEPS} decode "
          f"steps from that cache: p50 {1e3 * float(np.median(walls)):.3f} "
          f"ms; launches on this path {json.dumps(counts)}; card {card}")
    _lm_breakdown(torch, f"qwen3-4b decode step B={LM_PREFILL_BATCH}, "
                  f"{cache.size}-slot cache",
                  lambda: dec.fn(model, cache, tok))
    del cache, logits
    torch.cuda.empty_cache()

    # decode_32k: a full 32,768-slot cache (random bfloat16 values)
    spec = dec.args[0]
    shape = (spec.k.shape[0], LM_DECODE_BATCH) + tuple(spec.k.shape[2:])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = tfm.KVCache(
        torch.randn(shape, generator=gen, device="cuda",
                    dtype=cfg.act_dtype),
        torch.randn(shape, generator=gen, device="cuda",
                    dtype=cfg.act_dtype),
        torch.tensor(shape[2] - 1, dtype=torch.int32, device="cuda"))
    tok = toks[0, :LM_DECODE_BATCH].contiguous()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = []
    for i in range(LM_DECODE_STEPS):
        full = full._replace(pos=torch.tensor(shape[2] - 1, dtype=torch.int32,
                                              device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = dec.fn(model, full, tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    require(bool(torch.isfinite(logits).all()), "decode_32k: logits")
    p50 = float(np.median(walls))
    kv = full.k.numel() * full.k.element_size() * 2
    wbytes = sum(p.numel() for p in model.parameters()) * 4
    print(f"[lm] (a) qwen3-4b decode_32k, batch cut 128 -> "
          f"{LM_DECODE_BATCH}, every one of the {shape[2]} slots attended "
          f"(pos {shape[2] - 1}): step p50 {1e3 * p50:.3f} ms "
          f"({LM_DECODE_BATCH / p50:.1f} tokens/s); KV cache {kv} bytes, "
          f"float32 weights {wbytes} bytes: reading both once is "
          f"{(kv + wbytes) / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s; "
          f"peak above the model and cache "
          f"{torch.cuda.max_memory_allocated() - base} bytes; card {card}")
    del full, logits
    torch.cuda.empty_cache()

    # full-width checks on a short prompt: prefill and decode from an empty
    # cache, each against the forward's last position
    t = toks[:1, :LM_CHECK_TOKENS].contiguous()
    with torch.no_grad():
        fwd, _ = tfm.forward(params, t, cfg)
        last = fwd[0, -1]
        pl, _ = tfm.prefill(params, t, cfg, LM_CHECK_TOKENS)
        c = tfm.init_cache(cfg, 1, LM_CHECK_TOKENS, device="cuda")
        for i in range(LM_CHECK_TOKENS):
            dl, c = tfm.decode_step(params, c, t[:, i], cfg)
    rp, rd = _lm_rel(torch, pl[0], last), _lm_rel(torch, dl[0], last)
    require(rp <= LM_BF16_TOL and rd <= LM_BF16_TOL,
            f"qwen3: prefill / decode against the forward differ by "
            f"{rp:.4f} / {rd:.4f} of the largest |logit|")
    print(f"[lm] (a) qwen3-4b on a {LM_CHECK_TOKENS}-token prompt: the "
          f"prefill's logits and those of {LM_CHECK_TOKENS} decode steps "
          f"from an empty cache against the full forward's last position: "
          f"largest differences {rp:.4f} and {rd:.4f} of the largest "
          f"|logit| (gate {LM_BF16_TOL})")
    del fwd, c

    # SDPA beside the port's chunked attention on layer 0's q/k/v of the
    # first prompt
    one = toks[:1].contiguous()
    with torch.no_grad():
        lp = tfm.layer_views(params, cfg)[0]
        x = tfm.embed(params, one, cfg)
        q, k, v = tfm._qkv(lp, x, tfm._positions(1, S, one.device), cfg,
                           tfm.no_shard)
        del x
        kw = dict(causal=True, window=cfg.swa_window, q_chunk=cfg.q_chunk,
                  k_chunk=cfg.k_chunk)
        ours = chunked_attention(q, k, v, **kw)
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        rel = _lm_rel(torch, lib, ours)
        ours_ms = time_ms(torch, lambda: chunked_attention(q, k, v, **kw),
                          iters=3, warmup=1)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    H, dh = cfg.n_heads, cfg.head_dim
    causal_flops = 2 * 2 * H * S * S * dh // 2
    full_flops = 2 * causal_flops
    nbytes = (q.numel() + 2 * k.numel() + q.numel()) * 2
    b_ms = max(causal_flops / BF16_FLOPS_PER_S,
               nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"[lm] (h) one layer's prefill attention, qwen3-4b B=1 S={S} "
          f"(32 query heads, 8 kv heads, d_head 128, bf16): the port's "
          f"chunked_attention {ours_ms:.3f} ms (every key chunk, "
          f"{full_flops} FLOP of products with the masked ones), "
          f"F.scaled_dot_product_attention(is_causal, enable_gqa) "
          f"{lib_ms:.3f} ms; their outputs differ by {rel:.4f} of the "
          f"largest |output|; the causal work's bound {b_ms:.3f} ms "
          f"({causal_flops} FLOP at 989 TFLOP/s bf16); card {card}")
    del q, k, v, ours, lib, qt, kt, vt, model, params
    torch.cuda.empty_cache()


def _lm_train(torch, seed: int, card: str) -> None:
    """(d) stablelm-3b x train_4k at full width, depth LM_TRAIN_LAYERS,
    with remat, the batch cut to LM_TRAIN_BATCH: a counted step,
    LM_TRAIN_STEPS timed steps, AdamW alone against its bytes bound, one
    traced step, and one step twice from one state, the same bits."""
    import dataclasses

    import numpy as np

    import warnings

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import OPT, build_cell
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import TokenStream
    from repro_torch.legacy.models import transformer as tfm

    arch = get_arch("stablelm-3b")
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=LM_TRAIN_LAYERS))
    cfg = arch.model
    cell = build_cell(arch, "train_4k")
    S = cell.args[0].shape[1]
    model, _ = _lm_init(torch, cfg, seed)
    state = [optim.init_adam(model.params())]
    leaves = lambda: optim.tree_leaves((model.params(), state[0]))  # noqa
    state_bytes = sum(x.numel() * x.element_size() for x in leaves())
    stream = TokenStream(cfg.vocab, LM_TRAIN_BATCH, S, seed)

    def step(b):
        _, state[0], info = cell.fn(model, state[0], b["tokens"],
                                    b["labels"])
        return info

    losses = [float(step(stream.batch_at(0, device="cuda"))["loss"])]
    ops.reset_launch_counts()
    info = step(stream.batch_at(1, device="cuda"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want.update(threefry_randint=2)
    require(counts == want, f"lm train: launches {counts}, want {want}")
    losses.append(float(info["loss"]))
    batches = [stream.batch_at(i, device="cuda")
               for i in range(2, LM_TRAIN_STEPS + 2)]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(info["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    require(all(np.isfinite(losses)), f"lm train: losses {losses}")
    p50 = float(np.median(walls))
    n_tok = LM_TRAIN_BATCH * S
    print(f"[lm] (d) stablelm-3b train_4k at full width with remat, depth "
          f"cut 32 -> {LM_TRAIN_LAYERS}, batch cut 256 -> {LM_TRAIN_BATCH} x "
          f"{S}: parameters and "
          f"AdamW moments {state_bytes} bytes; {LM_TRAIN_STEPS} timed "
          f"steps: p50 {p50:.4f} s (min {min(walls):.4f}, max "
          f"{max(walls):.4f}), {n_tok / p50:.1f} tokens/s, "
          f"{cell.meta['model_flops'] / cell.meta['tokens'] * n_tok * cell.meta['flops_multiplier'] / p50 / 1e12:.1f} "
          f"TFLOP/s with the recompute; peak above the state {peak} bytes; "
          f"losses first {losses[0]:.6f} last {losses[-1]:.6f} (all "
          f"finite); launches a step {json.dumps(counts)}; card {card}")
    _lm_breakdown(torch, f"stablelm-3b train step B={LM_TRAIN_BATCH}",
                  lambda: step(batches[0]))
    params = model.params()
    b = batches[0]
    loss, _ = tfm.lm_loss(params, b["tokens"], b["labels"], cfg)
    grads = optim.tree_unflatten(params, torch.autograd.grad(
        loss, optim.tree_leaves(params)))
    del loss
    adam_ms = time_ms(torch, lambda: optim.update(OPT, params, grads,
                                                  state[0]),
                      iters=3, warmup=1)
    adam_bound = 7 * state_bytes / 3 / HBM_BYTES_PER_S * 1e3
    print(f"[lm] (d) AdamW alone (optim.update, plain per-leaf ops) on one "
          f"step's gradients: {adam_ms:.3f} ms, {adam_ms / adam_bound:.2f}x "
          f"its bytes bound {adam_bound:.3f} ms (7 x {state_bytes // 3} "
          f"bytes at 3.35 TB/s)")
    del grads, params

    # one step twice from one state: the state goes to the host, the first
    # result is swapped with it leaf by leaf (the host holds one state)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(batches[1])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print(f"[lm] (d) diagnostic step under "
          f"torch.use_deterministic_algorithms(warn_only=True): "
          f"{len(named)} ops named without a deterministic kernel"
          + "".join(f"\n[lm]   {x[:200]}" for x in named))
    # the float32 state to one host buffer, page-locked in place (a
    # caching pinned allocation would round each leaf up to a power of
    # two); after the first step each leaf goes through a card buffer:
    # the saved state back in, the result out to the host; after the
    # second step each leaf against it on the card
    t0 = time.perf_counter()
    flat = [x for x in leaves() if x.dtype == torch.float32]
    ints = [x.detach().clone() for x in leaves()
            if x.dtype != torch.float32]
    host = torch.empty(sum(x.numel() for x in flat), dtype=torch.float32)
    cudart = torch.cuda.cudart()
    rc = cudart.cudaHostRegister(host.data_ptr(), host.numel() * 4, 0)
    require(int(rc) == 0, f"cudaHostRegister of {host.numel() * 4} bytes: "
            f"{rc}")
    try:
        saved, at = [], 0
        for x in flat:
            saved.append(host[at: at + x.numel()].view(x.shape))
            at += x.numel()
        for h, x in zip(saved, flat):
            h.copy_(x.detach())
        t_save = time.perf_counter() - t0
        step(batches[1])
        flat = [x for x in leaves() if x.dtype == torch.float32]
        first_ints = [x.detach().clone() for x in leaves()
                      if x.dtype != torch.float32]
        tmp = torch.empty(max(x.numel() for x in flat), dtype=torch.float32,
                          device="cuda")
        with torch.no_grad():
            for h, x in zip(saved, flat):
                t = tmp[: x.numel()].view(x.shape)
                t.copy_(x)
                x.copy_(h)
                h.copy_(t)
            for x, v in zip([x for x in leaves()
                             if x.dtype != torch.float32], ints):
                x.copy_(v)
        step(batches[1])
        torch.cuda.synchronize()
        flat = [x for x in leaves() if x.dtype == torch.float32]
        same = [torch.equal(x, v) for x, v in zip(
            [x for x in leaves() if x.dtype != torch.float32], first_ints)]
        with torch.no_grad():
            for h, x in zip(saved, flat):
                t = tmp[: x.numel()].view(x.shape)
                t.copy_(h)
                same.append(torch.equal(t, x))
        del tmp, first_ints
    finally:
        cudart.cudaHostUnregister(host.data_ptr())
        del host
    require(all(same), f"lm train: one step twice from the same state gives "
            f"other bits in {same.count(False)} of {len(same)} leaves")
    print(f"[lm] (d) one step twice from the same state: all {len(same)} "
          f"parameter and moment leaves equal bit for bit (the token "
          f"embedding's gradient through F.embedding's sort-based backward) "
          f"({time.perf_counter() - t0:.1f} s with the pinned host copies, "
          f"{t_save:.1f} s of it the first)")
    del model, state, saved, batches
    torch.cuda.empty_cache()


def phase_lm(torch, seed: int, card: str) -> None:
    """The LM family on one card: (e) the five smoke configs against the
    CPU, (f) the train and serve CLIs, (c) h2o-danube long_500k, (b)
    granite-moe, (a) qwen3-4b serving with (h) its profile and SDPA, (d)
    stablelm-3b training."""
    parts = (("e smoke", _lm_smoke, (torch, seed)),
             ("f clis", _lm_clis, (torch, seed)),
             ("c long_500k", _lm_long, (torch, seed, card)),
             ("b granite", _lm_moe, (torch, seed, card)),
             ("a qwen3 serve", _lm_serve, (torch, seed, card)),
             ("d stablelm train", _lm_train, (torch, seed, card)))
    for tag, fn, args in parts:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fn(*args)
        print(f"[time] lm ({tag}): {time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated()} bytes")
        torch.cuda.reset_peak_memory_stats()
    print(f"[lm] cuts, each beside its run: (a) qwen3-4b prefill_32k batch "
          f"32 -> {LM_PREFILL_BATCH}, decode_32k batch 128 -> "
          f"{LM_DECODE_BATCH}; (b) granite-moe-3b-a800m prefill seq 32768 "
          f"-> {LM_MOE_SEQ}, batch 32 -> {LM_MOE_BATCH}; (c) h2o-danube-3-4b "
          f"long_500k uncut (B = 1), a prefill of {LM_LONG_PREFILL} tokens "
          f"and {LM_LONG_DECODE} decode steps; (d) stablelm-3b train_4k "
          f"batch 256 -> {LM_TRAIN_BATCH}; widths as published, the depths "
          f"too but (a) qwen3-4b 36 -> {LM_SERVE_LAYERS} and (d) "
          f"stablelm-3b 32 -> {LM_TRAIN_LAYERS} layers")


# ---------------------------------------------------------------------------
# The LM cells on a mesh (phase "lm mesh"): LM_MESH_WORLD processes of this
# script (--mesh-rank) on a 2 x 2 (data, model) mesh, sharing the card over
# gloo (--ranks 4: one rank a card over NCCL), each run against the
# one-rank path in this process.
# ---------------------------------------------------------------------------

LM_MESH_WORLD = 4
LM_MESH_SHAPE = (2, 2)
# (a) qwen3-4b at full width, depth cut 36 -> LM_MESH_QWEN_LAYERS: a
# prefill of LM_MESH_PREFILL (batch, seq), LM_MESH_DECODE_STEPS decode
# steps from its cache, decode_32k at LM_MESH_DECODE_BATCH over a full
# 32,768-slot cache of random values
LM_MESH_QWEN_LAYERS = 4
LM_MESH_PREFILL = (2, 4096)
LM_MESH_DECODE_STEPS = 8
LM_MESH_DECODE_BATCH = 8
# (b) deepseek-moe-16b x train_4k and train_4k_int8a2a at full width, depth
# cut 28 -> LM_MESH_MOE_LAYERS, batch 256 -> LM_MESH_TRAIN[0] (depth 1 and
# 2 x 2048 tokens took as long on an H100: the vocabulary's gathers and
# the float32 gradients' exchanges set its time, not the depth)
LM_MESH_MOE_LAYERS = 2
LM_MESH_TRAIN = (2, 4096)
# the int8 exchange against the exact one on layer 0's MoE (the
# reference's own bound, tests/test_distributed.py)
LM_MESH_INT8_TOL = 0.02
# (b)'s exact bf16 step's loss against the one-rank step's, as a share of
# itself. The gradients are held in float32 activations at depth
# LM_MESH_GRAD_LAYERS, each leaf within LM_MESH_F32_GRAD_TOL of its largest
# magnitude, where every token routes alike on the two paths (checked: a
# routing that differs voids the comparison and fails it). A token whose
# top-k set differs moves the routed leaves' gradients far past rounding:
# on an NVIDIA H100 80GB HBM3 at 700 W, in bf16 9 of 1,024 tokens at
# layer 0 moved them by 0.18-0.22 of their largest; in float32 at depth 2
# one token of 8,192 at layer 1 moved them by 0.03-0.07, against 1e-5 at
# depth 1 with none (PERF.md)
LM_MESH_BF16_LOSS_TOL = 0.05
LM_MESH_F32_GRAD_TOL = 1e-4
LM_MESH_GRAD_LAYERS = 1


def _lm_mesh_arch(name: str, kind: str, layers: int = None):
    """The cut arch of (a) or (b) with its cells' shapes (``layers``: (b)
    at another depth)."""
    import dataclasses

    from repro_torch.configs import get_arch
    arch = get_arch(name)
    if kind == "a":
        B, S = LM_MESH_PREFILL
        cfg = dataclasses.replace(arch.model, n_layers=LM_MESH_QWEN_LAYERS)
        shapes = {"prefill": dict(kind="prefill", seq=S, batch=B),
                  "decode": dict(kind="decode", seq=S, batch=B),
                  "decode_32k": dict(arch.shapes["decode_32k"],
                                     batch=LM_MESH_DECODE_BATCH)}
    else:
        B, S = LM_MESH_TRAIN
        cfg = dataclasses.replace(arch.model,
                                  n_layers=layers or LM_MESH_MOE_LAYERS)
        shapes = {k: dict(arch.shapes[k], batch=B, seq=S)
                  for k in ("train_4k", "train_4k_int8a2a")}
    return dataclasses.replace(arch, model=cfg, shapes=shapes)


def _lm_mesh_cache(torch, cfg, mesh_shape, seed: int, block=None):
    """decode_32k's full cache of random bfloat16 values, drawn block by
    block (a data shard's sequences × a model rank's slots, each from a
    seed of its own) so that a rank draws its block alone: the whole cache,
    or the block at ``block = (data index, model index)``."""
    from repro_torch.legacy.models import transformer as tfm
    G, M = mesh_shape
    L, B = LM_MESH_QWEN_LAYERS, LM_MESH_DECODE_BATCH
    S = 32768
    shape = (L, B // G, S // M, cfg.n_kv_heads, cfg.head_dim)

    def draw(i, j, which):
        gen = torch.Generator(device="cuda").manual_seed(
            seed * 1000 + 2 * (i * M + j) + which)
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    if block is not None:
        return tfm.KVCache(draw(*block, 0), draw(*block, 1), pos)
    full = [torch.empty((L, B, S) + shape[3:], dtype=torch.bfloat16,
                        device="cuda") for _ in range(2)]
    for i in range(G):
        for j in range(M):
            for w, c in enumerate(full):
                c[:, i * shape[1]: (i + 1) * shape[1],
                  j * shape[2]: (j + 1) * shape[2]] = draw(i, j, w)
    return tfm.KVCache(full[0], full[1], pos)


def _lm_mesh_batch(torch, cfg, batch: int, seq: int, seed: int) -> dict:
    from repro_torch.legacy.data import TokenStream
    return TokenStream(cfg.vocab, batch, seq, seed).batch_at(0,
                                                             device="cuda")


def _lm_mesh_refs(torch, tmp: Path, seed: int, card: str) -> dict:
    """The one-rank runs the ranks are held against, written to ``tmp``:
    (a) qwen3's prefill logits and cache, its decode logits, decode_32k's
    logits; (b) deepseek with moe_groups = 2: the bf16 loss, and the
    gradients in float32 activations (kept on the card and handed to the
    ranks as CUDA IPC handles) with each leaf's largest magnitude, and
    layer 0's routing in both dtypes → ``(what the ranks read, the
    gradients to keep alive until they exit)``."""
    import dataclasses
    import pickle

    from torch.multiprocessing.reductions import reduce_tensor

    from repro_torch.legacy.models import transformer as tfm

    from repro_torch.launch.steps import build_cell, lm_cell_config, lm_grads

    out = {}
    arch = _lm_mesh_arch("qwen3-4b", "a")
    cfg = arch.model
    model, _ = _lm_init(torch, cfg, seed)
    B, S = LM_MESH_PREFILL
    toks = _lm_mesh_batch(torch, cfg, B, S + LM_MESH_DECODE_STEPS,
                          seed)["tokens"]
    cp, cd, c32 = (build_cell(arch, k) for k in
                   ("prefill", "decode", "decode_32k"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = cp.fn(model, toks[:, :S].contiguous())
    torch.cuda.synchronize()
    out["a_prefill_s"] = time.perf_counter() - t0
    ref = {"prefill": logits.cpu(), "k": cache.k.cpu(), "v": cache.v.cpu()}
    for i in range(LM_MESH_DECODE_STEPS):
        logits, cache = cd.fn(model, cache, toks[:, S + i].contiguous())
        ref[f"decode{i}"] = logits.cpu()
    del cache
    full = _lm_mesh_cache(torch, cfg, LM_MESH_SHAPE, seed)
    tok32 = toks[:, S - 1].repeat(LM_MESH_DECODE_BATCH // B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = c32.fn(model, full, tok32)
    torch.cuda.synchronize()
    out["a_decode32_s"] = time.perf_counter() - t0
    ref["decode_32k"] = logits.cpu()
    torch.save(ref, tmp / "ref_a.pt")
    del model, full, logits, ref
    torch.cuda.empty_cache()

    arch = _lm_mesh_arch("deepseek-moe-16b", "b")
    # the mesh cell's config: one dispatch group a data shard
    cfg = dataclasses.replace(lm_cell_config(arch, "train_4k"),
                              moe_groups=LM_MESH_SHAPE[0])
    model, _ = _lm_init(torch, cfg, seed)
    b = _lm_mesh_batch(torch, cfg, *LM_MESH_TRAIN, seed)
    with torch.no_grad():
        out["b_loss"] = float(tfm.lm_loss(model.params(), b["tokens"],
                                          b["labels"], cfg)[0])
    out["b_routes_bf16"] = _lm_mesh_routes(torch, model, b["tokens"], cfg)
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=LM_MESH_GRAD_LAYERS,
                                dtype="float32")
    model, _ = _lm_init(torch, cfg32, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = lm_grads(model, b["tokens"], b["labels"], cfg32)
    torch.cuda.synchronize()
    out["b_grads_s"] = time.perf_counter() - t0
    out["b_peak"] = torch.cuda.max_memory_allocated()
    out["b_gmax"] = [float(g.abs().max()) for g in grads]
    out["b_routes_f32"] = _lm_mesh_routes(torch, model, b["tokens"], cfg32)
    # the float32 gradients stay on the card; the ranks map them (CUDA IPC)
    (tmp / "ref_b.pkl").write_bytes(pickle.dumps(
        [reduce_tensor(g) for g in grads]))
    del model, b
    torch.cuda.empty_cache()
    print(f"[lm mesh] one-rank references in this process: (a) qwen3-4b "
          f"prefill {out['a_prefill_s']:.3f} s, decode_32k step "
          f"{1e3 * out['a_decode32_s']:.3f} ms (B = {LM_MESH_DECODE_BATCH}, "
          f"first call); (b) deepseek-moe-16b with moe_groups = "
          f"{LM_MESH_SHAPE[0]}: the bf16 loss {out['b_loss']:.6f}; the "
          f"gradients in float32 activations {out['b_grads_s']:.3f} s, peak "
          f"{out['b_peak']} bytes; card {card}", flush=True)
    return out, grads


def _lm_mesh_routes(torch, model, tokens, cfg, shard=None) -> list:
    """Every layer's top-k expert choices, sorted, a row a token: on one
    rank from ``model``'s own path, on a mesh from the mesh path's."""
    from repro_torch.legacy.models import moe
    from repro_torch.legacy.models import transformer as tfm
    from repro_torch.legacy.models.layers import no_shard, rms_norm
    out = []
    with torch.no_grad():
        params = model.params()
        pos = tfm._positions(*tokens.shape, tokens.device)
        if shard is None:
            x = tfm.embed(params, tokens, cfg)
            layers = [(lp, None) for lp in tfm.layer_views(params, cfg)]
        else:
            x = tfm._embed_mesh(params, tokens, cfg, shard)
            layers = tfm._mesh_layers(params, cfg, shard)
        for lp, sp in layers:
            if shard is None:
                q, k, v = tfm._qkv(lp, x, pos, cfg, no_shard)
                x = tfm._attn_out(lp, x, q, k, v, cfg, no_shard)
                gain, router = lp["ln_ffn"], lp["moe"]["router"]
            else:
                x = tfm._attn_mesh(lp, sp, x, pos, cfg, shard)[0]
                gain = shard.whole(lp["ln_ffn"], sp["ln_ffn"])
                router = shard.whole(lp["moe"]["router"], sp["moe"]["router"])
            h = rms_norm(x, gain).reshape(-1, cfg.d_model)
            probs = torch.softmax((h @ router.to(h.dtype)).float(), dim=-1)
            out.append(moe.top_k(probs, cfg.top_k)[1].sort(-1).values
                       .tolist())
            x = (tfm._ffn(lp, x, cfg, no_shard) if shard is None else
                 tfm._ffn_mesh(lp, sp, x, cfg, shard))[0]
    return out


def phase_lm_mesh(torch, seed: int, card: str, world: int = LM_MESH_WORLD,
                  backend: str = "gloo") -> None:
    """(a) qwen3-4b prefill, decode and decode_32k, (b) deepseek-moe-16b
    train_4k and train_4k_int8a2a, (c) the deepseek and qwen3 smoke cells
    on the card against the same cells on the CPU ranks; on ``world``
    ranks of a (data, model) mesh over ``backend``, held against the
    one-rank path in this process."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_"))
    try:
        torch.cuda.reset_peak_memory_stats()
        refs, keep = _lm_mesh_refs(torch, tmp, seed, card)
        sizes = {k: v for k, v in globals().items()
                 if k.startswith("LM_MESH_")}
        (tmp / "job.json").write_text(json.dumps(
            {"lm_mesh": True, "world": world, "backend": backend,
             "seed": seed, "card": card, "refs": refs, "sizes": sizes}))
        t0 = time.perf_counter()
        logs = _run_rank_procs(tmp, world, f"lm mesh {backend}")
        print(f"[lm mesh] {world} ranks over {backend}: "
              f"{time.perf_counter() - t0:.1f} s from start to exit")
        del keep
        torch.cuda.ipc_collect()  # the ranks' mappings are gone
        torch.cuda.empty_cache()
        for r, log in enumerate(logs):
            for line in log.splitlines():
                if line.startswith("[lm mesh]"):
                    print(f"[lm mesh] rank {r} of {world}:{line[9:]}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(world)]
        worst = {k: max(x[k] for x in res) for k in res[0]
                 if k.startswith("rel ")}
        for k, v in sorted(worst.items()):
            print(f"[lm mesh] {k}: {v:.6f} (the largest over the ranks)")
        from repro_torch.launch.shardings import tree_paths
        from repro_torch.legacy.models import transformer as tfm
        names = [p for p, _ in tree_paths(tfm.param_shapes(
            _lm_mesh_arch("deepseek-moe-16b", "b", LM_MESH_GRAD_LAYERS)
            .model))]
        by_leaf = [max(x["b grads by leaf"][i] for x in res)
                   for i in range(len(names))]
        print(f"[lm mesh] (b) depth {LM_MESH_GRAD_LAYERS}, float32 "
              f"activations: each gradient leaf's largest difference from "
              f"the one-rank path's, as a share of its largest magnitude: "
              + ", ".join(f"{n} {v:.2e}" for n, v in zip(names, by_leaf)))
        flips = {}
        for tag in ("bf16", "f32"):
            per = [x[f"b route flips {tag}"] for x in res[::LM_MESH_SHAPE[1]]]
            flips[tag] = [sum(layer) for layer in zip(*per)]
            print(f"[lm mesh] (b) routing in {tag} activations: tokens of "
                  f"{LM_MESH_TRAIN[0] * LM_MESH_TRAIN[1]} whose top-k set "
                  f"of experts differs on the mesh from one rank, by layer: "
                  f"{flips[tag]}")
        require(sum(flips["f32"]) == 0, f"lm mesh (b): {flips['f32']} "
                f"tokens route otherwise in float32; the gradient "
                f"comparison needs the same routing")
        for k in ("rel a prefill logits", "rel a prefill cache",
                  "rel a decode logits", "rel a decode_32k logits"):
            require(worst[k] <= LM_BF16_TOL, f"lm mesh {k}: {worst[k]} > "
                    f"{LM_BF16_TOL}")
        require(worst["rel b loss"] <= LM_MESH_BF16_LOSS_TOL,
                f"lm mesh (b) loss: {worst['rel b loss']}")
        require(worst["rel b grads"] <= LM_MESH_F32_GRAD_TOL,
                f"lm mesh (b) float32 gradients: {worst['rel b grads']}")
        require(worst["rel b int8 moe"] <= LM_MESH_INT8_TOL,
                f"lm mesh (b) int8 MoE output: {worst['rel b int8 moe']}")
        print(f"[lm mesh] cuts: (a) qwen3-4b depth 36 -> "
              f"{LM_MESH_QWEN_LAYERS}, prefill_32k batch 32 -> "
              f"{LM_MESH_PREFILL[0]} and seq 32768 -> {LM_MESH_PREFILL[1]}, "
              f"decode_32k batch 128 -> {LM_MESH_DECODE_BATCH}; (b) "
              f"deepseek-moe-16b depth 28 -> {LM_MESH_MOE_LAYERS}, batch 256 "
              f"-> {LM_MESH_TRAIN[0]} and seq 4096 -> {LM_MESH_TRAIN[1]}; "
              f"(c) the smoke configs; widths as "
              f"published; a {LM_MESH_SHAPE[0]} x {LM_MESH_SHAPE[1]} "
              f"(data, model) mesh of {world} ranks over {backend}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_lm_mesh(rank: int, d: Path, job: dict) -> int:
    """One rank of phase_lm_mesh: (a), (b), (c) on the mesh; what it
    measured to rank{rank}.json."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    # the parent's sizes (a short check may cut them)
    globals().update({k: tuple(v) if isinstance(v, list) else v
                      for k, v in job["sizes"].items()})
    topo = multihost.initialize(init_method=f"file://{d}/rendezvous",
                                num_processes=job["world"], process_id=rank,
                                backend=job["backend"], timeout=600)
    out = {}
    try:
        mesh = init_device_mesh("cuda", LM_MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        _lm_mesh_transport(torch, mesh, rank, job, topo)
        for tag, fn in (("a", _rank_lm_mesh_a), ("b", _rank_lm_mesh_b),
                        ("c", _rank_lm_mesh_c)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn(torch, mesh, rank, d, job, out)
            print(f"[lm mesh] ({tag}) {time.perf_counter() - t0:.1f} s on "
                  f"this rank; its peak {torch.cuda.max_memory_allocated()} "
                  f"bytes", flush=True)
    finally:
        multihost.shutdown()
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def _lm_mesh_transport(torch, mesh, rank: int, job: dict, topo) -> None:
    """The all_to_all over ``model`` on CUDA tensors, checked first: int8
    and float32 rows through core.collectives.all_to_all."""
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    M = coll.axis_size(mesh, "model")
    m = coll.axis_index(mesh, "model")
    for dt in (torch.int8, torch.float32):
        x = (torch.arange(M * 3, device="cuda") + 10 * m).to(dt).view(M, 3)
        got = coll.all_to_all(x, mesh, "model")
        want = torch.stack([(torch.arange(3, device="cuda") + 3 * m + 10 * j)
                            .to(dt) for j in range(M)])
        require(torch.equal(got, want), f"rank {rank}: all_to_all of "
                f"{dt} CUDA rows over model: {got.tolist()}")
    if rank == 0:
        be = dist.get_backend(mesh.get_group("model"))
        how = ("gloo copies each CUDA tensor to host memory, exchanges it "
               "there and copies it back" if be == "gloo" else
               "NCCL on the cards")
        print(f"[lm mesh] transport: all_to_all over model is "
              f"torch.distributed.all_to_all_single on CUDA tensors over "
              f"{be} ({how}); checked on int8 and float32 rows; "
              f"{topo.num_processes} ranks, rank 0 on "
              f"cuda:{torch.cuda.current_device()}", flush=True)


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _comm_share(torch, fn) -> tuple:
    """``fn`` once more with every collective timed (the card synchronized
    around each) → (its wall, the collectives' seconds, their count)."""
    from repro_torch.legacy.models.spmd import comm_timer
    with comm_timer() as rec:
        _, wall = _sync_time(torch, fn)
    return wall, rec["s"], rec["calls"]


def _lm_mesh_rel(torch, got, want, scale: float) -> float:
    d = float((got.detach().float() - want.to(got.device).float())
              .abs().max())
    return d / scale if scale else d


def _rank_lm_mesh_a(torch, mesh, rank, d, job, out) -> None:
    """(a): qwen3-4b prefill, decode from its cache, decode_32k."""
    import numpy as np

    from repro_torch import random as trandom
    from repro_torch.kernels import ops
    from repro_torch.launch.shardings import local_block
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy.models import transformer as tfm

    seed = job["seed"]
    arch = _lm_mesh_arch("qwen3-4b", "a")
    cfg = arch.model
    cp, cd, c32 = (build_cell(arch, k, mesh, device="cuda") for k in
                   ("prefill", "decode", "decode_32k"))
    ops.reset_launch_counts()
    (model, init_s) = _sync_time(torch, lambda: tfm.init_transformer(
        cfg, key=trandom.PRNGKey(seed, device="cuda"), mesh=mesh,
        specs=cp.state_shardings[0]))
    counts = ops.launch_counts()
    require(sum(counts.values()) == counts["threefry_bits"] > 0,
            f"rank {rank}: lm mesh init launches {counts}")
    out["a init threefry_bits"] = counts["threefry_bits"]
    B, S = LM_MESH_PREFILL
    toks = _lm_mesh_batch(torch, cfg, B, S + LM_MESH_DECODE_STEPS,
                          seed)["tokens"]
    ref = torch.load(d / "ref_a.pt")
    bspec = cp.in_shardings[0]
    cspec = cd.in_shardings[0].k
    prompt = local_block(toks[:, :S].contiguous(), bspec, mesh)
    cp.fn(model, prompt)  # a first call, untimed (the library's set-up)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (logits, cache), wall = _sync_time(torch, lambda: cp.fn(model, prompt))
    peak = torch.cuda.max_memory_allocated() - base
    lscale = float(ref["prefill"].abs().max())
    out["rel a prefill logits"] = _lm_mesh_rel(
        torch, logits, local_block(ref["prefill"], bspec[:1], mesh), lscale)
    out["rel a prefill cache"] = max(_lm_mesh_rel(
        torch, c, local_block(ref[k], cspec, mesh),
        float(ref[k].abs().max())) for c, k in ((cache.k, "k"),
                                                (cache.v, "v")))
    iwall, cs, calls = _comm_share(torch, lambda: cp.fn(model, prompt))
    n_tok = B * S
    print(f"[lm mesh] (a) qwen3-4b prefill {B} x {S} on a "
          f"{LM_MESH_SHAPE[0]} x {LM_MESH_SHAPE[1]} mesh: wall {wall:.3f} s "
          f"({n_tok / wall:.1f} tokens/s over the mesh), peak above the "
          f"model {peak} bytes on this rank; instrumented run {iwall:.3f} s, "
          f"{calls} collectives {cs:.3f} s = {cs / iwall:.3f} of it; model "
          f"drawn in {init_s:.2f} s ({out['a init threefry_bits']} "
          f"threefry_bits launches on this rank); launches in the prefill "
          f"{json.dumps(ops.launch_counts())}", flush=True)
    out.update({"a prefill s": wall, "a prefill comm share": cs / iwall})
    walls, rel = [], 0.0
    for i in range(LM_MESH_DECODE_STEPS):
        tok = local_block(toks[:, S + i].contiguous(), cd.in_shardings[1],
                          mesh)
        (logits, cache), w = _sync_time(torch,
                                        lambda: cd.fn(model, cache, tok))
        walls.append(w)
        rel = max(rel, _lm_mesh_rel(
            torch, logits, local_block(ref[f"decode{i}"], bspec[:1], mesh),
            float(ref[f"decode{i}"].abs().max())))
    out["rel a decode logits"] = rel
    out["a decode p50 s"] = float(np.median(walls))
    del cache
    # decode_32k: this rank's block of the full random cache
    coords = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    full = _lm_mesh_cache(torch, cfg, LM_MESH_SHAPE, seed, block=coords)
    tok32 = local_block(toks[:, S - 1].repeat(LM_MESH_DECODE_BATCH // B),
                        c32.in_shardings[1], mesh)
    (logits, full), w32 = _sync_time(torch, lambda: c32.fn(model, full,
                                                           tok32))
    out["rel a decode_32k logits"] = _lm_mesh_rel(
        torch, logits, local_block(ref["decode_32k"], c32.in_shardings[1],
                                   mesh), float(ref["decode_32k"].abs().max()))
    walls32 = []
    for _ in range(3):
        (logits, full), w = _sync_time(torch, lambda: c32.fn(model, full,
                                                            tok32))
        walls32.append(w)
    iwall, cs, calls = _comm_share(torch, lambda: c32.fn(model, full, tok32))
    kv = full.k.numel() * full.k.element_size() * 2
    print(f"[lm mesh] (a) qwen3-4b decode from the prefill's cache: p50 "
          f"{1e3 * out['a decode p50 s']:.3f} ms a step "
          f"({LM_MESH_DECODE_STEPS} steps); decode_32k at B = "
          f"{LM_MESH_DECODE_BATCH} over a full cache ({kv} bytes of it on "
          f"this rank): first step {1e3 * w32:.3f} ms, p50 of 3 after it "
          f"{1e3 * float(np.median(walls32)):.3f} ms "
          f"({LM_MESH_DECODE_BATCH / float(np.median(walls32)):.1f} "
          f"tokens/s); instrumented step {1e3 * iwall:.3f} ms, {calls} "
          f"collectives {1e3 * cs:.3f} ms = {cs / iwall:.3f} of it",
          flush=True)
    out.update({"a decode_32k p50 s": float(np.median(walls32)),
                "a decode_32k comm share": cs / iwall})
    del model, full


def _rank_lm_mesh_b(torch, mesh, rank, d, job, out) -> None:
    """(b): deepseek-moe-16b train_4k and train_4k_int8a2a."""
    import dataclasses
    import pickle

    from repro_torch import random as trandom
    from repro_torch.launch.shardings import local_block, make_shard_fn
    from repro_torch.launch.steps import build_cell, lm_cell_config, lm_grads
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import moe
    from repro_torch.legacy.models import transformer as tfm
    from repro_torch.legacy.models.layers import rms_norm
    from repro_torch.legacy.models.spmd import reduce_sum, spec_leaves

    seed, refs = job["seed"], job["refs"]
    arch = _lm_mesh_arch("deepseek-moe-16b", "b")
    ct = build_cell(arch, "train_4k", mesh, device="cuda")
    c8 = build_cell(arch, "train_4k_int8a2a", mesh, device="cuda")
    specs = ct.state_shardings[0]
    require(c8.state_shardings[0] == specs, "lm mesh (b): the two cells "
            "lay the model out differently")
    cfg = lm_cell_config(arch, "train_4k", mesh)
    model = tfm.init_transformer(cfg, key=trandom.PRNGKey(seed,
                                                          device="cuda"),
                                 mesh=mesh, specs=specs)
    B, S = LM_MESH_TRAIN
    b = _lm_mesh_batch(torch, cfg, B, S, seed)
    tb, lb = (local_block(b[k], ct.in_shardings[0], mesh)
              for k in ("tokens", "labels"))
    shard = make_shard_fn(mesh, specs, batch=B)
    # each layer's routing against the one-rank path's: tokens whose top-k
    # set differs (bf16 near-ties)
    lo = mesh.get_local_rank("data") * tb.numel()

    def flips(routes, ref):
        return [sum(a != b for a, b in zip(mine, theirs[lo: lo + tb.numel()]))
                for mine, theirs in zip(routes, ref)]
    out["b route flips bf16"] = flips(
        _lm_mesh_routes(torch, model, tb, cfg, shard), refs["b_routes_bf16"])
    # the gradients in float32 activations, at LM_MESH_GRAD_LAYERS, against
    # the one-rank path's, every token routed alike
    a32 = _lm_mesh_arch("deepseek-moe-16b", "b", LM_MESH_GRAD_LAYERS)
    c32 = build_cell(a32, "train_4k", mesh, device="cuda")
    cfg32 = dataclasses.replace(lm_cell_config(a32, "train_4k", mesh),
                                dtype="float32")
    specs32 = c32.state_shardings[0]
    m32 = tfm.init_transformer(cfg32, key=trandom.PRNGKey(seed,
                                                          device="cuda"),
                               mesh=mesh, specs=specs32)
    s32 = make_shard_fn(mesh, specs32, batch=B)
    out["b route flips f32"] = flips(
        _lm_mesh_routes(torch, m32, tb, cfg32, s32), refs["b_routes_f32"])
    (_, grads), gwall = _sync_time(
        torch, lambda: lm_grads(m32, tb, lb, cfg32, s32))
    ref = [fn(*args) for fn, args in pickle.loads(
        (d / "ref_b.pkl").read_bytes())]
    rels = [_lm_mesh_rel(torch, g, local_block(r, sp, mesh), gmax)
            for g, r, sp, gmax in zip(grads, ref, spec_leaves(specs32),
                                      refs["b_gmax"])]
    out["rel b grads"] = max(rels)
    out["b grads by leaf"] = rels
    del grads, ref, m32
    torch.cuda.empty_cache()
    # layer 0's MoE on the same input, int8 against exact
    with torch.no_grad():
        params = model.params()
        x = tfm._embed_mesh(params, tb, cfg, shard)
        lp, sp = tfm._mesh_layers(params, cfg, shard)[0]
        x = tfm._attn_mesh(lp, sp, x, tfm._positions(*tb.shape, tb.device),
                           cfg, shard)[0]
        h = rms_norm(x, shard.whole(lp["ln_ffn"], sp["ln_ffn"]))
        h = h.reshape(-1, cfg.d_model)
        ys = [moe.moe_apply_spmd(lp["moe"], sp["moe"], h, dataclasses.replace(
            cfg.moe_cfg, a2a_int8=q), shard)[0].float() for q in (False, True)]
        num = reduce_sum(torch.sum(torch.square(ys[1] - ys[0])), mesh,
                         shard.dax)
        den = reduce_sum(torch.sum(torch.square(ys[0])), mesh, shard.dax)
        out["rel b int8 moe"] = float(torch.sqrt(num / den))
    del x, h, ys, params
    state = optim.init_adam(model.params())
    # one step of each, its collectives timed: gloo waits for the card at
    # each collective anyway (an untimed step's wall was within the two
    # runs' spread of it)
    for tag, cell in (("exact", ct), ("int8", c8)):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        holder = {}

        def step():
            holder["res"] = cell.fn(model, state, tb, lb)
        wall, cs, calls = _comm_share(torch, step)
        _, state, info = holder["res"]
        peak = torch.cuda.max_memory_allocated() - base
        out[f"b {tag} step s"] = wall
        out[f"b {tag} comm share"] = cs / wall
        if tag == "exact":
            out["rel b loss"] = abs(float(info["loss"]) - refs["b_loss"]) \
                / abs(refs["b_loss"])
        print(f"[lm mesh] (b) deepseek-moe-16b train_4k"
              f"{'_int8a2a' if tag == 'int8' else ''} step, {B} x {S} "
              f"tokens, its collectives timed: wall {wall:.3f} s "
              f"({B * S / wall:.1f} tokens/s over the mesh), {calls} "
              f"collectives {cs:.3f} s = {cs / wall:.3f} of it; peak above "
              f"the model and state {peak} bytes on this rank; loss "
              f"{float(info['loss']):.6f}, grad_norm "
              f"{float(info['grad_norm']):.4f}", flush=True)
    print(f"[lm mesh] (b) the gradients in float32 activations: "
          f"{gwall:.3f} s; the exact bf16 step's loss against the one-rank "
          f"{refs['b_loss']:.6f}", flush=True)
    del model, state


def _rank_lm_mesh_c(torch, mesh, rank, d, job, out) -> None:
    """(c): the deepseek and qwen3 smoke cells in float32 (TF32 off) on
    the card against the same cells on a CPU mesh of the same ranks."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.shardings import local_block
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import TokenStream
    from repro_torch.legacy.models import transformer as tfm
    from repro_torch.legacy.tree import leaves

    cpu_mesh = init_device_mesh("cpu", LM_MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
    shapes = {"t": dict(kind="train", seq=16, batch=2),
              "p": dict(kind="prefill", seq=16, batch=2),
              "d": dict(kind="decode", seq=16, batch=2)}
    for name in ("deepseek-moe-16b", "qwen3-4b"):
        arch = get_arch(name)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, **arch.smoke), shapes=shapes)
        cfg = arch.model
        params = tfm.init_params(trandom.PRNGKey(job["seed"], device="cpu"),
                                 cfg)
        b = TokenStream(cfg.vocab, 2, 20, job["seed"]).batch_at(
            0, device="cpu")
        runs = {}
        for dev, m in (("cuda", mesh), ("cpu", cpu_mesh)):
            cp, cd, ct = (build_cell(arch, k, m, device=dev) for k in "pdt")
            model = tfm.Transformer.from_params(
                _np_tree(params), cfg, device=dev, mesh=m,
                specs=cp.state_shardings[0])
            toks = b["tokens"].to(dev)
            res = []
            logits, cache = cp.fn(model, local_block(
                toks[:, :16].contiguous(), cp.in_shardings[0], m))
            res += [logits, cache.k, cache.v]
            for i in range(3):
                logits, cache = cd.fn(model, cache, local_block(
                    toks[:, 16 + i].contiguous(), cd.in_shardings[1], m))
                res.append(logits)
            tm = tfm.Transformer.from_params(
                _np_tree(params), cfg, device=dev, mesh=m,
                specs=ct.state_shardings[0])
            st = optim.init_adam(tm.params())
            _, st, info = ct.fn(tm, st, *(local_block(
                x[:, :16].contiguous().to(dev), ct.in_shardings[0], m)
                for x in (b["tokens"], b["labels"])))
            res += [info["loss"]] + leaves(tm.params()) + leaves(st.mu) \
                + leaves(st.nu)
            runs[dev] = [x.detach().cpu() for x in res]
        for x, y in zip(runs["cuda"], runs["cpu"]):
            torch.testing.assert_close(x, y, **LM_SMOKE_TOL)
        out[f"c {name} tensors"] = len(runs["cpu"])
        print(f"[lm mesh] (c) {name} smoke cells in float32 (TF32 off) on "
              f"the card's 2 x 2 mesh against the CPU ranks' 2 x 2 mesh: "
              f"prefill logits and cache, 3 decode steps, one train step's "
              f"loss, parameters and moments ({len(runs['cpu'])} tensors "
              f"on this rank) within {LM_SMOKE_TOL}", flush=True)


# ---------------------------------------------------------------------------
# Phase gnn: the GNN family and NequIP on one rank.
# ---------------------------------------------------------------------------

GNN_ARCHS = ("gin-tu", "pna", "egnn", "nequip")
# (a) card against CPU from the same weights and inputs, float32 (TF32
# off): logits or energies, the loss, and every gradient and moment leaf
# within GNN_TOL of the largest magnitude (the LM smoke's 1e-4: two float32
# sums of each segment and GEMMs in other orders; an elementwise 1e-4
# failed on an H100 on 40 of GIN full_graph_sm's 21,504 logits, at most
# 0.0047 apart, where its unnormalized sums cancel); parameters after
# one AdamW step
# within LM_STEP_TOL plus how far the two gradients move the step apart
# (_adam_moves). In bfloat16 activations (the three classifiers; NequIP
# has no dtype): the LM's LM_BF16_SMOKE_TOL shares of the largest logit
# and gradient
GNN_TOL = 1e-4
# PNA's gradient and moment leaves: a measurement forces a wider bound.
# Its std, sqrt(max(E[x^2] - E[x]^2, 0) + 1e-5), meets zero variance at
# every receiver whose messages are equal, and 1 / (2 sqrt(1e-5)) = 158
# scales the float32 residue of the subtraction into the gradient: at
# full_graph_sm's widths the reference and the port on the CPU differ by
# 5.9e-4 of a leaf's largest, an H100 and the CPU by 7.2e-4
GNN_PNA_GRAD_TOL = 1e-3
# the smoke configs' graph, build_trainable's: rmat(512, 2048)
GNN_SMOKE_GRAPH = (512, 2048)
# (d) ogb_products: timed steps a run, after an untimed first one; the
# runs that do not fit one card at the published size divide their node
# and edge counts by this (never a width; GNN_OGB_CUT[arch] = 1 is uncut)
GNN_TIMED_STEPS = 3
# (on an H100 80GB: GIN uncut peaks 25.9 GB above its inputs for a train
# step; at the published size PNA needs 17.3 GB more than is free, at a
# cut of 4 it peaks at 75.5 GB; EGNN fits at 8 (65.7 GB), NequIP at 16
# (48.5 GB))
GNN_OGB_CUT = {"gin-tu": 1, "pna": 8, "egnn": 8, "nequip": 16}
# (d) NequIP at this depth (published 5): to pay for the gnn mesh phase
# (at depth 5 its step took 2.55 s, and its run ~23 s, on an H100)
GNN_OGB_LAYERS = {"nequip": 2}
# (e) the calls kept from the full-size ogb_products GIN step, each against
# the plain version: of its one segment_sum, the degree; of its 9
# gather_sums (the 5 layers' aggregations, then the gradients of layers 4
# to 1; layer 0 gathers the features, which take no gradient), the first
# two layers' aggregations, (n + 1, 100) and (n + 1, 64) bf16, and layer 1's
# gradient; every call of the other runs
GNN_OGB_CALLS = {"segment_sum": (0,), "gather_sum": (0, 1, 8)}
# (d) traces of a step taken until one holds every segment kernel launch
GNN_TRACE_TRIES = 3
# (c) minibatch_lg's timed steps a run with --parent, in turns: its step
# (sampling included) is host-bound and spreads by a quarter step to step
GNN_MINIBATCH_STEPS = 10
# the molecule batch's variant: examples/legacy/train_gnn.py's
GNN_CC_VARIANT = "none+uf_sync_naive"


class _SegmentRecorder:
    """The segment_sum and gather_sum calls made while it is entered (the
    calls still launched as they were) as ``(entry, (vals, ids, offsets,
    kw, order))``: the values cloned, ``ids`` what the kernel reads
    (segment_sum's order, gather_sum's gathered ids), ``kw`` the wrapper's
    keywords (the layout's plan, gather_sum's bound on its ids), ``order``
    the layout's sort; ``keep(entry, i)`` says which calls, by their index among
    the entry's calls in the run, are kept."""

    def __init__(self, keep=lambda entry, i: True):
        self.calls, self.keep = [], keep
        self.made = {"segment_sum": 0, "gather_sum": 0}

    def _take(self, entry, vals, ids, offsets, kw, order) -> None:
        if self.keep(entry, self.made[entry]):
            self.calls.append((entry, (vals.clone(), ids, offsets, kw,
                                       order)))
        self.made[entry] += 1

    def __enter__(self):
        from types import SimpleNamespace

        import repro_torch.kernels.segments as segments

        # Segments.sum reaches the dispatch through the module's name for
        # ops: that name is patched, so the wrapper and its count stay;
        # gather_sum is recorded where its layout is at hand, in
        # Gathered.sum, which then runs as it was
        self._mod, self._ops = segments, segments.ops
        self._gathered = segments.Gathered.sum
        launch, gathered = self._ops.segment_sum, self._gathered

        def record(vals, order, offsets, *, plan=None):
            self._take("segment_sum", vals, order, offsets, dict(plan=plan),
                       order)
            return launch(vals, order, offsets, plan=plan)

        def record_gathered(g, x):
            flat = x.reshape(x.shape[0], -1).contiguous()
            self._take("gather_sum", flat, g.ids, g.segs.offsets,
                       dict(plan=g.plan, id_max=g.id_limit - 1),
                       g.segs.order)
            return gathered(g, x)
        segments.ops = SimpleNamespace(**{**vars(self._ops),
                                          "segment_sum": record})
        segments.Gathered.sum = record_gathered
        return self

    def __exit__(self, *exc):
        self._mod.ops = self._ops
        self._mod.Gathered.sum = self._gathered


def gnn_rmat(torch, n_real: int, m: int, seed: int,
             chunk: int = 1 << 24) -> tuple:
    """``m`` directed RMAT edges over ``[0, n_real)``, int32 on the card:
    graphs/generators.rmat's quadrant recursion with (a, b, c) = (0.5, 0.1,
    0.1), one torch.rand a level from a CUDA Generator seeded with
    ``seed``, each id modulo ``n_real``; duplicates and self loops kept
    (the GNN shapes count directed edge slots)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    scale = max(1, (n_real - 1).bit_length())
    s = torch.empty(m, dtype=torch.int32, device="cuda")
    r = torch.empty(m, dtype=torch.int32, device="cuda")
    for lo in range(0, m, chunk):
        k = min(chunk, m - lo)
        a = torch.zeros(k, dtype=torch.int64, device="cuda")
        b = torch.zeros(k, dtype=torch.int64, device="cuda")
        for level in range(scale):
            u = torch.rand(k, generator=gen, device="cuda")
            bit = 1 << (scale - 1 - level)
            a += (u >= 0.6).long() * bit                          # c, d
            b += ((u >= 0.7) | ((u >= 0.5) & (u < 0.6))).long() * bit  # b, d
        s[lo: lo + k] = (a % n_real).to(torch.int32)
        r[lo: lo + k] = (b % n_real).to(torch.int32)
    return s, r


def _gnn_padded(torch, x, m_pad: int, fill: int):
    out = torch.full((m_pad,), fill, dtype=torch.int32, device=x.device)
    out[: x.shape[0]] = x
    return out


def _gnn_dims(spec: dict, cut: int = 1) -> tuple:
    """A full-graph shape's ``(spec, cell dims)`` with its node and edge
    counts divided by ``cut``."""
    from repro_torch.launch.steps import gnn_cell_dims
    if cut > 1:
        spec = dict(spec, n=spec["n"] // cut, m=spec["m"] // cut)
    return spec, gnn_cell_dims(spec)


def _gnn_data(torch, name: str, cfg, dims: dict, d_feat: int,
              n_classes: int, seed: int, node_targets: bool,
              device="cuda") -> dict:
    """Seeded node inputs of a cell: NequIP's species, coordinates and
    float targets a graph; the classifiers' features (with EGNN's
    coordinates) and int targets a node (or a graph)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n1 = dims["n"] + 1
    kw = dict(generator=gen, device=device)
    coords = torch.randn(n1, 3, **kw)
    if name == "nequip":
        return {"species": torch.randint(0, cfg.n_species, (n1,), **kw,
                                         dtype=torch.int32),
                "coords": coords,
                "targets": torch.randn(dims["n_graphs"], **kw)}
    out = {"feats": torch.randn(n1, d_feat, **kw),
           "targets": torch.randint(
               0, n_classes, (n1 - 1 if node_targets else dims["n_graphs"],),
               **kw, dtype=torch.int32)}
    if cfg.kind == "egnn":
        out["coords"] = coords
    return out


def _gnn_loss_fn(torch, name: str, cfg, x: dict, s, r, *, n_real=None,
                 graph_ids=None, n_graphs: int = 1):
    """``params -> loss`` of the cell's step: NequIP's squared energy
    error; the classifiers' masked NLL over the n_real real nodes (or the
    graphs)."""
    from repro_torch.legacy.models import gnn, nequip
    if name == "nequip":
        return lambda p: nequip.nequip_loss(
            p, cfg, x["species"], x["coords"], s, r, x["targets"],
            graph_ids=graph_ids, n_graphs=n_graphs)
    mask = None
    if cfg.readout == "node":
        n = x["feats"].shape[0] - 1
        mask = (torch.arange(n, device=s.device) < n_real).float()
    return lambda p: gnn.gnn_loss(
        p, cfg, x["feats"], s, r, x["targets"], coords=x.get("coords"),
        graph_ids=graph_ids, n_graphs=n_graphs, label_mask=mask)


def _gnn_forward(name: str, model, x: dict, s, r, **kw):
    if name == "nequip":
        return model(x["species"], x["coords"], s, r, **kw)
    return model(x["feats"], s, r, coords=x.get("coords"), **kw)[0]


def _gnn_model(torch, name: str, cfg, seed: int, device="cuda"):
    from repro_torch import random as trandom
    from repro_torch.legacy.models import gnn, nequip
    key = trandom.PRNGKey(seed, device=device)
    if name == "nequip":
        return nequip.init_nequip(cfg, key=key)
    return gnn.init_gnn(cfg, key=key)


def _gnn_copy(torch, model, device):
    """The model with its parameters copied to ``device``."""
    from repro_torch.legacy import optim
    params = model.params()
    return type(model)(model.cfg, optim.tree_unflatten(
        params, [x.detach().to(device, copy=True)
                 for x in optim.tree_leaves(params)]))


def _gnn_grads(torch, model, loss_fn) -> tuple:
    from repro_torch.legacy import optim
    params = model.params()
    with torch.enable_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, optim.tree_leaves(params),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), [g.detach().double().cpu() for g in grads]


def _gnn_card_vs_cpu(torch, tag: str, name: str, cfg, x: dict, s, r,
                     seed: int, ocfg, *, step: bool = True, **kw) -> dict:
    """The model from PRNGKey(seed) on the card and a CPU copy, on the same
    inputs: the forward, the loss and its gradients, and (``step``) one
    AdamW step of each; the largest shares against the CPU's."""
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.legacy import optim
    card = _gnn_model(torch, name, cfg, seed)
    cpu = _gnn_copy(torch, card, "cpu")
    xc = {k: v.cpu() for k, v in x.items()}
    kc = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    fkw = {k: v for k, v in kw.items() if k in ("graph_ids", "n_graphs")}
    fkc = {k: v for k, v in kc.items() if k in ("graph_ids", "n_graphs")}
    rel = {}
    with torch.no_grad():
        og = _gnn_forward(name, card, x, s, r, **fkw)
        oc = _gnn_forward(name, cpu, xc, s.cpu(), r.cpu(), **fkc)
    rel["out"] = _lm_rel(torch, og.float().cpu(), oc.float())
    lg_fn = _gnn_loss_fn(torch, name, cfg, x, s, r, **kw)
    lc_fn = _gnn_loss_fn(torch, name, cfg, xc, s.cpu(), r.cpu(), **kc)
    lg, gg = _gnn_grads(torch, card, lg_fn)
    lc, gc = _gnn_grads(torch, cpu, lc_fn)
    rel["loss"] = abs(float(lg) - float(lc)) / max(abs(float(lc)), 1e-30)
    rel["grads"] = max(_lm_rel(torch, a, b) for a, b in zip(gg, gc))
    bf16 = getattr(cfg, "dtype", "float32") == "bfloat16"
    if bf16:
        require(rel["out"] <= LM_BF16_SMOKE_TOL["logits"]
                and rel["grads"] <= LM_BF16_SMOKE_TOL["grads"],
                f"gnn {tag} {name} bf16: card against CPU {rel}, past "
                f"{LM_BF16_SMOKE_TOL}")
        return rel
    grad_tol = GNN_PNA_GRAD_TOL if name == "pna" else GNN_TOL
    require(rel["out"] <= GNN_TOL and rel["loss"] <= GNN_TOL
            and rel["grads"] <= grad_tol,
            f"gnn {tag} {name}: card against CPU {rel} of the largest "
            f"magnitudes, past {GNN_TOL} (gradients {grad_tol})")
    if not step:
        return rel
    before = [p.detach().clone() for p in optim.tree_leaves(cpu.params())]
    sg, sc = optim.init_adam(card.params()), optim.init_adam(cpu.params())
    _, sg, ig = gnn_train_step(card, sg, lg_fn, ocfg)
    _, sc, ic = gnn_train_step(cpu, sc, lc_fn, ocfg)
    rel["moments"] = max(_lm_rel(torch, a.cpu(), b) for a, b in zip(
        optim.tree_leaves(sg.mu), optim.tree_leaves(sc.mu)))
    require(rel["moments"] <= grad_tol,
            f"gnn {tag} {name}: a moment leaf {rel['moments']} of its "
            f"largest from the CPU's")
    lr = float(ic["lr"])
    apart = [(a - b).abs() for a, b in zip(_adam_moves(gg, ocfg, lr),
                                           _adam_moves(gc, ocfg, lr))]
    moved = 0.0
    for a, b, p0, d in zip(optim.tree_leaves(card.params()),
                           optim.tree_leaves(cpu.params()), before, apart):
        a, b = a.detach().cpu().double(), b.detach().double()
        tol = LM_STEP_TOL["atol"] + LM_STEP_TOL["rtol"] * b.abs() + d
        require(bool(((a - b).abs() <= tol).all()),
                f"gnn {tag} {name}: a parameter after the step differs "
                f"from the CPU's by {float((a - b).abs().max())}")
        moved = max(moved, float((b - p0.double()).abs().max()))
    require(moved >= 0.5 * lr, f"gnn {tag} {name}: the step moved no "
            f"parameter by half of lr ({moved})")
    return rel


def _gnn_state(model, state) -> list:
    from repro_torch.legacy import optim
    return optim.tree_leaves((model.params(), state))


def _gnn_repeat(torch, tag: str, model, state, step) -> None:
    """One train step twice from one state: every parameter and moment
    leaf and the loss equal bit for bit."""
    saved = [x.detach().clone() for x in _gnn_state(model, state)]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for dst, src in zip(_gnn_state(model, state), saved):
                dst.copy_(src)
        _, state, info = step(model, state)
        torch.cuda.synchronize()
        runs.append([info["loss"].clone()]
                    + [x.detach().clone() for x in _gnn_state(model, state)])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    require(same, f"gnn {tag}: one train step twice from one state differs")
    print(f"[gnn] {tag}: one train step twice from one state: the loss and "
          f"all {len(saved)} parameter and moment leaves equal bit for bit")


def _gnn_traced(torch, fn, ops) -> tuple:
    """``(prof, wall, launch counts)`` of one run of ``fn`` under
    torch.profiler, after one run of ``fn`` that warms it (a trace started
    on the step itself can miss its first launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        prof.step()
    return prof, wall, counts


def _gnn_profile(torch, tag: str, fn, ops) -> dict:
    """One traced run of ``fn`` (``_gnn_traced``): the device time of its
    kernels split by name into gather_sum, segment_sum (this checkout's
    kernel, or a parent's two), the gathers (index_select's and the
    others), the GEMMs, PNA's scatter_reduce and the rest, with the busy
    share and the launches of index_select's gather kernels. ``ops``: the
    kernels.ops of the package ``fn`` runs (this checkout's or the
    parent's); a trace is taken again, GNN_TRACE_TRIES times at most,
    until its calls of each segment kernel equal the wrapper's count for
    that run."""
    from torch.autograd import DeviceType

    # one launch a call of each entry's first (or only) kernel; the
    # parent's segment_sum began with segment_pieces
    first = {"segment_sum": ("segment_sum_kernel", "segment_pieces_kernel"),
             "gather_sum": ("gather_sum_kernel",)}
    for attempt in range(1, GNN_TRACE_TRIES + 1):
        prof, wall, counts = _gnn_traced(torch, fn, ops)
        # the kernels (a schedule's step annotation spans them on the
        # device too, and is left out)
        rows = sorted(((ev.device_time_total, ev.key, ev.count)
                       for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA
                       and not ev.key.startswith("ProfilerStep")),
                      reverse=True)
        traced = {e: sum(c for _, k, c in rows if any(n in k for n in names))
                  for e, names in first.items()}
        want = {e: counts.get(e, 0) for e in first}
        if traced == want:
            break
        print(f"[gnn] profile {tag}: trace {attempt} holds segment kernel "
              f"calls {traced}, the wrappers launched {want}")
    require(traced == want, f"gnn profile {tag}: the trace holds segment "
            f"kernel calls {traced}, the wrappers launched {want}, in "
            f"{GNN_TRACE_TRIES} traces")
    part = dict(gather_sum=0.0, segment_sum=0.0, gathers=0.0, gemm=0.0,
                scatter_reduce=0.0, rest=0.0)
    index_launches = 0
    for dev_us, key, count in rows:
        k, t = key.lower(), dev_us / 1e3
        if "gather_sum_" in k:
            part["gather_sum"] += t
        elif any(w in k for w in ("segment_sum_", "segment_pieces",
                                  "segment_rows")):
            part["segment_sum"] += t
        elif any(w in k for w in ("vectorized_gather", "indexselect",
                                  "index_select")):
            part["gathers"] += t
            index_launches += count
        elif "gather" in k:
            part["gathers"] += t
        elif any(w in k for w in ("gemm", "xmma", "cutlass", "wgmma")):
            part["gemm"] += t
        elif "scatter" in k:
            part["scatter_reduce"] += t
        else:
            part["rest"] += t
    busy = sum(part.values())
    share = "; ".join(f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                      for k, v in part.items())
    print(f"[gnn] profile {tag}: traced wall {wall:.4f} s, device busy "
          f"{busy / 1e3:.4f} s ({100 * busy / 1e3 / wall:.1f}%), idle "
          f"{100 * (1 - busy / 1e3 / wall):.1f}%; {share}; index_select "
          f"gather launches {index_launches}; segment kernel calls traced "
          f"{json.dumps(traced)}, equal to the wrappers' counts (trace "
          f"{attempt})")
    for dev_us, key, count in rows[:8]:
        print(f"[gnn]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")
    return dict(part, busy=busy, wall=wall, index_launches=index_launches)


def molecule_batch(torch, nodes: int, edges: int, batch: int,
                   seed: int) -> tuple:
    """``batch`` graphs of ``nodes`` nodes and ``edges`` undirected edges
    each, on the card: a random spanning tree (node i to a uniform earlier
    node) and ``edges - nodes + 1`` more edges inside the graph (no self
    loops), node ids permuted over the batch. Returns the (batch * edges,
    2) int32 undirected edges and each node's graph (int64)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    i = torch.arange(1, nodes, device="cuda")
    parent = (torch.rand(batch, nodes - 1, **kw) * i).long()
    extra = edges - (nodes - 1)
    u = torch.randint(0, nodes, (batch, extra), **kw)
    v = (u + 1 + torch.randint(0, nodes - 1, (batch, extra), **kw)) % nodes
    a = torch.cat([i.expand(batch, -1), u], 1)
    b = torch.cat([parent, v], 1)
    base = (torch.arange(batch, device="cuda") * nodes)[:, None]
    perm = torch.randperm(batch * nodes, **kw)
    e = torch.stack([perm[(a + base).reshape(-1)],
                     perm[(b + base).reshape(-1)]], 1).to(torch.int32)
    graph = torch.empty(batch * nodes, dtype=torch.int64, device="cuda")
    graph[perm] = torch.arange(batch * nodes, device="cuda") // nodes
    return e, graph


def _gnn_smoke(torch, seed: int, records: list) -> dict:
    """(a) full_graph_sm at the published widths and depths, then the
    four smoke configs in float32 and bfloat16, card against CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import gnn_cell_config
    from repro_torch.legacy import optim

    ocfg = optim.OptimizerConfig(**LM_TRAIN_OPT)
    out = {}
    spec, dims = _gnn_dims(get_arch("gin-tu").shapes["full_graph_sm"])
    sizes = (f"full_graph_sm at the published widths and depths ({spec['n']} "
             f"nodes in {dims['n'] + 1} rows, {spec['m']} edges in "
             f"{dims['m_pad']} slots, {spec['d_feat']} features, "
             f"{spec['n_classes']} classes)")
    s0, r0 = gnn_rmat(torch, spec["n"], spec["m"], seed)
    s = _gnn_padded(torch, s0, dims["m_pad"], dims["n"])
    r = _gnn_padded(torch, r0, dims["m_pad"], dims["n"])
    for name in GNN_ARCHS:
        cfg = gnn_cell_config(get_arch(name), "full_graph_sm")
        x = _gnn_data(torch, name, cfg, dims, spec["d_feat"],
                      spec["n_classes"], seed, True)
        with _SegmentRecorder() as rec:
            out[f"full_graph_sm {name}"] = _gnn_card_vs_cpu(
                torch, "full_graph_sm", name, cfg, x, s, r, seed, ocfg,
                n_real=dims["n_real"])
        if name == "gin-tu":
            records += [("gnn full_graph_sm", e, c) for e, c in rec.calls
                        if c[0].is_cuda]
    sn, sm = GNN_SMOKE_GRAPH
    s0, r0 = gnn_rmat(torch, sn, sm, seed + 1)
    dims = dict(n_real=sn, n=sn, m_pad=sm, n_graphs=1)
    for name in GNN_ARCHS:
        arch = get_arch(name)
        cfg = dataclasses.replace(arch.model, **arch.smoke)
        if name != "nequip":
            cfg = dataclasses.replace(cfg, d_in=16, n_classes=4)
        x = _gnn_data(torch, name, cfg, dims, 16, 4, seed, True)
        out[f"smoke {name}"] = _gnn_card_vs_cpu(
            torch, "smoke", name, cfg, x, s0, r0, seed, ocfg, n_real=sn)
        if name != "nequip":
            bf = dataclasses.replace(cfg, dtype="bfloat16")
            out[f"smoke bf16 {name}"] = _gnn_card_vs_cpu(
                torch, "smoke bf16", name, bf, x, s0, r0, seed, ocfg,
                n_real=sn)
    print(f"[gnn] (a) card against CPU from the same weights and inputs "
          f"(float32, TF32 off): {sizes} and the smoke configs on the card's "
          f"RMAT of {GNN_SMOKE_GRAPH}: outputs, losses, gradient and moment "
          f"leaves within {GNN_TOL} of their largest magnitudes (PNA's "
          f"gradients and moments {GNN_PNA_GRAD_TOL}), "
          f"parameters after one AdamW step within "
          f"{LM_STEP_TOL} plus the gradients' AdamW divergence; bfloat16 "
          f"within {LM_BF16_SMOKE_TOL}. Largest shares: "
          + json.dumps({k: {a: float(f"{b:.3g}") for a, b in v.items()}
                        for k, v in out.items()}))
    return out


def _gnn_molecule(torch, seed: int, records: list, card: str) -> None:
    """(b) the molecule batch: graph ids from ConnectIt on the card (its
    kernels' launches asserted), each arch's cell step on them."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.configs import get_arch
    from repro_torch.graphs.containers import build_graph
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (
        build_cell,
        gnn_cell_config,
        gnn_cell_dims,
    )
    from repro_torch.legacy import optim

    spec = get_arch("gin-tu").shapes["molecule"]
    nodes, batch = spec["nodes"], spec["batch"]
    edges, graph = molecule_batch(torch, nodes, spec["edges"], batch, seed)
    n_real = nodes * batch
    g = build_graph(edges, n_real, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    labels = ConnectIt(GNN_CC_VARIANT, device="cuda").connected_components(g)
    cc_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    # the naive finish: hook rounds, the final compression's hop, the
    # canonicalization's scatter
    for name in ("hook_compress", "pointer_jump", "scatter_min"):
        require(counts[name] > 0, f"gnn molecule: ConnectIt launched no "
                f"{name} ({counts})")
    uniq, gid = np.unique(labels, return_inverse=True)
    truth = graph.cpu().numpy()
    # the components are the generator's graphs: one label a graph, one
    # graph a label
    pairs = np.unique(np.stack([gid, truth], 1), axis=0)
    require(len(uniq) == batch and len(pairs) == batch,
            f"gnn molecule: ConnectIt found {len(uniq)} graphs, {len(pairs)} "
            f"label-graph pairs; want {batch}")
    print(f"[gnn] (b) molecule: {batch} graphs x {nodes} nodes, "
          f"{spec['edges']} undirected edges each ({g.m} directed after "
          f"dedup); ConnectIt({GNN_CC_VARIANT!r}).connected_components on "
          f"the card found exactly the {batch} generated graphs in "
          f"{cc_s:.4f} s; launches {json.dumps(counts)}")
    dims = gnn_cell_dims(spec)
    n, m_pad = dims["n"], dims["m_pad"]
    for name in GNN_ARCHS:
        arch = get_arch(name)
        cell = build_cell(arch, "molecule")
        cfg = gnn_cell_config(arch, "molecule")
        s = _gnn_padded(torch, g.senders[: g.m], m_pad, n)
        r = _gnn_padded(torch, g.receivers[: g.m], m_pad, n)
        gids = torch.full((n + 1,), batch, dtype=torch.int32, device="cuda")
        gids[:n_real] = torch.from_numpy(gid.astype(np.int32)).cuda()
        x = _gnn_data(torch, name, cfg, dims, spec["d_feat"],
                      spec["n_classes"], seed, False)
        feats = {k: v for k, v in x.items() if k != "targets"}
        model = _gnn_model(torch, name, cfg, seed)
        state = optim.init_adam(model.params())
        ops.reset_launch_counts()
        with _SegmentRecorder() as rec:
            _, state, info = cell.fn(model, state, feats, s, r, x["targets"],
                                     gids)
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        require(counts["segment_sum"] > 0 and bool(
            torch.isfinite(info["loss"])) and (counts["gather_sum"] > 0) == (
                name == "gin-tu"), f"gnn molecule {name}: launches "
            f"{counts}, loss {info['loss']}")
        records += [("gnn molecule", e, c) for e, c in rec.calls]
        _gnn_repeat(torch, f"(b) molecule {name}", model, state,
                    lambda m, st: cell.fn(m, st, feats, s, r, x["targets"],
                                          gids))
        what = "per-graph energy" if name == "nequip" else "graph readout"
        print(f"[gnn] (b) molecule {name}: {what} over ConnectIt's "
              f"{batch} graph ids, a train step: loss "
              f"{float(info['loss']):.6f}, grad_norm "
              f"{float(info['grad_norm']):.6f}; segment_sum launches a step "
              f"{counts['segment_sum']}, gather_sum {counts['gather_sum']}; "
              f"card {card}")


def minibatch_csr(torch, n_real: int, n: int, m: int, m_rows: int,
                  seed: int) -> tuple:
    """The minibatch shape's CSR on the card: ``m`` RMAT edges (gnn_rmat)
    sorted by source, ``indptr`` (n + 2,) over the padded rows (rows
    ``[n_real, n]`` empty), ``indices`` (m_rows,) padded with the dump id
    n."""
    s, r = gnn_rmat(torch, n_real, m, seed)
    order = torch.argsort(s, stable=True)
    indices = _gnn_padded(torch, r[order], m_rows, n)
    del r
    indptr = torch.searchsorted(
        s[order], torch.arange(n + 2, dtype=torch.int32, device="cuda"),
        out_int32=True)
    return indptr, indices


def _gnn_minibatch(torch, seed: int, records: list, card: str,
                   cut: int, parent=None) -> None:
    """(c) minibatch_lg: the Reddit-scale CSR on the card, GraphNodeStream's
    seeds and sample_subgraph on the card against the CPU bit for bit, and
    GIN's train step at the published width, which samples its subgraph
    and so lays it out anew each step; with ``parent`` (--parent) the
    parent's step from the same parameters, its first loss against this
    one's and its p50 in turns with this one's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.graphs.containers import round_up
    from repro_torch.graphs.sampler import sample_subgraph
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (
        build_cell,
        gnn_cell_config,
        gnn_cell_dims,
    )
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import GraphNodeStream

    arch = get_arch("gin-tu")
    spec = arch.shapes["minibatch_lg"]
    if cut > 1:
        spec = dict(spec, n=spec["n"] // cut, m=spec["m"] // cut)
        arch = dataclasses.replace(arch, shapes={"minibatch_lg": spec})
    dims = gnn_cell_dims(spec)
    n_real, n = dims["n_real"], dims["n"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indptr, indices = minibatch_csr(torch, n_real, n, spec["m"],
                                    round_up(spec["m"], 8192), seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    b = GraphNodeStream(n_nodes=n_real, batch=spec["batch"],
                        seed=seed).batch_at(0, device="cuda")
    bc = GraphNodeStream(n_nodes=n_real, batch=spec["batch"],
                         seed=seed).batch_at(0, device="cpu")
    require(torch.equal(b["seeds"].cpu(), bc["seeds"]),
            "gnn minibatch: GraphNodeStream's seeds differ on the card")
    ops.reset_launch_counts()
    s, r = sample_subgraph(indptr, indices, b["seeds"], b["key"],
                           spec["fanout"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    sc, rc = sample_subgraph(indptr.cpu(), indices.cpu(), bc["seeds"],
                             bc["key"], spec["fanout"])
    require(torch.equal(s.cpu(), sc) and torch.equal(r.cpu(), rc),
            "gnn minibatch: sample_subgraph on the card differs from the "
            "CPU's on the same CSR and key")
    require(counts["threefry_randint"] == len(spec["fanout"]),
            f"gnn minibatch: sampling launches {counts}")
    print(f"[gnn] (c) minibatch_lg: CSR of {spec['m']} RMAT edges over "
          f"{n_real} nodes generated and sorted on the card in {gen_s:.2f} "
          f"s (indices {indices.numel() * 4} bytes); GraphNodeStream seeds "
          f"and sample_subgraph ({s.shape[0]} edges, fanout "
          f"{spec['fanout']}) equal the CPU's bit for bit; "
          f"threefry_randint launches {counts['threefry_randint']}")
    cell = build_cell(arch, "minibatch_lg")
    cfg = gnn_cell_config(arch, "minibatch_lg")
    x = _gnn_data(torch, "gin-tu", cfg, dims, spec["d_feat"],
                  spec["n_classes"], seed, True)
    feats = {"feats": x["feats"]}
    model = _gnn_model(torch, "gin-tu", cfg, seed)
    state = optim.init_adam(model.params())

    def step(model, state):
        return cell.fn(model, state, feats, indptr, indices, b["seeds"],
                       x["targets"], b["key"])

    vs = ""
    if parent is not None:
        pmodel, pstate, pcell, _ = _gnn_parent_cell(torch, parent, arch,
                                                    "minibatch_lg", model)

        def pstep(m, st):
            return pcell.fn(m, st, feats, indptr, indices, b["seeds"],
                            x["targets"], b["key"])
        _, pstate, pinfo0 = pstep(pmodel, pstate)
    _, _, info0 = step(model, state)  # warm
    if parent is not None:
        require(torch.equal(pinfo0["loss"], info0["loss"]), f"gnn "
                f"minibatch: the first step's loss {float(info0['loss'])!r} "
                f"is not the parent's {float(pinfo0['loss'])!r} bit for bit")
        turns = _steps_p50(torch, {
            "parent": lambda: pstep(pmodel, pstate),
            "change": lambda: step(model, state)}, GNN_MINIBATCH_STEPS)
        vs = (f"; parent -> change in turns (parent, change, change, parent, "
              f"{GNN_MINIBATCH_STEPS} steps each, sampling included): p50 "
              f"{turns['parent'][0]:.4f} -> {turns['change'][0]:.4f} s "
              f"({turns['parent'][0] / turns['change'][0]:.2f}x; parent "
              f"{json.dumps(turns['parent'][1])}, change "
              f"{json.dumps(turns['change'][1])}"
              f"); the first step's loss equal to the parent's bit for bit")
        del pmodel, pstate, pstep, pcell
    ops.reset_launch_counts()
    with _SegmentRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, info = step(model, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(counts["segment_sum"] > 0 and counts["gather_sum"] > 0
            and bool(torch.isfinite(info["loss"])),
            f"gnn minibatch: launches {counts}, loss {info['loss']}")
    records += [("gnn minibatch_lg", e, c) for e, c in rec.calls]
    _gnn_repeat(torch, "(c) minibatch_lg gin-tu", model, state, step)
    print(f"[gnn] (c) minibatch_lg gin-tu at {spec['d_feat']} features, "
          f"{spec['n_classes']} classes (features {x['feats'].numel() * 4} "
          f"bytes): a train step with its sampling {wall:.4f} s, loss "
          f"{float(info['loss']):.6f}; launches {json.dumps(counts)}{vs}; "
          f"card {card}")


def _gnn_parent_cell(torch, parent, arch, shape: str, model) -> tuple:
    """The parent checkout's (--parent) GIN cell of ``shape`` with a copy
    of ``model``'s parameters and fresh AdamW moments: ``(model, state,
    cell, the parent's kernels.ops)``. The parent's cell takes this
    checkout's arch (the parent's registry loads this checkout's
    configs)."""
    import importlib

    from repro_torch.legacy import optim
    name = parent.__name__
    psteps = importlib.import_module(f"{name}.launch.steps")
    pgnn = importlib.import_module(f"{name}.legacy.models.gnn")
    poptim = importlib.import_module(f"{name}.legacy.optim")
    pops = importlib.import_module(f"{name}.kernels.ops")
    params = model.params()
    pmodel = pgnn.GNN(model.cfg, optim.tree_unflatten(
        params, [x.detach().clone() for x in optim.tree_leaves(params)]))
    return (pmodel, poptim.init_adam(pmodel.params()),
            psteps.build_cell(arch, shape), pops)


def _steps_p50(torch, steps: dict, n: int) -> dict:
    """``{name: (p50, [wall of each step])}``: ``n`` steps of each of
    ``steps`` (name -> a no-argument step); of several, in turns, forth and
    back (2 n steps each)."""
    import numpy as np
    walls = {k: [] for k in steps}
    turns = list(steps) + list(steps)[::-1] if len(steps) > 1 else steps
    for k in turns:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[k]()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    return {k: (float(np.median(w)), w) for k, w in walls.items()}


def _step_peak(torch, fn) -> tuple:
    """``(peak bytes above what was allocated before, fn's result)``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def _gnn_ogb(torch, seed: int, records: list, card: str,
             small: bool, parent=None) -> dict:
    """(d) ogb_products: each arch's train step at the published size (GIN
    through its cell), or cut by GNN_OGB_CUT; step p50, edges/s, peak,
    a profiled step's split, the same bits twice. GIN's launches of both
    segment kernels asserted and no index_select gather in its trace; with
    ``parent`` (--parent) the parent's GIN step from the same parameters,
    its first loss against this one's, its peak, its p50 in turns and its
    trace. Returns each arch's launches a step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segments import Segments
    from repro_torch.launch.steps import (
        build_cell,
        gnn_cell_config,
        gnn_train_step,
        OPT,
    )
    from repro_torch.legacy import optim

    full = get_arch("gin-tu").shapes["ogb_products"]
    launches = {}
    # GIN last: its recorded calls are held until (e)
    for name in sorted(GNN_ARCHS, key=lambda a: a == "gin-tu"):
        arch = get_arch(name)
        cut = GNN_OGB_CUT[name] * (64 if small else 1)
        spec, dims = _gnn_dims(full, cut)
        cfg = gnn_cell_config(arch, "ogb_products")
        if name in GNN_OGB_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=GNN_OGB_LAYERS[name])
        torch.cuda.empty_cache()
        Segments.clear_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0, r0 = gnn_rmat(torch, spec["n"], spec["m"], seed)
        s = _gnn_padded(torch, s0, dims["m_pad"], dims["n"])
        r = _gnn_padded(torch, r0, dims["m_pad"], dims["n"])
        del s0, r0
        x = _gnn_data(torch, name, cfg, dims, spec["d_feat"],
                      spec["n_classes"], seed, True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        model = _gnn_model(torch, name, cfg, seed)
        state = optim.init_adam(model.params())
        gin = cut == 1 and name == "gin-tu"
        feats = {k: v for k, v in x.items() if k != "targets"}
        if gin:
            cell = build_cell(arch, "ogb_products")

            def step(model, state):
                return cell.fn(model, state, feats, s, r, x["targets"])
        else:
            loss_fn = _gnn_loss_fn(torch, name, cfg, x, s, r,
                                   n_real=dims["n_real"])

            def step(model, state):
                return gnn_train_step(model, state, loss_fn, OPT)
        pgin = None
        if gin and parent is not None:
            pmodel, pstate, pcell, pops = _gnn_parent_cell(
                torch, parent, arch, "ogb_products", model)

            def pstep(m, st):
                return pcell.fn(m, st, feats, s, r, x["targets"])
            pgin = pmodel, pstate, pstep, pops
        t0 = time.perf_counter()
        _, state, info0 = step(model, state)  # the first: sorts, warms
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        ops.reset_launch_counts()
        peak, (_, state, info) = _step_peak(torch, lambda: step(model, state))
        counts = ops.launch_counts()
        if gin and not small:  # the calls kept for (e), recorded apart
            with _SegmentRecorder(lambda e, i: i in GNN_OGB_CALLS[e]) as rec:
                step(model, state)
            records += [("gnn ogb_products", e, c) for e, c in rec.calls]
        require(counts["segment_sum"] > 0 and bool(
            torch.isfinite(info["loss"])), f"gnn ogb_products {name}: "
            f"launches {counts}, loss {info['loss']}")
        if name == "gin-tu":
            # the degree; each layer's aggregation, and each layer's
            # gradient but the first's (the features take none)
            require(counts["segment_sum"] == 1 and
                    counts["gather_sum"] == 2 * cfg.n_layers - 1,
                    f"gnn ogb_products gin-tu: launches a step {counts}")
        else:
            require(counts["gather_sum"] == 0, f"gnn ogb_products {name}: "
                    f"gather_sum launched ({counts})")
        launches[name] = {k: counts[k] for k in ("segment_sum",
                                                  "gather_sum")}
        vs = ""
        if pgin is not None:
            pmodel, pstate, pstep, pops = pgin
            _, pstate, pinfo0 = pstep(pmodel, pstate)
            ppeak, (_, pstate, _) = _step_peak(
                torch, lambda: pstep(pmodel, pstate))
            same = bool(torch.equal(pinfo0["loss"], info0["loss"])
                        and torch.equal(pinfo0["grad_norm"],
                                        info0["grad_norm"]))
            require(same, f"gnn ogb_products gin-tu: the first step's loss "
                    f"{float(info0['loss'])!r} and grad norm "
                    f"{float(info0['grad_norm'])!r} are not the parent's "
                    f"({float(pinfo0['loss'])!r}, "
                    f"{float(pinfo0['grad_norm'])!r}) bit for bit")
            turns = _steps_p50(torch, {
                "parent": lambda: pstep(pmodel, pstate),
                "change": lambda: step(model, state)}, GNN_TIMED_STEPS)
            p50, walls = turns["change"]
            pprof = _gnn_profile(torch, "(d) ogb_products gin-tu parent",
                                 lambda: pstep(pmodel, pstate), pops)
            vs = (f"; parent -> change in turns (parent, change, change, "
                  f"parent, {GNN_TIMED_STEPS} steps each): p50 "
                  f"{turns['parent'][0]:.4f} -> {p50:.4f} s "
                  f"({turns['parent'][0] / p50:.2f}x), peak {ppeak} -> "
                  f"{peak} bytes, traced busy {pprof['busy'] / 1e3:.4f} s, "
                  f"index_select gather launches {pprof['index_launches']} "
                  f"(the change's below); first step's loss and grad norm "
                  f"equal to the parent's bit for bit")
            del pmodel, pstate, pstep, pgin, pcell
        else:
            p50, walls = _steps_p50(torch, {"change": lambda: step(
                model, state)}, GNN_TIMED_STEPS)["change"]
        n_layers = cfg.n_layers
        prof = _gnn_profile(torch, f"(d) ogb_products {name}",
                            lambda: step(model, state), ops)
        if name == "gin-tu":
            require(prof["index_launches"] == 0, f"gnn ogb_products gin-tu: "
                    f"{prof['index_launches']} index_select gathers traced")
        _gnn_repeat(torch, f"(d) ogb_products {name}", model, state, step)
        cut_note = ("uncut" if cut == 1 else
                    f"nodes and edges / {cut}: n {spec['n']}, m {spec['m']}")
        cut_note += f"; depth {n_layers}"
        print(f"[gnn] (d) ogb_products {name} ({cut_note}; "
              f"{dims['m_pad']} edge slots, n + 1 = {dims['n'] + 1}; dtype "
              f"{getattr(cfg, 'dtype', 'float32')}, remat {cfg.remat}): "
              f"graph and inputs on the card in {gen_s:.2f} s; first step "
              f"(sorts the edges) {first:.4f} s; {len(walls)} timed "
              f"steps p50 {p50:.4f} s (min {min(walls):.4f}, max "
              f"{max(walls):.4f}), {dims['m_pad'] * n_layers / p50:.4e} "
              f"edges x layers / s; peak above the graph, inputs and state "
              f"{peak} bytes; loss {float(info['loss']):.6f}; launches a "
              f"step {json.dumps(counts)}{vs}; card {card}")
        del model, state, x, s, r, step, prof, feats
        Segments.clear_cache()
    torch.cuda.empty_cache()
    return launches


def _segment_within_bound(torch, tag: str, got, vals, ids, offsets,
                          counts, ref) -> float:
    """``got`` against ``ref`` in float64, 8 columns at a time, within the
    float32 reordering bound (``counts`` x 2^-24 x the row's sum of |x|,
    and one rounding to bfloat16); the largest error."""
    worst = 0.0
    for c0 in range(0, got.shape[1], 8):
        v = vals[:, c0: c0 + 8].double()
        want = ref(v, ids, offsets)
        bound = counts * 2.0 ** -24 * ref(v.abs(), ids, offsets)
        if vals.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -8 * want.abs()
        err = (got[:, c0: c0 + 8].double() - want).abs()
        require(bool((err <= bound + 1e-30).all()), f"{tag}: past the "
                f"reordering bound by {float((err - bound).max())}")
        worst = max(worst, float(err.max()))
        del v, want, bound, err
    return worst


def _live_csr(torch, ids, offsets, rows_x: int, dtype):
    """gather_sum's function as a sparse (R, rows_x) CSR of its live
    positions, ones of ``dtype`` (duplicates kept: torch.sparse.mm adds
    them)."""
    live = ids >= 0
    cum = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=ids.device)
    cum[1:] = torch.cumsum(live, 0)
    col = ids[live].long()
    return torch.sparse_csr_tensor(
        cum[offsets.long()], col,
        torch.ones(col.shape[0], dtype=dtype, device=ids.device),
        size=(offsets.shape[0] - 1, rows_x))


def _segment_run(torch, entry: str, run: str, calls: list, pseg) -> dict:
    """One recorded run of ``entry``: every call against the plain version
    and twice (gather_sum's also against the three-op path: its messages,
    index_select by the edges' ids and where, summed by segment_sum over
    the layout, the same bits), the calls' time back to back (with the
    parent's ``pseg`` in turns: its segment_sum, or for gather_sum its
    three-op path), the plain version's, one library call's and both bytes
    bounds."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment.ref import (
        gather_sum_ref,
        segment_sum_ref,
    )

    gather = entry == "gather_sum"
    kernel = ops.KERNELS[entry]
    ref = gather_sum_ref if gather else segment_sum_ref
    worst, nbytes, nbytes_once, live_adds = 0.0, 0, 0, 0
    msgs, firsts = [], []
    for vals, ids, offsets, kw, order in calls:
        got = kernel(vals, ids, offsets, **kw)
        require(torch.equal(got, kernel(vals, ids, offsets, **kw)),
                f"{entry} {run}: two launches differ")
        m = ids.shape[0]
        live = ids >= 0
        counts = segment_sum_ref(live.double()[:, None], torch.arange(
            m, device=ids.device), offsets)
        worst = max(worst, _segment_within_bound(
            torch, f"{entry} {run}", got, vals, ids, offsets, counts, ref))
        n_live = int(counts.sum())
        live_adds += n_live * vals.shape[1]
        fixed = (4 * m + 4 * offsets.numel()
                 + got.numel() * got.element_size())
        row = vals.shape[1] * vals.element_size()
        nbytes += (n_live if gather else m) * row + fixed
        nbytes_once += vals.numel() * vals.element_size() + fixed
        if gather:
            # the edges' gathered ids and mask, in the edges' own order
            e = order.long()
            eid = torch.zeros(m, dtype=torch.int32, device=ids.device)
            eid[e] = ids.clamp(min=0)
            mask = torch.zeros(m, dtype=torch.bool, device=ids.device)
            mask[e] = live
            mask = mask[:, None]
            three = ops.segment_sum(torch.where(
                mask, vals.index_select(0, eid), 0), order, offsets)
            require(torch.equal(got, three), f"gather_sum {run}: not the "
                    f"bits of index_select, where and segment_sum")
            if pseg is not None:
                require(torch.equal(got, pseg(torch.where(
                    mask, vals.index_select(0, eid), 0), order, offsets)),
                    f"gather_sum {run}: not the parent's bits")
            msgs.append((eid, mask))
            del three, e
        firsts.append(got if not firsts else None)
        del got, counts, live
    got0 = firsts[0]

    def change():
        return [kernel(v, i, o, **kw) for v, i, o, kw, _ in calls]

    def three_op(segment_sum):
        return lambda: [segment_sum(torch.where(
            mk, v.index_select(0, ei), 0), order, o) for (
                v, _, o, _, order), (ei, mk) in zip(calls, msgs)]
    turns = {"change": change}
    if pseg is not None:
        turns = {"parent": three_op(pseg) if gather else lambda: [
            pseg(v, i, o) for v, i, o, _, _ in calls], **turns}
    times = {k: [] for k in turns}
    for k in list(turns) + list(turns)[::-1] if len(turns) > 1 else turns:
        times[k].append(time_ms(torch, turns[k], iters=20))
    ms = sum(times["change"]) / len(times["change"])
    out = {"calls": len(calls), "ms": ms}
    if pseg is not None:
        out["parent_ms"] = sum(times["parent"]) / 2
    if gather:
        out["three_op_ms"] = time_ms(torch, three_op(ops.segment_sum),
                                     iters=5)
    out["plain_ms"] = time_ms(torch, lambda: [ref(v, i, o) for v, i, o, _,
                                               _ in calls], iters=5)
    if gather:
        dtype = calls[0][0].dtype
        lib = {}
        for dt in dict.fromkeys((torch.float32, dtype)):
            try:
                mats = [(_live_csr(torch, i, o, v.shape[0], dt), v.to(dt))
                        for v, i, o, _, _ in calls]
                diff = max(float((torch.sparse.mm(a, v).float() - g.float())
                                 .abs().max()) for (a, v), g in zip(
                    mats[:1], [got0]))
                lib[str(dt).split(".")[-1]] = (time_ms(
                    torch, lambda: [torch.sparse.mm(a, v) for a, v in mats],
                    iters=5), diff)
                del mats
            except RuntimeError as err:  # torch's refusal, said as it is
                lib[str(dt).split(".")[-1]] = (None, str(err)[:160])
        out["library"] = lib
        lib_ms = lib[str(dtype).split(".")[-1]][0]
        if lib_ms is None:
            lib_ms = lib["float32"][0]
        what = "torch.sparse.mm of a CSR of the live positions"
    else:
        pairs = []
        for vals, order, offsets, _, _ in calls:
            # the call's ids: a dropped entry (past offsets[-1]) on an
            # extra row, which the sum's result leaves out
            rows = offsets.shape[0] - 1
            seg = torch.full((order.shape[0],), rows, dtype=torch.int64,
                             device=order.device)
            counts = (offsets[1:] - offsets[:-1]).long()
            seg[order[: int(offsets[-1])].long()] = torch.repeat_interleave(
                torch.arange(rows, device=order.device), counts)
            pairs.append((torch.zeros((rows + 1, vals.shape[1]),
                                      dtype=vals.dtype, device=vals.device),
                          seg, vals))
        lib_ms = time_ms(torch, lambda: [z.index_add_(0, i, v)
                                         for z, i, v in pairs], iters=5)
        what = "index_add_ into a zero buffer"
        del pairs
    out["library_ms"] = lib_ms
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes_once, live_adds)
    out["bound_ms_per_position"] = bound_ms(nbytes, live_adds)[0]
    out["max_abs_err"] = worst
    shapes = sorted({(tuple(c[0].shape), str(c[0].dtype).split(".")[-1],
                      c[2].shape[0] - 1) for c in calls})
    vs = "" if pseg is None else (
        f" (parent {'three-op path' if gather else 'kernel'} "
        f"{out['parent_ms']:.4f} -> change {ms:.4f} in turns: "
        f"{out['parent_ms'] / ms:.2f}x)")
    extra = ""
    if gather:
        extra = (f" three_op_ms={out['three_op_ms']:.4f} (index_select, "
                 f"where, this segment_sum; the same bits); library "
                 f"{json.dumps(out['library'])}")
    print(f"[kernels] {entry} {run}: {len(calls)} calls, (rows of x or m, "
          f"d) dtype rows {shapes}: within the reordering bound (largest "
          f"|kernel - plain in float64| {worst:.3e}), the same bits "
          f"twice; kernel_ms={ms:.4f}{vs} plain_ms={out['plain_ms']:.4f} "
          f"library_ms={lib_ms} ({what}){extra} bound_ms="
          f"{out['bound_ms']:.4f} ({out['bound_by']}, {nbytes_once} bytes: "
          f"each input once) bound_ms_per_position="
          f"{out['bound_ms_per_position']:.4f} ({nbytes} bytes: a row a "
          f"position) kernel/bound={ms / out['bound_ms']:.2f}")
    return out


def _gnn_segment_cases(torch, records: list, parent=None) -> dict:
    """(e) segment_sum and gather_sum on every recorded call
    (_segment_run), a run at a time; with ``parent`` (--parent) the
    parent's segment_sum beside them. Returns the two kernels' rows."""
    import importlib
    pseg = None
    if parent is not None:
        pseg = importlib.import_module(
            f"{parent.__name__}.kernels.segment.kernel").segment_sum
    runs = {}
    for run, entry, call in records:
        runs.setdefault((entry, run), []).append(call)
    records.clear()
    rows = {}
    for entry in ("segment_sum", "gather_sum"):
        inputs = {}
        for run in GNN_RUNS:
            calls = runs.pop((entry, run), [])
            if calls:
                inputs[run] = _segment_run(torch, entry, run, calls, pseg)
            del calls
            torch.cuda.empty_cache()
        require(bool(inputs), f"{entry}: no call was recorded")
        run = max(inputs, key=GNN_RUNS.index)
        main = inputs[run]
        rows[entry] = {
            "name": entry, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment.cu",
            "replaces": (
                "none: not a TPU kernel (jax.ops.segment_sum, XLA, at "
                "src/repro/legacy/models/gnn.py:130)" if entry ==
                "segment_sum" else "none: not a TPU kernel (GIN's "
                "jax.ops.segment_sum(jnp.where(valid, hg[senders], 0)), "
                "XLA, at src/repro/legacy/models/gnn.py:140-141)"),
            "launches": 0, **{k: main[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "inputs": inputs, "main": run}
    return rows


def phase_gnn(torch, seed: int, card: str, results: dict,
              small: bool = False, parent=None) -> None:
    """The GNN family and NequIP on one rank: (a) card against CPU, (b)
    the molecule batch on ConnectIt's graph ids, (c) minibatch_lg, (d)
    ogb_products, (e) segment_sum and gather_sum on the recorded calls;
    with ``parent`` (--parent) the parent's GIN step and segment_sum in
    turns."""
    from repro_torch.kernels.segments import Segments

    precision = torch.get_float32_matmul_precision()
    require(precision == "highest" and
            not torch.backends.cuda.matmul.allow_tf32,
            f"float32 matmuls must run in full float32, got {precision!r}")
    records = []
    for tag, fn, args in (
            ("a smoke", _gnn_smoke, (torch, seed, records)),
            ("b molecule", _gnn_molecule, (torch, seed, records, card)),
            ("c minibatch_lg", _gnn_minibatch,
             (torch, seed, records, card, 64 if small else 1, parent))):
        t0 = time.perf_counter()
        fn(*args)
        Segments.clear_cache()
        torch.cuda.empty_cache()
        print(f"[time] gnn ({tag}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = _gnn_ogb(torch, seed, records, card, small, parent)
    print(f"[time] gnn (d ogb_products): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = _gnn_segment_cases(torch, records, parent)
    torch.cuda.empty_cache()
    print(f"[time] gnn (e segment_sum, gather_sum): "
          f"{time.perf_counter() - t0:.1f} s")
    # the main path of the phase: one ogb_products GIN train step
    for entry, row in rows.items():
        row["launches"] = launches["gin-tu"][entry]
        row["launches_per_step"] = {k: v[entry] for k, v in launches.items()}
        results[entry] = row


# ---------------------------------------------------------------------------
# gnn mesh: the GNN cells on a mesh of processes sharing the card.
# ---------------------------------------------------------------------------

GNN_MESH_WORLD = 4
GNN_MESH_SHAPE = (2, 2)
# the runs: GIN's ogb_products and ogb_products_spmd cells uncut, the other
# archs cut as in the gnn phase (GNN_OGB_CUT: four processes on one 80 GB
# card hold no more); with --ranks 4 (a rank a card) uncut but NequIP
# With --ranks 4 NequIP keeps a cut of nodes and edges: uncut, a rank's
# float32 edge messages (15.5 M edges of (32, 2l + 1)) lacked memory on an
# H100 80GB at depth 1
GNN_MESH_RANKS_CUT = {"nequip": 4}
GNN_MESH_RUNS = (("gin-tu", "ogb_products"), ("gin-tu", "ogb_products_spmd"),
                 ("pna", "ogb_products"), ("pna", "ogb_products_spmd"),
                 ("egnn", "ogb_products"), ("nequip", "ogb_products"))
# the runs' depth, by arch (widths and sizes as above; a layer's
# collectives are the run's time over gloo: at full depth GIN's uncut check
# and three steps took 42 s a run on an H100): GIN and PNA at 2, the least
# at which a gradient crosses the gather and PNA's mesh max (layer 0 reads
# the features, which take none); EGNN and NequIP at 1 (their layer 0
# reads an embedding of the inputs, which takes one)
GNN_MESH_LAYERS = {"gin-tu": 2, "pna": 2, "egnn": 1, "nequip": 1}
# against the one-rank step: bf16 runs at the card's bf16 gates (the
# largest logit's 0.05 for the loss, the largest gradient's 0.1 for every
# leaf); NequIP (float32) at the LM mesh's float32 gradient gate
GNN_MESH_F32_TOL = LM_MESH_F32_GRAD_TOL


def _gnn_mesh_case(torch, name: str, shape: str, cut: int, seed: int):
    """A run's cell dims, config, edges (whole) and inputs (whole), drawn on
    the card from the seed: the same on every rank (and for both cells of
    an arch)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import gnn_cell_config
    import dataclasses
    arch = get_arch(name)
    spec, dims = _gnn_dims(arch.shapes[shape], cut)
    cfg = dataclasses.replace(gnn_cell_config(arch, shape),
                              n_layers=GNN_MESH_LAYERS[name])
    s0, r0 = gnn_rmat(torch, spec["n"], spec["m"], seed)
    s = _gnn_padded(torch, s0, dims["m_pad"], dims["n"])
    r = _gnn_padded(torch, r0, dims["m_pad"], dims["n"])
    del s0, r0
    x = _gnn_data(torch, name, cfg, dims, spec["d_feat"], spec["n_classes"],
                  seed, True)
    return dims, cfg, s, r, x


def _gnn_mesh_cell(name: str, shape: str, cut: int, cfg, mesh=None):
    """The run's cell through ``build_cell``, on ``mesh`` or at one rank:
    the shape with its nodes and edges / ``cut`` and the published shape's
    config at the run's depth (``cfg``: bfloat16 and NequIP's remat past
    10^6 nodes of the uncut shape), forced where the cell would take its
    config from the cut sizes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    arch = get_arch(name)
    spec, _ = _gnn_dims(arch.shapes[shape], cut)
    arch = dataclasses.replace(arch, shapes={**arch.shapes, shape: spec})
    published = steps.gnn_cell_config
    steps.gnn_cell_config = lambda a, s: cfg
    try:
        return steps.build_cell(arch, shape, mesh)
    finally:
        steps.gnn_cell_config = published


def _gnn_mesh_result(torch, info, state) -> dict:
    """What a run's checked cell step is held to: its loss, gradient norm
    and first moments (the clipped gradients, scaled)."""
    from repro_torch.legacy import optim
    return {"loss": float(info["loss"]),
            "grad_norm": float(info["grad_norm"]),
            "mu": [m.detach().double().cpu()
                   for m in optim.tree_leaves(state.mu)]}


def _gnn_mesh_inputs(torch, name: str, shape: str, dims: dict, x: dict,
                     s, r) -> tuple:
    """The cell's whole inputs: ``(feats, senders, receivers, targets)``,
    or the spmd cell's ``(node input, coords, senders, receivers,
    targets)`` with int targets of n + 1 rows."""
    import torch.nn.functional as F
    if not shape.endswith("_spmd"):
        return ({k: v for k, v in x.items() if k != "targets"}, s, r,
                x["targets"])
    n1 = dims["n"] + 1
    if name == "nequip":
        return x["species"], x["coords"], s, r, x["targets"]
    coords = x.get("coords", torch.zeros(n1, 3, device=s.device))
    return x["feats"], coords, s, r, F.pad(x["targets"], (0, 1))


def phase_gnn_mesh(torch, seed: int, card: str, small: bool = False,
                   world: int = GNN_MESH_WORLD,
                   backend: str = "gloo") -> None:
    """The GNN cells on a 2 x 2 (data, model) mesh of ``world`` processes
    (GNN_MESH_RUNS), each run's first cell step held against the one-rank
    cell's step in this process where one card holds it (the loss, the
    gradient norm and every first moment), then one more cell step with
    its collectives timed: wall, the collectives' share, per-rank peak,
    launches."""
    import math
    import shutil
    import tempfile

    from repro_torch.legacy import optim

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gnn_mesh_"))
    runs = []
    try:
        for i, (name, shape) in enumerate(GNN_MESH_RUNS):
            one_card = backend == "gloo" or name == "gin-tu"
            cut = (GNN_OGB_CUT[name] if backend == "gloo" else
                   GNN_MESH_RANKS_CUT.get(name, 1)) * (64 if small else 1)
            runs.append([name, shape, cut, one_card])
            if not one_card:
                continue
            torch.cuda.empty_cache()
            dims, cfg, s, r, x = _gnn_mesh_case(torch, name, shape, cut,
                                                seed)
            args = _gnn_mesh_inputs(torch, name, shape, dims, x, s, r)
            cell = _gnn_mesh_cell(name, shape, cut, cfg)
            model = _gnn_model(torch, name, cfg, seed)
            t0 = time.perf_counter()
            _, state, info = cell.fn(model, optim.init_adam(model.params()),
                                     *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ref = _gnn_mesh_result(torch, info, state)
            torch.save(ref, tmp / f"ref{i}.pt")
            print(f"[gnn mesh] one rank in this process: {name} {shape} "
                  f"(n + 1 = {dims['n'] + 1}, {dims['m_pad']} edge slots): "
                  f"the cell's step in {wall:.3f} s (first call), loss "
                  f"{ref['loss']:.6f}, grad_norm {ref['grad_norm']:.6f}",
                  flush=True)
            del model, state, info, cell, s, r, x, args, ref
            from repro_torch.kernels.segments import Segments
            Segments.clear_cache()
        torch.cuda.empty_cache()
        (tmp / "job.json").write_text(json.dumps(
            {"gnn_mesh": True, "world": world, "backend": backend,
             "seed": seed, "runs": runs, "layers": GNN_MESH_LAYERS}))
        t0 = time.perf_counter()
        logs = _run_rank_procs(tmp, world, f"gnn mesh {backend}")
        print(f"[gnn mesh] {world} ranks over {backend}: "
              f"{time.perf_counter() - t0:.1f} s from start to exit")
        for r, log in enumerate(logs):
            for line in log.splitlines():
                if line.startswith("[gnn mesh]") and (r == 0 or "peak" in
                                                       line):
                    print(f"[gnn mesh] rank {r} of {world}:{line[10:]}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(world)]
        for i, (name, shape, cut, one_card) in enumerate(runs):
            tag = f"{name} {shape}"
            got = [x[str(i)] for x in res]
            loss_rel = max(g.get("loss rel", 0.0) for g in got)
            grad_rel = max(g.get("grad rel", 0.0) for g in got)
            bf16 = getattr(_gnn_cfg_of(name, shape), "dtype",
                           "float32") == "bfloat16"
            lt = LM_BF16_SMOKE_TOL["logits"] if bf16 else GNN_MESH_F32_TOL
            gt = LM_BF16_SMOKE_TOL["grads"] if bf16 else GNN_MESH_F32_TOL
            if one_card:
                require(loss_rel <= lt and grad_rel <= gt,
                        f"gnn mesh {tag}: the loss {loss_rel:.3e} and the "
                        f"gradient norm and first moments {grad_rel:.3e} "
                        f"from the one-rank cell step's, over {lt} / {gt}")
            require(all(math.isfinite(g["loss"]) for g in got),
                    f"gnn mesh {tag}: loss {[g['loss'] for g in got]}")
            counts = got[0]["launches"]
            if name == "gin-tu":  # the degree; the aggregations and their
                # gradients but layer 0's (the features take none)
                want = {"segment_sum": 1,
                        "gather_sum": 2 * GNN_MESH_LAYERS[name] - 1}
                require(all(g["launches"] == want for g in got),
                        f"gnn mesh {tag}: launches a step "
                        f"{[g['launches'] for g in got]}")
            else:
                require(all(g["launches"]["segment_sum"] > 0 for g in got),
                        f"gnn mesh {tag}: no segment_sum launched")
            cut_note = "uncut" if cut == 1 else f"nodes and edges / {cut}"
            vs = (f"the cell's first step: loss {loss_rel:.3e}, gradient "
                  f"norm and first moments {grad_rel:.3e} (largest over the "
                  f"ranks and leaves, each a share of the one-rank cell "
                  f"step's largest in its leaf) from the one-rank cell's "
                  f"step" if one_card else
                  "no one-rank step (it does not fit one card)")
            cut_note += f", depth {GNN_MESH_LAYERS[name]}"
            print(f"[gnn mesh] {tag} ({cut_note}) on a {GNN_MESH_SHAPE[0]} x "
                  f"{GNN_MESH_SHAPE[1]} mesh of {world} ranks over "
                  f"{backend}: {vs}; a cell step (after the checked one; the card "
                  f"synchronized around each collective) {got[0]['wall']:.4f}"
                  f" s, its {got[0]['comm calls']} collectives "
                  f"{got[0]['comm s']:.4f} s "
                  f"({got[0]['comm s'] / got[0]['wall']:.3f}); "
                  f"per-rank step peak "
                  f"{max(g['peak'] for g in got)} bytes; launches a step "
                  f"a rank {json.dumps(counts)}; loss {got[0]['loss']:.6f}; "
                  f"card {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _gnn_cfg_of(name: str, shape: str):
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import gnn_cell_config
    return gnn_cell_config(get_arch(name), shape)


def _rank_gnn_mesh(rank: int, d: Path, job: dict) -> int:
    """One rank of phase_gnn_mesh: each run's checked cell step and one
    more cell step with its collectives timed; what it measured to
    rank{rank}.json."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    from repro_torch.kernels.segments import Segments
    from repro_torch.launch import multihost
    from repro_torch.launch.shardings import local_block
    from repro_torch.legacy import optim

    globals().update(GNN_MESH_LAYERS=job["layers"])
    multihost.initialize(init_method=f"file://{d}/rendezvous",
                         num_processes=job["world"], process_id=rank,
                         backend=job["backend"], timeout=600)
    out = {}

    def blocks(cell, args, mesh):
        res = []
        for a, sh in zip(args, cell.in_shardings):
            if isinstance(a, dict):
                res.append({k: local_block(v, sh[k], mesh).clone()
                            for k, v in a.items()})
            else:
                res.append(local_block(a, sh, mesh).clone())
        return res

    case = [None]
    try:
        mesh = init_device_mesh("cuda", GNN_MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        for i, (name, shape, cut, one_card) in enumerate(job["runs"]):
            t0 = time.perf_counter()
            if case[0] != (name, cut):  # the two cells of an arch share it
                case[:] = [None]
                torch.cuda.empty_cache()
                case[:] = [(name, cut), _gnn_mesh_case(torch, name, shape,
                                                       cut, job["seed"])]
            dims, cfg, s, r, x = case[1]
            cell = _gnn_mesh_cell(name, shape, cut, cfg, mesh)
            args = blocks(cell, _gnn_mesh_inputs(torch, name, shape, dims,
                                                 x, s, r), mesh)
            del s, r, x
            model = _gnn_model(torch, name, cfg, job["seed"])
            _, state, info = cell.fn(model, optim.init_adam(model.params()),
                                     *args)
            got = _gnn_mesh_result(torch, info, state)
            rec = {"loss": got["loss"]}
            if one_card:
                ref = torch.load(d / f"ref{i}.pt")
                rec["loss rel"] = abs(rec["loss"] - ref["loss"]) / max(
                    abs(ref["loss"]), 1e-30)
                rec["grad rel"] = max(
                    abs(got["grad_norm"] - ref["grad_norm"])
                    / max(abs(ref["grad_norm"]), 1e-30),
                    *(float((g - w).abs().max())
                      / max(float(w.abs().max()), 1e-30)
                      for g, w in zip(got["mu"], ref["mu"], strict=True)))
            del got, info

            def step():
                return cell.fn(model, state, *args)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            rec["wall"], rec["comm s"], rec["comm calls"] = \
                _comm_share(torch, step)
            c = ops.launch_counts()
            rec["launches"] = {e: c[e] for e in ("segment_sum", "gather_sum")}
            rec["peak"] = torch.cuda.max_memory_allocated() - base
            out[str(i)] = rec
            print(f"[gnn mesh] {name} {shape}: {time.perf_counter() - t0:.1f}"
                  f" s on this rank; its step peak {rec['peak']} bytes",
                  flush=True)
            del model, state, args, cell, step
            Segments.clear_cache()
    finally:
        multihost.shutdown()
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--log-m", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a parent commit's src/repro_torch (git archive it "
                         "into build/): the bag cases time its bag forward "
                         "and backward too, the dlrm and train phases its "
                         "steps, and the gnn phase its GIN step and "
                         "segment_sum, in turns")
    ap.add_argument("--ranks", type=int, default=1,
                    help="N > 1: only the placements over N processes, one "
                         "rank a card over NCCL (needs N cards)")
    # one rank of a multi-process placements run, started by this script
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    parent = None
    if args.parent is not None:
        parent = load_package("repro_torch_parent", args.parent.resolve())
        parent.kernels._build.build_all(names=("embedding_bag", "segment"))
    if args.mesh_rank is not None:  # the parent's isolated cache, inherited
        try:
            return mesh_rank(args.mesh_rank, args.mesh_dir)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", flush=True)
            return 1

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    import os
    import tempfile

    from repro_torch import tune
    from repro_torch.kernels import ops

    # a tuning cache of the script's own, empty: a cache in the home
    # directory must not change the launch shapes between two runs
    cache_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cache_")
    os.environ[tune.ENV_VAR] = os.path.join(cache_dir.name, "tune.json")
    open(os.environ[tune.ENV_VAR], "w").close()
    tune.reset_default_cache()
    ops.clear_tuned_blocks()
    print(f"[cache] tuning cache {os.environ[tune.ENV_VAR]} (empty: every "
          f"kernel launches {ops.DEFAULT_BLOCK_M} threads a block outside "
          f"the tune phase)")
    try:
        device = timed("device", phase_device, torch)
        card = _card_line()
        timed("build", phase_build)
        g = timed("graph", phase_graph, torch, args.log_n, args.log_m,
                  args.seed)
        exact = (args.log_n, args.log_m, args.seed) == DEFAULT_GRAPH
        if args.ranks > 1:
            expect, _ = timed("oracle", phase_oracle, g)
            timed("ranks", phase_ranks, torch, g, expect, args.seed,
                  args.ranks, card)
            timed("cells ranks", phase_cells_ranks, torch, args.seed,
                  args.ranks, card)
            if args.ranks == LM_MESH_WORLD:
                timed("lm mesh", phase_lm_mesh, torch, args.seed, card,
                      args.ranks, "cpu:gloo,cuda:nccl")
                timed("gnn mesh", phase_gnn_mesh, torch, args.seed, card,
                      False, args.ranks, "cpu:gloo,cuda:nccl")
            else:
                print(f"[lm mesh] not run: its {LM_MESH_SHAPE[0]} x "
                      f"{LM_MESH_SHAPE[1]} mesh takes {LM_MESH_WORLD} "
                      f"ranks, not {args.ranks}")
            print(json.dumps({"ok": True, "device": device}))
            return 0
        # the DLRM phases' size cap: at the default 2^22 it cuts nothing, so
        # RM2 runs at its published widths; a short check cuts vocab,
        # batches and candidates to 2^log_n
        cap = 1 << args.log_n
        results = timed("kernels", phase_kernels, torch, g, cap, args.log_m,
                        args.seed, parent)
        timed("small", phase_small, torch)
        expect, keys = timed("oracle", phase_oracle, g)
        timed("paths", phase_paths, torch, g, expect, results, exact)
        timed("threefry", phase_threefry, torch, g, card)
        timed("forest", phase_forest, torch, g, expect, keys, exact)
        timed("stream", phase_stream, torch, g, expect, args.seed, exact,
              card)
        dyn = timed("dynamic", phase_dynamic, torch, g, expect, keys,
                    args.seed, exact, card)
        server = timed("serve", phase_serve, torch, g, args.seed, card)
        edges = timed("ingest", phase_ingest, torch, g, expect, args.seed,
                      args.log_m, exact, card)
        apps = timed("apps", phase_apps, torch, g, expect, keys, exact,
                     card)
        timed("placements", phase_placements, torch, g, expect, keys,
              args.seed, exact, card, dyn, apps)
        timed("tune", phase_tune, torch, g, expect,
              card)
        timed("cells", phase_cells, torch, g, expect, args.seed, args.log_n,
              args.log_m, exact, card)
        model, serve_inputs = timed("dlrm", phase_dlrm, torch, cap, args.seed,
                                    results, parent)
        timed("profile", phase_profile, torch, g, model, serve_inputs,
              args.seed, edges, apps["weights"], args.log_m, server)
        del model, serve_inputs  # the train phase holds ~27 GB of its own
        torch.cuda.empty_cache()
        timed("train", phase_train, torch, cap, args.seed, results, card,
              parent)
        timed("lm", phase_lm, torch, args.seed, card)
        torch.cuda.empty_cache()
        timed("lm mesh", phase_lm_mesh, torch, args.seed, card)
        torch.cuda.empty_cache()
        timed("gnn", phase_gnn, torch, args.seed, card, results,
              args.log_n < DEFAULT_GRAPH[0], parent)
        torch.cuda.empty_cache()
        timed("gnn mesh", phase_gnn_mesh, torch, args.seed, card,
              args.log_n < DEFAULT_GRAPH[0])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        cache_dir.cleanup()
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
