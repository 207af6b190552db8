#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (any failure exits non-zero; nothing is caught):

1. Card and build: the card's name and power limit (``nvidia-smi``), then
   every hand kernel built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once), with the build time and ``ptxas``
   report; then the warp-specialised and single-pass flash bodies', the
   two fp32 flash bodies' and the bf16 GEMM body's registers a thread
   and spill bytes per instantiation from that report (the script fails
   if one spills or ptxas ignored a flash body's ``setmaxnreg``).
2. Kernels: each kernel against its plain torch version on the card, at
   the executor's tile shapes (GEMM 4096x128xN, N in {128, 64, 8},
   without and with the accumulator, against torch.matmul / torch.addmm;
   GEMM rows [r0, r1) of a call bit-identical to the same rows passed
   alone, an unaligned view to its aligned copy, and acc aliasing C
   through the C entry to the wrapper's result; SpDMM n1=4096, f=128,
   w in {8, 64, 512}, strided views as the executor passes them) and at
   the ragged sweep shapes of ``tests/test_kernels.py``, fp32 tolerance
   rtol 1e-5 / atol 1e-4 (SDDMM's unmasked sweep: rtol 1e-4 / atol 1e-4,
   the JAX sweep's).  SpDMM also with a live length per row (``row_len``:
   rows of length 0, 1, w - 1 and w, pads between live slots, f in {8,
   128, 200}, strided h), bit-identical to the full-width walk and to the
   same call with acc aliasing out.  Median times of kernel, plain
   version and the PyTorch library call, and the bound (bytes over 3.35
   TB/s or flops over 67 TFLOP/s fp32, the H100 SXM data-sheet peaks).
   GEMM with bf16 x / w (the tensor-core body) on the sweep shapes and
   on shapes reaching each of its tiles within rtol 2e-2 / atol 1e-2 of
   the plain version and within K 2^-23 (|x| @ |w|) + 2^-23 |ref64| of
   the float64 result, a bf16 output (``out_dtype``) the fp32 one
   rounded (fp32 operands: the fp32 kernel's result rounded), row
   slices, second launches and unaligned copies (the staged route) bit
   for bit, the C side's TMA / staged route equal to
   ``ops.gemm_bf16_route``; timed at 4096x128x128 (strided x),
   4096x4096x128 and 4096x4096x4096 beside its bound, the plain version
   and bf16 ``torch.matmul`` (its row in the ``kernels`` line is the
   first).  SpDMM with a bf16 h (the Pallas kernel's bf16 sweep) within
   the same tolerance and bit for bit the fp32 kernel on the widened h,
   timed at the executor's tile shape beside the fp32 kernel.
3. Engine.serve path: ``Engine(device="cuda").serve`` answers b1-b8 on
   Cora (CO) and three b2 (GCN, hidden 128) requests on full-scale Flickr
   (FL, 89,250 vertices, 989,006 edges with self loops), weights random
   from seed 0.  Every output is held against the port's plain torch
   reference (``run_reference``, index_add_ / scatter_reduce) in float64
   on the card at rtol 2e-4 / atol 2e-5; the FL repeats must be cache
   hits (the third a CUDA-graph replay: the first pass stages the tiles,
   the second is the warm pass whose stats replays keep); the kernels'
   launches over the serve loop (the wrappers' plus the replays') must
   be > 0 and equal the executor's GEMM and SUM/MEAN SpDMM tile ops
   (``LAUNCHES["spdmm"]`` counts the SpDMM steps the kernel ran), and the
   SpDMM kernel's own launches (``KERNEL_LAUNCHES``) equal the plans'
   runs of steps (a run of one output tile's SpDMM steps is one launch).
   One more FL request (a cache hit) under ``torch.profiler``: device
   time by kernel (each hand kernel's sum on a line of its own) and the
   device's busy share.  Then the SpDMM kernel timed again on the
   widest real ELL slice of the FL program with the executor's
   ``row_len`` (beside the full-width walk of the same slice), which is
   the kernel's entry in the ``kernels`` line, and on that slice's whole
   row block (its output tile's step list, one launch) held to the plain
   version and bit for bit to the one-step kernel chained through acc,
   timed beside that chain, ``torch.addmm`` on the block's CSR and its
   bound: the step-list entry, whose launches are the kernel's on the
   main path.
4. Host-streaming and remap paths.  (a) b2@FL with ``residency="host"``
   on a fresh ``Engine(resident_budget_bytes=B)``, B halfway between the
   largest double-buffered shard window plus the weights (from the plan,
   before any run) and the device path's liveness-aware peak: a
   device-resident run is refused with advice to re-run with
   ``residency='host'``; ``compile(..., residency="host")`` and three runs
   (the first pins the graph's tiles in host memory), each bit-identical
   to phase 3's b2@FL#0 output and held to the float64 reference; the
   rise of ``max_memory_allocated`` stays under B; T_LoH, H2D bytes and
   rate, shards streamed, the peak staged window, per-layer wall time and
   H2D bytes; one hit under ``torch.profiler`` (busy share, and how long
   the H2D copies overlapped kernels); GEMM and SpDMM launches equal the
   executor's tile ops.  (b) b1, b3 and b6 on CO remapped with
   ``force="gemm"``, each run device-resident and host-streamed: equal
   bits, the float64 reference, ``tiles_remapped`` equal to the flipped
   steps, GEMM launches up (and SpDMM down) by exactly those steps, the
   densify kernel launched.  (c) b2@FL, one profiled hit, then
   ``Engine.remap`` with the default constants (the H100 data sheet) over its
   ``exec_profile`` densities and with ``probe=True`` (this card's
   kernels timed): decision counts, predicted gain, a device-resident
   hit's T_LoH and the float64 reference.  (d) The densify kernel on the
   widest real FL slice, bit-identical to its plain version, timed beside
   it and ``index_put_(accumulate=True)`` (its ``kernels`` entry), and
   bit for bit the plain version, twice alike, on ``densify_cases``
   (n_src 45 and 4,097, so rows start off 16-byte boundaries; duplicates
   over the kernel's quads and segments; full rows; out-of-range
   columns; the hub-heavy tile); the
   GEMM kernel at the remapped shape 4096x4096x128 (C = A.B and + acc),
   bit-identical on a copy of the densified block and to
   ``ACK.gemm_agg``, timed beside its plain version and torch.matmul /
   torch.addmm.
5. Runtime path: ``ServeLoop(OverlayPool(engines=[<the Engine above>,
   Engine()]), max_batch=4)`` with a worker thread per overlay serves 11
   requests: gat-dot (a dot-product-attention GAT, hidden 64, 2 layers)
   and b2 on FL, gat-dot on CO, in batches of 4, 4 and 3, the last run
   in a bucket of 4 lanes as JAX pads it
   (``Engine.submit_batch`` -> ``BinaryExecutor.run_batch``).  Checks:
   admission order, batch sizes, b2@FL hits on the overlay that compiled
   it, every output against the float64 reference, lane 0 of each batch
   bit-identical to the same request served alone, and launches of each
   kernel equal to bucket lanes x the pass's tile ops of its mode.  One gat-dot
   FL hit under ``torch.profiler``, and the SDDMM kernel timed on the
   widest real ELL slice of the gat-dot FL program (with its real mask
   and an accumulator), the kernel's entry in the ``kernels`` line, and
   on a synthetic hub tile of the same shape (256 rows with all 512
   slots live, the rest 25); on both, masked slots equal acc and two runs
   are equal.
6. Sampled serving: ``SamplingService`` (``repro_torch.sampling``) over
   ``OverlayPool(2 overlays)``, ``PartitionConfig(n1=256, n2=32)`` (the
   full-mode geometry of ``benchmarks/bench_sample.py``), max_batch 8, gcn
   normalization, on the full-scale synthesized Flickr graph (89,250
   vertices, 899,756 drawn edges, features of width 500 from seed 3).
   ``warm`` compiles the programs of a disjoint stream of 384 requests
   and runs each at batch sizes 1, 2, 4 and 8, twice (so the stream
   replays captured passes);
   then 64 requests (1-16 targets each from seed 0, fanouts (25, 10),
   GraphSAGE's published two-hop sizes, b1 / b3 / b6 round-robin) are
   served as graph-as-data lanes of bucket programs.  Checks: every
   response within rtol 2e-4 / atol 2e-5 of a float64 ``run_reference``
   of its own sampled subgraph; at least 8 (each model's first two and
   largest bucket, and every response of the largest bucket) bit-identical
   to the unpadded subgraph served through ``Engine.submit``; the
   program-cache hit rate after warm-up >= 0.9; GEMM and SpDMM launches
   (the wrappers' plus the replays') equal to the sum over batches of
   bucket lanes x the bucket program's tile steps; the same stream on an
   eager twin of the service (``replay=False`` overlays holding the
   programs the service compiled), every logit bit for bit the replayed
   one's.  Printed: p50
   / p99 latency, throughput, the bucket census, the mean batch size,
   ``graph_data`` H2D bytes per batch, the tile steps of each bucket
   program, and one profiled batch of 8 lanes (of each service).
7. Conformance (``repro_torch.obs``): ``build_report`` of b1-b8 on CO
   and b2@FL device-resident (per-layer CUDA-event times) and of b2@FL
   host-streamed under phase 4's budget (synchronized wall times, a
   traced and profiled hit), each program recompiled with
   ``use_cache=False`` so it carries its source: per-mode model error
   before and after calibration (calibrated <= uncalibrated checked), the
   fitted constants beside the card's name and power limit,
   ``fit_stage_bw`` (the stage spans' copy device time) within 15% of the
   copy-engine rate ``torch.profiler`` reads for the same hit, and the
   decisions of ``Engine.remap`` priced by the b2@FL report beside phase
   4's (data-sheet defaults, probe).
7b. Replays against the eager route (``Engine(replay=False)``) on the
   programs phases 3 and 5 staged: b2@FL and gat-dot@FL hits, one round
   of eager, replayed, replayed, eager, each bit for bit the first eager
   hit, launches of both routes equal to hits x tile ops (the SpDMM
   kernel's launches to hits x the plan's runs of steps), a replayed
   output against float64, one hit of each route profiled (busy share),
   and one more of each with the SpDMM kernel's device ms and launches
   (the replayed hit's launches binned by walked slots and longest row,
   from the steps the capture recorded);
   phase 5's stream on two eager overlays and on two replaying ones
   (after its warm and capturing runs), every response bit for bit, p50
   / p99 of each.
8. Live graphs (``repro_torch.livegraph``) with verification on: a
   ``GraphVersionStore`` of full-scale FL (n1=4096, n2=128, 22 blocks)
   served through ``OverlayPool(2 overlays, verify=True)``.  v0 is FL;
   v1 and v2 are content deltas of 32 removals of distinct existing pairs
   and 32 additions between existing vertices (seeds 1 and 2; a draw
   that would change the tile structure is drawn again); v3 adds 1,024
   vertices, each with one in- and one out-edge (23 blocks).  Each
   version's b2 first pass and two hits through ``Engine.submit``, held
   bit for bit to a cold compile of ``version.as_graph()`` on a second
   Engine and within rtol 2e-4 / atol 2e-5 of float64; v1 and v2 must be
   cache hits (no compile, T_LoC 0), v3 one miss; ``_Staged.uploaded`` of
   v1, v2 and v3 must equal the bytes of their patched tiles (from
   ``PatchStats.patched`` and the tiles' shapes) plus ``inv_in_degree``.
   b2 host-streamed on v0 and v1 under phase 4's budget logic, bit for
   bit to the device path, v1's pinned bytes equal to the shards that
   hold a patched tile, and ``verify.check_trace`` over a traced host hit
   of v1 (0 violations; its spans are host issue times, so it proves
   issue order only).  gat-dot on v1 (SDDMM over the version's edge ids,
   holes included), held the same way.  A cutover stream:
   ``ServeLoop(max_batch=4)``, 24 b2 requests on the live handle, cut
   over to v1 after the 8th admission and to v2 after the 16th; none
   dropped, each bit-identical to a solo serve of its pinned version,
   v0 and v1 reclaimed, and device memory falling by at least v1's
   copies no live version holds.  v3 compiled with ``GAGI_EXPORT_DIR``
   set, and ``python -m repro_torch.verify``'s ``main`` run over the
   exported bundle (exit 0).  Last, b1 on a live CO remapped with
   ``force="gemm"`` and rebound (verified) after a delta: at n1=4096 (one
   tile) one that drains the tile, so no instruction reads the aggregate
   layers' inputs; at n1=1024 one that drains one tile and adds an edge to
   another: only the patched tiles re-priced (the drained one skip), the
   binary changed only in their words, device and host runs equal, within
   the float64 tolerance (densify and GEMM kernels at n1=1024).  Every
   verification's time is printed.
9. LM serving path, qwen3-0.6b at full width (28 layers, d_model 1024, 16
   query / 8 KV heads of 128, vocab 151,936), weights random from
   ``torch.Generator`` seed 0 with the JAX initializers' scales:
   the flash kernel against its plain version (the sweep of
   ``tests/test_kernels.py`` in fp32 at atol 2e-5, its bf16 case at
   rtol / atol 3e-2, ragged causal Tq = Tk = 200, grouped KV heads with
   G = 2 and 8, and the path shape BH=64, T=2048, d=128 in fp32 and bf16
   with the prefill's 32 KV heads (G=2) and with one KV head per query
   head, timed beside the plain version and
   ``F.scaled_dot_product_attention(is_causal=True)`` (with
   ``enable_gqa=True`` for G=2 where torch takes it), a yardstick the
   port never calls; every bf16 case also within relative L2 2^-8 over
   the whole output and 2^-7 over each query row, ``check_rows``; at
   the head dims past 128 (136, 168, 170, 192, 240, 256; V d or 128
   wide) and under sliding windows 1, 5, 64, 1024 and >= T, with ragged
   T, G in {1, 2, 8} and windows that end inside a KV tile, in fp32 and
   bf16, two launches bit for bit; at gemma3-12b's prefill shape, BH=64
   over 32 KV heads, T=2048, d=240, bf16, without and with its window of
   1024, and at gemma3-27b's, BH=128 over 64 KV heads, d=168, timed
   beside the plain version and SDPA, which takes the window as a boolean
   ``attn_mask``);
   ``make_prefill_step`` in bf16 at B=4, T=2048 (a warm-up and 3 timed
   prefills, 28 flash launches each, last-position logits within
   relative L2 2e-2 of the same model run with plain attention, the
   reading of the same model with ``_sdpa_chunked`` attention beside it,
   one more prefill under ``torch.profiler``); greedy decode through
   ``launch.serve.generate`` at its defaults (8 requests, prompt 32, 16
   tokens), eager and with the serve step captured, in turns, every
   token equal, ms/token of each and one step of each profiled; fp32
   decode
   against forward at B=2, T=64 (every position within 2e-4 of max
   |logit|, the JAX test's tolerance); and the serving loop
   ``repro_torch.launch.serve.main`` at its defaults (8 requests, prompt
   32, 16 generated tokens, bf16).

10. Mesh (``mesh=``, the placement-scheduled multi-device path) on
   virtual shards of the card, ``DeviceMesh([cuda:0] * D)``: b1-b8 on CO
   at D = 2, 3 and 4, each bit for bit the device path, launches equal to
   the pass's tile ops and per-device tile ops summing to the device
   path's; b2 and gat-dot on full-scale FL at D = 4 (a mesh miss, then
   four hits in turns with four device-path hits on the same shared
   tiles, which share the shards' copies): bit for bit,
   within rtol 2e-4 / atol 2e-5 of float64, ``halo_bytes`` equal to the
   manifest's ``halo_bytes_total``, with ``halo_gather_bytes``,
   ``device_imbalance``, per-device records, per-layer gather bytes and
   the hit times beside the device path's; ``run_batch`` of 3 b2@FL lanes
   on the mesh, each lane bit for bit its solo run; a traced b2@FL hit
   through ``verify.check_trace`` (0 violations) and ``build_report``'s
   halo section; b1 on CO remapped with ``force="gemm"`` at D = 2 (densify
   and GEMM on the mesh); a live CO (n1=1024) version after a content
   delta on D = 2, a cache hit bit for bit to a cold compile.  It prints
   how many times the distinct-card path ran (0 on a one-card machine;
   with more cards, b2@FL on ``make_device_mesh(min(4, count))``).
11. granite-8b at full width (36 layers, d_model 4096, 32 query / 8 KV
   heads of 128, d_ff 14336, vocab 49,152, an untied head; 8.25 B
   parameters, bf16, random from seed 0): the flash kernel at its prefill
   shape (BH=128 over 32 KV heads, G=4, T=2048, d=128, bf16, causal) by
   ``check_rows`` against its plain version, timed beside the plain
   version, SDPA and the bound; ``make_prefill_step`` at B=4, T=2048 (a
   warm-up and 2 timed, 36 flash launches each), last-position logits
   within relative L2 2e-2 of plain attention; fp32 decode against
   forward at full width and 4 layers (B=2, T=64, 2e-4 of max |logit|);
   ``launch.serve --arch granite-8b`` with 4 requests of 16 tokens.
12. gemma3 at full width (``repro_torch.configs``; random from seed 0):
   gemma3-12b's 48 layers (40 windowed of 1024 and 8 global, d_model
   3840, 16 query / 8 KV heads of 240, vocab 262,144; 11.62 B
   parameters, 21.65 GiB of bf16) prefilled at B=4, T=2048 (a warm-up
   and 2 timed, 48 flash launches each, one more under
   ``torch.profiler``), last-position logits within relative L2 2e-2 of
   plain attention; fp32 decode against forward at 6 layers (5 windowed,
   1 global) over T = 1,088, past the window, so every local layer's
   ring buffer of 1,024 slots wraps (2e-4 of max |logit|);
   the same eager / captured decode at gemma3-12b's 48 layers (4
   requests, prompt 16, 16 tokens); ``launch.serve --arch gemma3-12b``
   with 4 requests of 16 tokens;
   gemma3-27b (d = 168) at 8 layers, its 2-layer remainder segment and a
   superblock, prefilled at 4x2048 against plain attention.
13. The train step: qwen3-0.6b at full width in bf16 (596 M parameters;
   params, fp32 master, mu and nu on the card), B=2, T=4096: the loss and
   every gradient of ``steps.value_and_grad`` through the kernel route
   (the flash kernel's forward, the chunked plain recompute backward)
   against the plain route (autograd through ``flash_attention_plain``,
   checkpointed per layer) within relative L2 2e-2, and in fp32 at 2
   layers within 1e-4; 6 steps of ``make_train_step`` on
   ``synthetic_batches`` under the config's ``remat="full"``
   (synchronized step ms, tokens/s, peak memory, every loss finite, 56
   flash launches a step: the forward runs again in the backward), one
   under ``torch.profiler``; the loss and every gradient under remat
   "full" and "dots" against "none" (bit for bit where "none" repeats
   itself bit for bit, else within max(4 x its spread, 2^-8) relative L2),
   2 timed steps of "none" and "dots" with their peak memory ("full"'s
   are the train path's), and 2 steps at
   T = 8192 under "full"; ``checkpoint.save`` / ``restore`` of the whole
   train state onto a fresh model on the card, bit for bit; and
   ``python -m repro_torch.launch.train`` at 2x4096, crashed after step
   4 (exit 42) and resumed from its own checkpoint of step 3 to step 5.
14. Cross-attention and the flash kernel's non-causal mode: the kernel
   at llama-3.2-vision's cross shape (BH=128 over 32 KV heads, G=4,
   Tq=2048, Tk=1,601, d=128) and whisper-base's encoder shape (BH=32,
   T=1,500, d=64), fp32 at atol 2e-5 and bf16 by ``check_rows``, timed
   beside the plain version, SDPA (``is_causal=False``) and the bound;
   llama-3.2-vision-11b at full width (40 layers, 8 with cross-attention
   over 1,601 vision tokens, d_model 4096, 32 / 8 heads of 128, vocab
   128,256; 10.11 B parameters, random from seed 0) prefilled in bf16 at
   B=4, T=2048 (a warm-up and 2 timed, 48 flash launches each: 40 causal,
   8 non-causal; one more under ``torch.profiler``), last-position logits
   within relative L2 2e-2 of plain attention, its eager / captured
   decode pair; fp32 decode against forward at one superblock (5 layers)
   with the cross caches filled by ``fill_cross_caches``;
   ``launch.serve --arch llama-3.2-vision-11b``.
15. whisper-base at full width (6 encoder and 6 decoder layers, d_model
   512, 8 heads of 64, vocab 51,865, tied head; 83.19 M parameters):
   ``make_prefill_step`` (encode 4 x 1,500 frames, then a bf16
   teacher-forced forward over 448 targets; 18 flash launches a forward:
   12 non-causal, 6 causal) against plain attention, ``encode`` timed
   alone, the eager / captured decode pair; fp32 decode against forward
   with the cross caches filled from ``encode``; ``launch.serve --arch
   whisper-base``.
16. The cross-attention train steps in bf16: whisper-base at full width
   (B=8, 1,500 frames, 448 targets) and llama-3.2-vision-11b cut to one
   superblock (5 layers at full width, the last with cross-attention;
   B=2, T=2048, 1,601 vision tokens; the AdamW state of all 40 layers
   would not fit the card): step 1's loss and every gradient against the
   plain route within relative L2 2e-2, 4 steps of ``make_train_step``
   (every loss finite, flash launches twice a forward's under remat
   "full"), step ms, tokens/s, peak memory; whisper's train state saved
   and restored bit for bit.
17. hymba-1.5b at full width (32 layers, d_model 1600; 25 query heads over
   5 KV heads of 64 under a window of 2,048, beside 25 SSM heads of 64
   with state 16; d_ff 5,504, vocab 32,001; 1.31 B parameters, random
   from seed 0): the flash kernel at its prefill shape (BH=100 over 20 KV
   heads, G=5, T=2048, d=64, bf16, causal; the window masks nothing) and
   at its train shape under the window (BH=50 over 10 KV heads, T=4096),
   by ``check_rows`` against its plain version, timed beside the plain
   version, SDPA (a boolean ``attn_mask`` under the window) and the
   bound; ``make_prefill_step`` in bf16 at B=4, T=2048 (a warm-up and 2
   timed, 32 causal flash launches each, one more under
   ``torch.profiler``), and one more whose 32 flash calls are each held
   to the plain version on their own operands by ``check_rows``; the
   same weights in fp32, last-position logits within relative L2 2e-2 of
   plain attention (in bf16 the model's own rounding moves them further:
   the bf16 reading is printed beside ``_sdpa_chunked`` attention's and
   the fp32 run's, not held); one layer's SSD scan (8 chunks) and
   attention timed (synchronized wall, device busy, device events); the
   eager / captured decode pair; fp32 decode against forward at 2 layers
   over 2,304 positions (the rings of 2,048 wrap, the SSD runs 9 chunks;
   2e-4 of max |logit|); ``launch.serve --arch hymba-1.5b``; step 1's
   loss and every gradient at B=2, T=4096 against the plain route, held
   within 2e-2 in fp32 and printed in bf16; the bf16 train step at B=2,
   T=4096 under remat "full" (a warm-up and one timed step, peak memory).
18. xlstm-125m at full width (12 layers: six mLSTM / sLSTM pairs with no
   FFN; d_model 768, 4 heads, vocab 50,304, tied head; 112.78 M
   parameters): the bf16 prefill at B=4, T=2048 (a warm-up and 2 timed,
   no flash launch); the first sequence's last-position logits of the
   same weights on the card and on the CPU, within relative L2 2e-2 in
   fp32 (in bf16 printed beside the card's bf16 against fp32, not held);
   one mLSTM and one sLSTM layer timed (the sLSTM's loop of 2,048 steps,
   launched eagerly: wall, device busy, device events a step); the eager
   / captured decode pair; fp32 decode against forward at 12 layers over
   512 positions; ``launch.serve --arch xlstm-125m``; the train step at
   B=2, T=1024 under remat "full" (a warm-up and 1 timed, peak memory;
   at T=4096 a step passed 30 s), then one mLSTM layer's gradient at
   T=4096 (finite; JAX's overflows there).
19. kimi-k2-1t-a32b cut to 2 layers at full width (``first_k_dense``: one
   dense layer, then one MoE layer of 384 experts of 7168 x 2048, top-8,
   and a shared expert; 64 query heads over 8 KV heads of 112, vocab
   163,840; 19.93 B parameters, 37.13 GiB bf16, random from seed 0): the
   flash kernel at its prefill shape (BH=256 over 32 KV heads, G=8,
   T=2048, d=112, bf16, causal) by ``check_rows``, timed beside the plain
   version, SDPA (``enable_gqa=True``) and the bound; the bf16 prefill at
   B=4, T=2048 with ``moe_impl="a2a"`` over ``DeviceMesh(["cuda:0"])`` (a
   warm-up and 2 timed, 2 flash launches each, one more profiled), its
   last-position logits against plain attention printed beside
   ``_sdpa_chunked``'s (not held: bf16 rounding flips routing at random
   init), then one more prefill whose flash calls are each held to the
   plain version on their own operands, with the (token, slot)
   assignments dropped at capacity factor 1.25 and the tokens whose top-8
   expert sets differ from the plain-attention prefill's counted; the
   eager / captured decode pair (``moe_local``, 4 requests, prompt 16, 16
   tokens); ``launch.serve`` at the cut (``moe_dense``, JAX's default);
   the MoE block alone in fp32 (63 GiB, nothing else resident):
   ``moe_dense`` at 64 tokens, ``moe_a2a`` at 64 and 256 tokens of one
   sequence over four virtual entries of the card and over one, and
   ``moe_local`` at 4 tokens over four and one, each against a plain
   reference of the same function (router, JAX's capacity drops per
   shard, each kept assignment through its expert) at rtol 2e-4 / atol
   2e-5, capacity factor 4.0; the smoke config in fp32 with
   ``moe_impl="a2a"`` on four entries of the card against four CPU
   entries (forward and decode logits within relative L2 2e-2).
20. deepseek-v3-671b cut to 4 layers at full width (MLA in every layer:
   128 heads, q_lora 1536, kv_lora 512, qk 128 + 64 rope, v 128; three
   dense layers, then one MoE layer of 256 experts top-8 and a shared
   expert; vocab 129,280; 15.11 B parameters, 28.15 GiB bf16): the flash
   kernel as MLA calls it (BH=512, G=1, T=2048, d=192, V 128 wide, bf16,
   causal) and as it called it before V took its own width (V
   zero-padded to 192; the padded output columns zero), each by
   ``check_rows``, two launches bit for bit, timed beside the plain
   version, SDPA with the 128-wide V and its own bound; the bf16 prefill at 4x2048 as kimi's (4 flash
   launches a prefill, each flash call of one more held, drops and
   routing flips counted), the decode pair, ``launch.serve`` at the cut;
   the absorbed MLA decode against the forward in fp32 at the 4 layers
   (56.3 GiB, B=2, T=64, 2e-4 of max |logit|); the smoke-width witness.
21. Distributed, on virtual entries of the card (``launch.mesh``'s
   (data, model) meshes): qwen3-0.6b's parameters at full width sharded
   and gathered on 2 x 4 by ``distributed.sharding``'s rules, bit for bit,
   each entry holding the bytes ``launch.dryrun`` reckons; two ZeRO-1
   train steps (``distributed.zero``) at 2x4096 bf16 under remat "full"
   with the AdamW state on 4 x 1 and on 2 x 4 (the layer stack split over
   the data rows), bit for bit ``make_train_step``'s two steps (loss,
   parameters, mu, nu, master, step), timed against them with the peak
   memory; the 28 layers as a 4-stage GPipe pipeline
   (``distributed.pipeline``) over 8 microbatches of 1x2048 bf16, bit for
   bit the per-microbatch layer loop, timed against it, bubble 3 / 11; the
   distinct-card branch (a toy pipeline over the first 4 cards) wherever
   there is more than one card, its runs counted (0 on one card).
22. Dry-run: ``launch.dryrun.analyze_cell`` of qwen3-0.6b's train step at
   2x4096 on a 1 x 1 mesh of the card (traced on ``meta``) against a real
   run: its argument bytes equal to the bytes of the parameters, AdamW
   state and batch on the card and within 0.1% of the allocation's
   growth, its predicted peak within 25% of ``max_memory_allocated``, its
   traced flops equal to ``FlopCounterMode`` on the card plus the flash
   kernel's formula, its roofline against the measured step; then
   ``launch.dryrun`` (a subprocess started with phase 17, which sees no
   card) on qwen3-0.6b, granite-8b and kimi-k2-1t-a32b at train_4k on the
   16 x 16 mesh: per-device GiB, the three roofline terms, the dominant
   one (its artifacts in ``artifacts/dryrun_torch/``).
23. The port's last contracts against the Pallas functions: the six
   ``examples/torch_*.py`` (the user entry points: quickstart, serve_gnn,
   compiler_tour, minibatch_serve, trace_inference, and
   lm_pretrain_smoke on qwen3-0.6b, the flash route) in subprocesses
   started together, each exit code checked and each one's kernel
   launches read back; meanwhile flash past d = 256 (the single-pass
   bodies, in one CTA up to d = 576 with dv <= 512 and in thread-block
   clusters past it) at d in {257, 264, 320, 512, 1024}, fp32 and bf16,
   at (d, dv) in {(330, 100), (385, 256), (513, 512), (576, 512), (576,
   256)} in both and {(576, 513), (577, 512)} in fp32, and in clusters
   at ``CONTRACT_CL`` in both (C = 2 and 3), causal, non-causal at
   ragged Tq / Tk, windowed and grouped (G = 4), and at
   ``CONTRACT_CL_WIDE`` (C = 8 and past the 8-CTA reach) in the
   non-causal and windowed modes, against the plain version (fp32 rtol 1e-5 / atol 1e-4, bf16
   ``check_rows``), the single-pass bodies', the bf16 body's at d = 128
   and the fp32 body's staged routes (bases 2 or 4 bytes past 16) bit
   for bit their TMA or 16-byte-copy routes, two launches bit for bit at
   d = 512, and
   ``out_dtype`` fp32 -> bf16 and bf16 -> fp32 on
   flash (d 128, 512, 1024), SpDMM and SDDMM at rtol 2e-2 / atol 1e-2
   (the bf16 store bit for bit the fp32 result rounded, bf16 SDDMM
   operands bit for bit the fp32 kernel on the widened operands); then
   six timed flash rows at T = 2048, causal, each its body and its
   cluster size named (the C entry ``flash_attention_body`` held to
   ``ops.flash_body``; past one CTA the clusters resident at once,
   ``cudaOccupancyMaxActiveClusters``), driven
   from zero launches, two launches bit for bit, held to the plain
   version and timed beside its bound, the plain version and
   ``F.scaled_dot_product_attention`` with the backend it dispatched to
   (with grouped KV heads also on the heads repeated G times, since
   ``enable_gqa`` can leave SDPA only its math backend):
   the single-pass body at d = 512 (BH = 32, bf16) and at the
   absorbed-MLA shape (BH = 128 over one KV head, d = 576, dv = 512,
   bf16; on no path), the fp32 body at qwen3-0.6b's prefill shape (BH =
   64 over 32, d = 128) and the fp32 single-pass body at d = 512 (BH =
   32), and both single-pass bodies in clusters of two at d = dv = 1,024
   (BH = 32).  The FL-slice entries of phases 3 and 5 also time
   SpDMM's bf16 store and SDDMM's bf16 store and bf16 operands, each
   beside the one PyTorch call of the same function where PyTorch takes
   it (``torch.addmm`` with a bf16 ``out``, ``torch.sparse.sampled_addmm``
   with a bf16 ``out`` or bf16 operands; where it refuses, the error is
   printed and ``library_ms`` is null); bf16 SDDMM operands run both
   routes there (8-byte loads, and rows one element off for the scalar
   route), each bit for bit the fp32 kernel on the widened operands with
   an fp32 and a bf16 store, the scalar route timed beside the vector
   one (``sddmm_bf16_routes``).  The build's nvcc report gives the
   densify kernel's and every SDDMM instantiation's registers and spills
   (``sparse_nvcc_check``; a spill fails).

``launches`` in the ``kernels`` line is a kernel's count over the driven
paths, through its wrapper (``kernels.ops.LAUNCHES``; a CUDA-graph
replay launches the captured kernels without one, and is counted apart,
in ``ops.REPLAYED``, which the logs print beside it) (the Engine.serve
path, the replay phase's hits, the host and remap runs of phase 4, the
runtime path, the sampled stream, the reported runs of phase 7, the live
path's runs of phase 8 (cold-compile comparisons excluded), the prefill
and forward runs of phase 9, the mesh runs of phase 10 (device-path
comparisons excluded), the prefill and forward runs of phases 11 and
12, the 6 train steps of phase 13, the prefill, forward and train
runs of phases 14-17, the prefill runs of phase 19, the prefill and
fp32 forward runs of phase 20, the ZeRO-1 steps and the pipeline of
phase 21, the real train steps of phase 22 and the six examples of
phase 23, read back from their processes),
each counted from zero just before the path runs and read just after.
For SpDMM that count is of the tile steps the kernel ran
(``LAUNCHES["spdmm"]``, equal to the executor's tile ops); the step-list
entry's ``launches`` is the kernel's own launches on the main path
(``ops.KERNEL_LAUNCHES``: a run of an output tile's steps is one launch,
two with its hub pass).
The script also tallies its own flash calls on the card by the body
``ops.flash_body`` names (``FLASH_TALLY``, the examples' in their
processes), apart for the driven paths, for their timed or profiled
repeats and for the kernel checks and timed rows, and prints them per
body before the last lines, after one line for each of the eight path
shapes of the bf16 body at d <= 128 (qwen3-0.6b's, granite-8b's,
hymba-1.5b's and kimi-k2's prefill, whisper-base's encoder,
llama-3.2-vision's cross layers, the qwen3-0.6b and hymba-1.5b train
shapes, each timed in its phase): its body, the kernel's time, SDPA's and
the bound.

Kernel times are device times: each trial queues a spin kernel first, so
the host enqueues 20 back-to-back calls while the device is busy, and a
CUDA event pair around them is divided by 20 (median of 5 trials).

The flash kernel also has an entry of its own at each of the two shapes
phases 19 and 20 give it, with the launches at that shape, and one for
each timed row of phase 23; SpDMM's bf16 store and SDDMM's bf16 store
and bf16 operands on the FL slice have one each, and so has GEMM's bf16
body at 4096x128x128 (bf16 ``torch.matmul`` its library call).  Those
eight count the one call each makes right before its timing.

The last lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  TF32 is off throughout
(``torch.backends.cuda.matmul.allow_tf32 = False``), so every fp32 product
here, the plain versions' included, is IEEE fp32.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12        # H100 SXM fp32, CUDA cores
PEAK_BF16_FLOP_S = 989e12       # H100 SXM bf16 tensor cores, dense
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
PATH_RTOL, PATH_ATOL = 2e-4, 2e-5

GEMM_SWEEP = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
              (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258)]
SPDMM_SWEEP = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
               (32, 64, 32, 8), (8, 8, 8, 8)]
# SpDMM with a live length per row: (n1, w, n_src, f).
SPDMM_ROW_LEN = [(64, 16, 50, 8), (100, 96, 70, 128), (128, 33, 100, 200),
                 (4096, 512, 4096, 128)]
SDDMM_SWEEP = [(128, 16, 128, 128), (64, 8, 96, 256), (56, 24, 70, 33),
               (8, 8, 8, 8)]
SDDMM_RTOL, SDDMM_ATOL = 1e-4, 1e-4
# tests/test_kernels.py's flash sweep: (tq, tk, heads, d, causal).
FLASH_SHAPES = [(128, 128, 2, 64, True), (256, 256, 4, 32, True),
                (128, 256, 1, 64, False), (256, 128, 2, 128, True)]
FLASH_ATOL = 2e-5                # the JAX sweep's fp32 tolerance
FLASH_BF16_TOL = 3e-2            # its bf16 case's rtol and atol
# bf16 flash outputs are also held at limits scaled to bf16 rounding (unit
# roundoff u = 2^-8): relative L2 over the whole output <= u and over each
# query row <= 2u.  Both sides round the output to bf16 (each within
# half an ulp) and the kernel also rounds P to bf16 for the tensor cores,
# so a right kernel reads about u/2 whole; a dropped KV tile or a 1%
# error in the score scale reads several u.
BF16_U = 2.0 ** -8
FLASH_BF16_WHOLE, FLASH_BF16_ROW = BF16_U, 2 * BF16_U
LM_ARCH, LM_B, LM_T = "qwen3-0.6b", 4, 2048
LM_REL_L2 = 2e-2                 # bf16 prefill against plain attention
DECODE_B, DECODE_T, DECODE_TOL = 2, 64, 2e-4
# The bf16 flash bodies' kernel names begin so (flash_bf16_ws_kernel up
# to d = 256, flash_bf16_sp_kernel and flash_bf16_wide_kernel past it).
FLASH_BF16 = "flash_bf16_"
# Kernel names of the hand kernels, as the profiler reports them.
HAND_KERNELS = ("gemm_f32_kernel", "spdmm_", "sddmm_f32_kernel",
                "flash_", "ell_densify_kernel")


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class FlashTally:
    """The script's own count of ``ops.flash_attention`` calls on the
    card, by the body ``ops.flash_body`` names, in three buckets: "paths"
    (the driven paths, their warm-up and comparison runs included),
    "timing" (the repeated calls of a timed or profiled path run) and
    "checks" (a kernel held to its plain version, a timed kernel row).
    ``install`` wraps the wrapper once; ``attention_as`` and the models
    see the wrapped one."""

    def __init__(self):
        self.counts = {"paths": {}, "timing": {}, "checks": {}}
        self.bucket = "paths"

    def install(self, ops):
        real = ops.flash_attention

        def counted(q, k, v, *args, **kwargs):
            if q.device.type == "cuda":
                try:
                    body = ops.flash_body(q.dtype, q.shape[-1], v.shape[-1])
                except (TypeError, ValueError):
                    body = "refused"
                got = self.counts[self.bucket]
                got[body] = got.get(body, 0) + 1
            return real(q, k, v, *args, **kwargs)
        ops.flash_attention = counted

    @contextlib.contextmanager
    def into(self, bucket):
        """Count into ``bucket`` while open; a path's timing inside a
        kernel check stays a check."""
        prev = self.bucket
        if not (bucket == "timing" and prev == "checks"):
            self.bucket = bucket
        try:
            yield
        finally:
            self.bucket = prev


FLASH_TALLY = FlashTally()


def tallied_as(bucket):
    """``fn``'s flash calls count into ``bucket`` of ``FLASH_TALLY``."""
    def wrap(fn):
        def wrapped(*args, **kwargs):
            with FLASH_TALLY.into(bucket):
                return fn(*args, **kwargs)
        wrapped.__name__, wrapped.__doc__ = fn.__name__, fn.__doc__
        return wrapped
    return wrap


def bound_ms(nbytes: float, flops: float, peak_flop_s=PEAK_FP32_FLOP_S):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / peak_flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


@tallied_as("timing")
def median_ms(torch, fn, reps: int = 5, launches: int = 20) -> float:
    """Device time of one ``fn()`` call: the median over ``reps`` trials of
    (event pair around ``launches`` back-to-back calls) / ``launches``.
    Each trial first queues a ~10 ms spin kernel, so the host enqueues
    the calls while the device is busy and the pair times the device
    work, not the host's launch path."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / launches)
    return statistics.median(per)


def check_close(torch, name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if bool((err > lim).any()):
        fail(f"{name}: max |err| {float(err.max()):.3e} exceeds "
             f"atol {atol} + rtol {rtol} * |want|")
    return float(err.max()) if err.numel() else 0.0


def rows_rel(got, want):
    """(relative L2 of ``got - want`` over the whole output, the largest
    over one row (the last dim)); inf where ``got`` is not finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = got - want
    return (float(err.norm() / want.norm()),
            float((err.norm(dim=-1)
                   / want.norm(dim=-1).clamp_min(1e-30)).max()))


def check_rows(torch, name, got, want, whole=FLASH_BF16_WHOLE,
               row=FLASH_BF16_ROW):
    """``rows_rel`` within ``whole`` and ``row``, else fail.  Unlike an
    elementwise atol, the limit follows the rows' own scale, which in
    causal attention falls with the row's position.  Returns (whole,
    worst row)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    r_whole, r_row = rows_rel(got, want)
    if not (r_whole <= whole and r_row <= row):
        fail(f"{name}: relative L2 {r_whole:.3e} whole (limit {whole:.3e}),"
             f" {r_row:.3e} worst row (limit {row:.3e})")
    return r_whole, r_row


WS_KERNEL = "flash_bf16_ws_kernel"       # the warp-specialised flash body
WS_INSTANTIATIONS = 6                   # (DQK, DV): (64, 64), (128,
                                        # 128), (192, 128 / 192), (256,
                                        # 128 / 256)
SP_KERNEL = "flash_bf16_sp_kernel"      # the single-pass body past d = 256
SP_INSTANTIATIONS = 6                   # (DQK, DV, MODE): one CTA (512,
                                        # 256 / 512, 0), (576, 512, 0); a
                                        # cluster (512, 256 / 512, 1), Q in
                                        # rounds (512, 512, 2)


def nvcc_rows(report: str, key_of) -> dict:
    """Registers a thread and spill bytes per kernel instantiation in an
    ``nvcc -Xptxas -v`` report, keyed by ``key_of(line)`` on a line that
    names an entry function (None: not one of the kernels read)."""
    rows, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            cur = key_of(ln)
            if cur:
                rows.setdefault(cur, {})
        elif cur and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            rows[cur].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        elif cur and re.search(r"Used \d+ registers", ln):
            rows[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return rows


def ws_nvcc_report(report: str, kernel: str = WS_KERNEL) -> dict:
    """A setmaxnreg flash body's lines (``kernel``: the warp-specialised or
    the single-pass one) of an ``nvcc -Xptxas -v`` report: per
    instantiation "DQK=.. DV=.." its registers a thread at entry (before
    ``setmaxnreg``) and spill bytes; and every ptxas warning that names
    ``setmaxnreg`` or ``wgmma`` (C7508: setmaxnreg ignored), and every
    ptxas line that says wgmma instructions are serialized (a wait after
    each product) in a function of ``kernel``."""
    def key_of(ln):
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?", ln)
        if not m:
            return None
        mode = f" MODE={m.group(3)}" if m.group(3) else ""
        return f"DQK={m.group(1)} DV={m.group(2)}{mode}"
    rows = nvcc_rows(report, key_of)
    warns = [ln.strip() for ln in report.splitlines()
             if ("warning" in ln.lower() and ("setmaxnreg" in ln
                                              or "wgmma" in ln
                                              or "C7508" in ln))
             or ("serialized" in ln and kernel in ln)]
    return {"instantiations": rows, "warnings": warns}


def ws_nvcc_check(report: str, kernel: str = WS_KERNEL,
                  count: int = WS_INSTANTIATIONS) -> dict:
    """Print a setmaxnreg flash body's registers and spills (``kernel``,
    ``count`` instantiations) from the flash build's report; fail if an
    instantiation spills, is missing, or ptxas ignored its
    ``setmaxnreg`` or serialized its wgmma.  A cached build (no report)
    is said so and not checked."""
    if report.strip() == "cached":
        log(f"nvcc {kernel}: cached build, no report in this run")
        return {"cached": True}
    got = ws_nvcc_report(report, kernel)
    for key, r in sorted(got["instantiations"].items()):
        log(f"nvcc {kernel} {key}: {r.get('registers')} registers a "
            f"thread at entry (setmaxnreg: producer 40 / 24, consumers 232 "
            f"/ 160 at two / three consumer warpgroups), "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
    for w in got["warnings"]:
        log(f"nvcc {kernel} warning: {w}")
    if len(got["instantiations"]) != count:
        fail(f"{kernel}: {len(got['instantiations'])} instantiations in "
             f"the nvcc report, expected {count}")
    if any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
           for r in got["instantiations"].values()):
        fail(f"{kernel} spills: {got['instantiations']}")
    if any("setmaxnreg" in w or "C7508" in w for w in got["warnings"]):
        fail(f"{kernel}: ptxas ignored setmaxnreg: {got['warnings']}")
    if any("serialized" in w for w in got["warnings"]):
        fail(f"{kernel}: ptxas serialized its wgmma: {got['warnings']}")
    return got


F32_KERNEL = re.compile(r"(flash_f32_(?:sp_)?kernel)I(\w*?)EEv")
F32_INSTANTIATIONS = 14                 # (DQK, DV) of the fp32 body: (32,
                                        # 32), (64, 64), (128, 128), (256,
                                        # 128 / 256); and the single pass in
                                        # one CTA and in a cluster; each
                                        # with both output types


def f32_nvcc_check(report: str) -> dict:
    """Print the fp32 flash bodies' registers a thread and spill bytes
    per instantiation (``flash_f32_kernel<DQK, DV, out>``,
    ``flash_f32_sp_kernel<out, cluster>``) from the flash build's nvcc
    report; fail if one spills or is missing.  A cached build (no report)
    is said so and not checked."""
    if report.strip() == "cached":
        log("nvcc fp32 flash bodies: cached build, no report in this run")
        return {"cached": True}
    def key_of(ln):
        m = F32_KERNEL.search(ln)
        if not m:
            return None
        args = re.findall(r"Li(\d+)E", m.group(2))
        args.append("bf16" if "bfloat16" in m.group(2) else "fp32")
        args += ["cluster" for b in re.findall(r"Lb(\d)E", m.group(2))
                 if b == "1"]
        return f"{m.group(1)}<{', '.join(args)}>"
    rows = nvcc_rows(report, key_of)
    for key, r in sorted(rows.items()):
        log(f"nvcc {key}: {r.get('registers')} registers a thread, "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
    if len(rows) != F32_INSTANTIATIONS:
        fail(f"fp32 flash bodies: {len(rows)} instantiations in the nvcc "
             f"report, expected {F32_INSTANTIATIONS}")
    if any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
           for r in rows.values()):
        fail(f"fp32 flash bodies spill: {rows}")
    return rows


# --------------------------------------------------------------------------- #
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def kernel_phase(torch, ops, ref):
    """Hold both kernels against their plain versions; returns the GEMM
    entry of the kernels line (its path shape)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    # Ragged sweep shapes (correctness only).
    for m, k, n in GEMM_SWEEP:
        x, w, acc = randn(m, k), randn(k, n), randn(m, n)
        check_close(torch, f"gemm {m}x{k}x{n}", ops.gemm(x, w, acc),
                    acc + ref.gemm_ref(x, w), KERNEL_RTOL, KERNEL_ATOL)
    for n1, w, ns, f in SPDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        vals = randn(n1, w) * (torch.rand(n1, w, generator=gen,
                                          device="cuda") > 0.4)
        h = randn(ns, f)
        check_close(torch, f"spdmm {n1}x{w} ns={ns} f={f}",
                    ops.spdmm(cols, vals, h), ref.spdmm_ref(cols, vals, h),
                    KERNEL_RTOL, KERNEL_ATOL)
    spdmm_row_len_cases(torch, ops, ref, gen)
    zero = ops.spdmm(torch.zeros(16, 8, dtype=torch.int32, device="cuda"),
                     torch.zeros(16, 8, device="cuda"), randn(16, 16))
    torch.cuda.synchronize()
    if float(zero.abs().max()) != 0.0:
        fail("spdmm: zero padding is not inert")
    for n1, w, ns, f in SDDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        hd, hs = randn(n1, 2 * f)[:, f:], randn(ns, f)
        check_close(torch, f"sddmm {n1}x{w} ns={ns} f={f}",
                    ops.sddmm(hd, hs, cols), ref.sddmm_ref(hd, hs, cols),
                    SDDMM_RTOL, SDDMM_ATOL)
    log("kernels: ragged sweeps within tolerance "
        f"({len(GEMM_SWEEP)} gemm, {len(SPDMM_SWEEP)} + "
        f"{len(SPDMM_ROW_LEN)} spdmm, {len(SDDMM_SWEEP)} sddmm shapes)")

    # GEMM at the executor's tile shape: a [4096, 128] sub-fiber view of a
    # padded [4096, 512] layer tensor times a [128, 128] weight block view,
    # in both forms the executor issues: the first K step of an output
    # tile (C = A.B, the kernels-line entry, against torch.matmul) and the
    # later ones (C = acc + A.B, against torch.addmm); then the narrower
    # widths N = 64 and 8 (the n2 that choose_partition picks for feature
    # widths under 128; the paths driven here all have n2 = 128).
    m, k = 4096, 128
    gemm_entry = None
    for n in (128, 64, 8):
        h_full, w_full = randn(m, 4 * k), randn(4 * k, 2 * n)
        x, w = h_full[:, k:2 * k], w_full[k:2 * k, n:2 * n]
        acc = randn(m, n)
        for with_acc in (False, True):
            a = acc if with_acc else None
            want = ref.gemm_ref(x, w) + (acc if with_acc else 0.0)
            err = check_close(torch, f"gemm path shape N={n}",
                              ops.gemm(x, w, a), want, KERNEL_RTOL,
                              KERNEL_ATOL)
            t_k = median_ms(torch, lambda: ops.gemm(x, w, a))
            if with_acc:
                t_p = median_ms(torch, lambda: acc + ref.gemm_ref(x, w))
                t_l = median_ms(torch, lambda: torch.addmm(acc, x, w))
                lib = "torch.addmm"
            else:
                t_p = median_ms(torch, lambda: ref.gemm_ref(x, w))
                t_l = median_ms(torch, lambda: torch.matmul(x, w))
                lib = "torch.matmul"
            nbytes = 4 * (m * k + k * n + (2 if with_acc else 1) * m * n)
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k)
            log(f"kernel gemm {m}x{k}x{n} (strided views"
                f"{', +acc' if with_acc else ''}): kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, {lib} {t_l:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
            if gemm_entry is None:
                gemm_entry = {
                    "name": "gemm", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/gemm.cu",
                    "replaces": "src/repro/kernels/gemm.py:38",
                    "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l}
    gemm_bits_cases(torch, ops, randn)
    gemm_entry["bf16"] = bf16_kernel_cases(torch, ops, ref, gen, randn)

    # SpDMM at the executor's tile shape, synthetic ELL tiles of width w
    # (60% of slots carry an edge, the rest are pad slots: cols 0, vals 0).
    n1, f = 4096, 128
    h_full = randn(n1, 4 * f)
    h = h_full[:, f:2 * f]
    for w in (8, 64, 512):
        live = torch.rand(n1, w, generator=gen, device="cuda") > 0.4
        cols = torch.where(live, torch.randint(0, n1, (n1, w), generator=gen,
                                               device="cuda"),
                           0).to(torch.int32).contiguous()
        vals = torch.where(live, randn(n1, w), 0.0).contiguous()
        acc = randn(n1, f)
        err = check_close(torch, f"spdmm path shape w={w}",
                          ops.spdmm(cols, vals, h, acc),
                          acc + ref.spdmm_ref(cols, vals, h),
                          KERNEL_RTOL, KERNEL_ATOL)
        sp, hc = _ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
        t_k = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc))
        t_p = median_ms(torch, lambda: acc + ref.spdmm_ref(cols, vals, h))
        t_l = median_ms(torch, lambda: torch.sparse.mm(sp, hc))
        b_ms, b_by = _spdmm_bound(n1, w, n1, f, int(live.sum()))
        log(f"kernel spdmm n1={n1} w={w} f={f} (strided h, +acc): "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.sparse.mm "
            f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max|err| {err:.2e}")
    return gemm_entry


BF16_RTOL, BF16_ATOL = 2e-2, 1e-2   # tests/test_kernels.py's bf16 sweeps
# The bf16 GEMM body sums bf16 products (exact in fp32) on the tensor cores
# into an fp32 accumulator, k-steps of 16 in order: against the float64
# result ref64 = acc + x @ w each element is held to K u (|x| @ |w|) + u
# |ref64| with u = 2^-23, one fp32 ulp's relative error on each of the K
# additions' partial sums and on the final acc addition.
F32_U = 2.0 ** -23
# Shapes past the JAX sweep, ragged in M, N and K: the first short-K tile
# (64 x 64, a ring of 4) with more k-stages (4) than the sweep gives it,
# then the bf16 body's other tiles (K > 256: 64 x 64 in a ring of 8 at N
# <= 128, 128 x 128 at N <= 1024, 128 x 256 past it).
GEMM_BF16_TILES = [(130, 200, 100), (130, 300, 100), (300, 600, 300),
                   (129, 333, 1100), (200, 1000, 2000)]
# The bf16 body's timed shapes: the executor's tile (x a strided sub-fiber
# view), the remapped aggregate (dense [4096, 4096] @ a strided [4096,
# 128] view) and a square product at the tensor cores' rate.
GEMM_BF16_TIMED = [(4096, 128, 128), (4096, 4096, 128), (4096, 4096, 4096)]
GEMM_BF16_KERNEL = "gemm_bf16_kernel"
GEMM_BF16_INSTANTIATIONS = 8            # 4 tiles x (TMA, staged)


def gemm_f64_excess(torch, x, w, acc, got) -> float:
    """The largest ``|got - ref64| - (K u (|x| @ |w|) + u |ref64|)`` over
    the elements (``F32_U``): <= 0 where the bound holds."""
    x64, w64 = x.double(), w.double()
    want = x64 @ w64 + (0.0 if acc is None else acc.double())
    lim = x.shape[1] * F32_U * (x64.abs() @ w64.abs()) + F32_U * want.abs()
    return float(((got.double() - want).abs() - lim).max())


def unaligned_copy(torch, t):
    """The same values in a view whose rows start one element past an
    aligned buffer's (row stride one element longer than a row)."""
    buf = torch.empty(t.shape[0], t.shape[1] + 1, dtype=t.dtype,
                      device=t.device)
    view = buf[:, 1:]
    view.copy_(t)
    return view


def gemm_bf16_check(torch, ops, ref, randn) -> dict:
    """The bf16 GEMM check: bf16 x (a strided view) and w on the JAX sweep
    and ``GEMM_BF16_TILES`` within rtol 2e-2 / atol 1e-2 of the plain
    version and within the float64 bound (``gemm_f64_excess``); the bf16
    output the fp32 one rounded; fp32 operands with a bf16 output the fp32
    kernel's result rounded; a contiguous copy (TMA where it qualifies) and
    an unaligned copy (the staged route) of the operands the same bits.
    Then the path shape (4096 x 128 x 128, strided x, +acc): the float64
    bound, rows [37, 1001) alone, a second launch and an unaligned copy
    bit for bit.  Fails at the first miss; returns the worst readings."""
    bf = torch.bfloat16
    worst = {"max_abs_err": 0.0, "f64_excess": -math.inf}
    for m, k, n in GEMM_SWEEP + GEMM_BF16_TILES:
        x, w = randn(m, 2 * k).to(bf)[:, k:], randn(k, n).to(bf)
        acc = randn(m, n)
        name = f"gemm bf16 {m}x{k}x{n}"
        got = ops.gemm(x, w, acc)
        err = check_close(torch, name, got, acc + ref.gemm_ref(x, w),
                          BF16_RTOL, BF16_ATOL)
        over = gemm_f64_excess(torch, x, w, acc, got)
        if over > 0:
            fail(f"{name}: {over:.3e} past the float64 bound")
        worst = {"max_abs_err": max(worst["max_abs_err"], err),
                 "f64_excess": max(worst["f64_excess"], over)}
        if not torch.equal(ops.gemm(x, w, acc, out_dtype=bf), got.to(bf)):
            fail(f"{name}: the bf16 output is not the fp32 one rounded")
        x32, w32 = x.float(), w.float()
        if not torch.equal(ops.gemm(x32, w32, acc, out_dtype=bf),
                           ops.gemm(x32, w32, acc).to(bf)):
            fail(f"{name}: fp32 operands' bf16 output is not the fp32 "
                 "kernel's result rounded")
        if not torch.equal(ops.gemm(x.contiguous(), w.contiguous(), acc),
                           got):
            fail(f"{name}: contiguous operands give other bits")
        if not torch.equal(ops.gemm(unaligned_copy(torch, x),
                                    unaligned_copy(torch, w), acc), got):
            fail(f"{name}: unaligned operands (the staged route) give "
                 "other bits")
    m, k, n, r0, r1 = 4096, 128, 128, 37, 1001
    x, w = randn(m, 4 * k).to(bf)[:, k:2 * k], randn(k, n).to(bf)
    acc = randn(m, n)
    full = ops.gemm(x, w, acc)
    check_close(torch, "gemm bf16 path shape +acc", full,
                acc + ref.gemm_ref(x, w), BF16_RTOL, BF16_ATOL)
    over = gemm_f64_excess(torch, x, w, acc, full)
    if over > 0:
        fail(f"gemm bf16 path shape: {over:.3e} past the float64 bound")
    if not torch.equal(full[r0:r1], ops.gemm(x[r0:r1], w, acc[r0:r1])):
        fail(f"gemm bf16 path shape: rows [{r0}, {r1}) differ from the "
             "same rows of the whole call")
    if not torch.equal(full, ops.gemm(x, w, acc)):
        fail("gemm bf16 path shape: a second launch gives other bits")
    if not torch.equal(full, ops.gemm(unaligned_copy(torch, x),
                                      unaligned_copy(torch, w), acc)):
        fail("gemm bf16 path shape: the staged route gives other bits")
    worst["f64_excess_path"] = over
    return worst


SDDMM_KERNEL = re.compile(r"sddmm_f32_kernelILb([01])E(\w+?)EEv")
SDDMM_INSTANTIATIONS = 8     # (vector, h type, out type): both routes of
                             # fp32 / bf16 operands and fp32 / bf16 stores


def sddmm_nvcc_key(ln: str):
    """``sddmm_f32_kernel<route, h type, out type>`` for an nvcc report
    line that names an instantiation of the SDDMM body, else None."""
    m = SDDMM_KERNEL.search(ln)
    if not m:
        return None
    bf = "13__nv_bfloat16"
    h = "bf16" if m.group(2).startswith(bf) else "fp32"
    rest = m.group(2)[len(bf) if h == "bf16" else 1:]
    vec = "vector" if m.group(1) == "1" else "scalar"
    out = "fp32" if rest == "f" else "bf16"
    return f"sddmm_f32_kernel<{vec}, {h}, {out}>"


def sparse_nvcc_check(gemm_report: str, sddmm_report: str) -> dict:
    """Print the densify kernel's and the SDDMM body's registers and spill
    bytes (``sddmm_f32_kernel<VEC, T, OutT>``, each instantiation) from
    the gemm and sddmm builds' nvcc reports; fail if one spills or is
    missing.  A cached build (no report) is said so and not checked."""
    rows = {}
    for report, key_of, count in (
            (gemm_report, lambda ln: "ell_densify_kernel"
             if "ell_densify_kernel" in ln else None, 1),
            (sddmm_report, sddmm_nvcc_key, SDDMM_INSTANTIATIONS)):
        if report.strip() == "cached":
            log("nvcc densify / sddmm: cached build, no report in this run")
            continue
        got = nvcc_rows(report, key_of)
        for key, r in sorted(got.items()):
            log(f"nvcc {key}: {r.get('registers')} registers a thread, "
                f"{r.get('spill_stores')} bytes spill stores, "
                f"{r.get('spill_loads')} bytes spill loads")
        if len(got) != count:
            fail(f"{len(got)} instantiations of {sorted(got)} in the nvcc "
                 f"report, expected {count}")
        if any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
               for r in got.values()):
            fail(f"densify / sddmm spills: {got}")
        rows.update(got)
    return rows


def gemm_bf16_nvcc_check(report: str) -> dict:
    """Print the bf16 GEMM body's registers and spills per instantiation
    ("NWG=.. BN=.. STAGES=.. TMA=..") from the gemm build's ``nvcc -Xptxas
    -v`` report; fail if one spills or is missing.  A cached build (no
    report) is said so and not checked."""
    if report.strip() == "cached":
        log(f"nvcc {GEMM_BF16_KERNEL}: cached build, no report in this run")
        return {"cached": True}
    rows, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            mt = re.search(GEMM_BF16_KERNEL + r"ILi(\d+)ELi(\d+)ELi(\d+)ELb"
                           r"([01])E", ln)
            cur = (f"NWG={mt.group(1)} BN={mt.group(2)} STAGES={mt.group(3)}"
                   f" TMA={mt.group(4)}") if mt else None
            if cur:
                rows.setdefault(cur, {})
        elif cur and "spill stores" in ln:
            mt = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
            rows[cur].update(spill_stores=int(mt.group(1)),
                             spill_loads=int(mt.group(2)))
        elif cur and re.search(r"Used \d+ registers", ln):
            rows[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    for key, r in sorted(rows.items()):
        log(f"nvcc {GEMM_BF16_KERNEL} {key}: {r.get('registers')} registers"
            f" a thread, {r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
    if len(rows) != GEMM_BF16_INSTANTIATIONS:
        fail(f"{GEMM_BF16_KERNEL}: {len(rows)} instantiations in the nvcc "
             f"report, expected {GEMM_BF16_INSTANTIATIONS}")
    if any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
           for r in rows.values()):
        fail(f"{GEMM_BF16_KERNEL} spills: {rows}")
    return rows


def gemm_bf16_operands(torch, randn, m, k, n):
    """bf16 operands of a timed shape (``GEMM_BF16_TIMED``): x a strided
    [4096, 128] sub-fiber view at K = 128, else contiguous; w a strided
    view at N = 128 (the remapped aggregate's h), else contiguous."""
    bf = torch.bfloat16
    x = (randn(m, 4 * k).to(bf)[:, k:2 * k] if k == 128
         else randn(m, k).to(bf))
    w = (randn(k, 4 * n).to(bf)[:, n:2 * n] if n == 128 and k > 128
         else randn(k, n).to(bf))
    return x, w


def bf16_kernel_cases(torch, ops, ref, gen, randn):
    """GEMM with bf16 x / w (the tensor-core body, ``gemm_bf16_check``;
    the route the C side takes held to ``ops.gemm_bf16_route``) and timed
    at ``GEMM_BF16_TIMED`` beside its bound, the plain version and bf16
    ``torch.matmul``; SpDMM with a bf16 h (the Pallas kernels' bf16
    sweeps, ``tests/test_kernels.py``) within rtol 2e-2 / atol 1e-2 of the
    plain version and bit for bit the fp32 kernel on the widened h (its
    body keeps the fp32 kernel's sum order), then timed at the executor's
    tile shape beside the plain version and the fp32 kernel.  Returns the
    readings."""
    bf = torch.bfloat16
    out = {"gemm_check": gemm_bf16_check(torch, ops, ref, randn)}
    for m, k, n in GEMM_SWEEP + GEMM_BF16_TILES + GEMM_BF16_TIMED:
        for x, w in ((randn(m, k + 1).to(bf)[:, 1:], randn(k, n).to(bf)),
                     (randn(m, k).to(bf), randn(k, n + 8).to(bf)[:, 8:])):
            plan = ops.entry("gemm_plan")(x.data_ptr(), w.data_ptr(), n, k,
                                          ops._ld(x), ops._ld(w))
            if (plan & 1) != (ops.gemm_bf16_route(x, w) == "tma"):
                fail(f"gemm bf16 {m}x{k}x{n}: the kernel's route "
                     f"({plan & 1}) is not ops.gemm_bf16_route's "
                     f"({ops.gemm_bf16_route(x, w)})")
    log(f"kernels: bf16 GEMM ({len(GEMM_SWEEP) + len(GEMM_BF16_TILES)} "
        f"shapes, fp32 and bf16 outputs) within rtol {BF16_RTOL} / atol "
        f"{BF16_ATOL} of the plain version and within K 2^-23 (|x| @ |w|) "
        "+ 2^-23 |ref64| of float64 (worst excess "
        f"{out['gemm_check']['f64_excess']:.3e}); contiguous, unaligned "
        "(staged) and row-sliced operands and second launches bit for bit;"
        " the kernel's TMA / staged route is ops.gemm_bf16_route's")
    for m, k, n in GEMM_BF16_TIMED:
        x, w = gemm_bf16_operands(torch, randn, m, k, n)
        ops.reset_launches()
        got = ops.gemm(x, w)
        n_l = ops.launch_totals()["gemm"]
        err = check_close(torch, f"gemm bf16 {m}x{k}x{n}", got,
                          ref.gemm_ref(x, w), BF16_RTOL, BF16_ATOL)
        over = gemm_f64_excess(torch, x, w, None, got)
        if over > 0:
            fail(f"gemm bf16 {m}x{k}x{n}: {over:.3e} past the float64 "
                 "bound")
        if not torch.equal(got, ops.gemm(x, w)):
            fail(f"gemm bf16 {m}x{k}x{n}: a second launch gives other bits")
        b_ms, b_by = bound_ms(2 * (m * k + k * n) + 4 * m * n,
                              2.0 * m * n * k, PEAK_BF16_FLOP_S)
        plan = ops.entry("gemm_plan")(x.data_ptr(), w.data_ptr(), n, k,
                                      ops._ld(x), ops._ld(w))
        out[f"gemm_{m}x{k}x{n}"] = {
            "route": ops.gemm_bf16_route(x, w), "tile": plan >> 1,
            "launches": n_l, "max_abs_err": err, "f64_excess": over, "bound_ms": b_ms,
            "bound_by": b_by,
            "ms": median_ms(torch, lambda: ops.gemm(x, w)),
            "plain_ms": median_ms(torch, lambda: ref.gemm_ref(x, w)),
            "torch_matmul_bf16_ms": median_ms(torch,
                                              lambda: torch.matmul(x, w))}
        if k == 128:
            xw, ww = x.float(), w.float()
            out[f"gemm_{m}x{k}x{n}"]["fp32_kernel_ms"] = median_ms(
                torch, lambda: ops.gemm(xw, ww))
        del x, w, got
    for n1, w, ns, f in SPDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        vals = randn(n1, w) * (torch.rand(n1, w, generator=gen,
                                          device="cuda") > 0.4)
        h = randn(ns, 2 * f).to(bf)[:, f:]
        name = f"spdmm bf16 h {n1}x{w} ns={ns} f={f}"
        got = ops.spdmm(cols, vals, h)
        check_close(torch, name, got, ref.spdmm_ref(cols, vals, h),
                    BF16_RTOL, BF16_ATOL)
        if not torch.equal(got, ops.spdmm(cols, vals, h.float())):
            fail(f"{name}: not the fp32 kernel's bits on the widened h")
    log(f"kernels: bf16-h SpDMM ({len(SPDMM_SWEEP)} shapes) within rtol "
        f"{BF16_RTOL} / atol {BF16_ATOL} of the plain version and bit for "
        "bit the fp32 kernel on the widened h")
    n1, wd, f = 4096, 64, 128
    live = torch.rand(n1, wd, generator=gen, device="cuda") > 0.4
    cols = torch.where(live, torch.randint(0, n1, (n1, wd), generator=gen,
                                           device="cuda"),
                       0).to(torch.int32).contiguous()
    vals = torch.where(live, randn(n1, wd), 0.0).contiguous()
    h = randn(n1, 4 * f).to(bf)[:, f:2 * f]
    hw = h.float()
    err = check_close(torch, "spdmm bf16 path shape", ops.spdmm(cols, vals, h),
                      ref.spdmm_ref(cols, vals, h), BF16_RTOL, BF16_ATOL)
    out["spdmm_4096_w64_f128"] = {
        "max_abs_err": err,
        "ms": median_ms(torch, lambda: ops.spdmm(cols, vals, h)),
        "fp32_kernel_ms": median_ms(torch, lambda: ops.spdmm(cols, vals, hw)),
        "plain_ms": median_ms(torch, lambda: ref.spdmm_ref(cols, vals, h))}
    for name, r in out.items():
        log(f"kernel {name} bf16: " + ", ".join(
            f"{k} {v:.4f}" if k.endswith("ms") else
            f"{k} {v}" if isinstance(v, (str, int)) else f"{k} {v:.2e}"
            for k, v in r.items()))
    return out


def gemm_bits_cases(torch, ops, randn):
    """GEMM results that must be bit-identical: rows [r0, r1) of a call
    against the same rows passed alone (r0 unaligned to any tile), an
    unaligned view (4-byte staging) against its aligned copy (16-byte
    staging), and acc aliasing C through the C entry point (the wrapper
    always allocates C), on the path shape and a ragged one."""
    for m, k, n, r0, r1 in ((4096, 128, 128, 37, 1001),
                            (130, 70, 258, 3, 129)):
        xf, w, acc = randn(m, k + 1), randn(k, n), randn(m, n)
        x = xf[:, 1:]                      # 4-byte aligned only
        xa = x.contiguous()
        name = f"gemm {m}x{k}x{n}"
        full = ops.gemm(xa, w, acc)
        if not torch.equal(full[r0:r1], ops.gemm(xa[r0:r1], w,
                                                 acc[r0:r1])):
            fail(f"{name}: rows [{r0}, {r1}) differ from the same rows of "
                 "the whole call")
        if not torch.equal(full, ops.gemm(x, w, acc)):
            fail(f"{name}: the unaligned view differs from its aligned copy")
        inout = acc.clone()
        rc = ops.entry("gemm")(
            xa.data_ptr(), w.data_ptr(), inout.data_ptr(), inout.data_ptr(),
            m, n, k, ops._ld(xa), ops._ld(w), ops._ld(inout),
            ops._ld(inout), ops._stream(xa))
        torch.cuda.synchronize()
        if rc != 0 or not torch.equal(inout, full):
            fail(f"{name}: acc aliasing C differs (rc {rc})")
    log("gemm: row slices, unaligned views and acc aliasing C bit-identical")


def spdmm_row_len_cases(torch, ops, ref, gen):
    """SpDMM with a live length per row: rows of length 0, 1, w - 1, w and
    random, pads between live slots (vals 0) and after the last; strided
    h, an accumulator, f in {8, 128, 200}.  Each is held against the plain
    version, is bit-identical to the walk over all w slots, and to the
    same call with acc aliasing out (through the C entry point, as the
    wrapper always allocates out)."""
    for n1, w, ns, f in SPDMM_ROW_LEN:
        lens = torch.randint(0, w + 1, (n1,), generator=gen, device="cuda")
        lens[:4] = torch.tensor([0, 1, w - 1, w], device="cuda")
        slot = torch.arange(w, device="cuda")
        live = (slot[None] < lens[:, None]) & (
            torch.rand(n1, w, generator=gen, device="cuda") > 0.3)
        live[torch.arange(n1, device="cuda"), (lens - 1).clamp_min(0)] |= \
            lens > 0
        cols = torch.where(live, torch.randint(
            0, ns, (n1, w), generator=gen, device="cuda"), 0).to(
            torch.int32).contiguous()
        vals = torch.where(live, torch.randn(n1, w, generator=gen,
                                             device="cuda"), 0.0)
        row_len = (live * (slot + 1)).amax(1).to(torch.int32).contiguous()
        if row_len[:4].tolist() != [0, 1, w - 1, w]:
            fail(f"spdmm row_len case {n1}x{w}: lengths "
                 f"{row_len[:4].tolist()}")
        h = torch.randn(ns, 2 * f + 4, generator=gen, device="cuda"
                        )[:, 4:4 + f]
        acc = torch.randn(n1, f, generator=gen, device="cuda")
        name = f"spdmm row_len {n1}x{w} ns={ns} f={f}"
        got = ops.spdmm(cols, vals, h, acc, row_len)
        check_close(torch, name, got, acc + ref.spdmm_ref(cols, vals, h),
                    KERNEL_RTOL, KERNEL_ATOL)
        if not torch.equal(got, ops.spdmm(cols, vals, h, acc)):
            fail(f"{name}: not bit-identical to the full-width walk")
        inout = acc.clone()
        rc = ops.entry("spdmm")(
            cols.data_ptr(), vals.data_ptr(), h.data_ptr(), inout.data_ptr(),
            inout.data_ptr(), row_len.data_ptr(), n1, w, f, ops._ld(h),
            ops._ld(inout), ops._ld(inout), ops._stream(h))
        torch.cuda.synchronize()
        if rc != 0 or not torch.equal(inout, got):
            fail(f"{name}: acc aliasing out differs (rc {rc})")


def _ell_to_csr(torch, cols, vals, live, n_src):
    """The true edges of an ELL tile as a CSR matrix [n1, n_src]
    (duplicate columns summed), for the library yardstick."""
    rows, slots = torch.nonzero(live, as_tuple=True)
    idx = torch.stack([rows, cols[rows, slots].long()])
    coo = torch.sparse_coo_tensor(idx, vals[rows, slots],
                                  (cols.shape[0], n_src)).coalesce()
    return coo.to_sparse_csr()


def library_call(torch, label, fn, want=None) -> dict:
    """One PyTorch call offered as a kernel's library yardstick: run once,
    and if PyTorch takes it (and its result is within rtol 2e-2 / atol
    1e-2 of ``want``, when given) timed; if it raises, the error it
    raised.  Returns {"call", "ms"} or {"call", "error"}."""
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        msg = f"{type(e).__name__}: {str(e).strip().splitlines()[0]}"
        log(f"library call {label}: PyTorch refuses it: {msg}")
        return {"call": label, "error": msg}
    if want is not None:
        got = got.values() if got.layout != torch.strided else got
        check_close(torch, f"library call {label}", got, want, 2e-2, 1e-2)
    ms = median_ms(torch, fn)
    log(f"library call {label}: {ms:.4f} ms")
    return {"call": label, "ms": ms}


def _spdmm_bound(n1, w, n_src, f, nnz, walked=None, h_bytes=4,
                 out_bytes=4):
    """Bytes: the cols + vals of the slots walked (``walked``; all n1 w
    when None, the full-width walk), row_len [n1] when given, h
    [n_src, f] (``h_bytes`` an element), acc [n1, f] (fp32) and out
    [n1, f] (``out_bytes`` an element), each once; operations: 2 flops
    per true edge and feature (pad slots are work the data does not
    need)."""
    slot_bytes = 8 * n1 * w if walked is None else 8 * walked + 4 * n1
    nbytes = (slot_bytes + h_bytes * n_src * f + 4 * n1 * f
              + out_bytes * n1 * f)
    return bound_ms(nbytes, 2.0 * nnz * f)


def _spdmm_steps_bound(n1, n_steps, walked, src_rows, f, nnz, h_bytes=4,
                       out_bytes=4):
    """A step list's bound: bytes of the walked slots' cols + vals, each
    step's row_len [n1], the ``src_rows`` rows of h the steps read
    (``h_bytes`` an element), acc [n1, f] (fp32) and out [n1, f] once;
    operations 2 flops per true edge and feature."""
    nbytes = (8 * walked + 4 * n1 * n_steps + h_bytes * src_rows * f
              + 4 * n1 * f + out_bytes * n1 * f)
    return bound_ms(nbytes, 2.0 * nnz * f)


def row_block_steps(torch, prog, j):
    """The step list the executor hands the SpDMM kernel for output row
    block j of ``prog``'s first SUM/MEAN aggregate layer (its tile's
    steps in stream order, every step a SPDMM step in a canonical
    program), with (its true edges, its walked slots, the source row
    blocks it reads)."""
    from repro_torch.core.ir import AggOp, LayerType
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    lp = next(lp for lp in prog.plan().layers
              if lp.layer_type == LayerType.AGGREGATE
              and AggOp(lp.mode) in (AggOp.SUM, AggOp.MEAN))
    tp = next(tp for tp in lp.tiles if tp.out_j == j)
    ks = tuple((ins.args[1], ins.args[3] >> 1) for ins in tp.compute)
    st = _staged(pg, torch.device("cuda"))
    steps = st.spdmm_steps(j, ks)
    nnz = sum(pg.tiles[(j, k)][s].nnz for k, s in ks)
    walked = sum(int(r.sum()) for _, _, r, _ in steps.steps)
    return steps, nnz, walked, len({k for k, _ in ks})


def plan_spdmm_runs(torch, prog) -> int:
    """SpDMM kernel launches of one device-resident pass of ``prog`` (one
    lane): per run of consecutive static-weight SPDMM steps on one source
    fiber in each SUM/MEAN aggregate tile, one launch, two when the run's
    step list (the executor's, from the staging) has hub rows; one per
    step with dynamic edge weights."""
    from repro_torch.core.ir import AggOp, LayerType
    from repro_torch.core.isa import Opcode
    from repro_torch.engine.executor import _staged
    st = _staged(prog.pgraph, torch.device("cuda"))
    launches = 0
    for lp in prog.plan().layers:
        if lp.layer_type != LayerType.AGGREGATE or AggOp(lp.mode) not in (
                AggOp.SUM, AggOp.MEAN):
            continue
        for tp in lp.tiles:
            runs, prev = [], None
            for ins in tp.compute:
                static = ins.op == Opcode.SPDMM and not ins.args[3] & 1
                ks = (ins.args[1], ins.args[3] >> 1)
                if static and prev == ins.args[2]:
                    runs[-1].append(ks)
                elif static:
                    runs.append([ks])
                elif ins.op == Opcode.SPDMM:
                    launches += 1
                prev = ins.args[2] if static else None
            launches += sum(1 + bool(st.spdmm_steps(tp.out_j, tuple(
                ks)).n_hub) for ks in runs)
    return launches


def steps_to_csr(torch, steps, n_cols):
    """The true edges of a step list as one CSR matrix [n1, n_cols] over
    the rows of h (duplicates summed), for the library yardstick."""
    rows, cols, vals = [], [], []
    for c, v, _, off in steps.steps:
        r, k = torch.nonzero(v != 0, as_tuple=True)
        rows.append(r)
        cols.append(c[r, k].long() + off)
        vals.append(v[r, k])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (steps.n1, n_cols)).coalesce()
    return coo.to_sparse_csr()


class StepLog:
    """While open, records each SpDMM kernel launch the wrappers make
    (``ops.spdmm`` and ``ops.spdmm_steps``) as (steps, walked slots,
    longest row_len), read from the staged row_len tiles of ``prog`` by
    address (no device read, so a capture may run inside); a launch on a
    tile outside them records walked / longest as None.  ``passes``
    holds one list per ``next_pass()``.  With ``lists=False`` a step-list
    call is not recorded, only the one-step calls it makes (a build that
    launches a step at a time)."""

    def __init__(self, torch, ops, prog, lists=True):
        from repro_torch.engine.executor import _staged
        st = _staged(prog.pgraph, torch.device("cuda"))
        self.ops, self.passes, self.lists = ops, [[]], lists
        self.of = {}
        for r in st.tiles("row_len").values():
            rc = r.cpu()
            self.of[r.data_ptr()] = (int(rc.sum()), int(rc.max()))

    def _note(self, row_lens, hub=None):
        got = [self.of.get(r.data_ptr()) if r is not None else None
               for r in row_lens]
        if hub is not None and hub.n_hub:       # the hub pass runs first
            self.passes[-1].append((len(got), hub.hub_walked,
                                    hub.hub_longest))
        if any(g is None for g in got):
            self.passes[-1].append((len(got), None, None))
        else:
            walked = sum(g[0] for g in got)
            if hub is not None:
                walked -= hub.hub_walked
            self.passes[-1].append((len(got), walked,
                                    max(g[1] for g in got)))

    def next_pass(self):
        self.passes.append([])

    def __enter__(self):
        ops, self.real = self.ops, (self.ops.spdmm, self.ops.spdmm_steps)
        one, many = self.real

        def spdmm(cols, vals, h, acc=None, row_len=None, *a, **k):
            self._note([row_len])
            return one(cols, vals, h, acc, row_len, *a, **k)

        def spdmm_steps(steps, h, acc=None, *a, **k):
            if self.lists:
                self._note([r for _, _, r, _ in steps.steps], steps)
            return many(steps, h, acc, *a, **k)
        ops.spdmm, ops.spdmm_steps = spdmm, spdmm_steps
        return self

    def __exit__(self, *exc):
        self.ops.spdmm, self.ops.spdmm_steps = self.real


WALKED_BINS = (1_000, 10_000, 100_000)   # walked slots of a launch
LONGEST_BINS = (8, 64, 256)              # its longest row_len


def launch_histogram(label, durations_us, descs) -> dict:
    """Per-launch device times of SpDMM kernels (``durations_us``, in
    launch order) binned by each launch's walked slots and longest row
    (``descs``: (steps, walked, longest) in the same order); prints the
    bins (launches, total ms, median us) and returns them."""
    def bin_of(v, edges):
        if v is None:
            return "unknown"
        for e in edges:
            if v < e:
                return f"< {e}"
        return f">= {edges[-1]}"
    if len(durations_us) != len(descs):
        fail(f"{label}: {len(durations_us)} SpDMM kernel events for "
             f"{len(descs)} recorded launches")
    out = {}
    for us, (n, walked, longest) in zip(durations_us, descs):
        key = (f"walked {bin_of(walked, WALKED_BINS)}, longest row "
               f"{bin_of(longest, LONGEST_BINS)}")
        out.setdefault(key, []).append((us, n))
    rows = {}
    for key in sorted(out):
        us = [u for u, _ in out[key]]
        rows[key] = {"launches": len(us), "steps": sum(n for _, n in
                                                       out[key]),
                     "ms": sum(us) / 1e3,
                     "median_us": statistics.median(us)}
        log(f"  {label}: {key}: {len(us)} launches ({rows[key]['steps']} "
            f"steps), {sum(us) / 1e3:.3f} ms, median "
            f"{statistics.median(us):.2f} us")
    log(f"  {label}: {len(durations_us)} launches, "
        f"{sum(durations_us) / 1e3:.3f} ms in all")
    return rows


def spdmm_events(torch, fn):
    """``fn()`` under torch.profiler (device activity only): the device
    durations (us) of its SpDMM kernel launches in launch order, or None
    when the profiler yields no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and "spdmm" in e.name]
    if not ev:
        return None
    ev.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in ev]


# --------------------------------------------------------------------------- #
def path_phase(torch):
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.ir import AggOp, LayerType
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    co = G.synthesize("CO").gcn_normalized()
    fl = G.synthesize("FL").gcn_normalized()
    log(f"graphs: CO |V|={co.n_vertices} |E|={co.n_edges} f={co.feat_dim}; "
        f"FL |V|={fl.n_vertices} |E|={fl.n_edges} f={fl.feat_dim} "
        f"({time.perf_counter() - t0:.2f} s)")
    reqs = [InferenceRequest(model=name, graph=co,
                             features=G.random_features(co, seed=1),
                             request_id=f"{name}@CO")
            for name in BENCHMARKS]
    reqs += [InferenceRequest(model="b2", graph=fl,
                              features=G.random_features(fl, seed=10 + i),
                              request_id=f"b2@FL#{i}")
             for i in range(3)]

    engine = Engine()                      # device="cuda", default geometry
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    exp = {"gemm": 0, "spdmm": 0, "spdmm_sum_mean": 0, "spdmm_runs": 0}
    responses, layer_times = [], []
    # ---- the main path: counts are zeroed just above, read just below.
    for req in reqs:
        resp = engine.serve([req])[0]
        st = engine.exec_stats
        modes = st.tile_ops_by_mode or {}
        exp["gemm"] += modes.get("gemm", 0)
        exp["spdmm"] += modes.get("spdmm", 0)
        prog = engine.cache.get(resp.cache_key)
        exp["spdmm_runs"] += plan_spdmm_runs(torch, prog)
        for lp in prog.plan().layers:
            if lp.layer_type == LayerType.AGGREGATE and AggOp(lp.mode) in (
                    AggOp.SUM, AggOp.MEAN):
                exp["spdmm_sum_mean"] += sum(len(tp.compute)
                                             for tp in lp.tiles)
        responses.append(resp)
        layer_times.append([(r["layer"], r["kernel"], r["tile_ops"],
                             r["wall_s"] * 1e3) for r in st.per_layer])
    launches = dict(ops.LAUNCHES)
    ran = ops.launch_totals()
    kernel_ran = ops.kernel_launch_totals()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path.
    launches["spdmm_kernel"] = kernel_ran["spdmm"]

    for req, resp, lt in zip(reqs, responses, layer_times):
        log(f"request {resp.request_id}: model {resp.model_name}, "
            f"T_LoC {resp.t_loc * 1e3:.2f} ms, T_LoH {resp.t_loh * 1e3:.2f} "
            f"ms, cache_hit {resp.cache_hit}")
        log("  per-layer CUDA-event ms: " + ", ".join(
            f"L{lid}:{k}x{n}={ms:.3f}" for lid, k, n, ms in lt))
    log(f"serve: {engine.stats.requests} requests, "
        f"{engine.stats.cache_hits} cache hits, {engine.stats.compiles} "
        f"compiles; max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"launches on the main path: gemm {launches['gemm']}, spdmm "
        f"{launches['spdmm']} through the wrappers, gemm {ran['gemm']}, "
        f"spdmm {ran['spdmm']} with the replays'; executor tile ops: gemm "
        f"{exp['gemm']}, spdmm {exp['spdmm']} (SUM/MEAN "
        f"{exp['spdmm_sum_mean']})")
    log(f"SpDMM kernel launches on the main path: {kernel_ran['spdmm']} "
        f"(with the replays') for {ran['spdmm']} steps; the plans' runs "
        f"{exp['spdmm_runs']}")
    hits = [r.t_loh * 1e3 for r in responses[-3:] if r.cache_hit]
    log("b2@FL cache hits: T_LoH " + ", ".join(f"{ms:.2f}" for ms in hits)
        + " ms")
    if [r.cache_hit for r in responses[-3:]] != [False, True, True]:
        fail("FL requests: expected one cache miss then two hits, got "
             f"{[r.cache_hit for r in responses[-3:]]}")
    if not (launches["gemm"] > 0 and launches["spdmm"] > 0):
        fail(f"a kernel was not launched on the main path: {launches}")
    if ran["gemm"] != exp["gemm"]:
        fail(f"gemm launches {ran['gemm']} != tile ops {exp['gemm']}")
    if not (ran["spdmm"] == exp["spdmm_sum_mean"] == exp["spdmm"]):
        fail(f"spdmm launches {ran['spdmm']} != SUM/MEAN tile ops "
             f"{exp['spdmm_sum_mean']} / all {exp['spdmm']}")
    if kernel_ran["spdmm"] != exp["spdmm_runs"]:
        fail(f"SpDMM kernel launches {kernel_ran['spdmm']} != the plans' "
             f"runs {exp['spdmm_runs']}")

    worst = hold_against_reference(torch, reqs, responses)
    log(f"path: {len(responses)} outputs within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of run_reference in float64 (worst max|err| "
        f"{worst:.3e})")
    profile_call(torch, lambda: engine.serve([reqs[-1]]), "b2@FL hit")
    fl_prog = engine.cache.get(responses[-1].cache_key)
    return launches, fl_prog, responses, peak, engine, co, fl


def hold_against_reference(torch, reqs, responses) -> float:
    """Every output against the port's plain reference on the card, run
    in float64 so that the reference's own rounding does not count; the
    fp32 reference's distance is printed beside it for comparison.
    Returns the worst max|err|; fails past rtol 2e-4 / atol 2e-5."""
    from repro_torch.core.gnn_builders import build
    from repro_torch.core.reference import run_reference
    worst, bad = 0.0, []
    for req, resp in zip(reqs, responses):
        g = req.graph
        model = build(req.model, g, req.seed) if isinstance(
            req.model, str) else req.model
        x = torch.as_tensor(req.features, device="cuda")
        y64 = run_reference(model, g, x, dtype=torch.float64)
        y32 = run_reference(model, g, x)
        got = resp.output.double()
        if tuple(got.shape) != (g.n_vertices, g.n_classes) or not bool(
                torch.isfinite(got).all()):
            fail(f"{resp.request_id}: output shape {tuple(got.shape)} "
                 "or non-finite values")
        err = (got - y64).abs()
        over = err > PATH_ATOL + PATH_RTOL * y64.abs()
        r = int(err.max(dim=1).values.argmax())
        indeg = int((torch.as_tensor(g.dst, device="cuda") == r).sum())
        err32 = float((y32.double() - y64).abs().max())
        log(f"  {resp.request_id}: shape {tuple(got.shape)}, max|y - "
            f"ref64| {float(err.max()):.3e} at row {r} (in-degree {indeg},"
            f" |ref64| {float(y64[r].abs().max()):.3e}), {int(over.sum())}"
            f" entries over tolerance; fp32 reference: max|ref32 - ref64| "
            f"{err32:.3e}, max|y - ref32| "
            f"{float((got - y32.double()).abs().max()):.3e}")
        worst = max(worst, float(err.max()))
        if bool(over.any()):
            bad.append(resp.request_id)
    if bad:
        fail(f"outputs outside rtol {PATH_RTOL} / atol {PATH_ATOL} of the "
             f"float64 reference: {bad}")
    return worst


def _busy_us(ivs) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


@tallied_as("timing")
def profile_call(torch, fn, label: str, split=None, out=None, cpu=True):
    """``fn()`` under torch.profiler: device time by kernel name (with
    each kernel's launches and their median and longest duration) and the
    device's busy share of the call's wall time; returns the device ms by
    kernel name.  When the profiler yields no device events it says "not
    measured" (and returns None); a profiler that raises fails the run.
    With ``split`` (a substring of event names, e.g. "HtoD") it also
    reports the busy time of the matching events, of the others, and how
    long the two overlapped.  With ``out`` (a dict) the wall and busy
    times and the busy share go there too (and the split's).  With
    ``cpu=False`` only device activity is traced: a host-bound call then
    runs (and is read back) with far less profiler overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log(f"profile {label}: no device events; device busy share not "
            "measured")
        return None
    by_name, ivs = {}, []
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        ivs.append((e.time_range.start, e.time_range.end))
    busy = _busy_us(ivs)
    log(f"profile {label}: wall {wall_us / 1e3:.2f} ms under the "
        f"profiler, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), {len(kern)} device events")
    if out is not None:
        out.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                   busy_share=busy / wall_us, events=len(kern))
    if split is not None:
        mine = [(e.time_range.start, e.time_range.end) for e in kern
                if split in e.name]
        rest = [(e.time_range.start, e.time_range.end) for e in kern
                if split not in e.name]
        a, b = _busy_us(mine), _busy_us(rest)
        both = a + b - busy
        log(f"  {split} events busy {a / 1e3:.2f} ms ({len(mine)} events), "
            f"the rest {b / 1e3:.2f} ms, both at once {both / 1e3:.2f} ms "
            f"({100 * both / max(min(a, b), 1e-9):.1f}% of the shorter)")
        if out is not None:
            out.update(split_ms=a / 1e3, rest_ms=b / 1e3,
                       overlap_ms=both / 1e3)
    total = {name: sum(us) for name, us in by_name.items()}
    hand = []
    for kern in HAND_KERNELS:
        runs = [u for name, us in by_name.items() if kern in name
                for u in us]
        if runs:
            hand.append(f"{kern} {sum(runs) / 1e3:.3f} ms x {len(runs)}")
    log("  hand kernels: " + (", ".join(hand) or "none"))
    for name, us in sorted(total.items(), key=lambda kv: -kv[1])[:10]:
        each = by_name[name]
        log(f"  {us / 1e3:9.3f} ms  {len(each):5d} x (median "
            f"{statistics.median(each):8.2f} us, max {max(each):8.2f} us)  "
            f"{name[:70]}")
    return {name: us / 1e3 for name, us in total.items()}


def fl_spdmm_entry(torch, ops, ref, prog):
    """The SpDMM kernel on the widest real ELL slice of the FL program,
    with the source view and the live lengths the executor passes it
    (timed beside the full-width walk of the same slice)."""
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, vals_d = st.tiles("cols"), st.tiles("vals")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, vals = cols_d[key], vals_d[key]
    row_len = st.tiles("row_len")[key]
    n1, w = cols.shape
    f = pg.config.n2
    nnz = pg.tiles[key[:2]][key[2]].nnz
    walked = int(row_len.sum())
    gen = torch.Generator(device="cuda").manual_seed(1)
    h_full = torch.randn(pg.n_blocks * n1, 4 * f, generator=gen,
                         device="cuda")
    k = key[1]
    h = h_full[k * n1:(k + 1) * n1, f:2 * f]
    acc = torch.randn(n1, f, generator=gen, device="cuda")
    got = ops.spdmm(cols, vals, h, acc, row_len)
    err = check_close(torch, "spdmm FL tile", got,
                      acc + ref.spdmm_ref(cols, vals, h), KERNEL_RTOL,
                      KERNEL_ATOL)
    if not torch.equal(got, ops.spdmm(cols, vals, h, acc)):
        fail("spdmm FL tile: row_len walk not bit-identical to the "
             "full-width walk")
    live = vals != 0
    sp, hc = _ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
    t_k = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc, row_len))
    t_full = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc))
    t_p = median_ms(torch, lambda: acc + ref.spdmm_ref(cols, vals, h))
    t_l = median_ms(torch, lambda: torch.sparse.mm(sp, hc))
    b_ms, b_by = _spdmm_bound(n1, w, n1, f, nnz, walked)
    b_pad, b_pad_by = _spdmm_bound(n1, w, n1, f, nnz)
    slots = sum(t.cols.size for ts in pg.tiles.values() for t in ts)
    log(f"FL program: {sum(len(ts) for ts in pg.tiles.values())} ELL "
        f"slices, {slots} padded slots for {pg.total_nnz()} edges "
        f"({slots / max(pg.total_nnz(), 1):.1f}x)")
    log(f"kernel spdmm on FL slice (j,k,s)={key} n1={n1} w={w} f={f} "
        f"nnz={nnz}, {walked} slots walked (sum of row_len): kernel "
        f"{t_k:.4f} ms (full-width walk {t_full:.4f} ms), plain "
        f"{t_p:.4f} ms, torch.sparse.mm {t_l:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; the padded slots' bound {b_pad:.4f} ms, {b_pad_by}), "
        f"L2 gather volume {walked * 4 * f / 1e6:.1f} MB, max|err| "
        f"{err:.2e}")
    # The bf16 store (out_dtype) on the same slice, fp32 and bf16 h: the
    # fp32 kernel's result rounded once, bit for bit.
    store = {}
    for tag, hh, hb in (("fp32 h", h, 4), ("bf16 h", h.bfloat16(), 2)):
        ops.reset_launches()
        got16 = ops.spdmm(cols, vals, hh, acc, row_len,
                          out_dtype=torch.bfloat16)
        n_l = ops.launch_totals()["spdmm"]
        if not torch.equal(got16, ops.spdmm(cols, vals, hh, acc,
                                            row_len).bfloat16()):
            fail(f"spdmm FL tile, {tag}, bf16 store: not the fp32 "
                 "kernel's result rounded once")
        e16 = check_close(torch, f"spdmm FL tile {tag} bf16 store", got16,
                          ref.spdmm_step_ref(cols, vals, hh, acc, row_len,
                                             torch.bfloat16), 2e-2, 1e-2)
        t16 = median_ms(torch, lambda: ops.spdmm(
            cols, vals, hh, acc, row_len, out_dtype=torch.bfloat16))
        t32 = median_ms(torch, lambda: ops.spdmm(cols, vals, hh, acc,
                                                 row_len))
        tp = median_ms(torch, lambda: ref.spdmm_step_ref(
            cols, vals, hh, acc, row_len, torch.bfloat16))
        b16, b16_by = _spdmm_bound(n1, w, n1, f, nnz, walked, hb, 2)
        # One PyTorch call for the same function: fp32 sums of the CSR
        # pattern times h, acc added, stored in bf16.
        hhc = hh.contiguous()
        out16 = torch.empty(n1, f, dtype=torch.bfloat16, device="cuda")
        lib = library_call(
            torch, f"torch.addmm(acc, csr, h, out=bf16) ({tag})",
            lambda: torch.addmm(acc, sp, hhc, out=out16))
        log(f"kernel spdmm on the FL slice, {tag}, bf16 store: kernel "
            f"{t16:.4f} ms (fp32 store {t32:.4f} ms), plain {tp:.4f} ms, "
            f"bound {b16:.4f} ms ({b16_by}), max|err| {e16:.2e}; the fp32 "
            "result rounded once, bit for bit")
        store[tag] = {"launches": n_l, "max_abs_err": e16, "ms": t16,
                      "fp32_store_ms": t32, "plain_ms": tp,
                      "bound_ms": b16, "bound_by": b16_by,
                      "library_ms": lib.get("ms"), "library": lib}
    block = fl_row_block_entry(torch, ops, ref, prog, key[0], h_full[
        :, f:2 * f], acc)
    return {"name": "spdmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spdmm.cu",
            "replaces": "src/repro/kernels/spdmm.py:44",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "full_walk_ms": t_full, "padded_bound_ms": b_pad,
            "bf16_store": store, "row_block": block}


def fl_row_block_entry(torch, ops, ref, prog, j, h, acc):
    """The SpDMM kernel on row block j's whole output tile (the widest FL
    slice's row block: the step list the executor hands it for that tile
    of the first aggregate layer) in one launch, over the strided [rows,
    f] source view ``h``: held to the plain version at the kernel
    tolerance and bit for bit to the one-step kernel chained through acc,
    timed beside that chain, the plain version, ``torch.addmm`` on the
    block's CSR and its bound."""
    steps, nnz, walked, blocks = row_block_steps(torch, prog, j)
    n1, f = steps.n1, h.shape[1]

    def chain():
        out = acc
        for c, v, r, off in steps.steps:
            out = ops.spdmm(c, v, h[off:off + n1], out, r)
        return out
    ops.reset_launches()
    got = ops.spdmm_steps(steps, h, acc)
    launched = (ops.kernel_launch_totals()["spdmm"],
                ops.launch_totals()["spdmm"])
    if launched != (1 + bool(steps.n_hub), len(steps)):
        fail(f"spdmm FL row block: {launched} kernel launches / steps, "
             f"expected ({1 + bool(steps.n_hub)}, {len(steps)})")
    want = ref.spdmm_steps_ref(steps.steps, h, acc, steps.n_src)
    err = check_close(torch, "spdmm FL row block", got, want, KERNEL_RTOL,
                      KERNEL_ATOL)
    if not torch.equal(got, chain()):
        fail("spdmm FL row block: the step list is not bit-identical to "
             "the one-step kernel chained through acc")
    t_k = median_ms(torch, lambda: ops.spdmm_steps(steps, h, acc))
    t_chain = median_ms(torch, chain)
    t_p = median_ms(torch, lambda: ref.spdmm_steps_ref(
        steps.steps, h, acc, steps.n_src), reps=3, launches=3)
    csr, hc = steps_to_csr(torch, steps, h.shape[0]), h.contiguous()
    lib = library_call(torch, "torch.addmm(acc, csr, h) (FL row block)",
                       lambda: torch.addmm(acc, csr, hc), want)
    b_ms, b_by = _spdmm_steps_bound(n1, len(steps), walked, blocks * n1, f,
                                    nnz)
    log(f"kernel spdmm step list on FL row block {j} (its output tile: "
        f"{len(steps)} steps over {blocks} source blocks, {nnz} edges, "
        f"{walked} slots walked, {steps.n_hub} hub entries walking "
        f"{steps.hub_walked}, n1={n1} f={f}): one call {t_k:.4f} ms, "
        f"the one-step kernel chained {t_chain:.4f} ms, plain {t_p:.4f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}), max|err| {err:.2e}; bit for bit "
        "the chain")
    return {"name": f"spdmm (step list: FL row block {j}, {len(steps)} "
                    f"steps in one call)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spdmm.cu",
            "replaces": "src/repro/kernels/spdmm.py:44",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib.get("ms"), "library": lib,
            "one_step_chain_ms": t_chain, "steps": len(steps), "nnz": nnz,
            "walked": walked, "hub_entries": steps.n_hub,
            "hub_walked": steps.hub_walked}


# --------------------------------------------------------------------------- #
def _resp(rid, y):
    """A response-like record for ``hold_against_reference``."""
    import types
    return types.SimpleNamespace(request_id=rid, output=y)


def host_phase(torch, engine, fl, fl_prog, fl_out):
    """b2@FL host-streamed (``residency="host"``) on a fresh Engine whose
    budget refuses the device path; see the module docstring."""
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.engine import ResidentBudgetError
    from repro_torch.engine.executor import _host_tiles
    from repro_torch.core import graph as G
    from repro_torch.kernels import ops

    x = G.random_features(fl, seed=10)
    ex = engine.executor
    window = ex.estimate_host_window_bytes(fl_prog, x.shape[1])
    weights = sum(int(w.nbytes) for w in fl_prog.weights.values())
    dev_peak = ex.estimate_device_peak_bytes(fl_prog, x.shape[1])
    if not window + weights < dev_peak:
        fail(f"host window {window} + weights {weights} is not below the "
             f"device peak {dev_peak}")
    budget = (window + weights + dev_peak) // 2
    log(f"host path b2@FL: largest double-buffered window {window} B + "
        f"weights {weights} B = {window + weights} B; device path's "
        f"liveness-aware peak {dev_peak} B; resident_budget_bytes "
        f"{budget} B")

    heng = Engine(resident_budget_bytes=budget)
    t0 = time.perf_counter()
    prog = heng.compile("b2", fl, residency="host")
    t_loc = time.perf_counter() - t0
    try:
        heng.run(prog, x, residency="device")
    except ResidentBudgetError as e:
        msg = str(e)
    else:
        fail("a device-resident b2@FL run under the budget was not refused")
    if "residency='host'" not in msg:
        fail(f"the refusal does not name residency='host': {msg}")
    log(f"device-resident run refused: {msg}")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    exp = {"gemm": 0, "spdmm": 0}
    runs = []
    # ---- the host path: counts are zeroed just above, read just below.
    for i in range(3):
        if i:
            t0 = time.perf_counter()
            prog = heng.compile("b2", fl, residency="host")
            t_loc = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = heng.run(prog, x)
        heng._sync()
        t_loh = time.perf_counter() - t0
        st = heng.exec_stats
        modes = st.tile_ops_by_mode or {}
        for k in exp:
            exp[k] += modes.get(k, 0)
        runs.append({"t_loc_s": t_loc, "t_loh_s": t_loh,
                     "h2d_bytes": st.h2d_bytes,
                     "shards_streamed": st.shards_streamed,
                     "peak_stage_bytes": st.peak_stage_bytes,
                     "layers": [(r["layer"], r["kernel"], r["tile_ops"],
                                 r["wall_s"], r["h2d_bytes"])
                                for r in st.per_layer],
                     "y": y})
    launches = dict(ops.LAUNCHES)
    rise = torch.cuda.max_memory_allocated() - base
    # ---- end of the host path.

    ht = _host_tiles(prog.pgraph, True)
    log(f"host tiles pinned once for the graph: {ht.nbytes} B "
        f"({ht.nbytes / 2**30:.3f} GiB) of host buffers")
    for i, r in enumerate(runs):
        log(f"host b2@FL#{i} ({'miss, pins the tiles' if i == 0 else 'hit'})"
            f": T_LoC {r['t_loc_s'] * 1e3:.2f} ms, T_LoH "
            f"{r['t_loh_s'] * 1e3:.2f} ms, h2d_bytes {r['h2d_bytes']}, "
            f"{r['h2d_bytes'] / r['t_loh_s'] / 1e9:.2f} GB/s over T_LoH, "
            f"shards_streamed {r['shards_streamed']}, peak_stage_bytes "
            f"{r['peak_stage_bytes']}")
        log("  per layer (host wall ms around the synchronized layer, H2D "
            "MB, GB/s): " + ", ".join(
                f"L{lid}:{k}x{n}={s * 1e3:.2f} ms/{b / 1e6:.1f} MB/"
                f"{b / max(s, 1e-9) / 1e9:.2f}"
                for lid, k, n, s, b in r["layers"]))
        if not torch.equal(r["y"], fl_out):
            fail(f"host b2@FL#{i} differs from the device path's b2@FL#0 "
                 f"by {float((r['y'] - fl_out).abs().max()):.3e}")
    if runs[0]["peak_stage_bytes"] != window:
        fail(f"peak_stage_bytes {runs[0]['peak_stage_bytes']} != the "
             f"plan's window {window}")
    log(f"host path: max_memory_allocated rose {rise} B "
        f"({rise / 2**30:.3f} GiB) over the three runs (budget {budget} B)")
    if rise > budget:
        fail(f"device memory rose {rise} B over the budget {budget} B")
    log(f"launches on the host path: gemm {launches['gemm']}, spdmm "
        f"{launches['spdmm']}; executor tile ops: {exp}")
    for k in exp:
        if not (launches[k] == exp[k] > 0):
            fail(f"host path {k} launches {launches[k]} != tile ops "
                 f"{exp[k]}")
    req = InferenceRequest(model="b2", graph=fl, features=x)
    worst = hold_against_reference(
        torch, [req] * 3, [_resp(f"host b2@FL#{i}", r["y"])
                           for i, r in enumerate(runs)])
    log(f"host path: 3 outputs bit-identical to the device path's and "
        f"within rtol {PATH_RTOL} / atol {PATH_ATOL} of the float64 "
        f"reference (worst max|err| {worst:.3e})")
    prof = {}
    profile_call(torch, lambda: (heng.run(prog, x), heng._sync()),
                 "b2@FL host hit", split="HtoD", out=prof)
    summary = {"budget": budget, "window": window, "weights": weights,
               "device_peak_estimate": dev_peak, "memory_rise": rise,
               "host_tile_bytes": ht.nbytes, "launches": launches,
               "profile": prof,
               "runs": [{k: v for k, v in r.items() if k != "y"}
                        for r in runs]}
    return launches, heng, x, summary


def remap_co_phase(torch, co):
    """b1, b3 and b6 on CO remapped with force="gemm", run device-resident
    and host-streamed: equal bits, the float64 reference, tiles_remapped
    and GEMM launches up by exactly the flipped steps."""
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    eng = Engine()
    total = {k: 0 for k in ops.LAUNCHES}
    out = []
    for name in ("b1", "b3", "b6"):
        x = G.random_features(co, seed=1)
        prog = eng.compile(name, co)
        ops.reset_launches()
        eng.run(prog, x)                    # the canonical binary
        canon = dict(ops.LAUNCHES)
        rp = eng.remap(prog, force="gemm")
        rec = rp.manifest["remap"]
        flipped = rec["remapped_ops"]
        ys = {}
        for residency in ("device", "host"):
            ops.reset_launches()
            # ---- a remapped run: counts zeroed above, read below.
            t0 = time.perf_counter()
            ys[residency] = eng.run(rp, x, residency=residency)
            eng._sync()
            t = time.perf_counter() - t0
            got = dict(ops.LAUNCHES)
            # ----
            for k in total:
                total[k] += got[k]
            st = eng.exec_stats
            log(f"remap {name}@CO force=gemm {residency}: {flipped} steps "
                f"flipped ({rec['counts']}), tiles_remapped "
                f"{st.tiles_remapped}, launches gemm {got['gemm']} (canonical"
                f" {canon['gemm']}), spdmm {got['spdmm']} (canonical "
                f"{canon['spdmm']}), densify {got['densify']}; T_LoH "
                f"{t * 1e3:.2f} ms")
            if not (st.tiles_remapped == flipped > 0):
                fail(f"{name}@CO: tiles_remapped {st.tiles_remapped} != "
                     f"flipped steps {flipped}")
            if got["gemm"] != canon["gemm"] + flipped or \
                    got["spdmm"] != canon["spdmm"] - flipped:
                fail(f"{name}@CO {residency}: GEMM launches {got['gemm']} "
                     f"!= {canon['gemm']} + {flipped} or SpDMM "
                     f"{got['spdmm']} != {canon['spdmm']} - {flipped}")
            if got["densify"] < 1:
                fail(f"{name}@CO {residency}: the densify kernel was not "
                     "launched")
        if not torch.equal(ys["device"], ys["host"]):
            fail(f"{name}@CO forced gemm: host differs from device by "
                 f"{float((ys['device'] - ys['host']).abs().max()):.3e}")
        req = InferenceRequest(model=name, graph=co, features=x)
        worst = hold_against_reference(
            torch, [req], [_resp(f"{name}@CO gemm", ys["device"])])
        out.append({"model": name, "flipped": flipped,
                    "counts": rec["counts"], "worst_err": worst})
    log("remap CO: forced-GEMM outputs bit-identical across residencies and "
        f"within rtol {PATH_RTOL} / atol {PATH_ATOL} of the reference")
    return total, out


def remap_fl_phase(torch, heng, fl, x):
    """b2@FL: one profiled hit, then remap priced by the default constants
    (the H100 data sheet) over the exec_profile densities and by probing
    this card's kernels; each run once device-resident (its T_LoH
    printed)."""
    from repro_torch.engine import InferenceRequest
    from repro_torch.kernels import ops
    heng.executor.resident_budget_bytes = None    # device-resident hits
    prog = heng.compile("b2", fl)
    heng.executor.profile_tiles = True
    heng.run(prog, x)
    heng._sync()
    heng.executor.profile_tiles = False
    t0 = time.perf_counter()
    heng.run(prog, x)
    heng._sync()
    t_canon = time.perf_counter() - t0
    log(f"remap FL: canonical b2@FL device-resident hit T_LoH "
        f"{t_canon * 1e3:.2f} ms; exec_profile kernel modes "
        f"{prog.manifest['exec_profile']['kernel_modes']}")
    total = {k: 0 for k in ops.LAUNCHES}
    out = {"canonical_t_loh_s": t_canon}
    req = InferenceRequest(model="b2", graph=fl, features=x)
    for label, kw in (("h100-default", {"source": "exec_profile"}),
                      ("probe", {"probe": True})):
        t0 = time.perf_counter()
        rp = heng.remap(prog, **kw)
        t_remap = time.perf_counter() - t0
        rec = rp.manifest["remap"]
        ops.reset_launches()
        # ---- a remapped run: counts zeroed above, read below.
        t0 = time.perf_counter()
        y = heng.run(rp, x)
        heng._sync()
        t = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        # ----
        for k in total:
            total[k] += got[k]
        st = heng.exec_stats
        log(f"remap FL {label} (source {rec['source']}, probe "
            f"{rec['probe']}, constants {rec['constants']}): counts "
            f"{rec['counts']}, predicted_gain_s {rec['predicted_gain_s']:.6e},"
            f" remap {t_remap:.2f} s; hit T_LoH {t * 1e3:.2f} ms, "
            f"tiles_remapped {st.tiles_remapped}, launches {got}")
        worst = hold_against_reference(torch, [req],
                                       [_resp(f"b2@FL {label}", y)])
        out[label] = {"counts": rec["counts"],
                      "predicted_gain_s": rec["predicted_gain_s"],
                      "remap_s": t_remap, "t_loh_s": t,
                      "tiles_remapped": st.tiles_remapped,
                      "worst_err": worst}
    return total, out


# Columns that straddle the densify kernel's quads, its lanes' quads
# (128 positions apart) and its 2,048-position segments, at every row
# alignment of an n_src off a multiple of 4; the row's ends (4,094 and
# up count back from n_src); and columns out of range.
DENSIFY_EDGE_COLS = (-1, 0, 1, 3, 4, 127, 128, 1022, 1023, 1024, 1025,
                     2047, 2048, 4094, 4095, 4096, 4097, 4100)


def densify_cases(torch, gen):
    """[(label, cols, vals, n_src)] the densify kernel is held on bit for
    bit: rows of an n_src that is not a multiple of 4 (so rows start off
    16-byte boundaries; 45 and 4,097), widths that are not multiples of
    32, rows with every slot live, duplicate-heavy rows whose columns
    fall in different quads and segments, out-of-range columns, and
    values of mixed sign and scale with zeros of either sign."""
    edges = torch.tensor(DENSIFY_EDGE_COLS, dtype=torch.int32,
                         device="cuda")

    def tile(n1, w, n_src, cols):
        vals = torch.randn(n1, w, generator=gen, device="cuda") * \
            torch.where(torch.rand(n1, w, generator=gen, device="cuda")
                        > 0.5, 1e4, 1.0)
        z = torch.rand(n1, w, generator=gen, device="cuda")
        vals = torch.where(z < 0.1, -0.0, torch.where(z < 0.2, 0.0, vals))
        return cols.to(torch.int32).contiguous(), vals.contiguous()

    out = []
    for n1, w, n_src in ((64, 37, 45), (256, 70, 4097), (128, 512, 4097),
                         (96, 33, 4096)):
        pick = torch.randint(0, edges.numel(), (n1, w), generator=gen,
                             device="cuda")
        cols = torch.where(edges[pick] >= 4094, edges[pick] - 4096 + n_src,
                           edges[pick])
        out.append((f"duplicates over quads and segments n1={n1} w={w} "
                    f"n_src={n_src}", *tile(n1, w, n_src, cols), n_src))
    cols = torch.randint(-3, 4097 + 3, (512, 45), generator=gen,
                         device="cuda")
    out.append(("spread, out-of-range columns n1=512 w=45 n_src=4097",
                *tile(512, 45, 4097, cols), 4097))
    n1, w = 4096, 512
    lens = torch.full((n1,), 25, device="cuda")
    lens[torch.randperm(n1, generator=gen, device="cuda")[:256]] = w
    live = torch.arange(w, device="cuda")[None] < lens[:, None]
    cols = torch.where(live, torch.randint(0, n1, (n1, w), generator=gen,
                                           device="cuda"), 0)
    c, v = tile(n1, w, n1, cols)
    out.append(("hub-heavy n1=4096 w=512 n_src=4096 (256 rows of 512 live "
                "slots, the rest 25)", c, torch.where(live, v, 0.0)
                .contiguous(), n1))
    return out


def densify_bound(torch, vals, n_src):
    """bound_ms of densify on this tile: every value read, a column read
    only under a live (non-zero) value, the block written once; an add a
    live slot.  Returns (ms, what binds, live slots)."""
    n1, w = vals.shape
    live = int(torch.count_nonzero(vals))
    return (*bound_ms(4 * n1 * w + 4 * live + 4 * n1 * n_src, float(live)),
            live)


def densify_same_bits(torch, ops, ref, label, cols, vals, n_src):
    """The densify kernel on one tile: bit for bit the plain version
    (signs of zero included), twice alike; returns max |err| (0)."""
    got = ops.densify(cols, vals, n_src)
    want = ref.densify_ref(cols, vals, n_src)
    err = check_close(torch, f"densify {label}", got, want, 0.0, 0.0)
    if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
            and torch.equal(ops.densify(cols, vals, n_src).view(torch.int32),
                            want.view(torch.int32))):
        fail(f"densify {label}: not bit for bit the plain version")
    return err


def remap_gemm_entry(torch, ops, ref, prog):
    """GEMM at the remapped shape, dense [4096, 4096] @ [4096, 128] with the
    block densified from the widest real FL slice (C = A.B and + acc),
    beside torch.matmul / torch.addmm; and the densify kernel on that
    slice against its plain version (bit for bit) and a library
    scatter."""
    from repro_torch.core.ack import ACK
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, vals_d = st.tiles("cols"), st.tiles("vals")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, vals = cols_d[key], vals_d[key]
    n1, w = cols.shape
    f = pg.config.n2
    nnz = pg.tiles[key[:2]][key[2]].nnz
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn(n1, 4 * f, generator=gen, device="cuda")[:, f:2 * f]
    acc = torch.randn(n1, f, generator=gen, device="cuda")

    d_err = densify_same_bits(torch, ops, ref, "FL slice", cols, vals, n1)
    dense = ops.densify(cols, vals, n1)
    cases = densify_cases(torch, gen)
    for label, c, v, n_src in cases:
        d_err = max(d_err, densify_same_bits(torch, ops, ref, label, c, v,
                                             n_src))
    log(f"kernel densify: bit for bit the plain version, twice alike, on "
        f"the FL slice and {len(cases)} more tiles: "
        + "; ".join(label for label, *_ in cases))
    del cases
    rows = torch.arange(n1, device="cuda")[:, None].expand(n1, w)
    cl = cols.long()

    def library():
        return torch.zeros(n1, n1, device="cuda").index_put_(
            (rows, cl), vals, accumulate=True)
    t_dk = median_ms(torch, lambda: ops.densify(cols, vals, n1))
    t_dp = median_ms(torch, lambda: ref.densify_ref(cols, vals, n1),
                     reps=3, launches=3)
    t_dl = median_ms(torch, library)
    db_ms, db_by, live = densify_bound(torch, vals, n1)
    log(f"kernel densify on FL slice (j,k,s)={key} n1={n1} w={w} nnz={nnz}"
        f" live={live}: kernel {t_dk:.4f} ms, plain {t_dp:.4f} ms, index_put_"
        f"(accumulate) {t_dl:.4f} ms, bound {db_ms:.4f} ms ({db_by}), "
        "bit-identical to the plain version")
    densify_entry = {
        "name": "densify", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/core/ack.py:95",
        "max_abs_err": d_err, "ms": t_dk, "plain_ms": t_dp,
        "bound_ms": db_ms, "bound_by": db_by, "library_ms": t_dl}

    info = {"slice": list(key), "w": w, "nnz": nnz}
    for with_acc in (False, True):
        a = acc if with_acc else None
        got = ops.gemm(dense, h, a)
        want = ref.gemm_ref(dense, h) + (acc if with_acc else 0.0)
        err = check_close(torch, f"gemm remapped shape{' +acc' * with_acc}",
                          got, want, KERNEL_RTOL, KERNEL_ATOL)
        if not torch.equal(got, ops.gemm(dense.clone(), h, a)):
            fail("gemm remapped shape: the densified block and its copy "
                 "give different bits")
        if with_acc and not torch.equal(
                got, ACK("cuda").gemm_agg(cols, vals, h, acc)):
            fail("gemm_agg on the FL slice differs from densify + gemm")
        t_k = median_ms(torch, lambda: ops.gemm(dense, h, a))
        t_p = median_ms(torch, lambda: ref.gemm_ref(dense, h) + (
            acc if with_acc else 0.0))
        if with_acc:
            t_l = median_ms(torch, lambda: torch.addmm(acc, dense, h))
            lib = "torch.addmm"
        else:
            t_l = median_ms(torch, lambda: torch.matmul(dense, h))
            lib = "torch.matmul"
        nbytes = 4 * (n1 * n1 + n1 * f + (2 if with_acc else 1) * n1 * f)
        b_ms, b_by = bound_ms(nbytes, 2.0 * n1 * n1 * f)
        log(f"kernel gemm {n1}x{n1}x{f} (densified FL slice, strided h"
            f"{', +acc' if with_acc else ''}): kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, {lib} {t_l:.4f} ms (TF32 off), bound "
            f"{b_ms:.4f} ms ({b_by}), "
            f"{t_k / b_ms:.2f}x the bound, max|err| {err:.2e}; bits equal "
            "on a copy of the block")
        info["acc" if with_acc else "plain"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by,
            "max_abs_err": err}
    return densify_entry, info


# --------------------------------------------------------------------------- #
def build_gat_dot(B, g, hidden: int = 64, n_layers: int = 2, seed: int = 0):
    """gat-dot: a single-head dot-product-attention GAT (the DP attention
    of SuperGAT, Kim & Oh, ICLR 2021; PyG ``SuperGATConv(attention_type=
    "DP")``, negative slope 0.2; b6's widths, paper Table 5) built from the
    builder module ``B``'s primitives.  A copy of ``build_gat_dot`` in
    ``tests/_torch_models.py``."""
    b = B._B(g, f"gatdot{n_layers}x{hidden}", seed)
    f, prev = g.feat_dim, None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else g.n_classes
        h = b.linear(prev, f, fo)
        e = b.vector_inner(h, fo, mode="dot")
        e = b.activation(e, 1, B.Activation.LRELU, on_edges=True)
        e = b.activation(e, 1, B.Activation.EDGE_SOFTMAX, on_edges=True)
        prev = b.aggregate(h, fo, B.AggOp.SUM, edge_weight_layer=e)
        if i < n_layers - 1:
            prev = b.activation(prev, fo, B.Activation.RELU)
        f = fo
    return b.m


def lanes_of(n: int) -> int:
    """The lanes ``Engine.submit_batch`` runs n requests in: JAX's bucket,
    the next power of two."""
    return 1 << (n - 1).bit_length()


def plan_tile_ops(prog) -> dict:
    """Tile ops of one pass of ``prog`` that launch each kernel: GEMM
    steps of LINEAR layers, SUM/MEAN SpDMM steps, dot-mode SDDMM steps."""
    from repro_torch.core.ir import AggOp, LayerType
    out = {"gemm": 0, "spdmm": 0, "sddmm": 0}
    for lp in prog.plan().layers:
        steps = sum(len(tp.compute) for tp in lp.tiles)
        if lp.layer_type == LayerType.LINEAR:
            out["gemm"] += steps
        elif lp.layer_type == LayerType.AGGREGATE and AggOp(lp.mode) in (
                AggOp.SUM, AggOp.MEAN):
            out["spdmm"] += steps
        elif lp.layer_type == LayerType.VECTOR_INNER and lp.mode == 0:
            out["sddmm"] += steps
    return out


def runtime_phase(torch, engine, co, fl):
    """ServeLoop over OverlayPool(engines=[engine, Engine()]): gat-dot and
    b2 on FL, gat-dot on CO, batched; see the module docstring."""
    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.runtime import OverlayPool, ServeLoop

    gat_fl, gat_co = build_gat_dot(TB, fl), build_gat_dot(TB, co)
    reqs = []
    for i in range(4):
        reqs.append(InferenceRequest(
            model=gat_fl, graph=fl, features=G.random_features(
                fl, seed=20 + i), request_id=f"gat-dot@FL#{i}"))
        reqs.append(InferenceRequest(
            model="b2", graph=fl, features=G.random_features(
                fl, seed=30 + i), request_id=f"b2@FL#{i}"))
        if i < 3:
            reqs.append(InferenceRequest(
                model=gat_co, graph=co, features=G.random_features(
                    co, seed=40 + i), request_id=f"gat-dot@CO#{i}"))
    home = 0                                # engine compiled b2@FL above
    pool = OverlayPool(engines=[engine, Engine()])
    loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
    # Record each batch's pass (per-layer CUDA-event times, tile ops by
    # mode) in the overlay's worker thread, right after its pass: an
    # overlay runs its batches FIFO, so its exec_stats are that batch's.
    batches = []
    execute_on = pool.execute_on

    def recorded(idx, batch):
        resps = execute_on(idx, batch)
        st = pool.engines[idx].exec_stats
        batches.append({
            "overlay": idx, "indices": list(batch.indices),
            "size": len(batch), "key": batch.key,
            "modes": dict(st.tile_ops_by_mode or {}),
            "layers": [(r["layer"], r["kernel"], r["tile_ops"],
                        r["wall_s"] * 1e3) for r in st.per_layer]})
        return resps
    pool.execute_on = recorded

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the runtime path: counts are zeroed just above, read below.
    t0 = time.perf_counter()
    try:
        resps = loop.serve(reqs)
    finally:
        loop.shutdown()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ran = ops.launch_totals()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the runtime path.

    batches.sort(key=lambda b: b["indices"][0])
    for req, r in zip(reqs, resps):
        log(f"runtime {r.request_id}: T_LoC {r.t_loc * 1e3:.2f} ms, T_LoH "
            f"{r.t_loh * 1e3:.2f} ms, batch {r.batch_size}, overlay "
            f"{r.overlay}, cache_hit {r.cache_hit}")
    exp = {"gemm": 0, "spdmm": 0, "sddmm": 0}
    for b in batches:
        prog = pool.engines[b["overlay"]].cache.get(
            pool.engine_key(b["key"]))
        per_pass = plan_tile_ops(prog)
        for k in exp:
            exp[k] += lanes_of(b["size"]) * per_pass[k]
        if per_pass["gemm"] != b["modes"].get("gemm", 0) or \
                per_pass["sddmm"] != b["modes"].get("sddmm", 0):
            fail(f"batch {b['indices']}: executor tile ops {b['modes']} "
                 f"disagree with the plan's {per_pass}")
        log(f"batch {reqs[b['indices'][0]].request_id} x{b['size']} on "
            f"overlay {b['overlay']}: tile ops per pass {per_pass}; "
            "per-layer CUDA-event ms: " + ", ".join(
                f"L{lid}:{k}x{n}={ms:.3f}" for lid, k, n, ms in b["layers"]))
    log(f"runtime: {len(resps)} responses in {wall:.2f} s; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    log("pool stats: " + json.dumps(pool.stats_snapshot()))
    log("metrics: " + json.dumps(pool.metrics.snapshot(max_batch=4)))
    log(f"launches on the runtime path: {launches} through the wrappers, "
        f"{ran} with the replays'; expected lanes x tile ops: {exp}")

    if [r.request_id for r in resps] != [r.request_id for r in reqs]:
        fail("runtime responses are not in admission order: "
             f"{[r.request_id for r in resps]}")
    want_sizes = {"gat-dot@FL": 4, "b2@FL": 4, "gat-dot@CO": 3}
    sizes = [r.batch_size for r in resps]
    if sizes != [want_sizes[r.request_id.split("#")[0]] for r in resps] \
            or sorted(b["size"] for b in batches) != [3, 4, 4]:
        fail(f"runtime batch sizes {sizes} / "
             f"{[b['size'] for b in batches]}, expected 4, 4 and 3")
    b2 = [r for r in resps if r.request_id.startswith("b2@FL")]
    if not all(r.cache_hit and r.overlay == home for r in b2):
        fail("b2@FL must hit on overlay 0, got "
             f"{[(r.cache_hit, r.overlay) for r in b2]}")
    for k in exp:
        if not (ran[k] == exp[k] > 0):
            fail(f"{k} launches {ran[k]} != lanes x tile ops {exp[k]}")
    worst = hold_against_reference(torch, reqs, resps)
    log(f"runtime: {len(resps)} outputs within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of run_reference in float64 (worst max|err| "
        f"{worst:.3e})")
    # Lane 0 of each batch against the same request served alone on the
    # same overlay (after the launch counts were read).
    for b in batches:
        i = b["indices"][0]
        solo = pool.engines[b["overlay"]].submit(reqs[i])
        if not torch.equal(solo.output, resps[i].output):
            diff = float((solo.output - resps[i].output).abs().max())
            fail(f"{reqs[i].request_id}: batched lane 0 differs from the "
                 f"solo serve by {diff:.3e}")
        st = pool.engines[b["overlay"]].exec_stats
        log(f"solo {reqs[i].request_id} on overlay {b['overlay']}: "
            f"bit-identical to lane 0 of its batch; T_LoH "
            f"{solo.t_loh * 1e3:.2f} ms, cache_hit {solo.cache_hit}; "
            "per-layer CUDA-event ms: " + ", ".join(
                f"L{r['layer']}:{r['kernel']}x{r['tile_ops']}="
                f"{r['wall_s'] * 1e3:.3f}" for r in st.per_layer))
    gat_eng = pool.engines[resps[0].overlay]
    profile_call(torch, lambda: gat_eng.serve([reqs[0]]),
                 "gat-dot@FL hit")
    gat_prog = gat_eng.cache.get(resps[0].cache_key)
    return launches, gat_prog, resps, peak, wall, reqs, pool


REPLAY_ROUNDS = 1        # rounds of eager, replay, replay, eager FL hits


def replay_phase(torch, fl, fl_prog, gat_prog, rt_reqs, rt_pool):
    """Replays against the eager route (``Engine(replay=False)``), on the
    programs phases 3 and 5 compiled (so on their staged tiles): b2@FL and
    gat-dot@FL hits in turns, each hit bit for bit the eager one, the
    launches of both routes equal to hits x the pass's tile ops, one
    replayed output of each against the float64 reference, and one hit of
    each route under the profiler; then the runtime stream of phase 5 on
    a pool of two eager overlays and on a pool of two replaying ones
    (each holding the programs its phase-5 counterpart held), measured
    after warm-up runs, every response bit for bit across the two, with
    the pools' p50 / p99.  Returns (launches of the hits, a summary)."""
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.runtime import OverlayPool, ServeLoop

    out = {}
    launches = {k: 0 for k in ops.LAUNCHES}
    eag, rep = Engine(replay=False), Engine()
    x = G.random_features(fl, seed=50)
    models = {"b2@FL": "b2", "gat-dot@FL": rt_reqs[0].model}
    for label, prog in (("b2@FL", fl_prog), ("gat-dot@FL", gat_prog)):
        want = eag.run(prog, x)
        with StepLog(torch, ops, prog) as rec:
            for _ in range(3):              # warm eager pass, capture
                rec.next_pass()
                rep.run(prog, x)
        descs = [p for p in rec.passes if p][-1]
        times = {"eager": [], "replay": []}
        ops.reset_launches()
        # ---- hits of both routes: counts zeroed above, read below.
        for _ in range(REPLAY_ROUNDS):
            for mode in ("eager", "replay", "replay", "eager"):
                eng = eag if mode == "eager" else rep
                t0 = time.perf_counter()
                y = eng.run(prog, x)
                eng._sync()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if not torch.equal(y, want):
                    fail(f"replay {label}: a {mode} hit differs from the "
                         f"first eager one by "
                         f"{float((y - want).abs().max()):.3e}")
        got, ran = dict(ops.LAUNCHES), ops.launch_totals()
        kran = ops.kernel_launch_totals()
        # ----
        for k in launches:
            launches[k] += got[k]
        per_pass = plan_tile_ops(prog)
        hits = 2 * REPLAY_ROUNDS
        runs = plan_spdmm_runs(torch, prog)
        if kran["spdmm"] != 2 * hits * runs or len(descs) != runs:
            fail(f"replay {label}: SpDMM kernel launches {kran['spdmm']} != "
                 f"{2 * hits} hits x {runs} a pass (the capture recorded "
                 f"{len(descs)})")
        for k in per_pass:
            if got[k] != hits * per_pass[k] or \
                    ran[k] != 2 * hits * per_pass[k]:
                fail(f"replay {label}: {k} launches {got[k]} (wrappers) / "
                     f"{ran[k]} (all) != {hits} / {2 * hits} hits x "
                     f"{per_pass[k]} tile ops")
        worst = hold_against_reference(
            torch, [InferenceRequest(models[label], fl, x)],
            [_resp(f"{label} replay", y)])
        prof = {"eager": {}, "replay": {}}
        for mode, eng in (("eager", eag), ("replay", rep)):
            profile_call(torch, lambda: (eng.run(prog, x), eng._sync()),
                         f"{label} {mode} hit (device activity only)",
                         out=prof[mode], cpu=False)
        spdmm = {}
        for mode, eng in (("eager", eag), ("replay", rep)):
            ev = spdmm_events(torch, lambda: (eng.run(prog, x), eng._sync()))
            if ev is None:
                log(f"replay {label} {mode} hit: SpDMM device time not "
                    "measured (no device events)")
                continue
            spdmm[mode] = {"ms": sum(ev) / 1e3, "kernel_launches": len(ev),
                           "steps": per_pass["spdmm"]}
            log(f"replay {label} {mode} hit: SpDMM device "
                f"{sum(ev) / 1e3:.3f} ms in {len(ev)} kernel launches "
                f"({per_pass['spdmm']} steps)")
            if mode == "replay":
                spdmm[mode]["bins"] = launch_histogram(
                    f"replay {label} hit SpDMM launches", ev, descs)
        med = {m: statistics.median(v) for m, v in times.items()}
        for mode in prof:
            if "busy_ms" in prof[mode]:
                prof[mode]["busy_over_unprofiled"] = (
                    prof[mode]["busy_ms"] / med[mode])
                log(f"replay {label} {mode} hit: device busy "
                    f"{prof[mode]['busy_ms']:.2f} ms over the unprofiled "
                    f"median {med[mode]:.2f} ms: "
                    f"{100 * prof[mode]['busy_over_unprofiled']:.1f}%")
        log(f"replay {label}: hits in turns, eager T_LoH "
            f"{[round(t, 2) for t in times['eager']]} ms (median "
            f"{med['eager']:.2f}), replayed "
            f"{[round(t, 2) for t in times['replay']]} ms (median "
            f"{med['replay']:.2f}); every hit bit for bit; launches "
            f"{got} through the wrappers, {ran} with the replays'; max|err| "
            f"{worst:.3e} against float64")
        out[label] = {"t_loh_ms": times, "median_ms": med,
                      "launches": got, "ran": ran, "worst_err": worst,
                      "profile": prof, "spdmm_kernel_launches": kran,
                      "spdmm": spdmm}

    # The runtime stream on eager and on replaying overlays.
    keys = {rt_pool.cache_key(r) for r in rt_reqs}
    held = [{k: e.cache.get(k) for k in keys if k in e.cache}
            for e in rt_pool.engines]

    def stream(replay, runs):
        engines = [Engine(replay=replay) for _ in held]
        for e, progs in zip(engines, held):
            for k, prog in progs.items():
                e.cache.put(k, prog)
        walls = []
        for _ in range(runs):               # the last is measured
            pool = OverlayPool(engines=engines)
            loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
            t0 = time.perf_counter()
            try:
                resps = loop.serve(rt_reqs)
            finally:
                loop.shutdown()
            walls.append(time.perf_counter() - t0)
        log(f"replay stream, {'replaying' if replay else 'eager'} "
            f"overlays: runs of {[round(w, 3) for w in walls]} s, "
            f"{sum(e.stats.compiles for e in engines)} compiles")
        snap = pool.metrics.snapshot(max_batch=4)["global"]
        return resps, walls[-1], snap

    # An eager overlay has nothing to warm (the programs are compiled and
    # staged); a replaying one keeps its warm passes in the first run and
    # captures in the second.
    e_resps, e_wall, e_snap = stream(False, 1)
    r_resps, r_wall, r_snap = stream(True, 3)
    for a, b in zip(e_resps, r_resps):
        if a.request_id != b.request_id or not torch.equal(a.output,
                                                           b.output):
            fail(f"replay stream: {b.request_id} differs from the eager "
                 "stream's")
    for label, wall, snap in (("eager", e_wall, e_snap),
                              ("replayed", r_wall, r_snap)):
        log(f"replay stream, {label} overlays: {len(rt_reqs)} requests in "
            f"{wall:.3f} s, p50 {snap['p50_latency_ms']:.3f} ms, p99 "
            f"{snap['p99_latency_ms']:.3f} ms, mean batch "
            f"{snap['mean_batch_size']:.3f}")
    log("replay stream: every response bit for bit across the two")
    out["stream"] = {"eager": {"wall_s": e_wall, "metrics": e_snap},
                     "replay": {"wall_s": r_wall, "metrics": r_snap}}
    return launches, out


def fl_sddmm_entry(torch, ops, ref, prog):
    """The SDDMM kernel on the widest real ELL slice of the gat-dot FL
    program, with its real mask, an accumulator, and the source / target
    views the executor passes it (the kernels-line entry); then on a
    synthetic hub tile of the same shape.  Returns (entry, hub tile
    summary)."""
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, mask_d = st.tiles("cols"), st.tiles("mask")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, mask = cols_d[key], mask_d[key]
    n1, w = cols.shape
    f = pg.config.n2
    j, k = key[0], key[1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn(pg.n_blocks * n1, f, generator=gen, device="cuda")
    hd, hs = h[j * n1:(j + 1) * n1], h[k * n1:(k + 1) * n1]
    acc = torch.randn(n1, w, generator=gen, device="cuda")
    fl = sddmm_tile(torch, ops, ref, f"gat-dot FL slice (j,k,s)={key}", hd,
                    hs, cols, mask, acc)
    fl["bf16"] = sddmm_bf16_cases(torch, ops, ref, hd, hs, cols, mask, acc)
    # Hub tile: n1 = 4096, w = 512, 256 rows with all 512 slots live, the
    # rest with their first 25 (the FL slice's median), live slots packed
    # at the front of each row as the partitioner packs them.
    lens = torch.full((n1,), 25, device="cuda")
    lens[torch.randperm(n1, generator=gen, device="cuda")[:256]] = w
    hub_mask = (torch.arange(w, device="cuda")[None] < lens[:, None]
                ).contiguous()
    hub_cols = torch.where(hub_mask, torch.randint(
        0, n1, (n1, w), generator=gen, device="cuda"), 0).to(
        torch.int32).contiguous()
    hub = sddmm_tile(torch, ops, ref, "synthetic hub tile", hd, hs, hub_cols,
                     hub_mask, acc)
    return ({"name": "sddmm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/sddmm.cu",
             "replaces": "src/repro/kernels/sddmm.py:46",
             "max_abs_err": fl["max_abs_err"], "ms": fl["ms"],
             "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
             "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
             "padded_bound_ms": fl["padded_bound_ms"], "bf16": fl["bf16"]},
            hub)


def sddmm_bf16_cases(torch, ops, ref, hd, hs, cols, mask, acc):
    """On one SDDMM tile: the bf16 store (fp32 operands; the fp32
    kernel's result rounded once, bit for bit) and bf16 operands (fp32
    out; the fp32 kernel's result on the widened operands, bit for bit),
    each held against the plain version and timed beside its bound and
    beside ``torch.sparse.sampled_addmm`` where PyTorch takes the call
    (``library_call``: else the error it raises)."""
    n1, w = cols.shape
    f = hd.shape[1]
    nnz = int(mask.sum())
    rows, slots = torch.nonzero(mask, as_tuple=True)
    src_rows = int(torch.unique(cols[rows, slots]).numel())
    dst_rows = int(torch.unique(rows).numel())
    hd16, hs16 = hd.bfloat16(), hs.bfloat16()
    # The CSR pattern of the live slots holding acc, for
    # torch.sparse.sampled_addmm (acc + h_dst @ h_src^T sampled there).
    crow = torch.zeros(n1 + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[rows, slots].long(),
                                  acc[rows, slots], size=(n1, hs.shape[0]))
    csr16, res16 = csr.to(torch.bfloat16), csr.to(torch.bfloat16)
    hdc, hst = hd.contiguous(), hs.t().contiguous()
    hd16c, hs16t = hd16.contiguous(), hs16.t().contiguous()
    calls = {
        "bf16 store": [("torch.sparse.sampled_addmm(csr, h_dst, h_src^T, "
                        "out=bf16 csr)",
                        lambda: torch.sparse.sampled_addmm(
                            csr, hdc, hst, out=res16))],
        "bf16 operands": [("torch.sparse.sampled_addmm(csr, bf16 h_dst, "
                           "bf16 h_src^T)",
                           lambda: torch.sparse.sampled_addmm(csr, hd16c,
                                                              hs16t)),
                          ("torch.sparse.sampled_addmm(bf16 csr, bf16 "
                           "h_dst, bf16 h_src^T): acc and the result in "
                           "bf16, not the same function",
                           lambda: torch.sparse.sampled_addmm(csr16, hd16c,
                                                              hs16t))]}
    out = {}
    for tag, a, b, odt, eb, ob in (
            ("bf16 store", hd, hs, torch.bfloat16, 4, 2),
            ("bf16 operands", hd16, hs16, torch.float32, 2, 4)):
        ops.reset_launches()
        got = ops.sddmm(a, b, cols, mask, acc, out_dtype=odt)
        n_l = ops.launch_totals()["sddmm"]
        same = (ops.sddmm(hd, hs, cols, mask, acc).bfloat16()
                if odt == torch.bfloat16 else
                ops.sddmm(a.float(), b.float(), cols, mask, acc))
        if not torch.equal(got, same):
            fail(f"sddmm FL slice, {tag}: not bit for bit the fp32 kernel's "
                 "result")
        err = check_close(torch, f"sddmm FL slice {tag}", got,
                          ref.sddmm_step_ref(a, b, cols, mask, acc, odt),
                          2e-2, 1e-2)
        t_k = median_ms(torch, lambda: ops.sddmm(a, b, cols, mask, acc,
                                                 out_dtype=odt))
        t_p = median_ms(torch, lambda: ref.sddmm_step_ref(a, b, cols, mask,
                                                          acc, odt))
        b_ms, b_by = bound_ms((5 + ob) * n1 * w + 4 * nnz
                              + eb * f * (dst_rows + src_rows),
                              2.0 * nnz * f)
        log(f"kernel sddmm on the FL slice, {tag}: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
            f"{err:.2e}; bit for bit the fp32 kernel's result")
        libs = [library_call(torch, label, fn, got[rows, slots])
                for label, fn in calls[tag]]
        out[tag] = {"launches": n_l, "max_abs_err": err, "ms": t_k,
                    "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": libs[0].get("ms"), "library": libs}
    out["bf16 operands"]["loads"] = "8-byte loads of four features"
    out["bf16 operands, scalar route"] = sddmm_bf16_routes(
        torch, ops, hd16, hs16, cols, mask, acc)
    return out


def off_by_one(torch, t):
    """``t``'s values in a view whose rows start one element past its
    buffer's, with a row stride one more than its width (so off every
    16-byte boundary: bf16 SDDMM operands take the scalar route)."""
    buf = torch.empty(t.shape[0], t.shape[1] + 1, dtype=t.dtype,
                      device=t.device)
    buf[:, 1:].copy_(t)
    return buf[:, 1:]


def sddmm_bf16_routes(torch, ops, hd16, hs16, cols, mask, acc):
    """bf16 SDDMM operands on both routes: as given (the vector route
    where f, the row strides and the bases allow 8-byte loads of four
    features) and off by one element (``off_by_one``: the scalar route's
    2-byte loads); each bit for bit the fp32 kernel on the widened
    operands, with an fp32 and a bf16 store.  Returns the scalar route's
    time and, beside it, the vector route's in the same call."""
    hdu, hsu = off_by_one(torch, hd16), off_by_one(torch, hs16)
    want = ops.sddmm(hd16.float(), hs16.float(), cols, mask, acc)
    for label, a, b in (("vector", hd16, hs16), ("scalar", hdu, hsu)):
        if not (torch.equal(ops.sddmm(a, b, cols, mask, acc), want)
                and torch.equal(ops.sddmm(a, b, cols, mask, acc,
                                          out_dtype=torch.bfloat16),
                                want.bfloat16())):
            fail(f"sddmm bf16 operands, {label} route: not bit for bit the "
                 "fp32 kernel on the widened operands")
    t_s = median_ms(torch, lambda: ops.sddmm(hdu, hsu, cols, mask, acc))
    t_v = median_ms(torch, lambda: ops.sddmm(hd16, hs16, cols, mask, acc))
    log(f"kernel sddmm bf16 operands: scalar route (rows one element off, "
        f"stride f + 1) {t_s:.4f} ms, vector route {t_v:.4f} ms in the "
        "same call; both bit for bit the fp32 kernel on the widened "
        "operands, fp32 and bf16 stores")
    return {"ms": t_s, "vector_ms": t_v}


def sddmm_tile(torch, ops, ref, label, hd, hs, cols, mask, acc):
    """One [n1, w] SDDMM tile with a mask and an accumulator: held against
    the plain version, masked slots equal to acc, two runs equal; times
    of kernel, plain version and torch.sparse.sampled_addmm, and the
    bound."""
    n1, w = cols.shape
    f = hd.shape[1]
    want = ref.sddmm_step_ref(hd, hs, cols, mask, acc)
    got = ops.sddmm(hd, hs, cols, mask, acc)
    err = check_close(torch, f"sddmm {label}", got, want, KERNEL_RTOL,
                      KERNEL_ATOL)
    if not torch.equal(got[~mask], acc[~mask]):
        fail(f"sddmm {label}: a masked slot does not keep its accumulator")
    if not torch.equal(got, ops.sddmm(hd, hs, cols, mask, acc)):
        fail(f"sddmm {label}: two runs on the same inputs differ")
    # Library yardstick: torch.sparse.sampled_addmm on the CSR pattern of
    # the live slots (acc + h_dst @ h_src^T sampled there).
    rows, slots = torch.nonzero(mask, as_tuple=True)
    counts = torch.bincount(rows, minlength=n1)
    crow = torch.zeros(n1 + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(counts, 0)
    live_cols = cols[rows, slots].long()
    csr = torch.sparse_csr_tensor(crow, live_cols, acc[rows, slots],
                                  size=(n1, hs.shape[0]))
    hdc, hst = hd.contiguous(), hs.t().contiguous()
    lib = torch.sparse.sampled_addmm(csr, hdc, hst)
    check_close(torch, f"sampled_addmm yardstick, {label}", lib.values(),
                want[rows, slots], KERNEL_RTOL, KERNEL_ATOL)
    t_k = median_ms(torch, lambda: ops.sddmm(hd, hs, cols, mask, acc))
    t_p = median_ms(torch, lambda: ref.sddmm_step_ref(hd, hs, cols, mask,
                                                      acc))
    t_l = median_ms(torch, lambda: torch.sparse.sampled_addmm(csr, hdc,
                                                              hst))
    nnz = int(rows.numel())
    src_rows = int(torch.unique(live_cols).numel())
    dst_rows = int(torch.unique(rows).numel())
    # Bytes the function needs: mask (1) + acc in (4) + out (4) per slot,
    # the column (4) of each live slot only (a masked slot's output is acc
    # whatever its column holds), and once each the h_dst rows that have a
    # live slot and the live source rows; operations: 2 f per live slot.
    b_ms, b_by = bound_ms(9 * n1 * w + 4 * nnz + 4 * f * (dst_rows
                                                          + src_rows),
                          2.0 * nnz * f)
    # The padded count: every slot's column and every h_dst row read.
    b_pad, _ = bound_ms(13 * n1 * w + 4 * f * (n1 + src_rows),
                        2.0 * nnz * f)
    log(f"kernel sddmm on {label} n1={n1} w={w} f={f} live={nnz} "
        f"({src_rows} source rows, L2 gather volume "
        f"{nnz * 4 * f / 1e6:.1f} MB): kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, torch.sparse.sampled_addmm {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; padded {b_pad:.4f} ms), max|err| "
        f"{err:.2e}; masked slots keep acc, two runs equal")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "live": nnz, "padded_bound_ms": b_pad}


# --------------------------------------------------------------------------- #
SAMPLE_GEOM = (256, 32)          # bench_sample.py's full-mode (n1, n2)
SAMPLE_FANOUTS = (25, 10)        # GraphSAGE's published two-hop sizes
SAMPLE_MODELS = ("b1", "b3", "b6")
SAMPLE_N, SAMPLE_WARM, SAMPLE_MAX_BATCH = 64, 384, 8
SAMPLE_MIN_HIT_RATE, SAMPLE_MIN_BITWISE = 0.9, 8


def sample_stream(np, n_vertices, n, seed, tag):
    """``n`` per-user requests: 1-16 distinct targets each (drawn from
    ``seed``), fanouts (25, 10), models b1 / b3 / b6 round-robin, and a
    sampling seed per request."""
    from repro_torch.sampling import TargetRequest
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = rng.choice(n_vertices, size=int(rng.integers(1, 17)),
                       replace=False)
        out.append(TargetRequest(
            targets=[int(v) for v in t], model=SAMPLE_MODELS[i % 3],
            fanouts=SAMPLE_FANOUTS, request_id=f"{tag}{i}",
            seed=int(rng.integers(1 << 30))))
    return out


def sampled_phase(torch, fl_raw):
    """Per-user ego-network serving through ``SamplingService`` on the
    full-scale synthesized Flickr graph; see the module docstring.
    Returns (launches of the served stream, a summary dict)."""
    import numpy as np

    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import build
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.core.reference import run_reference
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.runtime import Batch, request_cost
    from repro_torch.sampling import SamplingService, sample_ego

    n1, n2 = SAMPLE_GEOM
    geom = PartitionConfig(n1=n1, n2=n2)
    X = G.random_features(fl_raw, seed=3)
    svc = SamplingService(fl_raw, X, n_overlays=2, geometry=geom,
                          max_batch=SAMPLE_MAX_BATCH)
    reqs = sample_stream(np, fl_raw.n_vertices, SAMPLE_N, 0, "u")
    warm = sample_stream(np, fl_raw.n_vertices, SAMPLE_WARM, 1, "w")
    t0 = time.perf_counter()
    n_prog = svc.warm(warm)
    torch.cuda.synchronize()
    log(f"sampled: warmed {n_prog} programs from a disjoint stream of "
        f"{len(warm)} requests in {time.perf_counter() - t0:.2f} s")

    # Each batch's pass, recorded in the overlay's worker thread right
    # after it (an overlay runs its batches FIFO).
    batches = []
    execute_on = svc.pool.execute_on

    def recorded(idx, batch):
        resps = execute_on(idx, batch)
        st = svc.pool.engines[idx].exec_stats
        batches.append({"overlay": idx, "key": batch.key,
                        "size": len(batch),
                        "modes": dict(st.tile_ops_by_mode or {}),
                        "h2d_bytes": st.h2d_bytes,
                        "t_loh_s": resps[0].t_loh})
        return resps
    svc.pool.execute_on = recorded
    h0 = sum(e.stats.cache_hits for e in svc.pool.engines)
    r0 = sum(e.stats.requests for e in svc.pool.engines)
    torch.cuda.synchronize()
    ops.reset_launches()
    # ---- the sampled path: counts are zeroed just above, read below.
    t0 = time.perf_counter()
    try:
        resps = svc.serve(reqs)
    finally:
        svc.shutdown()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ran = ops.launch_totals()
    # ---- end of the sampled path.
    svc.pool.execute_on = execute_on
    hits = sum(e.stats.cache_hits for e in svc.pool.engines) - h0
    served = sum(e.stats.requests for e in svc.pool.engines) - r0
    hit_rate = hits / served

    snap = svc.pool.metrics.snapshot(max_batch=SAMPLE_MAX_BATCH)["global"]
    census = dict(sorted(svc.bucket_counts.items(),
                         key=lambda kv: -kv[1]))
    log(f"sampled: {len(resps)} responses in {wall:.3f} s "
        f"({len(resps) / wall:.2f} requests/s), latency p50 "
        f"{snap['p50_latency_ms']:.3f} ms, p99 {snap['p99_latency_ms']:.3f}"
        f" ms (of {snap['requests']} requests), {len(batches)} batches, "
        f"mean batch size {snap['mean_batch_size']:.3f}; program-cache hit "
        f"rate after warm-up {hit_rate:.4f} ({hits}/{served})")
    log(f"sampled: bucket census ({len(census)} buckets) {census}")
    # Tile steps of each bucket program and its expected launches.
    exp = {"gemm": 0, "spdmm": 0}
    steps = {}
    for b in batches:
        eng = svc.pool.engines[b["overlay"]]
        prog = eng.cache.get(svc.pool.engine_key(b["key"]))
        if prog is None:
            fail(f"sampled: a served program left overlay {b['overlay']}'s "
                 "cache")
        per_pass = plan_tile_ops(prog)
        label = f"{prog.model_name}@{prog.graph_name}"
        steps[label] = {"tile_steps": per_pass, "n_blocks":
                        prog.pgraph.n_blocks}
        for k in exp:
            exp[k] += lanes_of(b["size"]) * per_pass[k]
        if per_pass["gemm"] != b["modes"].get("gemm", 0):
            fail(f"sampled batch {label}: executor GEMM steps "
                 f"{b['modes']} != the plan's {per_pass}")
    for label, s in sorted(steps.items()):
        log(f"  program {label}: nb {s['n_blocks']}, tile steps per lane "
            f"{s['tile_steps']}")
    h2d = [b["h2d_bytes"] for b in batches]
    log(f"sampled: graph_data H2D bytes per batch: mean "
        f"{statistics.mean(h2d):.0f}, max {max(h2d)}, total {sum(h2d)}; "
        f"launches {launches} through the wrappers, {ran} with the "
        f"replays'; expected lanes x tile steps {exp}")
    for k in exp:
        if not (ran[k] == exp[k] > 0):
            fail(f"sampled {k} launches {ran[k]} != lanes x tile steps"
                 f" {exp[k]}")
    if hit_rate < SAMPLE_MIN_HIT_RATE:
        fail(f"sampled: cache hit rate {hit_rate:.4f} < "
             f"{SAMPLE_MIN_HIT_RATE}")
    if [r.request_id for r in resps] != [r.request_id for r in reqs]:
        fail("sampled responses are not in request order")

    # Every response against a float64 reference of its own subgraph;
    # the largest bucket of each model and more against the unpadded
    # subgraph served through Engine.submit, bit for bit.
    size = {r.bucket: tuple(int(p[1:]) for p in r.bucket.split("-")[:3])
            for r in resps}
    chosen = set()
    for m in SAMPLE_MODELS:
        mine = [i for i, q in enumerate(reqs) if q.model == m]
        chosen.add(max(mine, key=lambda i: size[resps[i].bucket]))
        chosen.update(mine[:2])
    largest = max(size.values())
    chosen.update(i for i, r in enumerate(resps) if size[r.bucket] ==
                  largest)
    solo = Engine(geometry=geom)
    worst, bitwise = 0.0, 0
    for i, (q, r) in enumerate(zip(reqs, resps)):
        ego = sample_ego(fl_raw, q.targets, q.fanouts, seed=q.seed)
        sub = ego.graph.gcn_normalized()
        xs = torch.as_tensor(X[ego.vertices], device="cuda")
        nt = ego.n_targets
        if tuple(r.logits.shape) != (nt, fl_raw.n_classes) or not bool(
                torch.isfinite(r.logits).all()):
            fail(f"sampled {r.request_id}: logits {tuple(r.logits.shape)} "
                 "or non-finite values")
        y64 = run_reference(build(q.model, sub, q.model_seed), sub, xs,
                            dtype=torch.float64)[:nt]
        err = (r.logits.double() - y64).abs()
        if bool((err > PATH_ATOL + PATH_RTOL * y64.abs()).any()):
            fail(f"sampled {r.request_id} ({q.model}, {r.bucket}): max|err| "
                 f"{float(err.max()):.3e} past rtol {PATH_RTOL} / atol "
                 f"{PATH_ATOL} of the float64 reference")
        worst = max(worst, float(err.max()))
        if i in chosen:
            y = solo.submit(InferenceRequest(q.model, sub, X[ego.vertices],
                                             seed=q.model_seed)).output
            if not torch.equal(r.logits, y[:nt]):
                fail(f"sampled {r.request_id} ({q.model}, {r.bucket}): "
                     "padded logits differ from the unpadded subgraph's by "
                     f"{float((r.logits - y[:nt]).abs().max()):.3e}")
            bitwise += 1
    if bitwise < SAMPLE_MIN_BITWISE:
        fail(f"sampled: only {bitwise} responses held bit for bit")
    log(f"sampled: {len(resps)} responses within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of float64 references of their subgraphs (worst "
        f"max|err| {worst:.3e}); {bitwise} (each model, the largest bucket "
        f"{largest}) bit-identical to the unpadded subgraph through "
        "Engine.submit")

    # One batch of the most populated key, profiled.
    key = max({b["key"] for b in batches},
              key=lambda k: sum(b["size"] for b in batches
                                if b["key"] == k))
    infs = [svc.prepare(q, count=False)[0] for q in reqs]
    same = [inf for inf in infs if svc.pool.cache_key(inf) == key]
    same = (same * SAMPLE_MAX_BATCH)[:SAMPLE_MAX_BATCH]
    batch = Batch(key=key, requests=same, indices=list(range(len(same))),
                  created_at=0.0, cost=len(same) * request_cost(same[0]))
    prof = {}
    profile_call(torch, lambda: svc.pool.submit_batch(batch),
                 f"sampled batch of {len(same)} ({same[0].graph.name})",
                 split="HtoD", out=prof)

    # The same stream on an eager twin of the service (overlays of
    # Engine(replay=False)) holding the programs the service compiled, on
    # the same overlays (an eager overlay has nothing else to warm): its
    # logits equal the replayed ones bit for bit (lanes are independent,
    # whatever batches the flushes form).
    esvc = SamplingService(fl_raw, X, n_overlays=2, geometry=geom,
                           max_batch=SAMPLE_MAX_BATCH, replay=False)
    for e, src in zip(esvc.pool.engines, svc.pool.engines):
        for prog in src.cache.values():
            e.cache.put(prog.cache_key, prog)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        eresps = esvc.serve(reqs)
    finally:
        esvc.shutdown()
    ewall = time.perf_counter() - t0
    esnap = esvc.pool.metrics.snapshot(max_batch=SAMPLE_MAX_BATCH)["global"]
    for a, b in zip(resps, eresps):
        if not torch.equal(a.logits, b.logits):
            d = float((a.logits - b.logits).abs().max())
            fail(f"sampled {a.request_id}: replayed logits differ from the "
                 f"eager twin's by {d:.3e}")
    eprof = {}
    profile_call(torch, lambda: esvc.pool.submit_batch(batch),
                 f"sampled batch of {len(same)}, eager twin", split="HtoD",
                 out=eprof)
    log(f"sampled, eager twin: {len(eresps)} responses in {ewall:.3f} s "
        f"({len(eresps) / ewall:.2f} requests/s), p50 "
        f"{esnap['p50_latency_ms']:.3f} ms, p99 {esnap['p99_latency_ms']:.3f}"
        f" ms; replayed: {len(resps) / wall:.2f} requests/s, p50 "
        f"{snap['p50_latency_ms']:.3f} ms, p99 {snap['p99_latency_ms']:.3f} "
        "ms; logits bit for bit equal")
    del esvc
    return launches, {
        "eager": {"wall_s": ewall, "requests_per_s": len(eresps) / ewall,
                  "metrics": esnap, "profile": eprof},
        "wall_s": wall, "requests_per_s": len(resps) / wall,
        "hit_rate": hit_rate, "warmed_programs": n_prog, "metrics": snap,
        "buckets": census, "batches": len(batches),
        "h2d_bytes_per_batch": h2d, "tile_steps": steps,
        "launches": launches, "worst_err": worst, "bitwise": bitwise,
        "profile": prof}


def _report_line(label, rep) -> str:
    modes = ", ".join(f"{m} {rep.model_error[m]:.4f} -> "
                      f"{rep.model_error_calibrated[m]:.4f} (scale "
                      f"{rep.scales[m]:.4g})" for m in sorted(rep.model_error))
    return (f"conformance {label}: predicted {rep.predicted_s * 1e3:.4f} ms, "
            f"measured {rep.measured_s * 1e3:.4f} ms; model error "
            f"{rep.model_error_overall:.4f} -> "
            f"{rep.model_error_overall_calibrated:.4f} calibrated; per mode "
            f"{modes}")


def _checked_report(label, rep):
    for m, e in rep.model_error.items():
        if not rep.model_error_calibrated[m] <= e + 1e-12:
            fail(f"conformance {label}: calibrated error "
                 f"{rep.model_error_calibrated[m]} > uncalibrated {e} "
                 f"({m})")
    if rep.model_error_overall_calibrated > rep.model_error_overall + 1e-12:
        fail(f"conformance {label}: calibrated overall error above the "
             "uncalibrated one")
    log(_report_line(label, rep))
    return rep


def conformance_phase(torch, co, fl, card, budget, fl_remap):
    """Conformance reports on the card (b1-b8 on CO and b2@FL device-
    resident, b2@FL host-streamed under phase 4's budget), fitted
    constants, fit_stage_bw against the profiler's copy rate, and the
    remap decisions a fitted report makes on FL; see the module
    docstring.  Returns (launches of the reported runs, a summary)."""
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.perfmodel import DEFAULT_CONSTANTS
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.obs import build_report, fit_stage_bw, tracing

    out = {"co": {}, "card": card}
    launches = {k: 0 for k in ops.LAUNCHES}

    def counted(fn):
        ops.reset_launches()
        # ---- a reported run: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        # ----
        return y

    ceng = Engine()
    for name in BENCHMARKS:
        prog = ceng.compile(name, co, use_cache=False)
        x = G.random_features(co, seed=1)
        ceng.run(prog, x)                                  # warm
        counted(lambda: ceng.run(prog, x))
        rep = _checked_report(f"{name}@CO device",
                              build_report(prog, ceng.exec_stats))
        out["co"][name] = rep.to_dict()

    t0 = time.perf_counter()
    prog = ceng.compile("b2", fl, use_cache=False)
    log(f"conformance: b2@FL recompiled with its source in "
        f"{time.perf_counter() - t0:.2f} s")
    x = G.random_features(fl, seed=10)
    ceng.run(prog, x)                                      # uploads tiles
    y_dev = counted(lambda: ceng.run(prog, x))
    dev = _checked_report("b2@FL device", build_report(prog,
                                                       ceng.exec_stats))
    ceng.executor.resident_budget_bytes = budget
    y_host = ceng.run(prog, x, residency="host")           # pins tiles
    prof = {}
    with tracing() as t:
        profile_call(torch, lambda: counted(
            lambda: ceng.run(prog, x, residency="host")),
            "b2@FL host hit, traced", split="HtoD", out=prof)
    events = t.events()
    host_stats = ceng.exec_stats
    host = _checked_report("b2@FL host", build_report(
        prog, host_stats, residency="host", events=events))
    ceng.executor.resident_budget_bytes = None
    if not torch.equal(y_host, y_dev):
        fail("conformance: b2@FL host output differs from the device path")
    stages = [e for e in events if e.get("name") == "stage"]
    if not stages or any("copy_us" not in e["args"] for e in stages):
        fail("conformance: host stage spans without the copies' device "
             "time")
    bw = fit_stage_bw(events)
    host_dur_bw = sum(e["args"]["bytes"] ** 2 for e in stages) / sum(
        e["args"]["bytes"] * e["dur"] / 1e6 for e in stages)
    prof_bw = (host_stats.h2d_bytes / (prof["split_ms"] / 1e3)
               if prof.get("split_ms") else None)
    if prof_bw is None:
        fail("conformance: the profiler read no HtoD copies; the copy-"
             "engine rate was not measured")
    gap = abs(bw - prof_bw) / prof_bw
    log(f"conformance: fit_stage_bw {bw / 1e9:.3f} GB/s from {len(stages)} "
        f"stage spans' copy time, the profiler's copy-engine rate "
        f"{prof_bw / 1e9:.3f} GB/s ({host_stats.h2d_bytes} B over "
        f"{prof['split_ms']:.3f} ms of HtoD copies), {100 * gap:.2f}% apart;"
        f" the spans' host durations would fit {host_dur_bw / 1e9:.3f} GB/s"
        f" ({card})")
    if gap > 0.15:
        fail(f"conformance: fit_stage_bw {bw:.4g} B/s is {100 * gap:.1f}% "
             f"from the profiler's copy rate {prof_bw:.4g} B/s (limit 15%)")

    fitted = dict(dev.calibrated_constants, stage_bw=bw)
    for k, v in DEFAULT_CONSTANTS.to_dict().items():
        run = "b2@FL host stage spans" if k == "stage_bw" else "b2@FL device"
        got = f"{fitted[k]:.4g}" if k in fitted else "not fitted"
        log(f"  constant {k}: data sheet {v:.4g}, fitted {got} from {run} "
            f"({card})")
    rp = ceng.remap(prog, report=dev)
    rec = rp.manifest["remap"]
    log(f"conformance: remap of b2@FL priced by the fitted constants: counts "
        f"{rec['counts']}, predicted gain {rec['predicted_gain_s']:.6e} s; "
        f"by the H100 data sheet {fl_remap['h100-default']['counts']}, "
        f"by probe {fl_remap['probe']['counts']} (phase 4)")
    if rp.binary != prog.binary:
        y = ceng.run(rp, x)
        hold_against_reference(torch, [InferenceRequest("b2", fl, x)],
                               [_resp("b2@FL fitted remap", y)])
    out.update(fl_device=dev.to_dict(), fl_host=host.to_dict(),
               fitted_constants=fitted, fit_stage_bw=bw,
               profiler_copy_bw=prof_bw, stage_host_duration_bw=host_dur_bw,
               fitted_remap={"counts": rec["counts"],
                             "predicted_gain_s": rec["predicted_gain_s"]},
               host_profile=prof)
    return launches, out


# --------------------------------------------------------------------------- #
LIVE_GEOM = (4096, 128)         # (n1, n2): the compiler's pick for FL
# The compiler's pick for CO, n1 = 4096, puts it in one tile: the delta
# drains every tile the aggregate layers read (the rebind the verifier
# once refused).  Blocks of 1024 (3 x 3 tiles) keep GEMM tiles beside the
# drained one, so the rebound program runs the densify kernel.
LIVE_REMAP_GEOMS = ((4096, 128), (1024, 128))
LIVE_DELTA_EDGES = 32           # removals and additions of a content delta
LIVE_NEW_VERTICES = 1024        # the structural delta: one in-, one out-edge
LIVE_STREAM, LIVE_CUTS = 24, {8: 1, 16: 2}   # admission index -> version
HOST_ALIGN = 16                 # elements: a host buffer's slice alignment
# Bytes per element of each staged tile kind, and what it spans: the
# [n1, w] slots, one entry a row, or the live slots.
KIND_BYTES = {"cols": (4, "slots"), "vals": (4, "slots"),
              "mask": (1, "slots"), "row_len": (4, "rows"),
              "live_pos": (8, "nnz"), "live_epos": (8, "nnz")}


def kind_bytes(t, kind, align=1) -> int:
    """Bytes of an ELL slice's staged ``kind`` (its element count rounded
    up to ``align``), from the slice's shape and nnz alone."""
    item, over = KIND_BYTES[kind]
    n = {"slots": t.cols.size, "rows": t.cols.shape[0], "nnz": t.nnz}[over]
    return item * ((int(n) + align - 1) // align * align)


def live_delta(np, GraphDelta, version, seed):
    """A content delta on ``version``: LIVE_DELTA_EDGES removals of
    distinct existing (src, dst) pairs (drawn uniformly over the pairs; a
    pair's multi-edges go together), then as many additions between
    existing vertices, from ``seed``.  A draw that would change the tile
    structure (a new tile, or a slice more or less where a row crosses a
    multiple of the width cap) is not a content delta and is drawn again
    from (seed, attempt); returns (delta, attempt)."""
    g = version.as_graph()
    nv = g.n_vertices
    pairs = np.unique(g.src.astype(np.int64) * nv + g.dst)
    for attempt in range(16):
        rng = np.random.default_rng([seed, attempt])
        d = GraphDelta(nv)
        for p in rng.choice(pairs, LIVE_DELTA_EDGES, replace=False):
            d.remove_edge(int(p // nv), int(p % nv))
        for _ in range(LIVE_DELTA_EDGES):
            u, v = (int(a) for a in rng.integers(0, nv, 2))
            d.add_edge(u, v, float(rng.uniform(0.1, 1.0)))
        if not version.store.apply(d.coalesce())[1].structural_change:
            return d, attempt
    fail(f"live: no content delta in 16 draws from seed {seed}")


def structural_delta(np, GraphDelta, g, seed):
    """LIVE_NEW_VERTICES new vertices (zero features), each with one
    in-edge from and one out-edge to a random existing vertex."""
    rng = np.random.default_rng(seed)
    d = GraphDelta(g.n_vertices, feat_dim=g.feat_dim)
    for _ in range(LIVE_NEW_VERTICES):
        w = d.add_vertex()
        a, b = (int(v) for v in rng.integers(0, g.n_vertices, 2))
        d.add_edge(a, w, float(rng.uniform(0.1, 1.0)))
        d.add_edge(w, b, float(rng.uniform(0.1, 1.0)))
    return d


def host_rss() -> str:
    """This process's resident host memory, and its peak (getrusage)."""
    import resource
    rss = 0
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return (f"host RSS {rss / 2**30:.2f} GiB (peak {peak / 2**30:.2f} "
            "GiB)")


def patched_tiles(v):
    return [tuple(int(a) for a in k.split(":")) for k in v.stats.patched]


def live_phase(torch, card):
    """Live full-scale FL (``repro_torch.livegraph``) with verification on;
    see the module docstring.  Returns (launches of the live path, a
    summary)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.engine import (Engine, InferenceRequest,
                                    ResidentBudgetError)
    from repro_torch.engine.executor import (_host_tiles, _staged,
                                             release_staging)
    from repro_torch.kernels import ops
    from repro_torch.livegraph import (GraphDelta, GraphVersionStore,
                                       LiveGraphServer)
    from repro_torch.obs import tracing
    from repro_torch.runtime import OverlayPool, ServeLoop
    from repro_torch.verify import check_trace
    from repro_torch.verify.__main__ import main as verify_main

    out = {"card": card, "versions": {}}
    launches = {k: 0 for k in ops.LAUNCHES}

    def counted(fn):
        ops.reset_launches()
        # ---- a run of the live path: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        for k, n in ops.LAUNCHES.items():
            launches[k] += n
        # ----
        return y

    fl = G.synthesize("FL").gcn_normalized()
    geom = PartitionConfig(n1=LIVE_GEOM[0], n2=LIVE_GEOM[1])
    t0 = time.perf_counter()
    store = GraphVersionStore(fl, geometry=geom)
    log(f"live: tile store of FL built in {time.perf_counter() - t0:.2f} s "
        f"({len(store.head.pgraph.tiles)} tiles, "
        f"{sum(len(ts) for ts in store.head.pgraph.tiles.values())} slices, "
        f"{store.head.pgraph.tile_bytes()} B of ELL on the host); "
        + host_rss())
    pool = OverlayPool(2, geometry=geom, verify=True)
    eng = pool.engines[0]
    live = LiveGraphServer(store, metrics=pool.metrics)
    verify_s = []

    def timed_verify(e, idx):
        real = e._verify_program

        def run(prog):
            t = time.perf_counter()
            real(prog)
            verify_s.append((f"overlay {idx} {prog.model_name}"
                             f"@{prog.graph_name}",
                             time.perf_counter() - t))
        e._verify_program = run
    for idx, e in enumerate(pool.engines):
        timed_verify(e, idx)
    xs = [G.random_features(fl, seed=60 + i) for i in range(4)]

    def cold(model, gv, x):
        """The same graph as a plain Graph, cold-compiled and run on a
        second Engine (not counted: a comparison, not the live path)."""
        e = Engine(geometry=geom)
        p = e.compile(model, dataclasses.replace(gv, name=gv.name + "-cold"))
        y = e.run(p, x)
        release_staging(p.pgraph)
        del e, p
        gc.collect()
        return y

    def hold(label, model, gv, x, y):
        """y against the cold compile (bits) and float64 (tolerance)."""
        yc = cold(model, gv, x)
        if not torch.equal(y, yc):
            fail(f"live {label}: differs from a cold compile of the version "
                 f"by {float((y - yc).abs().max()):.3e}")
        worst = hold_against_reference(
            torch, [InferenceRequest(model, gv, x)], [_resp(label, y)])
        log(f"live {label}: bit-identical to a cold compile, within rtol "
            f"{PATH_RTOL} / atol {PATH_ATOL} of float64 (max|err| "
            f"{worst:.3e})")

    def serve(v, model, label, x):
        """A first pass and two hits of ``model`` on version ``v`` through
        Engine.submit (the program rebound to v's tiles)."""
        gv = v.as_graph()
        resps = [counted(lambda: eng.submit(InferenceRequest(
            model, gv, x, request_id=f"{label}#{i}"))) for i in range(3)]
        st = _staged(v.pgraph, eng.device)
        for r in resps[1:]:
            if not torch.equal(r.output, resps[0].output):
                fail(f"live {label}: a hit differs from the first pass")
        rec = {"t_loc_s": resps[0].t_loc, "cache_hit": resps[0].cache_hit,
               "first_t_loh_s": resps[0].t_loh,
               "hit_t_loh_s": [r.t_loh for r in resps[1:]],
               "uploaded": st.uploaded, "kinds": st.kinds()}
        log(f"live {label}: T_LoC {resps[0].t_loc * 1e3:.2f} ms (cache_hit "
            f"{resps[0].cache_hit}), first pass T_LoH "
            f"{resps[0].t_loh * 1e3:.2f} ms, hits "
            + ", ".join(f"{r.t_loh * 1e3:.2f}" for r in resps[1:])
            + f" ms; uploaded {st.uploaded} B ({', '.join(st.kinds())}); "
            + host_rss())
        return resps[0].output, rec

    def expect_uploaded(v, rec, kinds, label):
        want = v.pgraph.inv_in_degree.nbytes + sum(
            kind_bytes(t, kind) for jk in patched_tiles(v)
            for t in v.pgraph.tiles[jk] for kind in kinds)
        log(f"live {label}: {len(v.stats.patched)} of "
            f"{len(v.pgraph.tiles)} tiles patched "
            f"({v.stats.tiles_created} created); uploaded {rec['uploaded']} "
            f"B, the patched tiles' {', '.join(kinds)} plus inv_in_degree "
            f"{want} B (a full upload: {out['versions']['v0']['uploaded']} "
            "B)")
        if rec["uploaded"] != want:
            fail(f"live {label}: uploaded {rec['uploaded']} B != the patched "
                 f"tiles' {want} B")
        rec["uploaded_expected"] = want

    # ---- v0: the first compile, host-streamed under PR 16's budget ----- #
    v0 = store.head
    c0 = eng.stats.compiles
    y0, rec0 = serve(v0, "b2", "b2@FL v0", xs[0])
    out["versions"]["v0"] = rec0
    if rec0["cache_hit"] or eng.stats.compiles != c0 + 1:
        fail("live v0: expected one compile")
    kinds = rec0["kinds"]
    hold("b2@FL v0", "b2", v0.as_graph(), xs[0], y0)
    ex = eng.executor
    prog0 = eng.compile("b2", v0.as_graph())
    window = ex.estimate_host_window_bytes(prog0, xs[0].shape[1])
    weights = sum(int(w.nbytes) for w in prog0.weights.values())
    dev_peak = ex.estimate_device_peak_bytes(prog0, xs[0].shape[1])
    budget = (window + weights + dev_peak) // 2
    ex.resident_budget_bytes = budget
    try:
        eng.run(prog0, xs[0], residency="device")
    except ResidentBudgetError:
        pass
    else:
        fail("live: a device-resident run under the budget was not refused")
    ex.resident_budget_bytes = None

    def host_run(prog, v, label):
        """A host-streamed pass under the budget that refuses the device
        path."""
        ex.resident_budget_bytes = budget
        t = time.perf_counter()
        y = counted(lambda: eng.run(prog, xs[0], residency="host"))
        ex.resident_budget_bytes = None
        ht = _host_tiles(v.pgraph, eng.device.type == "cuda")
        log(f"live {label} host-streamed: T_LoH "
            f"{(time.perf_counter() - t) * 1e3:.2f} ms, pinned {ht.nbytes} "
            f"B for this version, h2d {eng.exec_stats.h2d_bytes} B; "
            + host_rss())
        return y, ht

    yh0, ht0 = host_run(prog0, v0, "b2@FL v0")
    if not torch.equal(yh0, y0):
        fail("live v0: the host path differs from the device path")
    host_kinds = sorted(ht0._rows)
    rec0["pinned"] = ht0.nbytes

    # ---- v1, v2: content deltas ---------------------------------------- #
    applied = []
    for seed in (1, 2):
        d, attempt = live_delta(np, GraphDelta, store.head, seed)
        t = time.perf_counter()
        applied.append((store.apply(d), time.perf_counter() - t, attempt))
    (v1, _, _), (v2, _, _) = applied
    for v, ta, attempt in applied:
        holes = v.store.eid_capacity - v.store.live_edges
        log(f"live v{v.vid}: delta (draw {attempt}) applied in {ta:.2f} s: "
            f"{json.dumps(v.stats.as_dict())}; {v.store.live_edges} live "
            f"edges, edge-id capacity {v.store.eid_capacity} ({holes} "
            "holes)")
        if v.stats.structural_change:
            fail(f"live v{v.vid}: a content delta changed the structure")
    for v in (v1, v2):
        c = eng.stats.compiles
        y, rec = serve(v, "b2", f"b2@FL v{v.vid}", xs[0])
        out["versions"][f"v{v.vid}"] = rec
        if not rec["cache_hit"] or rec["t_loc_s"] != 0.0 or \
                eng.stats.compiles != c:
            fail(f"live v{v.vid}: expected a cache hit with T_LoC 0 and no "
                 "compile")
        expect_uploaded(v, rec, kinds, f"b2@FL v{v.vid}")
        hold(f"b2@FL v{v.vid}", "b2", v.as_graph(), xs[0], y)
        if v is v1:
            y1 = y
    prog1 = eng.compile("b2", v1.as_graph())
    yh1, ht1 = host_run(prog1, v1, "b2@FL v1")
    if not torch.equal(yh1, y1):
        fail("live v1: the host path differs from the device path")
    rows = sorted({j for j, _ in patched_tiles(v1)})
    want = sum(kind_bytes(t, kind, HOST_ALIGN) for j in rows
               for (jj, _), ts in v1.pgraph.tiles.items() if jj == j
               for t in ts for kind in host_kinds)
    if ht1._inv_deg is not None:        # pinned only if a MEAN layer ran
        want += v1.pgraph.inv_in_degree.nbytes
    log(f"live b2@FL v1 host: pinned {ht1.nbytes} B for the {len(rows)} of "
        f"{v1.pgraph.n_blocks} shards that hold a patched tile "
        f"(expected {want} B; v0 pinned {ht0.nbytes} B)")
    if ht1.nbytes != want:
        fail(f"live v1: pinned {ht1.nbytes} B != {want} B")
    out["versions"]["v1"].update(pinned=ht1.nbytes, pinned_expected=want,
                                 pinned_shards=len(rows))
    ex.resident_budget_bytes = budget
    with tracing() as tr:
        counted(lambda: eng.run(prog1, xs[0], residency="host"))
    ex.resident_budget_bytes = None
    race = check_trace(tr.to_dict(), prog1)
    log(f"live b2@FL v1 traced host hit: check_trace overlap_pairs "
        f"{race.stats.get('overlap_pairs')}, {len(race.violations)} "
        f"violations, checks {race.checks_run} (spans are host issue "
        "times: issue order only)")
    if not race.ok:
        fail("live: race check failed: " + race.to_markdown())
    out["race"] = {"overlap_pairs": race.stats.get("overlap_pairs"),
                   "violations": len(race.violations)}

    gat = build_gat_dot(TB, fl)
    c = eng.stats.compiles
    t = time.perf_counter()
    gprog = eng.compile(gat, v1.as_graph())
    t_gc = time.perf_counter() - t
    t = time.perf_counter()
    yg = counted(lambda: eng.run(gprog, xs[0]))
    log(f"live gat-dot@FL v1: compiled and bound in {t_gc:.2f} s, a pass in "
        f"{(time.perf_counter() - t) * 1e3:.2f} ms, over "
        f"{v1.store.eid_capacity - v1.store.live_edges} edge-id holes")
    if eng.stats.compiles != c + 1:
        fail("live: gat-dot on v1 should compile once")
    hold("gat-dot@FL v1", gat, v1.as_graph(), xs[0], yg)

    # ---- the cutover stream --------------------------------------------- #
    solo = {}
    for v in (v0, v1, v2):
        p = eng.compile("b2", v.as_graph())
        for i, x in enumerate(xs):
            solo[(v.vid, i)] = counted(lambda: eng.run(p, x))
    compiles = sum(e.stats.compiles for e in pool.engines)
    held = {}
    for v in (v1, v2):
        st = _staged(v.pgraph, eng.device)
        held[v.vid] = (st.kinds(), set(st.kinds()) | st._reserved)
    v2_ids = {id(t) for ts in v2.pgraph.tiles.values() for t in ts}
    v1_free = sum(kind_bytes(t, kind) for ts in v1.pgraph.tiles.values()
                  for t in ts for kind in held[1][0]
                  if not (id(t) in v2_ids and kind in held[2][1]))
    v1_own = sum(kind_bytes(t, kind) for jk in patched_tiles(v1)
                 for t in v1.pgraph.tiles[jk] for kind in held[1][0])
    loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    expected = {}
    ops.reset_launches()
    # ---- the cutover stream: counts zeroed above, read below.
    t = time.perf_counter()
    try:
        for i in range(LIVE_STREAM):
            if i in LIVE_CUTS:
                live.cutover(v1 if LIVE_CUTS[i] == 1 else v2)
            rid = f"live#{i}"
            loop.submit(InferenceRequest("b2", live, xs[i % 4],
                                         request_id=rid))
            expected[rid] = (live.active.vid, i % 4)
        resps = loop.drain()
    finally:
        loop.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for k, n in ops.LAUNCHES.items():
        launches[k] += n
    # ---- end of the cutover stream.
    mem1 = torch.cuda.memory_allocated()
    outs = {r.output.untyped_storage().data_ptr():
            r.output.untyped_storage().nbytes() for r in resps}
    freed = mem0 - (mem1 - sum(outs.values()))
    by_rid = {r.request_id: r for r in resps}
    if sorted(by_rid) != sorted(expected):
        fail(f"live stream: {len(resps)} responses for {len(expected)} "
             "requests")
    for rid, (vid, fi) in expected.items():
        r = by_rid[rid]
        if not r.graph_name.endswith(f"@v{vid}"):
            fail(f"live stream: {rid} admitted on v{vid}, served on "
                 f"{r.graph_name}")
        if not torch.equal(r.output, solo[(vid, fi)]):
            fail(f"live stream: {rid} differs from a solo serve of v{vid}")
    if live.reclaimed != [0, 1] or \
            sum(e.stats.compiles for e in pool.engines) != compiles:
        fail(f"live stream: reclaimed {live.reclaimed}, compiles changed")
    log(f"live stream: {len(resps)} b2@FL requests, cutovers at admissions "
        f"{sorted(LIVE_CUTS)}, served in {wall:.2f} s; none dropped, each "
        "bit-identical to a solo serve of its pinned version; batches "
        + ", ".join(f"{r.request_id}:{r.batch_size}@{r.graph_name}"
                    for r in resps[::4]))
    log(f"live stream: device memory fell {freed} B when v0 and v1 were "
        f"reclaimed (outputs held: {sum(outs.values())} B); v1's copies no "
        f"live version holds: {v1_free} B (v1's own patched tiles: "
        f"{v1_own} B); " + host_rss())
    if freed < v1_free:
        fail(f"live: reclaiming v1 freed {freed} B < its {v1_free} B")
    lg = pool.metrics.snapshot(max_batch=4)["livegraph"]
    log("live metrics: " + json.dumps(lg))
    out["stream"] = {"wall_s": wall, "freed": freed, "v1_free": v1_free,
                     "v1_own_patched": v1_own, "livegraph": lg}

    # ---- v3: a structural delta; the exported bundle verified ---------- #
    t = time.perf_counter()
    v3 = live.apply(structural_delta(np, GraphDelta, v2.as_graph(), 3))
    log(f"live v3: structural delta applied in {time.perf_counter() - t:.2f}"
        f" s: {json.dumps(v3.stats.as_dict())}; {v3.pgraph.n_blocks} blocks")
    nb = -(-v3.n_vertices // geom.n1)
    if not v3.stats.structural_change or \
            not v3.pgraph.n_blocks == nb > v0.pgraph.n_blocks:
        fail(f"live v3: expected a structural change to {nb} blocks")
    x3 = G.random_features(v3.as_graph(), seed=64)
    export = tempfile.mkdtemp(prefix="gagi-export-")
    os.environ["GAGI_EXPORT_DIR"] = export
    c = eng.stats.compiles
    try:
        y3, rec3 = serve(v3, "b2", "b2@FL v3", x3)
    finally:
        del os.environ["GAGI_EXPORT_DIR"]
    out["versions"]["v3"] = rec3
    if rec3["cache_hit"] or eng.stats.compiles != c + 1:
        fail("live v3: expected a cache miss and one compile")
    expect_uploaded(v3, rec3, kinds, "b2@FL v3")
    hold("b2@FL v3", "b2", v3.as_graph(), x3, y3)
    t = time.perf_counter()
    rc = verify_main([export, "--json", os.path.join(export, "r.json")])
    log(f"live: python -m repro_torch.verify over {len(os.listdir(export))-1}"
        f" exported bundle(s): exit {rc} in {time.perf_counter() - t:.2f} s")
    shutil.rmtree(export)
    if rc != 0:
        fail(f"live: repro_torch.verify exited {rc}")

    # ---- densify: a forced-GEMM program rebound after a delta (CO) ------ #
    out["remap_rebind"] = [live_remap_rebind(torch, counted, g)
                           for g in LIVE_REMAP_GEOMS]

    log("live: verification times: " + ", ".join(
        f"{label} {s * 1e3:.1f} ms" for label, s in verify_s))
    out["verify_s"] = verify_s
    log(f"live phase launches: {launches}")
    for k in ("gemm", "spdmm", "sddmm", "densify"):
        if not launches[k] > 0:
            fail(f"live: {k} was not launched on the live path")
    del store, live, pool, eng, v0, v1, v2, v3, prog0, prog1, gprog
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def live_remap_rebind(torch, counted, geometry):
    """b1 on a live CO graph remapped with force="gemm", then a delta that
    drains the smallest tile and, when there is another, adds an edge to
    the largest: the rebind (verified) re-prices only the patched tiles
    (the drained one becomes skip), the binary differs only in their
    words, and the rebound program runs device-resident and host-streamed
    with the same bits, within the float64 tolerance (on the densify and
    GEMM kernels where a tile stays GEMM)."""
    import numpy as np

    from repro_torch.core import graph as G
    from repro_torch.core.isa import HEADER_BYTES, Instr
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.core.passes.remap import _scan_groups
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.livegraph import GraphDelta, GraphVersionStore

    co = G.synthesize("CO").gcn_normalized()
    geom = PartitionConfig(n1=geometry[0], n2=geometry[1])
    store = GraphVersionStore(co, geometry=geom)
    eng = Engine(geometry=geom, verify=True)
    prog = eng.compile("b1", store.head.as_graph())
    rp0 = eng.remap(prog, force="gemm")
    s0 = store.head.store
    jk_empty = min(s0.edges, key=lambda k: s0.edges[k].n)
    jk_big = max(s0.edges, key=lambda k: s0.edges[k].n)
    d = GraphDelta(co.n_vertices)
    te = s0.edges[jk_empty]
    for u, w in sorted(set(zip(te.src.tolist(), te.dst.tolist()))):
        d.remove_edge(u, w)             # a pair's multi-edges go together
    if jk_big != jk_empty:
        o = s0.edges[jk_big]
        d.add_edge(int(o.src[0]), int(o.dst[0]), 0.5)
    v1 = store.apply(d)
    patched = set(v1.stats.patched)
    p1 = eng.compile("b1", v1.as_graph())
    rec = p1.manifest["remap"]
    if rec["tiles"][f"{jk_empty[0]}:{jk_empty[1]}"]["mode"] != "skip":
        fail("live remap: the drained tile was not re-priced to skip")
    kept = [jk for jk, e in rec["tiles"].items()
            if jk not in patched and e != rp0.manifest["remap"]["tiles"][jk]]
    words = [np.frombuffer(b, "<u4", offset=HEADER_BYTES).reshape(-1, 4)
             for b in (rp0.binary, p1.binary)]
    owner = {}
    for grp in _scan_groups([Instr.decode(w) for w in words[0]]):
        for idx in (grp.compute, *grp.mem):
            owner[idx] = f"{grp.j}:{grp.k}"
    stray = [r for r in np.nonzero((words[0] != words[1]).any(axis=1))[0]
             if owner.get(int(r)) not in patched]
    if kept or stray:
        fail(f"live remap: untouched tiles re-priced {kept} or words changed "
             f"outside the patched tiles {stray[:4]}")
    x = G.random_features(co, seed=1)
    y = counted(lambda: eng.run(p1, x))
    st = eng.exec_stats
    yh = counted(lambda: eng.run(p1, x, residency="host"))
    if not torch.equal(y, yh):
        fail("live remap: host and device runs of the rebound program "
             "differ")
    worst = hold_against_reference(
        torch, [InferenceRequest("b1", v1.as_graph(), x)],
        [_resp("b1@CO live remap", y)])
    log(f"live remap: b1@CO (n1={geom.n1}) forced GEMM, rebound and "
        f"verified after a delta patching "
        f"{sorted(patched)}: counts {rec['counts']}, {st.tiles_remapped} "
        f"GEMM steps and {st.tiles_skipped} skipped a pass, host = device "
        f"bits, max|err| {worst:.3e} against float64")
    return {"patched": sorted(patched), "counts": rec["counts"],
            "tiles_remapped": st.tiles_remapped,
            "tiles_skipped": st.tiles_skipped}


# --------------------------------------------------------------------------- #
MESH_CO_DEVICES = (2, 3, 4)     # virtual shards of the card, b1-b8 on CO
MESH_FL_DEVICES = 4             # b2 and gat-dot on full-scale FL
MESH_LANES = 3                  # run_batch lanes on the mesh
MESH_LIVE_GEOM = (1024, 128)    # live CO on the mesh: 3 x 3 tiles


def mesh_phase(torch, card):
    """The placement-scheduled multi-device path on virtual shards of the
    card (``DeviceMesh([cuda:0] * D)``); see the module docstring.
    Returns (launches of the mesh path, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.engine.executor import _staged
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh, make_device_mesh
    from repro_torch.livegraph import (GraphDelta, GraphVersionStore,
                                       LiveGraphServer)
    from repro_torch.obs import build_report, tracing
    from repro_torch.verify import check_trace

    out = {"card": card, "co": {}, "fl": {}}
    launches = {k: 0 for k in ops.LAUNCHES}
    eng = Engine()
    dev0 = DeviceMesh([eng.device]).devices[0]      # cuda:<current>

    def mesh(d):
        return DeviceMesh([dev0] * d)

    def counted(fn):
        ops.reset_launches()
        # ---- a run of the mesh path: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        # ----
        for k, n in got.items():
            launches[k] += n
        return y, got

    def expect(label, got, want, passes=1):
        for k in ("gemm", "spdmm", "sddmm"):
            if got[k] != passes * want[k]:
                fail(f"mesh {label}: {k} launches {got[k]} != {passes} x "
                     f"{want[k]} tile ops")

    def same(label, got, want):
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            fail(f"mesh {label}: differs from the device path (max|d| "
                 f"{err:.3e})")

    co = G.synthesize("CO").gcn_normalized()
    fl = G.synthesize("FL").gcn_normalized()
    t0 = time.perf_counter()
    for name in BENCHMARKS:
        prog = eng.compile(name, co, mesh=max(MESH_CO_DEVICES))
        x = G.random_features(co, seed=1)
        y = eng.run(prog, x)
        dev_ops = eng.exec_stats.tile_ops
        rec = {}
        for d in MESH_CO_DEVICES:
            ym, got = counted(lambda: eng.run(prog, x, mesh=mesh(d)))
            st = eng.exec_stats
            same(f"{name}@CO D={d}", ym, y)
            expect(f"{name}@CO D={d}", got, plan_tile_ops(prog))
            if sum(r["tile_ops"] for r in st.per_device) != dev_ops:
                fail(f"mesh {name}@CO D={d}: per-device tile ops "
                     f"{[r['tile_ops'] for r in st.per_device]} do not sum "
                     f"to the device path's {dev_ops}")
            rec[d] = {"halo_gather_bytes": st.halo_gather_bytes,
                      "halo_bytes": st.halo_bytes,
                      "device_imbalance": st.device_imbalance}
        out["co"][name] = rec
    log(f"mesh: b1-b8 on CO at D = {MESH_CO_DEVICES} virtual shards of "
        f"{dev0}, each bit for bit the device path, launches equal to the "
        f"tile ops ({time.perf_counter() - t0:.1f} s)")

    # b2 and gat-dot on full-scale FL at D = 4: a mesh miss (compile and
    # the tile upload) and two hits, then the device path on the same
    # (shared) tiles.
    fl_progs = {}
    for label in ("b2", "gat-dot"):
        model = "b2" if label == "b2" else build_gat_dot(TB, fl)
        x = G.random_features(fl, seed=20)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        prog = eng.compile(model, fl, mesh=MESH_FL_DEVICES)
        t_loc = time.perf_counter() - t0
        fl_progs[label] = (prog, model, x)
        walls, ys, dev_walls = [], [], []
        # The mesh miss, then hits of the two paths in turns (device,
        # mesh, mesh, device, twice), so that both see the same host.
        for which in ("mesh",) + ("device", "mesh", "mesh", "device") * 2:
            t0 = time.perf_counter()
            if which == "mesh":
                ym, got = counted(lambda: eng.run(
                    prog, x, mesh=mesh(MESH_FL_DEVICES)))
                walls.append((time.perf_counter() - t0) * 1e3)
                ys.append(ym)
                st = eng.exec_stats
                expect(f"{label}@FL", got, plan_tile_ops(prog))
                if len(walls) == 1:
                    staged = torch.cuda.memory_allocated() - mem0
            else:
                y = eng.run(prog, x)
                torch.cuda.synchronize()
                dev_walls.append((time.perf_counter() - t0) * 1e3)
                dev_ops = eng.exec_stats.tile_ops
                dev_layers = [r["wall_s"] * 1e3
                              for r in eng.exec_stats.per_layer]
        for i, ym in enumerate(ys):
            same(f"{label}@FL run {i}", ym, y)
        # The device path's staging shares the virtual shards' tile
        # copies: it uploaded its inverse in-degree and nothing else.
        full = _staged(prog.pgraph, eng.device)
        if full.uploaded != full.inv_deg.numel() * 4:
            fail(f"mesh {label}@FL: the device path uploaded "
                 f"{full.uploaded} B beside the shards' copies")
        pl = prog.manifest["placement"]
        if sum(r["tile_ops"] for r in st.per_device) != dev_ops:
            fail(f"mesh {label}@FL: per-device tile ops do not sum to the "
                 f"device path's {dev_ops}")
        if st.halo_bytes != pl["halo_bytes_total"]:
            fail(f"mesh {label}@FL: halo_bytes {st.halo_bytes} != the "
                 f"manifest's {pl['halo_bytes_total']}")
        worst = hold_against_reference(
            torch, [InferenceRequest(model, fl, x)],
            [_resp(f"{label}@FL mesh D={MESH_FL_DEVICES}", ys[-1])])
        layers = [(r["layer"], r["kernel"], r["halo_gather_bytes"],
                   r["wall_s"] * 1e3) for r in st.per_layer]
        log(f"mesh {label}@FL D={MESH_FL_DEVICES}: T_LoC {t_loc:.2f} s; "
            f"mesh passes (the miss, then hits) "
            f"{', '.join(f'{w:.2f}' for w in walls)} ms; device-path hits "
            f"on the same tiles, in turns with the mesh's "
            f"{', '.join(f'{w:.2f}' for w in dev_walls)} ms;"
            f" {staged} B staged by the mesh miss; halo_gather_bytes "
            f"{st.halo_gather_bytes}, halo_bytes (placement estimate) "
            f"{st.halo_bytes}, device_imbalance {st.device_imbalance:.4f}, "
            f"peak_device_bytes {st.peak_device_bytes}; per device "
            f"{st.per_device}; max|err| {worst:.3e} against float64")
        log(f"  mesh {label}@FL per layer of the last mesh hit (id, "
            "kernel, halo_gather_bytes, CUDA-event ms; the last device-path"
            " hit's ms): " + ", ".join(
                f"L{a}:{k}:{b}:{ms:.3f}:{dms:.3f}"
                for (a, k, b, ms), dms in zip(layers, dev_layers)))
        out["fl"][label] = {
            "t_loc_s": t_loc, "mesh_ms": walls, "device_ms": dev_walls,
            "device_layer_ms": dev_layers,
            "staged_bytes": staged,
            "halo_gather_bytes": st.halo_gather_bytes,
            "halo_bytes": st.halo_bytes,
            "device_imbalance": st.device_imbalance,
            "peak_device_bytes": st.peak_device_bytes,
            "per_device": st.per_device, "per_layer": layers,
            "max_abs_err": worst}

    # run_batch of lanes on the mesh, each lane equal to its solo run.
    prog, model, x = fl_progs["b2"]
    xs = np.stack([G.random_features(fl, seed=30 + i)
                   for i in range(MESH_LANES)])
    t0 = time.perf_counter()
    ys, got = counted(lambda: eng.run_batch(prog, xs,
                                            mesh=mesh(MESH_FL_DEVICES)))
    batch_ms = (time.perf_counter() - t0) * 1e3
    expect("b2@FL batch", got, plan_tile_ops(prog), passes=MESH_LANES)
    if eng.exec_stats.runs != 1:
        fail("mesh batch: stats do not merge the lanes into one pass")
    for i in range(MESH_LANES):
        solo, _ = counted(lambda: eng.run(prog, xs[i],
                                          mesh=mesh(MESH_FL_DEVICES)))
        same(f"b2@FL lane {i}", ys[i], solo)
    log(f"mesh: run_batch of {MESH_LANES} b2@FL lanes in {batch_ms:.2f} ms,"
        " each lane bit for bit its solo run")

    # A traced mesh hit: the race detector and the conformance report's
    # halo section (the miss's program carries its source).
    with tracing() as tr:
        counted(lambda: eng.run(prog, x, mesh=mesh(MESH_FL_DEVICES)))
    trace = tr.to_dict()
    rep = check_trace(trace, prog)
    if not rep.ok:
        fail(f"mesh: check_trace over a traced b2@FL hit: "
             f"{rep.to_markdown()}")
    halos = [e for e in trace["traceEvents"]
             if e.get("name") == "halo_exchange"]
    report = build_report(prog, eng.exec_stats, events=tr.events())
    if report.halo is None or report.halo["gathered_bytes"] != \
            eng.exec_stats.halo_gather_bytes:
        fail(f"mesh: build_report's halo section {report.halo}")
    copy_us = [e["args"].get("copy_us") for e in halos]
    log(f"mesh: check_trace over a traced b2@FL hit: 0 violations "
        f"({', '.join(rep.checks_run)} ran); {len(halos)} halo_exchange "
        f"spans, copy_us {copy_us}; build_report halo section "
        f"{report.halo}")
    out["trace"] = {"checks_run": rep.checks_run, "halo_spans": len(halos),
                    "copy_us": copy_us, "halo": report.halo}

    # A forced-GEMM remap of b1 on CO at D = 2 (densify on the mesh).
    rp = eng.remap(eng.compile("b1", co), force="gemm")
    x = G.random_features(co, seed=1)
    y = eng.run(rp, x)
    ym, got = counted(lambda: eng.run(rp, x, mesh=mesh(2)))
    same("remapped b1@CO D=2", ym, y)
    st = eng.exec_stats
    if not (got["densify"] > 0 and got["gemm"] == st.tile_ops_by_mode[
            "gemm"] and st.tiles_remapped == rp.manifest["remap"][
                "remapped_ops"] > 0):
        fail(f"mesh remap: launches {got}, tiles_remapped "
             f"{st.tiles_remapped}")
    log(f"mesh: forced-GEMM b1@CO at D=2: {st.tiles_remapped} GEMM steps, "
        f"launches {got}, bit for bit the device path")
    del eng, rp, fl_progs, prog, model, ys, xs
    gc.collect()
    torch.cuda.empty_cache()

    # A live CO version after a content delta, on the mesh.
    geom = PartitionConfig(n1=MESH_LIVE_GEOM[0], n2=MESH_LIVE_GEOM[1])
    store = GraphVersionStore(co, geometry=geom)
    live = LiveGraphServer(store)
    leng = Engine(geometry=geom, verify=True)
    leng.compile("b2", live, mesh=2)
    d, attempt = live_delta(np, GraphDelta, store.head, seed=5)
    live.apply(d)
    x = G.random_features(co, seed=4)
    prog = leng.compile("b2", live, mesh=2)
    ym, got = counted(lambda: leng.run(prog, x, mesh=mesh(2), graph=live))
    if leng.stats.compiles != 1:
        fail("mesh live: a content delta recompiled")
    g1 = store.head.as_graph()
    cold = Engine(geometry=geom)
    yc = cold.run(cold.compile("b2", dataclasses.replace(g1, name="cold")),
                  x)
    same("live b2@CO v1 D=2 (against a cold compile)", ym, yc)
    worst = hold_against_reference(torch, [InferenceRequest("b2", g1, x)],
                                   [_resp("b2@CO live v1 mesh", ym)])
    log(f"mesh: live CO v1 (content delta, draw {attempt}) on D=2: a cache "
        f"hit, bit for bit a cold compile, max|err| {worst:.3e} against "
        f"float64; launches {got}")
    del leng, cold, live, store

    # Distinct cards, where the machine has them.
    n_cards = torch.cuda.device_count()
    out["distinct_card_runs"] = 0
    if n_cards > 1:
        d = min(MESH_FL_DEVICES, n_cards)
        deng = Engine()
        prog = deng.compile("b2", fl, mesh=d)
        x = G.random_features(fl, seed=20)
        y = deng.run(prog, x)
        ym, _ = counted(lambda: deng.run(prog, x,
                                         mesh=make_device_mesh(d)))
        same(f"b2@FL on {d} distinct cards", ym.to(y.device), y)
        out["distinct_card_runs"] = 1
        del deng, prog
    log(f"mesh: the distinct-card path ran {out['distinct_card_runs']} "
        f"time(s) ({n_cards} card(s) on this machine)")
    log("mesh: launches on the mesh path: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    out["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


# --------------------------------------------------------------------------- #
GRANITE_ARCH = "granite-8b"
GRANITE_B, GRANITE_T = 4, 2048
GRANITE_DECODE_LAYERS = 4       # the fp32 witness: weights near 5 GB


@tallied_as("checks")
def flash_at_shape(torch, ops, ref, cfg, b, t, label, window=0):
    """The flash kernel at ``cfg``'s attention shape for b sequences of
    t tokens (bf16, causal, under ``window`` when > 0; random q / k / v
    from seed 5): held to its plain version by ``check_rows``, timed
    beside the plain version and SDPA (with a boolean mask under a
    window), with its bound.  Returns its row for the ``PERF.md``
    table."""
    bh, kvh, d = b * cfg.n_heads, b * cfg.n_kv_heads, cfg.hd
    g = bh // kvh
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(bh, t, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(kvh, t, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    name = f"flash {label} BH={bh} KV heads={kvh} G={g}"
    body = ops.flash_body(torch.bfloat16, d, d)
    got = ops.flash_attention(q, k, v, True, window)
    want = ref.flash_attention_plain(q, k, v, True, window)
    r_whole, r_row = check_rows(torch, name, got, want)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(ops.flash_attention(q, k, v, True, window), got):
        fail(f"{name}: two launches differ")
    del got, want
    t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, True,
                                                       window))
    t_p = median_ms(torch, lambda: ref.flash_attention_plain(
        q, k, v, True, window), reps=3, launches=3)
    lib, how = sdpa_yardstick(torch, q, k, v, window)
    t_l = median_ms(torch, lib)
    b_ms, b_by = flash_bound(bh, t, t, d, True, 2, PEAK_BF16_FLOP_S,
                             kv_heads=kvh, window=window)
    log(f"kernel flash_attention {name} T={t} d={d} causal window={window} "
        f"bf16 ({body} body): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"F.scaled_dot_product_attention ({how}) {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); relative L2 {r_whole:.3e} whole, "
        f"{r_row:.3e} worst row, max|err| {err:.2e}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": f"BH={bh} over {kvh} KV heads, T={t}, d={d}, bf16, "
                     "causal" + (f", window {window}" if window else ""),
            "body": body, "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "library": how, "rel_l2_whole": r_whole,
            "rel_l2_worst_row": r_row}


def granite_phase(torch, ops, ref):
    """granite-8b at full width: the flash kernel at its prefill shape
    (GQA group 4), the bf16 prefill of all 36 layers against plain
    attention, the fp32 decode witness at 4 layers, and ``launch.serve``;
    see the module docstring.  Returns (flash launches over the counted
    runs, the flash kernel's row at the granite shape, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.steps import build_model

    cfg = get_config(GRANITE_ARCH)
    flash_row = flash_at_shape(torch, ops, ref, cfg, GRANITE_B, GRANITE_T,
                               "granite prefill shape")

    n_flash, pre = lm_prefill(torch, ops, ref, cfg, GRANITE_B, GRANITE_T,
                              seed=1, timed=2)
    rng = np.random.default_rng(2)

    # fp32 decode against forward at full width, 4 layers.
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=GRANITE_DECODE_LAYERS)
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DECODE_B, DECODE_T)
                                        ).astype(np.int32), device="cuda")
    ops.reset_launches()
    # ---- the granite forward run: counts zeroed above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the granite forward run.
    if fwd_launches != cfg32.n_layers:
        fail(f"granite forward: flash launches {fwd_launches} != "
             f"{cfg32.n_layers}")
    cache = model.init_cache(DECODE_B, DECODE_T)
    worst, scale = 0.0, float(fwd.abs().max())
    t0 = time.perf_counter()
    for i in range(DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        worst = max(worst, float((lg[:, 0] - fwd[:, i]).abs().max()))
    log(f"granite decode against forward, fp32, {cfg32.n_layers} layers, "
        f"B={DECODE_B} T={DECODE_T}: max |decode - forward| / max |forward|"
        f" = {worst / scale:.3e} (limit {DECODE_TOL}; "
        f"{time.perf_counter() - t0:.2f} s)")
    if not worst / scale < DECODE_TOL:
        fail(f"granite decode differs from forward by {worst / scale:.3e}")
    del model, fwd, cache, lg
    gc.collect()
    torch.cuda.empty_cache()

    # The serving loop at granite-8b: 4 requests of 16 tokens.
    srv = drive_serve(torch, GRANITE_ARCH, "granite")
    summary = {**pre, "decode_vs_forward": worst / scale,
               "serve_prefill_ms": srv[0],
               "serve_decode_ms_per_token": srv[1],
               "flash_granite_shape": flash_row}
    return n_flash + fwd_launches, flash_row, summary


GEMMA_ARCH, GEMMA_27B = "gemma3-12b", "gemma3-27b"
GEMMA_B, GEMMA_T = 4, 2048
GEMMA_DECODE_LAYERS = 6         # one superblock: 5 windowed, 1 global
GEMMA_DECODE_T = 1088           # past the window of 1024: the rings wrap
GEMMA_27B_LAYERS = 8            # the 2-layer rem segment + a superblock


def decode_pair(torch, model, cfg, b, plen, gen, label):
    """``launch.serve.generate`` on ``model`` for b prompts of ``plen``
    tokens (numpy seed 7) and ``gen`` generated, eagerly and with the
    serve step captured as a CUDA graph, in turns (eager, captured,
    captured, eager): every generated token of the captured runs equals
    the eager runs', and each mode's ms/token (the decode's wall time
    over gen - 1 steps, synchronized) is printed.  Then one step of each,
    the captured one a replay, under the profiler (busy share)."""
    import numpy as np

    from repro_torch.launch import serve

    prompts = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32), device="cuda")
    ms = {"eager": [], "captured": []}
    toks = {}
    for mode in ("eager", "captured", "captured", "eager"):
        got, _, t_dec = serve.generate(model, cfg, prompts, gen,
                                       capture=mode == "captured")
        ms[mode].append(t_dec / (gen - 1) * 1e3)
        if mode in toks and not torch.equal(toks[mode], got):
            fail(f"{label}: two {mode} decodes generated different tokens")
        toks[mode] = got
    if not torch.equal(toks["eager"], toks["captured"]):
        n = int((toks["eager"] != toks["captured"]).sum())
        fail(f"{label}: the captured decode differs from the eager one in "
             f"{n} of {toks['eager'].numel()} tokens")
    log(f"{label} decode, {b} requests, prompt {plen}, {gen} tokens: "
        f"eager {[round(x, 2) for x in ms['eager']]} ms/token, captured "
        f"{[round(x, 2) for x in ms['captured']]} ms/token; the "
        f"{toks['eager'].numel()} generated tokens equal token for token")
    prof = {}
    for mode in ("eager", "captured"):
        step = serve.Step(model, cfg, model,
                          model.init_cache(b, plen + gen), b,
                          capture=mode == "captured")
        tok = prompts[:, :1]
        for p in range(3):                  # eager, capture, replay
            tok = step(tok, p)
        prof[mode] = {}
        profile_call(torch, lambda: step(tok, 3),
                     f"{label} decode step, {mode}", out=prof[mode])
        del step
        if "busy_ms" in prof[mode]:
            share = prof[mode]["busy_ms"] / statistics.median(ms[mode])
            prof[mode]["busy_over_unprofiled"] = share
            log(f"{label} decode step, {mode}: device busy "
                f"{prof[mode]['busy_ms']:.2f} ms over the unprofiled "
                f"{statistics.median(ms[mode]):.2f} ms/token: "
                f"{100 * share:.1f}%")
    return {"ms_per_token": ms, "profile": prof}


@contextlib.contextmanager
def flash_modes(ops):
    """While open, each ``ops.flash_attention`` call is tallied by mode
    in the yielded dict ("causal" / "non_causal") and then made as it
    was; the launches themselves count in ``ops.LAUNCHES`` as ever."""
    modes = {"causal": 0, "non_causal": 0}
    real = ops.flash_attention

    def tally(q, k, v, causal=True, window=0):
        modes["causal" if causal else "non_causal"] += 1
        return real(q, k, v, causal, window)
    with attention_as(ops, tally):
        yield modes


def lm_prefill(torch, ops, ref, cfg, b, t, seed, timed, profile=False,
               then=None, extra=None, tokens_key="tokens", per_prefill=None,
               hold=True, model_kw=None):
    """A bf16 prefill of ``cfg`` at b x t (``batch[tokens_key]`` from
    numpy ``seed``, plus the tensors of ``extra``: vision tokens or audio
    frames) with random weights from seed 0: a warm-up and ``timed`` timed
    runs with the flash launches counted from zero (``per_prefill`` a run,
    ``cfg.n_layers`` when None; tallied by mode under "modes"), the
    last-position logits within LM_REL_L2 of the same model with plain
    attention (with ``hold`` off, for a model whose bf16 rounding alone
    moves its logits further, reported beside the reading of
    ``_sdpa_chunked`` attention, a route with no kernel, and held by the
    caller in fp32), and with ``profile`` one more prefill under
    ``torch.profiler``; ``then(model)`` runs last, its dict in the summary
    under "then".  ``model_kw`` goes to ``build_model`` (a MoE model's
    ``moe_impl`` and ``mesh``).  Returns (flash launches, summary)."""
    import numpy as np

    from repro_torch.models.steps import build_model, make_prefill_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, **(model_kw or {}))
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    w_bytes = torch.cuda.memory_allocated() - base
    log(f"{cfg.name} ({cfg.n_layers} layers): {n_par:,} parameters, "
        f"{w_bytes / 2**30:.2f} GiB in {cfg.dtype}, built from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32), device="cuda")
    prefill = make_prefill_step(model, cfg)
    batch = {tokens_key: tokens, **(extra or {})}
    per = cfg.n_layers if per_prefill is None else per_prefill
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the prefill path: counts zeroed above, read below.
    walls = []
    with flash_modes(ops) as modes:
        for _ in range(1 + timed):           # a warm-up, then the timed
            t0 = time.perf_counter()
            logits = prefill(model, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the prefill path.
    if n_flash != per * len(walls) or sum(modes.values()) != n_flash:
        fail(f"{cfg.name}: flash launches {n_flash} over {len(walls)} "
             f"prefills != {per} per prefill (calls by mode {modes})")
    if tuple(logits.shape) != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{cfg.name} prefill logits: shape {tuple(logits.shape)} or "
             "non-finite")
    with attention_as(ops, ref.flash_attention_plain):
        want = prefill(model, batch)
    got32, want32 = logits.float(), want.float()
    rel = float((got32 - want32).norm() / want32.norm())
    agree = float((got32.argmax(-1) == want32.argmax(-1)).float().mean())
    rel_wit = None
    if not hold:
        with attention_as(ops, chunked_attention):
            wit = prefill(model, batch).float()
        rel_wit = float((wit - want32).norm() / want32.norm())
        del wit
    med = statistics.median(walls[1:])
    flops = 2.0 * cfg.n_params() * b * t
    log(f"{cfg.name} prefill {b}x{t}: wall ms "
        f"{[round(w, 2) for w in walls]} (first is the warm-up), median "
        f"{med:.2f} ms, {b * t / med * 1e3:,.0f} tokens/s "
        f"({flops:.3e} flops of weight products); peak memory "
        f"{peak / 2**30:.3f} GiB (weights included); flash launches "
        f"{n_flash} {modes}; logits against plain attention: relative L2 "
        f"{rel:.3e} (limit {LM_REL_L2}" + ("" if hold else
                                           ", not held in bf16: _sdpa_chunked "
                                           f"attention reads {rel_wit:.3e}")
        + f"), argmax agreement {agree:.3f}")
    if hold and not rel <= LM_REL_L2:
        fail(f"{cfg.name} prefill logits differ from plain attention by "
             f"relative L2 {rel:.3e}")
    flash_dev = None
    if profile:
        by_name = profile_call(torch, lambda: prefill(model, batch),
                               f"{cfg.name} prefill {b}x{t}")
        if by_name:
            flash_dev = sum(ms for n, ms in by_name.items()
                            if FLASH_BF16 in n)
            dev = sum(by_name.values())
            log(f"{cfg.name}: flash kernel device time in the profiled "
                f"prefill {flash_dev:.3f} ms of {dev:.3f} ms of device time "
                f"({100 * flash_dev / dev:.1f}%); device time over the "
                f"unprofiled median wall: {100 * dev / med:.1f}%")
    del logits, want, prefill, got32, want32, batch
    after = then(model) if then is not None else None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return n_flash, {"params": n_par, "weight_bytes": w_bytes,
                     "then": after, "modes": modes,
                     "prefill_ms": walls, "prefill_median_ms": med,
                     "tokens_per_s": b * t / med * 1e3,
                     "weight_product_flops": flops,
                     "prefill_peak_bytes": peak, "prefill_rel_l2": rel,
                     "prefill_rel_l2_sdpa_chunked": rel_wit,
                     "prefill_argmax_agreement": agree,
                     "flash_device_ms_in_profiled_prefill": flash_dev}


def gemma3_phase(torch, ops, ref):
    """gemma3-12b at full width (48 layers: 40 windowed of 1024, 8 global,
    d = 240) prefilled in bf16 against plain attention; its fp32 decode
    against forward at 6 layers past the window (ring buffers wrap);
    ``launch.serve --arch gemma3-12b``; gemma3-27b (d = 168) at 8 layers
    against plain attention.  Returns (flash launches over the counted
    runs, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.steps import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GEMMA_ARCH)
    n12, s12 = lm_prefill(
        torch, ops, ref, cfg, GEMMA_B, GEMMA_T, seed=1, timed=2,
        profile=True, then=lambda m: decode_pair(torch, m, cfg, 4, 16, 16,
                                                 cfg.name))

    # fp32 decode against forward at full width, one superblock, past the
    # window: every local layer's ring buffer of 1024 slots wraps.
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=GEMMA_DECODE_LAYERS)
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (DECODE_B, GEMMA_DECODE_T)).astype(np.int32),
        device="cuda")
    ops.reset_launches()
    # ---- the gemma3 forward run: counts zeroed above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the gemma3 forward run.
    if fwd_launches != cfg32.n_layers:
        fail(f"gemma3 forward: flash launches {fwd_launches} != "
             f"{cfg32.n_layers}")
    cache = model.init_cache(DECODE_B, GEMMA_DECODE_T)
    slots = sorted({lc["k"].shape[1] for lc in cache})
    if slots != [cfg.local_window, GEMMA_DECODE_T]:
        fail(f"gemma3 cache slots {slots}, expected ring buffers of "
             f"{cfg.local_window} and full caches of {GEMMA_DECODE_T}")
    t0 = time.perf_counter()
    errs = []
    for i in range(GEMMA_DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        errs.append((lg[:, 0] - fwd[:, i]).abs().amax())
    worst = float(torch.stack(errs).max()) / float(fwd.abs().max())
    dec_s = time.perf_counter() - t0
    log(f"gemma3 decode against forward, fp32, {cfg32.n_layers} layers, "
        f"B={DECODE_B} T={GEMMA_DECODE_T} (rings of {cfg.local_window} "
        f"slots wrap): max |decode - forward| / max |forward| = "
        f"{worst:.3e} (limit {DECODE_TOL}; {dec_s:.2f} s)")
    if not worst < DECODE_TOL:
        fail(f"gemma3 decode differs from forward by {worst:.3e}")
    del model, fwd, cache, lg, errs
    gc.collect()
    torch.cuda.empty_cache()

    # The serving loop at gemma3-12b: 4 requests of 16 tokens.
    srv = drive_serve(torch, GEMMA_ARCH, "gemma3")

    cfg27 = dataclasses.replace(get_config(GEMMA_27B),
                                n_layers=GEMMA_27B_LAYERS)
    n27, s27 = lm_prefill(torch, ops, ref, cfg27, GEMMA_B, GEMMA_T, seed=3,
                          timed=1)
    return n12 + fwd_launches + n27, {
        "gemma3_12b": s12, "gemma3_27b_8_layers": s27,
        "decode_vs_forward": worst, "decode_s": dec_s,
        "serve_prefill_ms": srv[0], "serve_decode_ms_per_token": srv[1]}


# --------------------------------------------------------------------------- #
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "qwen3-0.6b", 2, 4096, 6
TRAIN_LONG_T = 8192             # under remat "full"; "none" cannot hold it
TRAIN_REMAT_STEPS = 2           # timed steps of the other remat policies
TRAIN_GRAD_REL = 2e-2           # bf16 step 1, kernel route against plain
TRAIN_GRAD_REL32 = 1e-4         # fp32, 2 layers


@contextlib.contextmanager
def plain_attention_route():
    """While open, the LM's flash route is autograd through
    ``flash_attention_plain``, checkpointed per call (its [BH, T, T]
    scores are recomputed in the backward instead of kept for every
    layer): the plain route the train step's gradients are held to."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import ref
    from repro_torch.models import attention as A

    class Plain:
        @staticmethod
        def apply(q, k, v, causal, window):
            return checkpoint(ref.flash_attention_plain, q, k, v, causal,
                              window, use_reentrant=False)

    real = A._FlashAttention
    A._FlashAttention = Plain
    try:
        yield
    finally:
        A._FlashAttention = real


def grads_against_plain(torch, model, cfg, batch, limit, label, hold=True):
    """The loss and every gradient of ``steps.value_and_grad`` through
    the kernel route and the plain route, held within relative L2
    ``limit`` (with ``hold`` off only reported; every gradient must still
    be finite); returns (loss, plain loss, worst gradient's relative L2,
    its name)."""
    from repro_torch.models.steps import value_and_grad

    _, loss, _, grads = value_and_grad(model, cfg, batch)
    with plain_attention_route():
        _, ploss, _, pgrads = value_and_grad(model, cfg, batch)
    torch.cuda.synchronize()
    rel_loss = abs(float(loss) - float(ploss)) / abs(float(ploss))
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        pg = pgrads[name].float()
        if not bool(torch.isfinite(g).all()):
            fail(f"{label}: gradient {name} not finite")
        rel = float((g.float() - pg).norm() / pg.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"{label}: loss {float(loss):.6f} (plain route {float(ploss):.6f}, "
        f"relative {rel_loss:.3e}); worst gradient relative L2 {worst:.3e} "
        f"({worst_name}; limit {limit}{'' if hold else ', not held'}) over "
        f"{len(grads)} gradients")
    if hold and not (rel_loss <= limit and worst <= limit):
        fail(f"{label}: kernel route differs from the plain route (loss "
             f"{rel_loss:.3e}, gradient {worst_name} {worst:.3e})")
    return float(loss), float(ploss), worst, worst_name


def remat_compare(torch, model, opt, cfg, batches, base, own):
    """``cfg.remat`` on the card: the loss and every gradient of
    ``value_and_grad`` on step 1's batch under "full" and "dots" against
    "none", computed twice.  A tensor "none" reproduces bit for bit must
    match it bit for bit; one it does not (atomic adds in the embedding's
    gradient) is held to relative L2 max(4 x none's own spread, 2^-8).
    Then ``TRAIN_REMAT_STEPS`` timed steps of each policy but the
    config's own, whose numbers are ``own`` (the train path's steps): ms,
    tokens/s, peak memory above ``base``; and steps at T = TRAIN_LONG_T
    under "full".  The model is left on its own config."""
    import dataclasses

    from repro_torch.data import synthetic_batches
    from repro_torch.models.steps import make_train_step, value_and_grad

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    got = {}
    for tag in ("none", "full", "dots", "none again"):
        model.cfg = dataclasses.replace(cfg, remat=tag.split()[0])
        _, loss, _, grads = value_and_grad(model, model.cfg, batches[0])
        got[tag] = (loss, grads)
    torch.cuda.synchronize()
    loss0, g0 = got["none"]
    loss1, g1 = got["none again"]
    spread = {n: rel(g1[n], g) for n, g in g0.items()
              if not torch.equal(g1[n], g)}
    if not torch.equal(loss0, loss1):
        fail(f"remat: two 'none' losses differ ({float(loss0)!r}, "
             f"{float(loss1)!r})")
    worst = {}
    for policy in ("full", "dots"):
        loss, grads = got[policy]
        if not torch.equal(loss, loss0):
            fail(f"remat {policy}: loss {float(loss)!r} != none's "
                 f"{float(loss0)!r}")
        worst[policy] = 0.0
        for n, g in grads.items():
            if n not in spread:
                if not torch.equal(g, g0[n]):
                    fail(f"remat {policy}: gradient {n} differs from "
                         f"none's, which none reproduces bit for bit")
                continue
            r = rel(g, g0[n])
            worst[policy] = max(worst[policy], r)
            if r > max(4 * spread[n], 2.0 ** -8):
                fail(f"remat {policy}: gradient {n} relative L2 {r:.3e} "
                     f"past max(4 x none's spread {spread[n]:.3e}, 2^-8)")
    log(f"remat: losses equal bit for bit under none / full / dots "
        f"({float(loss0):.6f}); {len(g0) - len(spread)} of {len(g0)} "
        f"gradients equal bit for bit, the rest ({sorted(spread)}: none "
        f"against itself {[round(v, 9) for v in spread.values()]}) within "
        f"{worst}")
    del got, g0, g1, grads
    gc.collect()
    torch.cuda.empty_cache()

    def timed(policy, batch_list, label):
        model.cfg = dataclasses.replace(cfg, remat=policy)
        step = make_train_step(model, model.cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for b in batch_list:
            t0 = time.perf_counter()
            _, _, met = step(model, opt, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        peak = torch.cuda.max_memory_allocated() - base
        tok = int(batch_list[0]["tokens"].numel())
        med = statistics.median(walls[1:])
        if not all(math.isfinite(x) for x in losses):
            fail(f"remat {label}: losses {losses}")
        log(f"remat {label}: step ms {[round(w, 2) for w in walls]} (first "
            f"is the warm-up), median {med:.2f} ms, "
            f"{tok / med * 1e3:,.0f} tokens/s, peak "
            f"{peak / 2**30:.3f} GiB (state included)")
        return {"step_ms": walls, "median_ms": med,
                "tokens_per_s": tok / med * 1e3, "peak_bytes": peak,
                "losses": losses}

    out = {"grad_spread_none": spread, "worst_rel_l2": worst,
           cfg.remat: own}
    for policy in ("none", "full", "dots"):
        if policy != cfg.remat:
            out[policy] = timed(policy, batches[:TRAIN_REMAT_STEPS],
                                f"{policy} {TRAIN_B}x{TRAIN_T}")
    it = synthetic_batches(cfg, TRAIN_B, TRAIN_LONG_T, seed=1)
    long = [{k: torch.as_tensor(v, device="cuda")
             for k, v in next(it).items()} for _ in range(2)]
    out[f"full_T{TRAIN_LONG_T}"] = timed(
        "full", long, f"full {TRAIN_B}x{TRAIN_LONG_T}")
    del long
    model.cfg = cfg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(torch, ops, ref):
    """qwen3-0.6b at full width trained in bf16 at B=2, T=4096: step 1's
    loss and gradients against the plain route, the same in fp32 at 2
    layers, 6 timed steps of ``make_train_step`` on
    ``synthetic_batches``, a checkpoint round trip of the train state on
    the card, and ``launch.train`` crashed at step 4 and resumed from its
    own checkpoint.  Returns (flash launches over the counted steps, a
    summary)."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models.steps import (build_model, init_train_state,
                                          make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    flash_train = flash_at_shape(torch, ops, ref, cfg, TRAIN_B, TRAIN_T,
                                 "train step shape")
    it = synthetic_batches(cfg, TRAIN_B, TRAIN_T, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in next(it).items()} for _ in range(TRAIN_STEPS)]

    # fp32 at full width, 2 layers: kernel route against plain.
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    m32, _ = init_train_state(build_model(cfg32, seed=0))
    r32 = grads_against_plain(torch, m32, cfg32, batches[0],
                              TRAIN_GRAD_REL32, "train fp32, 2 layers")
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, opt = init_train_state(build_model(cfg, seed=0))
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    n_par = sum(p.numel() for p in model.parameters())
    log(f"train {cfg.name}: {n_par:,} parameters in {cfg.dtype}, params + "
        f"fp32 master, mu and nu {state_bytes / 2**30:.3f} GiB")
    r16 = grads_against_plain(torch, model, cfg, batches[0],
                              TRAIN_GRAD_REL, "train bf16 step 1")
    step = make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the train path: counts zeroed above, read below.
    walls, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the train path.
    # Under remat the forward runs again in the backward: twice a step.
    per_step = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    if n_flash != per_step * TRAIN_STEPS:
        fail(f"train: flash launches {n_flash} over {TRAIN_STEPS} steps != "
             f"{per_step} per step (remat {cfg.remat!r})")
    if not all(math.isfinite(x) for x in losses) or int(opt.step) != \
            TRAIN_STEPS:
        fail(f"train: losses {losses}, step {int(opt.step)}")
    med = statistics.median(walls[1:])
    tok = TRAIN_B * TRAIN_T
    log(f"train {cfg.name} B={TRAIN_B} T={TRAIN_T} bf16, remat "
        f"{cfg.remat!r}: step wall ms "
        f"{[round(w, 2) for w in walls]} (first is the warm-up), median "
        f"{med:.2f} ms, {tok / med * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB (state included); flash launches "
        f"{n_flash}; losses {[round(x, 4) for x in losses]}")
    by_name = profile_call(torch, lambda: step(model, opt, batches[0]),
                           f"train step {TRAIN_B}x{TRAIN_T}")
    flash_dev = None
    b_ms, b_by = flash_bound(TRAIN_B * cfg.n_heads, TRAIN_T, TRAIN_T, cfg.hd,
                             True, 2, PEAK_BF16_FLOP_S,
                             kv_heads=TRAIN_B * cfg.n_kv_heads)
    if by_name:
        flash_dev = sum(ms for n, ms in by_name.items()
                        if FLASH_BF16 in n)
        dev = sum(by_name.values())
        log(f"train: flash kernel device time in the profiled step "
            f"{flash_dev:.3f} ms of {dev:.3f} ms of device time, "
            f"{flash_dev / per_step:.4f} ms a call against a bound of "
            f"{b_ms:.4f} ms ({b_by})")
    remat = remat_compare(torch, model, opt, cfg, batches, base, {
        "step_ms": walls, "median_ms": med, "tokens_per_s": tok / med * 1e3,
        "peak_bytes": peak, "losses": losses})

    # Checkpoint round trip of the whole train state on the card.
    ckpt = checkpoint_round_trip(torch, cfg, model, opt, losses[-1],
                                 cfg.name)
    del model, opt, batches
    gc.collect()
    torch.cuda.empty_cache()

    # launch.train, crashed after step 4 and resumed from its checkpoint.
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with tempfile.TemporaryDirectory() as ck:
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                TRAIN_ARCH, "--steps", "5", "--batch", str(TRAIN_B), "--seq",
                str(TRAIN_T), "--log-every", "1", "--ckpt-dir", ck,
                "--ckpt-every", "3", "--resume", "auto"]
        t0 = time.perf_counter()
        r1 = subprocess.run(args + ["--crash-at", "4"], env=env,
                            capture_output=True, text=True, timeout=600)
        r2 = subprocess.run(args, env=env, capture_output=True, text=True,
                            timeout=600)
        drv_s = time.perf_counter() - t0
        last = latest_step(ck)
    for line in (r1.stdout + r2.stdout).splitlines():
        log(f"launch.train: {line}")
    if (r1.returncode != 42 or r2.returncode != 0 or last != 3
            or "[resume] restored step 3" not in r2.stdout
            or "done: 5 steps" not in r2.stdout):
        fail(f"launch.train crash / resume: exits {r1.returncode}, "
             f"{r2.returncode}, latest step {last}:\n{r1.stderr[-2000:]}"
             f"\n{r2.stderr[-2000:]}")
    log(f"launch.train --arch {TRAIN_ARCH} --batch {TRAIN_B} --seq "
        f"{TRAIN_T}: crashed after step 4 (exit 42), resumed from step 3, "
        f"done at 5; {drv_s:.2f} s for both processes")
    return n_flash, {
        "params": n_par, "state_bytes": state_bytes, "step_ms": walls,
        "remat": cfg.remat, "remat_policies": remat,
        "flash_train_shape": flash_train,
        "step_median_ms": med, "tokens_per_s": tok / med * 1e3,
        "peak_bytes": peak, "losses": losses,
        "flash_device_ms_in_profiled_step": flash_dev,
        "flash_bound_ms": b_ms,
        "step1_bf16": {"loss": r16[0], "plain_loss": r16[1],
                       "worst_grad_rel_l2": r16[2], "worst_grad": r16[3]},
        "fp32_2_layers": {"loss": r32[0], "plain_loss": r32[1],
                          "worst_grad_rel_l2": r32[2],
                          "worst_grad": r32[3]},
        "checkpoint": ckpt, "launch_train_s": drv_s}


# --------------------------------------------------------------------------- #
VISION_ARCH = "llama-3.2-vision-11b"
VISION_B, VISION_T = 4, 2048
VISION_SUPERBLOCK = 5           # 4 self-attention layers, then a cross one
WHISPER_ARCH = "whisper-base"
WHISPER_B, WHISPER_FRAMES = 4, 1500
WHISPER_DECODE_T = 64
WHISPER_TRAIN_B, VISION_TRAIN_B = 8, 2
CROSS_TRAIN_STEPS = 4           # a warm-up and 3 timed, for each model


def drive_serve(torch, arch, label, cfg=None):
    """``python -m repro_torch.launch.serve --arch <arch>`` (its ``main``)
    with 4 requests of 16 prompt and 16 generated tokens, its output
    checked; returns (prefill ms, decode ms/token, wall s).  ``cfg`` (a
    layer cut of the arch's config) is what ``launch.serve``'s ``get_config``
    returns for the call, for a model whose full depth the card cannot
    hold."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    real = serve.get_config
    if cfg is not None:
        serve.get_config = lambda name: cfg
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--arch", arch, "--requests", "4",
                             "--prompt-len", "16", "--gen", "16"])
    finally:
        serve.get_config = real
    drv_s = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"serve {label}: {line}")
    m = re.search(r"prefill: ([\d.]+) ms\s+decode: ([\d.]+) ms \(([\d.]+) "
                  r"ms/token\)", text)
    gens = re.findall(r"^\s+\[([\d, ]+)\]$", text, re.M)
    if rc != 0 or m is None or len(gens) != 3 or any(
            len(x.split(",")) != 16 for x in gens):
        fail(f"launch.serve --arch {arch}: exit {rc}, output not as "
             "expected")
    log(f"launch.serve {arch}: prefill {m.group(1)} ms, decode "
        f"{m.group(3)} ms/token, {drv_s:.2f} s in all")
    gc.collect()
    torch.cuda.empty_cache()
    return float(m.group(1)), float(m.group(3)), drv_s


@tallied_as("checks")
def flash_noncausal_rows(torch, ops, ref):
    """The kernel's non-causal mode at the two shapes the new paths give
    it: llama-3.2-vision's cross layers at B=4 (128 query heads over 32 KV
    heads, G=4, Tq=2048 over Tk=1,601 vision tokens, d=128) and
    whisper-base's encoder at B=4 (32 heads, T=1,500 frames, d=64).  At
    each, fp32 at the sweep's atol 2e-5 and bf16 by ``check_rows``
    against the plain version, two bf16 launches equal, and the bf16 call
    timed beside the plain version, SDPA (``is_causal=False``) and the
    bound.  Returns a row per shape."""
    from repro_torch.configs import get_config

    vis, wsp = get_config(VISION_ARCH), get_config(WHISPER_ARCH)
    shapes = {
        "vision cross": (VISION_B * vis.n_heads, VISION_B * vis.n_kv_heads,
                         VISION_T, vis.n_vision_tokens, vis.hd),
        "whisper encoder": (WHISPER_B * wsp.n_heads,
                            WHISPER_B * wsp.n_kv_heads, WHISPER_FRAMES,
                            WHISPER_FRAMES, wsp.hd)}
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for label, (bh, kvh, tq, tk, d) in shapes.items():
        name = (f"flash {label} BH={bh} KV heads={kvh} Tq={tq} Tk={tk} "
                f"d={d} non-causal")
        q = torch.randn(bh, tq, d, generator=gen, device="cuda")
        k, v = (torch.randn(kvh, tk, d, generator=gen, device="cuda")
                for _ in range(2))
        err32 = check_close(torch, f"{name} fp32",
                            ops.flash_attention(q, k, v, False),
                            ref.flash_attention_plain(q, k, v, False), 0.0,
                            FLASH_ATOL)
        q, k, v = (x.bfloat16() for x in (q, k, v))
        body = ops.flash_body(torch.bfloat16, d, d)
        got = ops.flash_attention(q, k, v, False)
        want = ref.flash_attention_plain(q, k, v, False)
        r_whole, r_row = check_rows(torch, f"{name} bf16", got, want)
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(ops.flash_attention(q, k, v, False), got):
            fail(f"{name} bf16: two launches differ")
        del got, want
        t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, False))
        t_p = median_ms(torch, lambda: ref.flash_attention_plain(
            q, k, v, False), reps=3, launches=3)
        lib, how = sdpa_yardstick(torch, q, k, v, causal=False)
        t_l = median_ms(torch, lib)
        b_ms, b_by = flash_bound(bh, tq, tk, d, False, 2, PEAK_BF16_FLOP_S,
                                 kv_heads=kvh)
        log(f"kernel flash_attention {name} bf16 ({body} body): kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"F.scaled_dot_product_attention ({how}) "
            f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); relative L2 "
            f"{r_whole:.3e} whole, {r_row:.3e} worst row, max|err| "
            f"{err:.2e} (fp32: max|err| {err32:.2e}, atol {FLASH_ATOL})")
        rows[label] = {
            "shape": f"BH={bh} over {kvh} KV heads, Tq={tq}, Tk={tk}, d={d},"
                     " bf16, non-causal", "body": body, "max_abs_err": err,
            "max_abs_err_fp32": err32, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "library": how, "rel_l2_whole": r_whole,
            "rel_l2_worst_row": r_row}
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def decode_witness(torch, ops, model, label, forward, filled, toks,
                   want_launches):
    """fp32 decode against forward: ``forward()`` (flash launches counted
    from zero, tallied by mode, ``want_launches`` of them), then the cache
    ``filled()`` returns (its cross caches filled in place) and one decode
    step a position,
    every logit within DECODE_TOL of max |forward logit|.  Returns (flash
    launches, modes, worst relative error)."""
    b, t = toks.shape
    ops.reset_launches()
    # ---- the forward run: counts zeroed above, read below.
    with flash_modes(ops) as modes:
        fwd, _ = forward()
        torch.cuda.synchronize()
    n_flash = ops.LAUNCHES["flash_attention"]
    # ---- end of the forward run.
    if n_flash != want_launches or sum(modes.values()) != n_flash:
        fail(f"{label} forward: flash launches {n_flash} != "
             f"{want_launches} (calls by mode {modes})")
    cache = filled()
    t0 = time.perf_counter()
    errs = []
    for i in range(t):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        errs.append((lg[:, 0] - fwd[:, i]).abs().amax())
    worst = float(torch.stack(errs).max()) / float(fwd.abs().max())
    log(f"{label} decode against forward, fp32, B={b} T={t}: max |decode "
        f"- forward| / max |forward| = {worst:.3e} (limit {DECODE_TOL}; "
        f"{time.perf_counter() - t0:.2f} s); forward flash launches "
        f"{n_flash} {modes}")
    if not worst < DECODE_TOL:
        fail(f"{label} decode differs from forward by {worst:.3e}")
    return n_flash, modes, worst


def vision_phase(torch, ops, ref):
    """llama-3.2-vision-11b at full width: the bf16 prefill of all 40
    layers (8 with cross-attention over 1,601 vision tokens) against plain
    attention, with its eager / captured decode pair; the fp32 decode
    witness at one superblock with the cross caches filled by
    ``fill_cross_caches``; ``launch.serve``.  Returns (flash launches over
    the counted runs, their non-causal share, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.steps import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(VISION_ARCH)
    n_cross = cfg.n_layers // cfg.cross_attn_every
    rng = np.random.default_rng(4)
    vis = torch.as_tensor(rng.normal(0, 0.1, (
        VISION_B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32),
        device="cuda").to(cfg.torch_dtype)
    n_pre, pre = lm_prefill(
        torch, ops, ref, cfg, VISION_B, VISION_T, seed=1, timed=2,
        profile=True, extra={"vision": vis},
        per_prefill=cfg.n_layers + n_cross,
        then=lambda m: decode_pair(torch, m, cfg, 4, 16, 16, cfg.name))
    runs = len(pre["prefill_ms"])
    if pre["modes"] != {"causal": cfg.n_layers * runs,
                        "non_causal": n_cross * runs}:
        fail(f"vision prefill: calls by mode {pre['modes']}, expected "
             f"{cfg.n_layers} causal and {n_cross} non-causal a prefill")
    del vis

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=VISION_SUPERBLOCK)
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DECODE_B, DECODE_T)
                                        ).astype(np.int32), device="cuda")
    src = torch.as_tensor(rng.normal(0, 0.1, (
        DECODE_B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32),
        device="cuda")

    def filled():
        cache = model.init_cache(DECODE_B, DECODE_T)
        model.fill_cross_caches(cache, src)
        return cache
    n_fwd, fwd_modes, worst = decode_witness(
        torch, ops, model, f"vision ({VISION_SUPERBLOCK} layers)",
        lambda: model(toks, cross_kv_x=src), filled, toks,
        VISION_SUPERBLOCK + 1)
    del model, src
    gc.collect()
    torch.cuda.empty_cache()
    srv = drive_serve(torch, VISION_ARCH, "vision")
    return n_pre + n_fwd, pre["modes"]["non_causal"] + fwd_modes[
        "non_causal"], {**pre, "decode_vs_forward": worst,
                        "serve_prefill_ms": srv[0],
                        "serve_decode_ms_per_token": srv[1]}


def whisper_phase(torch, ops, ref):
    """whisper-base at full width: ``make_prefill_step`` (encode 4 x 1,500
    frames, then a bf16 teacher-forced forward over 448 targets) against
    plain attention, 18 flash launches a forward (6 encoder layers and 6
    cross blocks non-causal, 6 decoder layers causal); encode timed alone;
    the eager / captured decode pair; the fp32 decode witness with the
    cross caches filled from ``encode``; ``launch.serve``.  Returns
    (flash launches over the counted runs, their non-causal share, a
    summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.steps import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    per = cfg.n_encoder_layers + 2 * cfg.n_layers
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.normal(0, 0.1, (
        WHISPER_B, WHISPER_FRAMES, cfg.d_model)).astype(np.float32),
        device="cuda").to(cfg.torch_dtype)

    def then(m):
        enc_ms = median_ms(torch, lambda: m.encode(frames), reps=3,
                           launches=5)
        log(f"whisper encode {WHISPER_B}x{WHISPER_FRAMES} frames, bf16: "
            f"{enc_ms:.4f} ms of device time")
        return {"encode_ms": enc_ms,
                "decode_pair": decode_pair(torch, m, cfg, 4, 16, 16,
                                           cfg.name)}
    n_pre, pre = lm_prefill(
        torch, ops, ref, cfg, WHISPER_B, cfg.decoder_target_len, seed=6,
        timed=2, profile=True, then=then, extra={"frames": frames},
        tokens_key="targets", per_prefill=per)
    runs = len(pre["prefill_ms"])
    want = {"causal": cfg.n_layers * runs,
            "non_causal": (cfg.n_encoder_layers + cfg.n_layers) * runs}
    if pre["modes"] != want:
        fail(f"whisper forward: calls by mode {pre['modes']} != {want}")
    del frames

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, seed=0)
    fr = torch.as_tensor(rng.normal(0, 0.1, (
        DECODE_B, WHISPER_FRAMES, cfg.d_model)).astype(np.float32),
        device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (
        DECODE_B, WHISPER_DECODE_T)).astype(np.int32), device="cuda")

    def filled():
        cache = model.init_cache(DECODE_B, WHISPER_DECODE_T,
                                 cross_len=WHISPER_FRAMES)
        model.fill_cross_caches(cache, model.encode(fr))
        return cache
    n_fwd, fwd_modes, worst = decode_witness(
        torch, ops, model, "whisper", lambda: model(fr, toks), filled,
        toks, per)
    del model, fr
    gc.collect()
    torch.cuda.empty_cache()
    srv = drive_serve(torch, WHISPER_ARCH, "whisper")
    return n_pre + n_fwd, pre["modes"]["non_causal"] + fwd_modes[
        "non_causal"], {**pre, "decode_vs_forward": worst,
                        "serve_prefill_ms": srv[0],
                        "serve_decode_ms_per_token": srv[1]}


def checkpoint_round_trip(torch, cfg, model, opt, loss, label):
    """``checkpoint.save`` of the train state under ``TMPDIR`` and
    ``restore`` onto a fresh model (seed 1) on the card, bit for bit, or
    fail; returns bytes and seconds."""
    import tempfile

    from repro_torch.checkpoint import restore, save
    from repro_torch.models.steps import build_model, init_train_state

    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        save(ck, int(opt.step), (model, opt), meta={"loss": loss})
        save_s = time.perf_counter() - t0
        fresh, fopt = init_train_state(build_model(cfg, seed=1))
        t0 = time.perf_counter()
        (fresh, fopt), got_step, meta = restore(ck, (fresh, fopt))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = got_step == int(fopt.step) == int(opt.step) and all(
            torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), fresh.state_dict().values()))
        for n in opt.mu:
            same = same and torch.equal(opt.mu[n], fopt.mu[n]) and \
                torch.equal(opt.nu[n], fopt.nu[n]) and \
                torch.equal(opt.master[n], fopt.master[n])
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ck) for f in fs)
    log(f"checkpoint of the {label} train state: {nbytes:,} bytes, save "
        f"{save_s:.2f} s, restore onto the card {restore_s:.2f} s, bit for "
        f"bit: {same}")
    if not same or fresh.embed.device != model.embed.device:
        fail(f"checkpoint round trip of the {label} train state is not bit "
             "for bit")
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}


def train_case(torch, ops, cfg, b, t, steps, per_fwd, against_plain=True):
    """``make_train_step`` on ``cfg`` (bf16, random from seed 0) over
    ``steps`` batches of ``synthetic_batches(cfg, b, t, seed=0)``: with
    ``against_plain``, step 1's loss and every gradient against the plain
    route within TRAIN_GRAD_REL first; then the steps with the flash
    launches counted (``per_fwd`` a forward, twice that a step under
    remat), every loss finite, step ms, tokens/s and peak memory (the
    train state included).  Returns (flash launches, calls by mode, a
    summary, the model, its optimizer state)."""
    from repro_torch.data import synthetic_batches
    from repro_torch.models.steps import (build_model, init_train_state,
                                          make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    it = synthetic_batches(cfg, b, t, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in next(it).items()} for _ in range(steps)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, opt = init_train_state(build_model(cfg, seed=0))
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    n_par = sum(p.numel() for p in model.parameters())
    log(f"train {cfg.name} ({cfg.n_layers} layers): {n_par:,} "
        f"parameters in {cfg.dtype}, params + fp32 master, mu and nu "
        f"{state_bytes / 2**30:.3f} GiB")
    r16 = (grads_against_plain(torch, model, cfg, batches[0],
                               TRAIN_GRAD_REL,
                               f"train {cfg.name} bf16 step 1")
           if against_plain else None)
    step = make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the train path: counts zeroed above, read below.
    walls, losses = [], []
    with flash_modes(ops) as modes:
        for bt in batches:
            t0 = time.perf_counter()
            model, opt, met = step(model, opt, bt)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the train path.
    per_step = per_fwd * (1 if cfg.remat == "none" else 2)
    if n_flash != per_step * len(batches) or sum(
            modes.values()) != n_flash:
        fail(f"train {cfg.name}: flash launches {n_flash} over "
             f"{len(batches)} steps != {per_step} per step (calls by "
             f"mode {modes})")
    if not all(math.isfinite(x) for x in losses) or int(opt.step) != \
            len(batches):
        fail(f"train {cfg.name}: losses {losses}, step {int(opt.step)}")
    med = statistics.median(walls[1:])
    tok = int(batches[0]["targets" if cfg.encoder_decoder
                         else "tokens"].numel())
    log(f"train {cfg.name} B={b} T={t} bf16, remat {cfg.remat!r}: "
        f"step wall ms {[round(w, 2) for w in walls]} (first is the "
        f"warm-up), median {med:.2f} ms, {tok / med * 1e3:,.0f} "
        f"{'target ' if cfg.encoder_decoder else ''}tokens/s; peak "
        f"memory {peak / 2**30:.3f} GiB (state included); flash "
        f"launches {n_flash} {modes}; losses "
        f"{[round(x, 4) for x in losses]}")
    out = {"layers": cfg.n_layers, "batch": b, "seq": t, "params": n_par,
           "state_bytes": state_bytes, "step_ms": walls,
           "step_median_ms": med, "tokens_per_s": tok / med * 1e3,
           "peak_bytes": peak, "losses": losses, "modes": modes}
    if r16 is not None:
        out["step1_bf16"] = {"loss": r16[0], "plain_loss": r16[1],
                             "worst_grad_rel_l2": r16[2],
                             "worst_grad": r16[3]}
    del batches, step
    return n_flash, modes, out, model, opt


def cross_train_phase(torch, ops, ref):
    """``make_train_step`` in bf16 on whisper-base at full width (B=8,
    1,500 frames, 448 targets) and on llama-3.2-vision-11b cut to one
    superblock (5 layers at full width, the last with cross-attention;
    B=2, T=2048, 1,601 vision tokens; its AdamW state at 40 layers is
    past the card's 80 GB): step 1's loss and every gradient against the
    plain route within 2e-2, ``CROSS_TRAIN_STEPS`` steps with every loss
    finite and the flash launches counted (twice a forward's under
    remat), step ms, tokens/s, peak memory; whisper's checkpoint round
    trip.  Returns (flash launches, non-causal launches by model, a
    summary)."""
    import dataclasses

    from repro_torch.configs import get_config

    out, launches, non_causal = {}, 0, {}
    cases = (("whisper", get_config(WHISPER_ARCH), WHISPER_TRAIN_B,
              WHISPER_FRAMES),
             ("vision", dataclasses.replace(get_config(VISION_ARCH),
                                            n_layers=VISION_SUPERBLOCK),
              VISION_TRAIN_B, VISION_T))
    for label, cfg, b, t in cases:
        per_fwd = cfg.n_encoder_layers + cfg.n_layers + (
            cfg.n_layers if cfg.encoder_decoder
            else cfg.n_layers // cfg.cross_attn_every)
        n_flash, modes, out[label], model, opt = train_case(
            torch, ops, cfg, b, t, CROSS_TRAIN_STEPS, per_fwd)
        launches += n_flash
        non_causal[label] = modes["non_causal"]
        if cfg.encoder_decoder:
            out[label]["checkpoint"] = checkpoint_round_trip(
                torch, cfg, model, opt, out[label]["losses"][-1], cfg.name)
        del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, non_causal, out


HYMBA_ARCH, XLSTM_ARCH = "hymba-1.5b", "xlstm-125m"
HYMBA_B, HYMBA_T = 4, 2048
HYMBA_DECODE_LAYERS = 2
HYMBA_DECODE_T = 2304           # past the window of 2,048; SSD in 9 chunks
HYMBA_TRAIN_B, HYMBA_TRAIN_T, HYMBA_TRAIN_STEPS = 2, 4096, 4
XLSTM_B, XLSTM_T = 4, 2048
XLSTM_DECODE_T = 512            # two query chunks of the mLSTM
# T = 1,024, not 4,096: at 4,096 a step took 23.6-27.6 s and its warm-up
# up to 32.3 s (the sLSTM's loop of 4,096 steps under autograd and remat).
XLSTM_TRAIN_B, XLSTM_TRAIN_T, XLSTM_TRAIN_STEPS = 2, 1024, 2
MLSTM_LONG_T = 4096             # one mLSTM layer's gradient, finite


@tallied_as("timing")
def loop_cost(torch, label, fn, steps):
    """A host-paced piece of the model (a scan's loop): the synchronized
    wall ms of ``fn()`` (median of 3 after a warm-up), and one call under
    the profiler (device only): device busy ms and device events, also
    per step of its loop."""
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = {}
    profile_call(torch, fn, label, out=prof, cpu=False)
    med = statistics.median(walls)
    per = prof["events"] / steps if "events" in prof else None
    log(f"{label}: wall {med:.2f} ms (of {[round(w, 2) for w in walls]}), "
        f"device busy {prof.get('busy_ms', 'not measured')} ms, "
        f"{prof.get('events', 'not measured')} device events over {steps} "
        f"steps of its loop ({per} a step)")
    return {"wall_ms": walls, "median_ms": med, "steps": steps,
            "events_per_step": per, **prof}


def block_input(torch, cfg, b, t):
    """A bf16 block input [b, t, d_model] of unit RMS (an ``ln1`` output's
    scale), from seed 9."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    return torch.randn(b, t, cfg.d_model, generator=gen,
                       device="cuda").to(cfg.torch_dtype)


@contextlib.contextmanager
def flash_calls_held(torch, ops, ref, label):
    """While open, each (bf16) ``ops.flash_attention`` call runs the
    kernel and holds its output to the plain version on the same operands
    by ``check_rows``; the yielded dict counts the calls and keeps the
    worst relative L2 (whole, row)."""
    seen = {"calls": 0, "whole": 0.0, "row": 0.0}
    real = ops.flash_attention

    def held(q, k, v, causal=True, window=0):
        got = real(q, k, v, causal, window)
        w, r = check_rows(torch, f"{label} call {seen['calls']}", got,
                          ref.flash_attention_plain(q, k, v, causal, window))
        seen.update(calls=seen["calls"] + 1, whole=max(seen["whole"], w),
                    row=max(seen["row"], r))
        return got
    with attention_as(ops, held):
        yield seen


def hymba_phase(torch, ops, ref):
    """hymba-1.5b at full width (32 layers; 25 query heads over 5 KV heads
    of 64 under a window of 2,048, beside 25 SSM heads of state 16): the
    flash kernel at its prefill shape (G = 5) and, windowed, at its train
    shape; the bf16 prefill at 4x2048 (32 causal flash calls a prefill,
    one profiled), every flash call of one more prefill held to the plain
    version on its own operands, one layer's SSD scan and attention
    timed, the eager / captured decode pair; the same weights in fp32,
    whose prefill logits are held within LM_REL_L2 of plain attention
    (in bf16 the model's rounding alone moves them further, so the bf16
    logits are reported beside ``_sdpa_chunked``'s and the fp32 run's);
    the fp32 decode witness at 2 layers over 2,304 positions (the rings
    wrap, the SSD runs 9 chunks); ``launch.serve``; step 1's loss and
    gradients against the plain route in fp32 (held) and bf16
    (reported), and the bf16 train step at 2x4096 under remat "full".
    Returns (flash launches over the counted runs, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as SSM
    from repro_torch.models.steps import build_model, make_prefill_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(HYMBA_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rows = {"prefill": flash_at_shape(torch, ops, ref, cfg, HYMBA_B,
                                      HYMBA_T, "hymba prefill shape"),
            "train": flash_at_shape(torch, ops, ref, cfg, HYMBA_TRAIN_B,
                                    HYMBA_TRAIN_T, "hymba train shape",
                                    window=cfg.local_window)}
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (HYMBA_B, HYMBA_T)).astype(np.int32), device="cuda")}

    def then(m):
        out = {}
        with flash_calls_held(torch, ops, ref, "hymba bf16 prefill") as seen:
            plain16 = make_prefill_step(m, cfg)(m, batch).float()
        if seen["calls"] != cfg.n_layers:
            fail(f"hymba: {seen['calls']} flash calls held, expected "
                 f"{cfg.n_layers}")
        log(f"hymba bf16 prefill: each of its {seen['calls']} flash calls "
            f"held to the plain version on its own operands (worst relative"
            f" L2 {seen['whole']:.3e} whole, {seen['row']:.3e} row)")
        out["flash_calls_held"] = seen
        bp, h = m.layers[0], block_input(torch, cfg, HYMBA_B, HYMBA_T)
        with torch.no_grad():
            out["ssd_one_layer"] = loop_cost(
                torch, f"hymba SSD scan, one layer, {HYMBA_B}x{HYMBA_T}",
                lambda: SSM.ssm_scan_ssd(bp.ssm, h, cfg.ssm_state),
                max(1, HYMBA_T // 256))
            out["attention_one_layer"] = loop_cost(
                torch, "hymba attention, one layer", lambda: A.attention(
                    bp.attn, h, window=cfg.local_window,
                    rope_theta=cfg.rope_theta), 1)
        del h
        out["decode_pair"] = decode_pair(torch, m, cfg, 4, 16, 16, cfg.name)
        # The same weights in fp32: the kernel route against plain
        # attention (held), and against the bf16 run (the model's own
        # bf16 rounding).
        m32 = build_model(cfg32, seed=0)
        m32.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
        pre32 = make_prefill_step(m32, cfg32)
        ops.reset_launches()
        # ---- the hymba fp32 prefill: counts zeroed above, read below.
        got32 = pre32(m32, batch)
        torch.cuda.synchronize()
        n32 = ops.LAUNCHES["flash_attention"]
        # ---- end of the hymba fp32 prefill.
        with attention_as(ops, ref.flash_attention_plain):
            want32 = pre32(m32, batch)
        rel32 = float((got32 - want32).norm() / want32.norm())
        gap = float((plain16 - want32).norm() / want32.norm())
        log(f"hymba fp32 prefill {HYMBA_B}x{HYMBA_T}, the bf16 weights: "
            f"logits against plain attention relative L2 {rel32:.3e} (limit "
            f"{LM_REL_L2}); flash launches {n32}; the bf16 model's plain "
            f"route against this one: {gap:.3e}")
        if n32 != cfg.n_layers or not rel32 <= LM_REL_L2:
            fail(f"hymba fp32 prefill: {n32} flash launches, logits "
                 f"{rel32:.3e} from plain attention")
        del m32, pre32, got32, want32, plain16
        gc.collect()
        torch.cuda.empty_cache()
        out.update(fp32_rel_l2=rel32, bf16_vs_fp32_rel_l2=gap,
                   fp32_launches=n32)
        return out
    n_pre, pre = lm_prefill(torch, ops, ref, cfg, HYMBA_B, HYMBA_T, seed=1,
                            timed=2, profile=True, then=then, hold=False)
    if pre["modes"]["non_causal"]:
        fail(f"hymba prefill: calls by mode {pre['modes']}")

    dec = dataclasses.replace(cfg32, n_layers=HYMBA_DECODE_LAYERS)
    model = build_model(dec, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (DECODE_B, HYMBA_DECODE_T)).astype(np.int32),
        device="cuda")

    def ring():
        cache = model.init_cache(DECODE_B, HYMBA_DECODE_T)
        shapes = {(lc["k"].shape[1], tuple(lc["ssm"].shape), lc["ssm"].dtype)
                  for lc in cache}
        want = (cfg.local_window, (DECODE_B, cfg.ssm_heads,
                                   cfg.d_model // cfg.ssm_heads,
                                   cfg.ssm_state), torch.float32)
        if shapes != {want}:
            fail(f"hymba caches {shapes}, expected {want}")
        return cache
    n_fwd, _, worst = decode_witness(
        torch, ops, model, f"hymba ({HYMBA_DECODE_LAYERS} layers, rings of "
        f"{cfg.local_window} wrapped)", lambda: model(toks), ring, toks,
        HYMBA_DECODE_LAYERS)
    del model, toks
    gc.collect()
    torch.cuda.empty_cache()
    srv = drive_serve(torch, HYMBA_ARCH, "hymba")

    # Step 1's loss and gradients against the plain route, on the same
    # weights in fp32 (held) and bf16 (reported).
    b1 = {k: torch.as_tensor(v, device="cuda") for k, v in next(
        synthetic_batches(cfg, HYMBA_TRAIN_B, HYMBA_TRAIN_T, seed=0)).items()}
    step1 = {}
    for c, hold in ((cfg32, True), (cfg, False)):
        model = build_model(c, seed=0)
        for p in model.parameters():
            p.requires_grad_(True)
        r = grads_against_plain(torch, model, c, b1, TRAIN_GRAD_REL,
                                f"train {c.name} {c.dtype} step 1", hold)
        step1[c.dtype] = {"loss": r[0], "plain_loss": r[1],
                          "worst_grad_rel_l2": r[2], "worst_grad": r[3]}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    del b1
    n_train, _, train, model, opt = train_case(
        torch, ops, cfg, HYMBA_TRAIN_B, HYMBA_TRAIN_T, HYMBA_TRAIN_STEPS,
        cfg.n_layers, against_plain=False)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    n32 = pre["then"]["fp32_launches"]
    return n_pre + n32 + n_fwd + n_train, {
        **pre, "flash_rows": rows, "decode_vs_forward": worst,
        "serve_prefill_ms": srv[0], "serve_decode_ms_per_token": srv[1],
        "step1": step1, "train": train,
        "flash_launches": {"prefill": n_pre, "fp32_prefill": n32,
                           "fp32_forward": n_fwd, "train": n_train}}


def xlstm_phase(torch, ops, ref):
    """xlstm-125m at full width (12 layers: six mLSTM / sLSTM pairs, no
    FFN, no attention): the bf16 prefill at 4x2048 with no flash launch;
    its weights on the card and on the CPU, the first sequence's
    last-position logits held within LM_REL_L2 in fp32 (in bf16 the
    model's rounding alone moves them further: reported); one mLSTM and
    one sLSTM layer timed (the sLSTM's loop over 2,048 steps, launched
    eagerly), the eager / captured decode pair;
    the fp32 decode witness at 12 layers over 512 positions; ``launch.serve``;
    the train step at 2x1024.  Returns a summary."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import xlstm_blocks as XL
    from repro_torch.models.steps import build_model, make_prefill_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(XLSTM_ARCH)
    seed = 1

    def then(m):
        # The first sequence's last-position logits on the card and on the
        # CPU, the same weights in bf16 (reported: the model's bf16
        # rounding alone moves them further than LM_REL_L2) and in fp32
        # (held within LM_REL_L2).
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, (XLSTM_B, XLSTM_T)).astype(np.int32)[:1]
        logits, cpu_s = {}, 0.0
        for c in (cfg, dataclasses.replace(cfg, dtype="float32")):
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                mm = build_model(c, device=dev, seed=1)
                mm.load_state_dict({k: v.to(dev)
                                    for k, v in m.state_dict().items()})
                logits[c.dtype, dev] = make_prefill_step(mm, c)(mm, {
                    "tokens": torch.as_tensor(tokens, device=dev)
                })[0].float().cpu()
                if dev == "cpu":
                    cpu_s += time.perf_counter() - t0
                del mm

        def rel(a, b):
            return float((logits[a] - logits[b]).norm()
                         / logits[b].norm())
        out = {"bf16_card_vs_cpu": rel(("bfloat16", "cuda"),
                                       ("bfloat16", "cpu")),
               "fp32_card_vs_cpu": rel(("float32", "cuda"),
                                       ("float32", "cpu")),
               "bf16_vs_fp32_card": rel(("bfloat16", "cuda"),
                                        ("float32", "cuda")),
               "cpu_s": cpu_s}
        log(f"xlstm prefill 1x{XLSTM_T}, first sequence's last-position "
            f"logits, card against the CPU: fp32 relative L2 "
            f"{out['fp32_card_vs_cpu']:.3e} (limit {LM_REL_L2}); bf16 "
            f"{out['bf16_card_vs_cpu']:.3e}, not held: bf16 against fp32 "
            f"on the card reads {out['bf16_vs_fp32_card']:.3e} "
            f"({cpu_s:.2f} s on the CPU)")
        if not out["fp32_card_vs_cpu"] <= LM_REL_L2:
            fail(f"xlstm fp32 prefill on the card differs from the CPU by "
                 f"relative L2 {out['fp32_card_vs_cpu']:.3e}")
        h = block_input(torch, cfg, XLSTM_B, XLSTM_T)
        with torch.no_grad():
            mls = loop_cost(torch, f"xlstm mLSTM scan, one layer, "
                            f"{XLSTM_B}x{XLSTM_T}", lambda: XL.mlstm_scan(
                                m.layers[0].core, h),
                            max(1, XLSTM_T // 256))
            sls = loop_cost(torch, f"xlstm sLSTM scan, one layer, "
                            f"{XLSTM_B}x{XLSTM_T}", lambda: XL.slstm_scan(
                                m.layers[1].core, h), XLSTM_T)
        del h
        return {**out, "mlstm_one_layer": mls, "slstm_one_layer": sls,
                "decode_pair": decode_pair(torch, m, cfg, 4, 16, 16,
                                           cfg.name)}
    n_pre, pre = lm_prefill(torch, ops, ref, cfg, XLSTM_B, XLSTM_T,
                            seed=seed, timed=2, then=then, per_prefill=0)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (DECODE_B, XLSTM_DECODE_T)).astype(np.int32),
        device="cuda")

    def states():
        cache = model.init_cache(DECODE_B, XLSTM_DECODE_T)
        if any(float(lc["m"].max()) != float(np.float32(-1e30))
               for lc in cache):
            fail("xlstm caches: the stabilizer does not start at -1e30")
        return cache
    n_fwd, _, worst = decode_witness(
        torch, ops, model, f"xlstm ({cfg.n_layers} layers)",
        lambda: model(toks), states, toks, 0)
    del model, toks
    gc.collect()
    torch.cuda.empty_cache()
    srv = drive_serve(torch, XLSTM_ARCH, "xlstm")
    n_train, _, train, model, opt = train_case(
        torch, ops, cfg, XLSTM_TRAIN_B, XLSTM_TRAIN_T, XLSTM_TRAIN_STEPS, 0,
        against_plain=False)
    # One trained mLSTM layer's gradient at T = 4,096, where a later key's
    # logD passes exp's range (JAX's where(mask, exp(logD), 0) is NaN
    # there; the port masks before the exp).
    core = model.layers[0].core
    h = block_input(torch, cfg, XLSTM_TRAIN_B, MLSTM_LONG_T)
    grads = torch.autograd.grad(XL.mlstm_scan(core, h).float().sum(),
                                list(core.values()))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"xlstm mLSTM layer gradient at {XLSTM_TRAIN_B}x{MLSTM_LONG_T}: "
        f"finite {finite}")
    if not finite:
        fail("xlstm mLSTM gradient at T=4096 is not finite")
    train["mlstm_grad_finite_t4096"] = finite
    del model, opt, core, h, grads
    gc.collect()
    torch.cuda.empty_cache()
    if n_pre + n_fwd + n_train:
        fail(f"xlstm: {n_pre + n_fwd + n_train} flash launches on a path "
             "with no attention")
    return {**pre, "decode_vs_forward": worst, "serve_prefill_ms": srv[0],
            "serve_decode_ms_per_token": srv[1], "train": train}


KIMI_ARCH, DEEPSEEK_ARCH = "kimi-k2-1t-a32b", "deepseek-v3-671b"
KIMI_LAYERS = 2                 # first_k_dense: one dense, one MoE layer
DEEPSEEK_LAYERS = 4             # three dense MLA layers, one MoE layer
MOE_B, MOE_T = 4, 2048
MOE_BLOCK_TOKENS = (64, 256)    # the fp32 MoE block's a2a inputs
MOE_LOCAL_TOKENS = 4            # ... and its moe_local (decode) input
MOE_BLOCK_CF = 4.0
MOE_SMOKE_T = 10                # the smoke-width witness, card vs the CPU


@contextlib.contextmanager
def moe_taps(MOE):
    """While open, ``moe._router`` and ``moe._dispatch_local`` run as
    ever and the yielded dict keeps each router call's ids (sorted in each
    row: the top-k sets), the dispatched assignments and how many of them
    past their expert's capacity were dropped."""
    seen = {"ids": [], "assignments": 0, "dropped": 0}
    router, dispatch = MOE._router, MOE._dispatch_local

    def tap_router(p, x, top_k):
        w, ids, aux = router(p, x, top_k)
        seen["ids"].append(ids.sort(dim=-1).values)
        return w, ids, aux

    def tap_dispatch(xf, ids, n_experts, cap):
        buf, slot, keep = dispatch(xf, ids, n_experts, cap)
        seen["assignments"] += keep.numel()
        seen["dropped"] += int((~keep).sum())
        return buf, slot, keep
    MOE._router, MOE._dispatch_local = tap_router, tap_dispatch
    try:
        yield seen
    finally:
        MOE._router, MOE._dispatch_local = router, dispatch


def moe_prefill_checks(torch, ops, ref, m, cfg, batch, label):
    """One more bf16 prefill of a MoE model (moe_impl "a2a"): each of its
    flash calls held to the plain version on its own operands by
    ``check_rows``, the (token, slot) assignments dropped at the config's
    capacity factor counted, and the tokens whose top-k expert sets differ
    from a prefill with plain attention (random init routes on small
    logit gaps, so the bf16 rounding of either route flips some)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.steps import make_prefill_step

    prefill = make_prefill_step(m, cfg)
    with flash_calls_held(torch, ops, ref, f"{label} bf16 prefill") as seen, \
            moe_taps(MOE) as taps:
        prefill(m, batch)
    if seen["calls"] != cfg.n_layers:
        fail(f"{label}: {seen['calls']} flash calls held, expected "
             f"{cfg.n_layers}")
    with attention_as(ops, ref.flash_attention_plain), \
            moe_taps(MOE) as plain:
        prefill(m, batch)
    flips = [int((a != b).any(dim=-1).sum())
             for a, b in zip(taps["ids"], plain["ids"])]
    n_tok = sum(a.shape[0] for a in taps["ids"])
    log(f"{label} bf16 prefill {MOE_B}x{MOE_T}: each of its {seen['calls']} "
        f"flash calls held to the plain version on its own operands (worst "
        f"relative L2 {seen['whole']:.3e} whole, {seen['row']:.3e} row); "
        f"a2a at capacity factor {cfg.capacity_factor} dropped "
        f"{taps['dropped']} of {taps['assignments']} (token, slot) "
        f"assignments; {sum(flips)} of {n_tok} tokens route to another "
        f"top-{cfg.top_k} set under plain attention ({flips} a MoE layer)")
    return {"flash_calls_held": seen, "dropped": taps["dropped"],
            "assignments": taps["assignments"], "top_k_set_flips": flips,
            "routed_tokens": n_tok}


def moe_reference(torch, p, x, top_k, cap, shards):
    """The MoE FFN's function, written plainly: x [N, d] fp32; the router
    (fp32 softmax, top k, renormalized); in each shard (a list of token
    rows, in order) an expert keeps its first ``cap`` assignments in
    (token, slot) order and drops the rest; each kept assignment adds
    weight x (x wi_e * sigmoid(x wg_e)) wo_e to its token, expert by
    expert; then the shared expert.  Returns (y [N, d], dropped)."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ids_h = ids.cpu().tolist()
    by_e, dropped = {}, 0
    for rows in shards:
        count = {}
        for n in rows:
            for j, e in enumerate(ids_h[n]):
                if count.get(e, 0) < cap:
                    by_e.setdefault(e, []).append((n, j))
                else:
                    dropped += 1
                count[e] = count.get(e, 0) + 1
    y = torch.zeros_like(x)
    for e, pairs in by_e.items():
        rows = torch.tensor([n for n, _ in pairs], device=x.device)
        cols = torch.tensor([j for _, j in pairs], device=x.device)
        xe = x[rows]
        h = (xe @ p["wi"][e]) * torch.sigmoid(xe @ p["wg"][e])
        y.index_add_(0, rows, (h @ p["wo"][e]) * w[rows, cols][:, None])
    s = p["shared"]
    y = y + (x @ s["wi"]) * torch.sigmoid(x @ s["wg"]) @ s["wo"]
    return y, dropped


def moe_block_phase(torch, cfg, label):
    """The MoE block alone at full width in fp32 (kimi-k2: 384 experts of
    7168 x 2048, 63 GiB; nothing else resident), random from seed 0:
    ``moe_dense`` against :func:`moe_reference`, and ``moe_a2a`` (N tokens
    of one sequence, split by sequence over the entries) and ``moe_local``
    (MOE_LOCAL_TOKENS tokens of one position) over four virtual entries of
    the card and over one entry, each against the reference with its own
    shards' drops, at PATH_RTOL / PATH_ATOL."""
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import moe as MOE

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.moe_init(gen, cfg.d_model, cfg.d_ff_moe, cfg.n_experts,
                     torch.float32, n_shared=cfg.n_shared_experts)
    torch.cuda.synchronize()
    w_bytes = torch.cuda.memory_allocated() - base
    log(f"{label} MoE block in fp32: {w_bytes / 2**30:.2f} GiB of weights "
        f"({base / 2**30:.2f} GiB resident before), built in "
        f"{time.perf_counter() - t0:.2f} s")
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xgen = torch.Generator(device="cuda").manual_seed(11)
    out = {"weight_bytes": w_bytes, "cases": []}

    def held(name, got, want, dropped, ms):
        err = check_close(torch, name, got, want, PATH_RTOL, PATH_ATOL)
        log(f"{name}: max|err| {err:.3e} (rtol {PATH_RTOL}, atol "
            f"{PATH_ATOL}), {dropped} assignments dropped, {ms:.3f} ms")
        out["cases"].append({"name": name, "max_abs_err": err,
                             "dropped": dropped, "ms": ms})
    torch.cuda.reset_peak_memory_stats()
    for n in MOE_BLOCK_TOKENS:
        x = torch.randn(1, n, d, generator=xgen, device="cuda")
        if n == min(MOE_BLOCK_TOKENS):
            want, dropped = moe_reference(torch, p, x[0], k, n * k,
                                          [range(n)])
            held(f"{label} moe_dense N={n}", MOE.moe_dense(p, x, k)[0][0],
                 want, dropped, median_ms(torch, lambda: MOE.moe_dense(
                     p, x, k), reps=3, launches=2))
        for n_dev in (4, 1):
            mesh = DeviceMesh(["cuda:0"] * n_dev)
            tl = n // n_dev
            cap = MOE._capacity(tl, k, MOE_BLOCK_CF, e, 4)
            want, dropped = moe_reference(
                torch, p, x[0], k, cap,
                [range(j * tl, (j + 1) * tl) for j in range(n_dev)])
            held(f"{label} moe_a2a N={n} over {n_dev} entries (cap {cap})",
                 MOE.moe_a2a(p, x, k, MOE_BLOCK_CF, mesh)[0][0], want,
                 dropped, median_ms(torch, lambda: MOE.moe_a2a(
                     p, x, k, MOE_BLOCK_CF, mesh), reps=3, launches=2))
        del x, want
    n = MOE_LOCAL_TOKENS
    x = torch.randn(n, 1, d, generator=xgen, device="cuda")
    cap = MOE._capacity(n, k, MOE_BLOCK_CF, e, 1)
    want, dropped = moe_reference(torch, p, x[:, 0], k, cap, [range(n)])
    for n_dev in (4, 1):
        mesh = DeviceMesh(["cuda:0"] * n_dev)
        held(f"{label} moe_local {n} tokens over {n_dev} entries (cap "
             f"{cap})", MOE.moe_local(p, x, k, MOE_BLOCK_CF, mesh)[0][:, 0],
             want, dropped, median_ms(torch, lambda: MOE.moe_local(
                 p, x, k, MOE_BLOCK_CF, mesh), reps=3, launches=2))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"{label} MoE block: peak memory {out['peak_bytes'] / 2**30:.2f} "
        f"GiB; {time.perf_counter() - t0:.2f} s")
    del p, x, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def smoke_witness(torch, ops, arch, label):
    """The smoke config in fp32 with moe_impl "a2a" on four virtual
    entries of the card against the same weights on four CPU entries:
    all logits of a forward over MOE_SMOKE_T tokens (relative L2 within
    LM_REL_L2, the limit the card-against-CPU readings are held to) and
    of decode over the same positions, the aux loss beside them."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.steps import build_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    models = {dev: build_model(cfg, device=dev, seed=3, moe_impl="a2a",
                               mesh=DeviceMesh([dev] * 4))
              for dev in ("cuda", "cpu")}
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, MOE_SMOKE_T)).astype(np.int32)
    fwd, dec = {}, {}
    for dev, m in models.items():
        tk = torch.as_tensor(toks, device=dev)
        lg, aux = m(tk)
        fwd[dev] = (lg.float().cpu(), float(aux))
        cache = m.init_cache(2, MOE_SMOKE_T)
        dec[dev] = torch.cat([m.decode_step(cache, tk[:, i:i + 1], i)[0]
                              for i in range(MOE_SMOKE_T)], 1).float().cpu()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    r_fwd = rel(fwd["cuda"][0], fwd["cpu"][0])
    r_dec = rel(dec["cuda"], dec["cpu"])
    log(f"{label} smoke width fp32, card against the CPU (moe_impl a2a on "
        f"4 entries each): forward logits relative L2 {r_fwd:.3e}, decode "
        f"{r_dec:.3e} (limit {LM_REL_L2}); aux {fwd['cuda'][1]:.6f} / "
        f"{fwd['cpu'][1]:.6f}")
    if not (r_fwd <= LM_REL_L2 and r_dec <= LM_REL_L2):
        fail(f"{label} smoke width: card differs from the CPU by {r_fwd:.3e}"
             f" (forward), {r_dec:.3e} (decode)")
    return {"forward_rel_l2": r_fwd, "decode_rel_l2": r_dec,
            "aux": [fwd["cuda"][1], fwd["cpu"][1]]}


def flash_shape_entry(row, name, launches):
    """A flash row as a ``kernels``-line entry of its own."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:26",
            "launches": launches, **{k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}


def kimi_phase(torch, ops, ref):
    """kimi-k2 cut to 2 layers at full width (d_model 7168; 64 query heads
    over 8 KV heads of 112; a dense layer, then 384 experts top-8 and a
    shared expert; 19.93 B parameters, 37.13 GiB bf16, random from seed
    0): the flash kernel at its prefill shape (G = 8, d = 112), the bf16
    prefill at 4x2048 with moe_impl "a2a" over ``DeviceMesh(["cuda:0"])``
    (each flash call held, drops and routing flips counted), the eager /
    captured decode pair (``moe_local``), ``launch.serve`` at the cut
    (``moe_dense``, as JAX's), the MoE block alone in fp32, and the
    smoke-width witness.  Returns (flash launches, the flash row, a
    summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DeviceMesh

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(KIMI_ARCH), n_layers=KIMI_LAYERS)
    row = flash_at_shape(torch, ops, ref, cfg, MOE_B, MOE_T,
                         "kimi prefill shape")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (MOE_B, MOE_T)).astype(np.int32), device="cuda")}

    def then(m):
        out = moe_prefill_checks(torch, ops, ref, m, cfg, batch, "kimi")
        out["decode_pair"] = decode_pair(torch, m, cfg, 4, 16, 16,
                                         f"{cfg.name} ({KIMI_LAYERS} layers,"
                                         " moe_local)")
        return out
    n_pre, pre = lm_prefill(
        torch, ops, ref, cfg, MOE_B, MOE_T, seed=1, timed=2, profile=True,
        then=then, hold=False,
        model_kw={"moe_impl": "a2a", "mesh": DeviceMesh(["cuda:0"])})
    del batch
    srv = drive_serve(torch, KIMI_ARCH, f"kimi ({KIMI_LAYERS} layers)",
                      cfg=cfg)
    block = moe_block_phase(torch, cfg, "kimi")
    smoke = smoke_witness(torch, ops, KIMI_ARCH, "kimi")
    return n_pre, row, {**pre, "flash_row": row, "moe_block": block,
                        "smoke_witness": smoke,
                        "serve_prefill_ms": srv[0],
                        "serve_decode_ms_per_token": srv[1]}


@tallied_as("checks")
def mla_flash_row(torch, ops, ref, cfg, b, t):
    """The flash kernel as MLA calls it at b x t: BH = b heads, G = 1, dqk
    = qk_nope + qk_rope (192), V at its own width v_head_dim (128), bf16,
    causal; held by ``check_rows``, two launches bit for bit, timed beside
    the plain version and SDPA on the same V, with the bound of its work
    (2 (dqk + dv) flops a kept pair).  Then the call MLA made before V took
    its own width: V zero-padded to dqk (the padded output columns must
    stay 0), held and timed the same way, with its own bound (4 dqk)."""
    import torch.nn.functional as F
    bh, dqk, dv = b * cfg.n_heads, cfg.qk_nope + cfg.qk_rope, cfg.v_head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k = (torch.randn(bh, t, dqk, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    v = torch.randn(bh, t, dv, generator=gen, device="cuda").bfloat16()
    vp = F.pad(v, (0, dqk - dv))
    rows = {}
    for tag, vv in (("V", v), ("padded", vp)):
        w = vv.shape[2]
        name = (f"flash MLA prefill shape BH={bh} G=1 d={dqk} (V {dv}"
                + (f" padded to {dqk})" if w > dv else ")"))
        got = ops.flash_attention(q, k, vv, True)
        want = ref.flash_attention_plain(q, k, vv, True)
        r_whole, r_row = check_rows(torch, name, got, want)
        err = float((got.float() - want.float()).abs().max())
        if w > dv and float(got[..., dv:].abs().max()) != 0.0:
            fail(f"{name}: the padded output columns are not zero")
        if not torch.equal(ops.flash_attention(q, k, vv, True), got):
            fail(f"{name}: two launches differ")
        del got, want
        t_k = median_ms(torch, lambda: ops.flash_attention(q, k, vv, True))
        t_p = median_ms(torch, lambda: ref.flash_attention_plain(
            q, k, vv, True), reps=3, launches=3)
        t_l = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
        b_ms, b_by = flash_bound(bh, t, t, dqk, True, 2, PEAK_BF16_FLOP_S,
                                 dv=w)
        log(f"kernel flash_attention {name} T={t} causal bf16: kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"F.scaled_dot_product_attention (V {dv} wide) {t_l:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); relative L2 {r_whole:.3e} "
            f"whole, {r_row:.3e} worst row, max|err| {err:.2e}")
        rows[tag] = {
            "shape": f"BH={bh}, G=1, T={t}, d={dqk}, V {dv}"
                     + (f" padded to {dqk}" if w > dv else "")
                     + ", bf16, causal",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "library": f"V {dv} wide", "rel_l2_whole": r_whole,
            "rel_l2_worst_row": r_row}
    del q, k, v, vp
    torch.cuda.empty_cache()
    return {**rows["V"], "padded": rows["padded"]}


def deepseek_phase(torch, ops, ref):
    """deepseek-v3 cut to 4 layers at full width (d_model 7168; MLA with
    128 heads, q_lora 1536, kv_lora 512, qk 128 + 64, v 128; three dense
    layers, then 256 experts top-8 and a shared expert; 15.11 B
    parameters, 28.15 GiB bf16): the flash kernel at MLA's prefill shape
    (d = 192, V 128 wide), the bf16 prefill at 4x2048 (moe_impl "a2a", each
    flash call held), the decode pair, ``launch.serve`` at the cut, the
    fp32 witness (absorbed decode against the forward at the 4 layers,
    56.3 GiB) and the smoke-width witness.  Returns (flash launches, the
    flash row, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.steps import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(DEEPSEEK_ARCH),
                              n_layers=DEEPSEEK_LAYERS)
    row = mla_flash_row(torch, ops, ref, cfg, MOE_B, MOE_T)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (MOE_B, MOE_T)).astype(np.int32), device="cuda")}

    def then(m):
        out = moe_prefill_checks(torch, ops, ref, m, cfg, batch, "deepseek")
        out["decode_pair"] = decode_pair(
            torch, m, cfg, 4, 16, 16,
            f"{cfg.name} ({DEEPSEEK_LAYERS} layers, moe_local)")
        return out
    n_pre, pre = lm_prefill(
        torch, ops, ref, cfg, MOE_B, MOE_T, seed=1, timed=2, profile=True,
        then=then, hold=False,
        model_kw={"moe_impl": "a2a", "mesh": DeviceMesh(["cuda:0"])})
    del batch
    srv = drive_serve(torch, DEEPSEEK_ARCH,
                      f"deepseek ({DEEPSEEK_LAYERS} layers)", cfg=cfg)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (DECODE_B, DECODE_T)).astype(np.int32), device="cuda")

    def latent():
        cache = model.init_cache(DECODE_B, DECODE_T)
        want = {"c": (DECODE_B, DECODE_T, cfg.kv_lora),
                "k_rope": (DECODE_B, DECODE_T, cfg.qk_rope)}
        if any({k: tuple(v.shape) for k, v in lc.items()} != want
               for lc in cache):
            fail(f"deepseek caches are not the latent {want}")
        return cache
    n_fwd, _, worst = decode_witness(
        torch, ops, model, f"deepseek ({DEEPSEEK_LAYERS} layers, absorbed "
        "MLA decode)", lambda: model(toks), latent, toks, DEEPSEEK_LAYERS)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    del model, toks
    gc.collect()
    torch.cuda.empty_cache()
    smoke = smoke_witness(torch, ops, DEEPSEEK_ARCH, "deepseek")
    return n_pre + n_fwd, row, {
        **pre, "flash_row": row, "decode_vs_forward": worst,
        "fp32_weight_bytes": w_bytes, "smoke_witness": smoke,
        "serve_prefill_ms": srv[0], "serve_decode_ms_per_token": srv[1],
        "flash_launches": {"prefill": n_pre, "fp32_forward": n_fwd}}


# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def attention_as(ops, fn):
    """While open, ``ops.flash_attention`` is ``fn``: the check's own
    reference runs of the model (no launch is counted)."""
    real = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = real


def chunked_attention(q, k, v, causal=True, window=0, chunk=256):
    """``ops.flash_attention``'s function through the port's
    ``_sdpa_chunked``, which rounds P to the value dtype for the P.V
    product as the kernel's bf16 body (and JAX) do: a run of the model
    with this attention shows what that rounding alone does to the
    logits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.attention import _sdpa_chunked
    t, d, dv = q.shape[1], q.shape[2], v.shape[2]
    pos = torch.arange(t, device=q.device)
    o = _sdpa_chunked(*(x.transpose(0, 1)[None]
                        for x in (q, k, F.pad(v, (0, d - dv)))), pos,
                      pos, causal, window, d ** -0.5, chunk)
    return o[0].transpose(0, 1)[..., :dv].contiguous()


def flash_bound(bh, tq, tk, d, causal, elem_bytes, peak_flop_s,
                kv_heads=None, window=0, dv=None):
    """Bytes: q, k, v read once (k / v over ``kv_heads`` heads, bh when
    None), out written once; operations: 2 (d + dv) flops (two products)
    per (query, key) pair the mask keeps (under a window W, query i keeps
    keys max(0, i - W + 1) .. i); v and out ``dv`` wide (d when None)."""
    kv = bh if kv_heads is None else kv_heads
    dv = d if dv is None else dv
    if causal:
        pairs = sum(min(tk, i + 1) - (max(0, i - window + 1) if window
                                      else 0) for i in range(tq))
    else:
        pairs = tq * tk
    return bound_ms(elem_bytes * (d * (bh * tq + kv * tk)
                                  + dv * (kv * tk + bh * tq)),
                    2.0 * (d + dv) * bh * pairs, peak_flop_s)


def sdpa_yardstick(torch, q, k, v, window=0, causal=True):
    """``F.scaled_dot_product_attention`` (causal, or with ``causal``
    off every key visible; under a window W with a boolean ``attn_mask``
    holding ``0 <= qpos - kpos < W``) on the kernel's operands, k / v
    with one head per G query heads:
    ``enable_gqa=True`` where the installed torch takes it (2.5 on), else
    on heads repeated G times.  Returns (the call, how grouped heads and
    the mask were passed)."""
    import torch.nn.functional as F
    g = q.shape[0] // k.shape[0]
    q4, k4, v4 = q[None], k[None], v[None]
    kw, how = {"is_causal": causal}, "" if causal else ", is_causal=False"
    if window:
        t = q.shape[1]
        dif = (torch.arange(t, device=q.device)[:, None]
               - torch.arange(k.shape[1], device=q.device)[None, :])
        kw = {"attn_mask": (dif >= 0) & (dif < window)}
        how = ", boolean attn_mask"
    if g == 1:
        return (lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)), \
            "one KV head per query head" + how
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True, **kw)), "enable_gqa=True" + how
    kr, vr = (x.repeat_interleave(g, dim=0)[None] for x in (k, v))
    return (lambda: F.scaled_dot_product_attention(q4, kr, vr, **kw)), \
        "KV heads repeated (no enable_gqa)" + how


@tallied_as("checks")
def flash_kernel_phase(torch, ops, ref):
    """The flash kernel against its plain version on the JAX sweep, its
    bf16 case, ragged and grouped-head cases, gemma3's head dims and
    sliding windows, and the path shape; returns the kernels-line entry
    (the path shape in bf16 with qwen3-0.6b's grouped KV heads, as the
    prefill calls it), the path-shape readings and the rows of gemma3's
    prefill shape."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def qkv(bh, tq, tk, d, dtype, g=1):
        return [torch.randn(n, t, d, generator=gen, device="cuda"
                            ).to(dtype)
                for n, t in ((bh, tq), (bh // g, tk), (bh // g, tk))]

    cases = [(tq, tk, h, d, c, torch.float32, 1)
             for tq, tk, h, d, c in FLASH_SHAPES]
    cases += [(128, 128, 2, 64, True, torch.bfloat16, 1),
              (200, 200, 3, 128, True, torch.float32, 1),
              (200, 200, 3, 128, True, torch.bfloat16, 1)]
    cases += [(tq, tk, h, d, c, dt, g) for tq, tk, h, d, c, dt, g in (
        (128, 128, 4, 64, True, torch.bfloat16, 2),
        (200, 200, 8, 128, True, torch.bfloat16, 8),
        (77, 130, 4, 40, False, torch.bfloat16, 2),
        (256, 128, 4, 128, True, torch.float32, 2),
        (200, 200, 8, 128, True, torch.float32, 8))]
    for tq, tk, h, d, causal, dt, g in cases:
        q, k, v = qkv(h, tq, tk, d, dt, g)
        tol = ((0.0, FLASH_ATOL) if dt == torch.float32
               else (FLASH_BF16_TOL, FLASH_BF16_TOL))
        name = f"flash {tq}x{tk} h={h} G={g} d={d} causal={causal} {dt}"
        got = ops.flash_attention(q, k, v, causal)
        want = ref.flash_attention_plain(q, k, v, causal)
        check_close(torch, name, got, want, *tol)
        if dt == torch.bfloat16:
            r_whole, r_row = check_rows(torch, name, got, want)
            log(f"{name}: relative L2 {r_whole:.3e} whole, {r_row:.3e} "
                "worst row")
    log(f"flash: {len(cases)} sweep / bf16 / ragged / grouped-head cases "
        "within tolerance")
    n_wide = flash_window_cases(torch, ops, ref, qkv)
    log(f"flash: {n_wide} wide-head / sliding-window cases within "
        "tolerance")

    # qwen3-0.6b prefill heads at B=4: 64 query heads of 128 over 32 KV
    # heads (G=2, the layout the prefill passes), and the same call with
    # one KV head per query head (the layout before grouped heads were
    # read in the kernel), in bf16 and fp32.
    bh, t, d = LM_B * 16, LM_T, 128
    entry, path_rel = None, {}
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        for g in (2, 1):
            q, k, v = qkv(bh, t, t, d, dt, g)
            name = f"flash path shape {str(dt)[6:]} G={g}"
            got = ops.flash_attention(q, k, v, True)
            want = ref.flash_attention_plain(q, k, v, True)
            if bf16:
                # Late rows average ~i keys, so their values are ~0.03 and
                # an elementwise 3e-2 would not see a dropped KV tile there.
                r_whole, r_row = check_rows(torch, name, got, want)
                err = float((got.float() - want.float()).abs().max())
                log(f"{name}: relative L2 {r_whole:.3e} whole (limit "
                    f"{FLASH_BF16_WHOLE:.3e}), {r_row:.3e} worst row (limit "
                    f"{FLASH_BF16_ROW:.3e}), max|err| {err:.3e}")
                path_rel[f"G={g}"] = {"whole": r_whole, "worst_row": r_row}
            else:
                err = check_close(torch, name, got, want, 0.0, FLASH_ATOL)
            del got, want
            t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                               True))
            t_p = median_ms(torch, lambda: ref.flash_attention_plain(
                q, k, v, True), reps=3, launches=5)
            lib, how = sdpa_yardstick(torch, q, k, v)
            t_l = median_ms(torch, lib)
            b_ms, b_by = flash_bound(bh, t, t, d, True, 2 if bf16 else 4,
                                     PEAK_BF16_FLOP_S if bf16
                                     else PEAK_FP32_FLOP_S, kv_heads=bh // g)
            body = ops.flash_body(dt, d, d)
            log(f"kernel flash_attention BH={bh} KV heads={bh // g} T={t} "
                f"d={d} causal {dt} ({body} body): kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, F.scaled_dot_product_attention "
                f"({how}) {t_l:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
            path_rel.setdefault("ms", {})[f"{str(dt)[6:]} G={g}"] = {
                "body": body, "kernel": t_k, "plain": t_p, "sdpa": t_l,
                "bound": b_ms}
            if entry is None:
                entry = {"name": "flash_attention", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention.py"
                                     ":26",
                         "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": t_l}
            del q, k, v
    return entry, path_rel, flash_gemma3_rows(torch, ops, ref, qkv)


# The head dims past 128 (136; 168: gemma3-27b; 170, which TMA cannot take;
# 192: deepseek-v3's MLA; 240: gemma3-12b; 256: the widest of the
# warp-specialised body) and windows (1, 5, 64, gemma3's 1024, and >= T:
# none); (T, heads, G, d, window, dv): V d wide, then 128 (MLA's width)
# and G = 8.  T is ragged against every body's tiles; 100 and 1000 end
# inside a KV tile.
FLASH_WIDE_CASES = [(T, h, g, d, w, d)
                    for d in (136, 168, 170, 192, 240, 256)
                    for T, h, g, w in ((300, 4, 2, 0), (300, 4, 2, 1),
                                       (300, 4, 1, 5), (300, 4, 2, 64),
                                       (1300, 2, 2, 1024),
                                       (300, 2, 1, 1024))]
FLASH_WIDE_CASES += [(T, h, g, d, w, 128)
                     for d in (168, 170, 192, 240)
                     for T, h, g, w in ((300, 4, 2, 0), (300, 4, 1, 5),
                                        (1300, 2, 2, 1024))]
FLASH_WIDE_CASES += [(300, 8, 8, 240, 0, 240), (300, 8, 8, 192, 64, 128)]
FLASH_WINDOW_CASES = [(250, 4, 2, 128, 100, 128), (1100, 2, 1, 64, 1000, 64),
                      (77, 2, 2, 40, 3, 40)]


def flash_window_cases(torch, ops, ref, qkv):
    """The kernel at the head dims past 128 (V d or 128 wide) and under
    sliding windows, fp32 at atol 2e-5 and bf16 under ``check_rows``, two
    launches bit for bit; returns the case count."""
    n = 0
    for T, h, g, d, w, dv in FLASH_WIDE_CASES + FLASH_WINDOW_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(h, T, T, d, dt, g)
            v = v[..., :dv].contiguous()
            name = (f"flash {T}x{T} h={h} G={g} d={d} dv={dv} window={w} "
                    f"{dt}")
            got = ops.flash_attention(q, k, v, True, w)
            want = ref.flash_attention_plain(q, k, v, True, w)
            if dt == torch.float32:
                check_close(torch, name, got, want, 0.0, FLASH_ATOL)
            else:
                check_rows(torch, name, got, want)
            if not torch.equal(ops.flash_attention(q, k, v, True, w), got):
                fail(f"{name}: two launches differ")
            n += 1
    return n


GEMMA_FLASH_WINDOW = 1024


def flash_gemma3_rows(torch, ops, ref, qkv):
    """The kernel at gemma3-12b's prefill shape (B=4: 64 query heads of
    240 over 32 KV heads, T=2048, bf16, causal), without and with its
    local layers' window of 1024, and at gemma3-27b's (128 query heads of
    168 over 64 KV heads), each held by ``check_rows``, two launches bit
    for bit, timed beside the plain version and SDPA with the bound;
    returns a row per shape."""
    rows = {}
    for label, bh, d, w in (("window=0", LM_B * 16, 240, 0),
                            (f"window={GEMMA_FLASH_WINDOW}", LM_B * 16,
                             240, GEMMA_FLASH_WINDOW),
                            ("gemma3-27b", LM_B * 32, 168, 0)):
        t = LM_T
        if label != f"window={GEMMA_FLASH_WINDOW}":
            q, k, v = qkv(bh, t, t, d, torch.bfloat16, 2)
        model = "gemma3-27b" if d == 168 else "gemma3-12b"
        name = f"flash {model} prefill shape window={w}"
        got = ops.flash_attention(q, k, v, True, w)
        want = ref.flash_attention_plain(q, k, v, True, w)
        r_whole, r_row = check_rows(torch, name, got, want)
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(ops.flash_attention(q, k, v, True, w), got):
            fail(f"{name}: two launches differ")
        del got, want
        t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, True, w))
        t_p = median_ms(torch, lambda: ref.flash_attention_plain(
            q, k, v, True, w), reps=3, launches=3)
        lib, how = sdpa_yardstick(torch, q, k, v, w)
        t_l = median_ms(torch, lib)
        b_ms, b_by = flash_bound(bh, t, t, d, True, 2, PEAK_BF16_FLOP_S,
                                 kv_heads=bh // 2, window=w)
        log(f"kernel flash_attention {model} BH={bh} KV heads={bh // 2} "
            f"T={t} d={d} causal window={w} bf16: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, F.scaled_dot_product_attention ({how}) "
            f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); relative L2 "
            f"{r_whole:.3e} whole, {r_row:.3e} worst row, max|err| "
            f"{err:.2e}")
        rows[label] = {
            "shape": f"{model}: BH={bh} over {bh // 2} KV heads, T={t}, "
                     f"d={d}, bf16, causal, window {w}", "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "library": how, "rel_l2_whole": r_whole,
            "rel_l2_worst_row": r_row}
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def lm_phase(torch, ops, ref):
    """qwen3-0.6b prefill (bf16, B=4, T=2048), fp32 decode against
    forward, and ``launch.serve``; see the module docstring.  Returns
    (flash launches over the counted runs, a summary dict)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.steps import build_model, make_prefill_step

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # the GNN phases' state
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {n_par:,} parameters ({cfg.n_params():,} in "
        f"matrices) in {cfg.dtype}, built from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_B, LM_T)).astype(
        np.int32), device="cuda")
    prefill = make_prefill_step(model, cfg)
    batch = {"tokens": tokens}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the prefill path: counts are zeroed just above, read below.
    walls = []
    for _ in range(4):                       # a warm-up, then 3 timed
        t0 = time.perf_counter()
        logits = prefill(model, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the prefill path.
    n_prefill = len(walls)
    if launches["flash_attention"] != cfg.n_layers * n_prefill:
        fail(f"flash launches {launches['flash_attention']} over "
             f"{n_prefill} prefills != {cfg.n_layers} per prefill")
    if tuple(logits.shape) != (LM_B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)} or non-finite")
    with attention_as(ops, ref.flash_attention_plain):
        want = prefill(model, batch)
    with attention_as(ops, chunked_attention):
        wit = prefill(model, batch)
    got32, want32 = logits.float(), want.float()
    rel = float((got32 - want32).norm() / want32.norm())
    rel_wit = float((wit.float() - want32).norm() / want32.norm())
    agree = float((got32.argmax(-1) == want32.argmax(-1)).float().mean())
    prefill_ms = statistics.median(walls[1:])
    log(f"prefill {LM_B}x{LM_T}: wall ms {[round(w, 2) for w in walls]} "
        f"(first is the warm-up), median {prefill_ms:.2f} ms, "
        f"{LM_B * LM_T / prefill_ms * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB the "
        f"earlier phases hold (weights included, max_memory_allocated); "
        f"flash launches {launches['flash_attention']}")
    log(f"prefill logits against plain attention: relative L2 {rel:.3e} "
        f"(limit {LM_REL_L2}), argmax agreement {agree:.3f}; the same "
        f"model with _sdpa_chunked attention (P rounded to bf16, no "
        f"kernel) reads {rel_wit:.3e}")
    if not rel <= LM_REL_L2:
        fail(f"prefill logits differ from plain attention by relative L2 "
             f"{rel:.3e}")
    by_name = profile_call(torch, lambda: prefill(model, batch),
                           f"prefill {LM_B}x{LM_T}")
    flash_dev = None
    if by_name:
        flash_dev = sum(ms for n, ms in by_name.items()
                        if FLASH_BF16 in n)
        dev = sum(by_name.values())
        log(f"flash kernel device time in the profiled prefill: "
            f"{flash_dev:.3f} ms of {dev:.3f} ms of device time "
            f"({100 * flash_dev / dev:.1f}%); device time over the "
            f"unprofiled median wall: {100 * dev / prefill_ms:.1f}%")
    # Decode at launch.serve's shape (8 requests, prompt 32, 16 tokens),
    # eager and captured, each step also under the profiler.
    pair = decode_pair(torch, model, cfg, 8, 32, 16, cfg.name)
    del model, logits, want, wit, prefill
    torch.cuda.empty_cache()

    # fp32 decode against forward at full width.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DECODE_B, DECODE_T)
                                        ).astype(np.int32), device="cuda")
    ops.reset_launches()
    # ---- the forward run: counts are zeroed just above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the forward run.
    if fwd_launches != cfg.n_layers:
        fail(f"forward: flash launches {fwd_launches} != {cfg.n_layers}")
    cache = model.init_cache(DECODE_B, DECODE_T)
    t0 = time.perf_counter()
    worst = 0.0
    scale = float(fwd.abs().max())
    for i in range(DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        worst = max(worst, float((lg[:, 0] - fwd[:, i]).abs().max()))
    dec_s = time.perf_counter() - t0
    log(f"decode against forward, fp32, B={DECODE_B} T={DECODE_T}: max "
        f"|decode - forward| / max |forward| = {worst / scale:.3e} (limit "
        f"{DECODE_TOL}; {DECODE_T} steps in {dec_s:.2f} s)")
    if not worst / scale < DECODE_TOL:
        fail(f"decode differs from forward by {worst / scale:.3e} of max "
             "|logit|")
    del model, fwd, cache
    torch.cuda.empty_cache()

    # The serving loop, launch.serve, at its defaults.
    ops.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", LM_ARCH, "--requests", "8",
                         "--prompt-len", "32", "--gen", "16"])
    drv_s = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"serve: {line}")
    m = re.search(r"prefill: ([\d.]+) ms\s+decode: ([\d.]+) ms \(([\d.]+) "
                  r"ms/token\)", out)
    gens = re.findall(r"^\s+\[([\d, ]+)\]$", out, re.M)
    if rc != 0 or m is None or len(gens) != 3 or any(
            len(g.split(",")) != 16 for g in gens):
        fail(f"launch.serve: exit {rc}, output not as expected")
    log(f"launch.serve: prefill {m.group(1)} ms, decode {m.group(3)} "
        f"ms/token, {drv_s:.2f} s in all; flash launches "
        f"{ops.LAUNCHES['flash_attention']} (prefill by decode steps)")
    summary = {"prefill_ms": walls, "prefill_median_ms": prefill_ms,
               "decode_pair": pair,
               "prefill_peak_bytes": peak, "prefill_rel_l2": rel,
               "prefill_rel_l2_sdpa_chunked": rel_wit,
               "flash_device_ms_in_profiled_prefill": flash_dev,
               "decode_vs_forward": worst / scale,
               "serve_prefill_ms": float(m.group(1)),
               "serve_decode_ms_per_token": float(m.group(3))}
    return launches["flash_attention"] + fwd_launches, summary


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
DIST_ARCH = "qwen3-0.6b"
ZERO_MESHES = ((4, 1), (2, 4))  # (data, model) meshes of virtual entries
ZERO_STEPS = 2
PIPE_STAGES, PIPE_MICRO, PIPE_T = 4, 8, 2048
DRY_CELLS = ("qwen3-0.6b", "granite-8b", "kimi-k2-1t-a32b")
DRY_STEPS = 3                   # the real run: a warm-up and 2 timed steps
DRY_PEAK_REL = 0.25             # predicted peak against the measured one
DRY_GROWTH_REL = 1e-3           # argument bytes against the allocation


def start_dryrun_cells():
    """Phase 22's cells on ``meta`` (``launch.dryrun`` at train_4k on the
    16 x 16 mesh for ``DRY_CELLS``) in a subprocess that sees no card:
    host work, run while phases 17-22 use the card."""
    code = ("from repro_torch.launch import dryrun\n"
            f"for a in {list(DRY_CELLS)!r}:\n"
            "    dryrun.main(['--arch', a, '--shape', 'train_4k', "
            "'--mesh', 'single', '--force'])\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def zero_state_mismatches(torch, SH, Z, ref_opt, zs, model, mesh):
    """Names whose mu, nu or master, gathered from the ZeRO blocks one
    parameter at a time, differ from the unsharded state's bits."""
    specs = Z.opt_state_specs(model, mesh).master
    slots = SH.layer_slots(model)
    bad = []
    for n, p in model.named_parameters():
        for part in ("mu", "nu", "master"):
            full = SH.gather(getattr(zs, part)[n], specs[n], mesh, p.shape,
                             p.device, slots.get(n))
            if not torch.equal(full, getattr(ref_opt, part)[n]):
                bad.append(f"{part}:{n}")
    return bad


def distributed_phase(torch, ops):
    """Phase 21: qwen3-0.6b's parameters at full width shard and gather
    on a 2 x 4 (data, model) mesh of virtual entries of the card; ZeRO-1
    train steps on 4 x 1 and 2 x 4 meshes against ``make_train_step``; the
    28 layers as a 4-stage GPipe pipeline against the per-microbatch loop;
    the distinct-card branch where there is more than one card.  Returns
    (flash launches over the ZeRO and pipeline paths, a summary)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import zero as Z
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import (DeviceMesh, make_device_mesh,
                                         make_local_mesh)
    from repro_torch.models.steps import (build_model, init_train_state,
                                          make_train_step)
    from repro_torch.models.transformer import block_apply

    gc.collect()
    torch.cuda.empty_cache()
    card = torch.device("cuda", 0)
    cfg = get_config(DIST_ARCH)
    summary = {}

    # ---- placement: shard then gather every parameter at full width.
    mesh = make_local_mesh(2, 4, [card] * 8)
    model = build_model(cfg, device=card, seed=0)
    specs = SH.param_specs(model, mesh)
    held = [0] * mesh.size
    t0 = time.perf_counter()
    for n, p in model.named_parameters():
        shards = SH.shard(p, specs[n], mesh)
        for i, sh in enumerate(shards):
            held[i] += sh.numel() * sh.element_size()
        if not torch.equal(SH.gather(shards, specs[n], mesh, p.shape, card),
                           p):
            fail(f"placement: {n} does not round-trip bit for bit")
        del shards
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    reckoned = D.param_bytes(build_model(cfg, device="meta"), mesh)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if set(held) != {reckoned}:
        fail(f"placement: entries hold {sorted(set(held))} bytes, the "
             f"dry-run reckons {reckoned}")
    log(f"placement {cfg.name} on 2 x 4 (data, model), 8 entries of the "
        f"card: every parameter round-trips bit for bit; each entry holds "
        f"{reckoned:,} B ({reckoned / 2**30:.4f} GiB) = the dry-run's "
        f"reckoning, of {total:,} B unsharded; {place_s:.2f} s")
    summary["placement"] = {"entry_bytes": reckoned, "total_bytes": total,
                            "seconds": place_s}

    # ---- ZeRO-1 against the unsharded step.
    it = synthetic_batches(cfg, TRAIN_B, TRAIN_T, seed=1)
    batches = [{k: torch.as_tensor(v, device=card)
                for k, v in next(it).items()} for _ in range(ZERO_STEPS)]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref, ropt = init_train_state(build_model(cfg, device=card, seed=0))
    rstep = make_train_step(ref, cfg)
    r_walls, r_loss = [], []
    for b in batches:
        t0 = time.perf_counter()
        ref, ropt, met = rstep(ref, ropt, b)
        torch.cuda.synchronize()
        r_walls.append((time.perf_counter() - t0) * 1e3)
        r_loss.append(met["loss"].clone())
    r_peak = torch.cuda.max_memory_allocated() - base
    log(f"zero: unsharded {cfg.name} {TRAIN_B}x{TRAIN_T} bf16 steps ms "
        f"{[round(w, 2) for w in r_walls]}, peak {r_peak / 2**30:.3f} GiB "
        f"(params, state and activations), losses "
        f"{[round(float(x), 5) for x in r_loss]}")
    summary["unsharded"] = {"step_ms": r_walls, "peak_bytes": r_peak,
                            "losses": [float(x) for x in r_loss]}
    n_flash = 0
    for nd, nm in ZERO_MESHES:
        zmesh = make_local_mesh(nd, nm, [card] * (nd * nm))
        torch.cuda.synchronize()
        zbase = torch.cuda.memory_allocated()
        model = build_model(cfg, device=card, seed=0)
        zs = Z.zero_init(model, zmesh)
        zstep = Z.make_zero_train_step(model, cfg, zmesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        # ---- the ZeRO path: counts zeroed above, read below.
        walls, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            model, zs, met = zstep(model, zs, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"].clone())
        launched = ops.LAUNCHES["flash_attention"]
        peak = torch.cuda.max_memory_allocated() - zbase
        # ---- end of the ZeRO path.
        n_flash += launched
        per_step = cfg.n_layers * (1 if cfg.remat == "none" else 2)
        if launched != per_step * ZERO_STEPS:
            fail(f"zero {nd}x{nm}: flash launches {launched} != "
                 f"{per_step * ZERO_STEPS}")
        if not all(torch.equal(a, b) for a, b in zip(losses, r_loss)):
            fail(f"zero {nd}x{nm}: losses {losses} != unsharded {r_loss}")
        bad = [n for (n, a), (_, b) in zip(ref.named_parameters(),
                                           model.named_parameters())
               if not torch.equal(a, b)]
        bad += zero_state_mismatches(torch, SH, Z, ropt, zs, model, zmesh)
        if bad or int(zs.step) != int(ropt.step):
            fail(f"zero {nd}x{nm}: not bit for bit the unsharded step: "
                 f"{bad[:8]} ({len(bad)}), step {int(zs.step)}")
        per_entry = Z.shard_bytes(zs)
        log(f"zero {cfg.name} on {nd} x {nm} (data, model): 2 steps bit for "
            f"bit the unsharded steps (loss, parameters, mu, nu, master, "
            f"step); steps ms {[round(w, 2) for w in walls]} against "
            f"{[round(w, 2) for w in r_walls]} unsharded; peak "
            f"{peak / 2**30:.3f} GiB against {r_peak / 2**30:.3f}; state "
            f"per entry {min(per_entry.values()) / 2**30:.3f}-"
            f"{max(per_entry.values()) / 2**30:.3f} GiB "
            f"(state bytes reckoned {D.state_bytes(model, zmesh) / 2**30:.3f}"
            f"); flash launches {launched}")
        summary[f"zero_{nd}x{nm}"] = {
            "step_ms": walls, "peak_bytes": peak,
            "state_bytes_per_entry": per_entry, "flash_launches": launched}
        del model, zs, zstep
        gc.collect()
        torch.cuda.empty_cache()
    del ropt, rstep, batches

    # ---- GPipe: 4 stages of 7 layers, 8 microbatches of 1 x 2048.
    pairs = list(zip(ref.specs, ref.layers))
    per = len(pairs) // PIPE_STAGES
    parts = [pairs[s * per:(s + 1) * per] for s in range(PIPE_STAGES)]
    pmesh = DeviceMesh([card] * PIPE_STAGES, (PIPE_STAGES,), ("stage",))
    gen = torch.Generator(device=card).manual_seed(5)

    def stage(layers, h):
        for spec, bp in layers:
            h, _ = block_apply(cfg, spec, bp, h, None)
        return h

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def pipe():
        return pipeline_apply(stage, parts, x, pmesh)

    def loop():
        return torch.stack([stage(pairs, mb) for mb in x])

    with torch.no_grad():
        x = ref.embed[torch.randint(0, cfg.vocab, (PIPE_MICRO, 1, PIPE_T),
                                    device=card, generator=gen).long()]
        loop()                                               # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        # ---- the pipeline path: counts zeroed above, read below.
        y, t_pipe = timed(pipe)
        p_flash = ops.LAUNCHES["flash_attention"]
        # ---- end of the pipeline path; then loop, loop, pipeline.
        want, t_loop = timed(loop)
        t_loop2 = timed(loop)[1]
        t_pipe2 = timed(pipe)[1]
    pipe_ms, seq_ms = [t_pipe, t_pipe2], [t_loop, t_loop2]
    if p_flash != cfg.n_layers * PIPE_MICRO:
        fail(f"pipeline: flash launches {p_flash} != "
             f"{cfg.n_layers * PIPE_MICRO}")
    if not torch.equal(y, want):
        fail("pipeline: not bit for bit the per-microbatch layer loop")
    n_flash += p_flash
    bubble = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    log(f"pipeline {cfg.name}: {cfg.n_layers} layers in {PIPE_STAGES} "
        f"stages of {per}, {PIPE_MICRO} microbatches of 1x{PIPE_T} bf16 on "
        f"{PIPE_STAGES} entries of the card: bit for bit the sequential "
        f"loop; {[round(t, 2) for t in pipe_ms]} ms against "
        f"{[round(t, 2) for t in seq_ms]} ms sequential (pipeline, loop, "
        f"loop, pipeline); "
        f"bubble {PIPE_STAGES - 1}/{PIPE_MICRO + PIPE_STAGES - 1} = "
        f"{bubble:.4f} of the ticks (one card runs the stages in turn); "
        f"flash launches {p_flash}")
    summary["pipeline"] = {"ms": pipe_ms, "sequential_ms": seq_ms,
                           "bubble": bubble, "flash_launches": p_flash}
    del ref, parts, pairs, x, y, want

    # ---- the distinct-card branch (0 runs on one card).
    distinct = 0
    if torch.cuda.device_count() > 1:
        devs = make_device_mesh(min(4, torch.cuda.device_count())).devices
        ws = [torch.randn(256, 256, device=d, generator=torch.Generator(
            device=d).manual_seed(i)) * 0.06 for i, d in enumerate(devs)]
        xs = torch.randn(8, 4, 256, device=devs[0])
        got = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, xs,
                             DeviceMesh(devs, (len(devs),), ("stage",)))
        seq = []
        for mb in xs:
            h = mb
            for w in ws:
                h = torch.tanh(h.to(w.device) @ w)
            seq.append(h.to(devs[0]))
        if not torch.equal(got, torch.stack(seq)):
            fail("pipeline on distinct cards: not the sequential loop")
        distinct += 1
    log(f"distributed: distinct-card runs {distinct} "
        f"({torch.cuda.device_count()} card(s))")
    summary["distinct_card_runs"] = distinct
    gc.collect()
    torch.cuda.empty_cache()
    return n_flash, summary


def dryrun_phase(torch, ops, proc):
    """Phase 22: the dry-run's reckoning of qwen3-0.6b's train step at
    2 x 4096 on a 1 x 1 mesh against a real run on the card (argument
    bytes against the tensors and the allocation, the predicted peak
    against ``max_memory_allocated``, traced flops against
    ``FlopCounterMode``, the roofline against the step time); then the
    cells of ``DRY_CELLS`` traced on ``meta`` by ``proc``.  Returns (flash
    launches over the real steps, a summary)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.steps import (build_model, init_train_state,
                                          make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    card = torch.device("cuda", 0)
    cfg = get_config(DIST_ARCH)
    cell = ShapeCell(f"train_{TRAIN_B}x{TRAIN_T}", TRAIN_T, TRAIN_B,
                     "train")
    t0 = time.perf_counter()
    rec = D.analyze_cell(cfg, cell, make_local_mesh(1, 1, [card]))
    trace_s = time.perf_counter() - t0
    mem = rec["memory"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, opt = init_train_state(build_model(cfg, device=card, seed=0))
    batch = {k: torch.as_tensor(v, device=card) for k, v in
             next(synthetic_batches(cfg, TRAIN_B, TRAIN_T, seed=2)).items()}
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    held = sum(t.numel() * t.element_size() for t in (
        list(model.parameters()) + list(batch.values())
        + [t for d in (opt.mu, opt.nu, opt.master) for t in d.values()]))
    args = mem["argument_bytes"]
    log(f"dryrun {cfg.name} {TRAIN_B}x{TRAIN_T} train on 1 x 1: traced on "
        f"meta in {trace_s:.1f} s; argument bytes {args:,} reckoned, "
        f"{held:,} held by the parameters, state and batch on the card, "
        f"allocation grew {grown:,} ({(grown - args) / args:+.6%})")
    if held != args:
        fail(f"dryrun: argument bytes {args} != the tensors' {held}")
    if abs(grown - args) > DRY_GROWTH_REL * args:
        fail(f"dryrun: the allocation grew {grown}, not within "
             f"{DRY_GROWTH_REL:.1%} of {args}")
    step = make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the real step: counts zeroed above, read below.
    walls = []
    for _ in range(DRY_STEPS):
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the real step.
    with FlopCounterMode(display=False) as fc:
        step(model, opt, batch)
    torch.cuda.synchronize()
    counted = fc.get_total_flops()
    traced = rec["analysis"]["flops_per_device"]
    kern = rec["analysis"]["kernel_flops"].get("flash_attention", 0.0)
    predicted = mem["per_device_total"]
    med_s = statistics.median(walls[1:]) / 1e3
    rf = rec["roofline"]
    roof_s = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    log(f"dryrun: predicted peak {predicted / 2**30:.3f} GiB (arguments "
        f"{args / 2**30:.3f} + temp {mem['temp_bytes'] / 2**30:.3f} + new "
        f"outputs), measured max_memory_allocated {peak / 2**30:.3f} GiB "
        f"over the model's allocations: ratio {predicted / peak:.4f}")
    log(f"dryrun: traced flops {traced:.6e} = FlopCounterMode on the card "
        f"{counted:.6e} + the flash kernel's formula {kern:.6e} "
        f"(difference {traced - counted - kern:.1f})")
    log(f"dryrun: roofline compute {rf['compute_s'] * 1e3:.2f} ms, memory "
        f"{rf['memory_s'] * 1e3:.2f} ms, collective "
        f"{rf['collective_s'] * 1e3:.2f} ms ({rf['dominant']}); step "
        f"{med_s * 1e3:.2f} ms measured (steps {[round(w, 2) for w in walls]}"
        f"): the step runs at {roof_s / med_s:.4f} of its roofline; flash "
        f"launches {n_flash}")
    if abs(predicted / peak - 1) > DRY_PEAK_REL:
        fail(f"dryrun: predicted peak {predicted} not within "
             f"{DRY_PEAK_REL:.0%} of the measured {peak}")
    if traced - kern != counted:
        fail(f"dryrun: traced flops {traced} - kernel {kern} != "
             f"FlopCounterMode's {counted}")
    if n_flash != DRY_STEPS * cfg.n_layers * (1 if cfg.remat == "none"
                                               else 2):
        fail(f"dryrun: flash launches {n_flash}")
    summary = {"argument_bytes": args, "held_bytes": held,
               "allocation_growth": grown, "predicted_peak": predicted,
               "measured_peak": peak, "traced_flops": traced,
               "flop_counter": counted, "kernel_flops": kern,
               "roofline": rf, "step_ms": walls, "trace_s": trace_s}
    del model, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    for line in out.splitlines():
        log(f"launch.dryrun: {line}")
    if proc.returncode != 0:
        fail(f"launch.dryrun exited {proc.returncode}")
    cells = {}
    for arch in DRY_CELLS:
        with open(D.artifact_path(arch, "train_4k", "single")) as fh:
            r = json.load(fh)
        if r.get("status") != "ok":
            fail(f"dryrun {arch} train_4k: {r.get('error')}")
        rf, m = r["roofline"], r["memory"]
        gib = m["per_device_total"] / 2**30
        log(f"dryrun {arch} train_4k on 16 x 16: {gib:.2f} GiB a device "
            f"(arguments {m['argument_bytes'] / 2**30:.2f}, temp "
            f"{m['temp_bytes'] / 2**30:.2f}; over the card's 80 GB: "
            f"{'yes' if m['per_device_total'] > 80e9 else 'no'}); compute "
            f"{rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, "
            f"collective {rf['collective_s']:.4f} s: {rf['dominant']}; "
            f"traced in {r['trace_s']} s")
        cells[arch] = {"memory": m, "roofline": rf, "trace_s": r["trace_s"],
                       "collective_bytes": r["analysis"][
                           "collective_bytes_per_device"]}
    summary["cells"] = cells
    summary["cells_wait_s"] = time.perf_counter() - t0
    return n_flash, summary


# --------------------------------------------------------------------------- #
# Phase 23: the last contracts (any head dim, out_dtype, the examples)
# --------------------------------------------------------------------------- #
CONTRACT_DS = (257, 264, 320, 512, 1024)
# (label, Tq, Tk, heads, G, causal, window): Tq / Tk ragged against the
# 64-row tiles, Tq < Tk in the non-causal case.
CONTRACT_MODES = (("causal", 300, 300, 4, 1, True, 0),
                  ("non-causal", 200, 333, 4, 1, False, 0),
                  ("windowed", 300, 300, 4, 2, True, 100),
                  ("grouped", 300, 300, 8, 4, True, 0))
WIDE_BH, WIDE_T, WIDE_D = 32, 2048, 512   # the timed single-pass row
# The absorbed-MLA row (DeepSeek-V3's MLA with the latent absorbed, as
# FlashMLA computes it: 128 query heads over one KV head, d = 576, V 512
# wide); on no path of the repo.
MLA_ABS_BH, MLA_ABS_D, MLA_ABS_DV = 128, 576, 512
# (d, dv) of the single-pass body at its instantiations' edges beyond
# CONTRACT_DS (dv = d there), in every mode; bf16.
CONTRACT_SP = ((330, 100), (385, 256), (513, 512), (576, 512), (576, 256))
# ... in fp32 too, and just past one CTA's reach (clusters of two).
CONTRACT_F32 = CONTRACT_SP + ((576, 513), (577, 512))
# (d, dv) of the single-pass bodies in clusters, in every mode, both
# types: C = 2 (640; 600 with dv 513), 3 (1,100 with dv 64: two ranks
# hold no column of v; 1,536).
CONTRACT_CL = ((640, 640), (600, 513), (1100, 64), (1536, 1536))
# ... and at C = 8 (4,096) and past the 8-CTA reach (4,160: Q in rounds,
# v in two slabs), both types, in the modes of CONTRACT_CL_WIDE_MODES
# only (the gpu tests run both causal, and 4,160 non-causal with dv =
# 100 and G = 2; the CPU tests hold the plain version there to JAX).
CONTRACT_CL_WIDE = ((4096, 4096), (4160, 4160))
CONTRACT_CL_WIDE_MODES = ("non-causal", "windowed")
# (d, dv) whose fp32 staged route (bases 4 bytes past 16: 4-byte copies)
# is held bit for bit to the 16-byte copies: each fp32 body's widths, and
# a cluster's.
CONTRACT_F32_STAGED = ((128, 128), (192, 128), (256, 256), (WIDE_D, WIDE_D),
                       (576, 512), (1024, 1000))
# The timed rows past one CTA's reach: d = dv = CL_D, both types (a
# cluster of two).
CL_D = 1024
# fp32 rows timed beside fp32 SDPA: (label, query heads, KV heads, d), T =
# WIDE_T, causal.
FP32_ROWS = (("fp32 body, qwen3-0.6b prefill", 64, 32, 128),
             ("fp32 single-pass body", WIDE_BH, WIDE_BH, WIDE_D))
OUT_DTYPE_TOL = (2e-2, 1e-2)    # JAX's bf16 sweep tolerance (rtol, atol)
# (script, arguments): the user entry points, at their JAX twins' sizes.
EXAMPLES = (("torch_quickstart.py",), ("torch_serve_gnn.py",),
            ("torch_compiler_tour.py",), ("torch_minibatch_serve.py",),
            ("torch_trace_inference.py", "--out", "{tmp}/trace.json"),
            ("torch_lm_pretrain_smoke.py", "qwen3-0.6b"))
EXAMPLE_TIMEOUT = 300
# Runs an example's main() and prints the kernel launches it made.
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "from repro_torch.kernels import ops\n"
    "bodies, real = {}, ops.flash_attention\n"
    "def counted(q, k, v, *a, **kw):\n"
    "    if q.device.type == 'cuda':\n"
    "        b = ops.flash_body(q.dtype, q.shape[-1], v.shape[-1])\n"
    "        bodies[b] = bodies.get(b, 0) + 1\n"
    "    return real(q, k, v, *a, **kw)\n"
    "ops.flash_attention = counted\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code not in (0, None):\n"
    "        raise\n"
    "from repro_torch.kernels import ops\n"
    "print('LAUNCHES ' + json.dumps(ops.launch_totals()))\n"
    "print('FLASH_BODIES ' + json.dumps(bodies))\n")


def start_examples(tmp):
    """Every example in a subprocess of its own, all at once, output to a
    file under ``tmp``; returns name -> (process, log path)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = {}
    for script, *args in EXAMPLES:
        log_path = os.path.join(tmp, script + ".log")
        with open(log_path, "w") as fh:
            procs[script] = (subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER,
                 os.path.join(HERE, "examples", script),
                 *(a.format(tmp=tmp) for a in args)],
                cwd=HERE, env=env, stdout=fh, stderr=subprocess.STDOUT),
                log_path)
    return procs


def finish_examples(procs):
    """Wait for every example; fail on a non-zero exit.  Returns name ->
    {"seconds", "launches"} and the launches summed over all six (and,
    under "flash_bodies", their flash calls on the card by body)."""
    t0, out, total = time.perf_counter(), {}, {}
    try:
        for name, (proc, log_path) in procs.items():
            left = max(1.0, EXAMPLE_TIMEOUT - (time.perf_counter() - t0))
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                fail(f"example {name}: still running after "
                     f"{EXAMPLE_TIMEOUT} s")
            with open(log_path) as fh:
                text = fh.read()
            if rc != 0:
                fail(f"example {name}: exit {rc}\n{text[-3000:]}")
            found = re.findall(r"^LAUNCHES (\{.*\})$", text, re.M)
            if not found:
                fail(f"example {name}: no launch counts printed")
            ran = json.loads(found[-1])
            for k, n in ran.items():
                total[k] = total.get(k, 0) + n
            bodies = re.findall(r"^FLASH_BODIES (\{.*\})$", text, re.M)
            for b, n in (json.loads(bodies[-1]) if bodies else {}).items():
                total.setdefault("flash_bodies", {})
                total["flash_bodies"][b] = total["flash_bodies"].get(b, 0) + n
            out[name] = {"seconds": time.perf_counter() - t0,
                         "launches": ran}
            lines = text.strip().splitlines()
            log(f"example {name}: exit 0 after "
                f"{out[name]['seconds']:.1f} s, launches {ran}; its last "
                f"line: {lines[-2][:100] if len(lines) > 1 else ''}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out, total


def sdpa_backend(torch, fn):
    """The backend ``F.scaled_dot_product_attention`` dispatched to: the
    first of flash, cuDNN, memory-efficient and math that, allowed alone
    (``sdpa_kernel``), gives the unrestricted call's output bit for
    bit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    want = fn()
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel([backend]):
                    got = fn()
            except RuntimeError:            # the backend cannot take it
                continue
        if torch.equal(got, want):
            return backend.name
    return "not found"


@tallied_as("checks")
def contract_flash_cases(torch, ops, ref, qkv):
    """Flash past d = 256 against the plain version in every mode (both
    single-pass bodies, in one CTA and in clusters), V also narrower than
    d, their staged routes (bases off 16 bytes) bit for bit their TMA /
    16-byte-copy routes (in one CTA and in a cluster), and the fp32
    body's and the bf16 body's at d = 128 likewise; returns the number of
    cases."""
    n = 0
    cases = [(d, d, dt) for d in CONTRACT_DS
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(d, dv, torch.bfloat16) for d, dv in CONTRACT_SP]
    cases += [(d, dv, torch.float32) for d, dv in CONTRACT_F32]
    cases += [(d, dv, dt) for d, dv in CONTRACT_CL + CONTRACT_CL_WIDE
              for dt in (torch.float32, torch.bfloat16)]
    for d, dv, dt in cases:
        for label, tq, tk, h, g, causal, window in CONTRACT_MODES:
            if ((d, dv) in CONTRACT_CL_WIDE
                    and label not in CONTRACT_CL_WIDE_MODES):
                continue
            q, k, v = qkv(h, tq, tk, d, dt, g)
            v = v[..., :dv].contiguous()
            name = (f"flash d={d} dv={dv} {label} {tq}x{tk} h={h} G={g} "
                    f"window={window} {str(dt)[6:]} "
                    f"({ops.flash_body(dt, d, dv)}, C = "
                    f"{ops.flash_cluster(dt, d, dv)})")
            got = ops.flash_attention(q, k, v, causal, window)
            want = ref.flash_attention_plain(q, k, v, causal, window)
            if dt == torch.float32:
                check_close(torch, name, got, want, KERNEL_RTOL,
                            KERNEL_ATOL)
            else:
                check_rows(torch, name, got, want)
            n += 1
    staged = [(d, dv, torch.bfloat16)
              for d, dv in ((128, 128), (WIDE_D, WIDE_D),
                            (MLA_ABS_D, MLA_ABS_DV), (CL_D, 1000))]
    staged += [(d, dv, torch.float32) for d, dv in CONTRACT_F32_STAGED]
    for d, dv, dt in staged:
        q, k, v = qkv(4, 300, 300, d, dt, 2)
        v = v[..., :dv].contiguous()
        off = []
        for t in (q, k, v):    # the same values from one element past 16
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            off.append(buf[1:].view(t.shape))
            off[-1].copy_(t)
        got = ops.flash_attention(*off, True)
        if not torch.equal(got, ops.flash_attention(q, k, v, True)):
            fail(f"flash d={d} dv={dv} {str(dt)[6:]} "
                 f"({ops.flash_body(dt, d, dv)}): the staged route's bits "
                 "differ from the TMA / 16-byte-copy route's")
        if dt == torch.float32:
            check_close(torch, f"flash d={d} dv={dv} fp32 staged route", got,
                        ref.flash_attention_plain(q, k, v, True),
                        KERNEL_RTOL, KERNEL_ATOL)
        else:
            check_rows(torch, f"flash d={d} dv={dv} bf16 staged route", got,
                       ref.flash_attention_plain(q, k, v, True))
        n += 1
    return n


@tallied_as("checks")
def out_dtype_cases(torch, ops, ref, qkv, gen):
    """fp32 -> bf16 and bf16 -> fp32 on flash (both bodies), SpDMM and
    SDDMM against the plain versions; returns the number of cases."""
    n = 0
    for d in (128, WIDE_D, 1024):
        for dt, ot in ((torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.float32)):
            q, k, v = qkv(4, 300, 300, d, dt, 2)
            name = f"flash out_dtype d={d} {str(dt)[6:]} -> {str(ot)[6:]}"
            got = ops.flash_attention(q, k, v, True, out_dtype=ot)
            if got.dtype != ot:
                fail(f"{name}: returned {got.dtype}")
            check_close(torch, name, got, ref.flash_attention_plain(
                q, k, v, True, out_dtype=ot), *OUT_DTYPE_TOL)
            if dt == torch.float32 and not torch.equal(
                    got, ops.flash_attention(q, k, v, True).to(ot)):
                fail(f"{name}: not the fp32 result rounded once")
            n += 1
    for n1, w, ns, f in SPDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        vals = torch.randn(n1, w, generator=gen, device="cuda")
        h = torch.randn(ns, f, generator=gen, device="cuda")
        acc = torch.randn(n1, f, generator=gen, device="cuda")
        for hh, ot in ((h, torch.bfloat16), (h.bfloat16(), torch.float32),
                       (h.bfloat16(), torch.bfloat16)):
            name = f"spdmm out_dtype {n1}x{w} f={f} {hh.dtype} -> {ot}"
            got = ops.spdmm(cols, vals, hh, acc, out_dtype=ot)
            check_close(torch, name, got, ref.spdmm_step_ref(
                cols, vals, hh, acc, out_dtype=ot), *OUT_DTYPE_TOL)
            if not torch.equal(got, ops.spdmm(cols, vals, hh, acc).to(ot)):
                fail(f"{name}: not the fp32 result rounded once")
            n += 1
    for n1, w, ns, f in SDDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        hd = torch.randn(n1, f, generator=gen, device="cuda")
        hs = torch.randn(ns, f, generator=gen, device="cuda")
        mask = torch.rand(n1, w, generator=gen, device="cuda") > 0.3
        acc = torch.randn(n1, w, generator=gen, device="cuda")
        for a, b, ot in ((hd, hs, torch.bfloat16),
                         (hd.bfloat16(), hs.bfloat16(), torch.float32),
                         (hd.bfloat16(), hs.bfloat16(), torch.bfloat16)):
            name = f"sddmm out_dtype {n1}x{w} f={f} {a.dtype} -> {ot}"
            got = ops.sddmm(a, b, cols, mask, acc, out_dtype=ot)
            check_close(torch, name, got, ref.sddmm_step_ref(
                a, b, cols, mask, acc, ot), *OUT_DTYPE_TOL)
            if not torch.equal(got, ops.sddmm(a.float(), b.float(), cols,
                                              mask, acc).to(ot)):
                fail(f"{name}: not the fp32 kernel on the widened operands, "
                     "rounded once")
            n += 1
    return n


def contracts_phase(torch, ops, ref):
    """Phase 23.  Returns (the timed flash rows as kernels-line entries,
    the examples' launches summed, the phase's readings)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(23)

    def qkv(bh, tq, tk, d, dtype, g=1):
        return [torch.randn(nh, t, d, generator=gen, device="cuda"
                            ).to(dtype)
                for nh, t in ((bh, tq), (bh // g, tk), (bh // g, tk))]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        procs = start_examples(tmp)
        try:     # the kernel checks run while the examples do
            n_flash = contract_flash_cases(torch, ops, ref, qkv)
            log(f"flash past d = 256: {n_flash} cases (d in {CONTRACT_DS},"
                f" fp32 and bf16; (d, dv) in {CONTRACT_SP} in both, "
                f"{CONTRACT_F32[len(CONTRACT_SP):]} in fp32, clusters "
                f"{CONTRACT_CL} in both, {CONTRACT_CL_WIDE} in both in "
                f"modes {CONTRACT_CL_WIDE_MODES}; causal / non-causal / "
                f"windowed / "
                "G=4, ragged; the staged routes) within tolerance")
            n_out = out_dtype_cases(torch, ops, ref, qkv, gen)
            log(f"out_dtype: {n_out} flash / SpDMM / SDDMM cases within "
                f"rtol {OUT_DTYPE_TOL[0]} / atol {OUT_DTYPE_TOL[1]}, each "
                "bit for bit the fp32 result rounded once")
        except BaseException:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            raise
        examples, ex_launches = finish_examples(procs)
    if ex_launches.get("flash_attention", 0) <= 0 or min(
            ex_launches.get(k, 0) for k in ("gemm", "spdmm")) <= 0:
        fail(f"the examples launched too few kernels: {ex_launches}")

    # Two identical launches, then the timed rows, each counted from zero
    # around the one call that drives it.
    with FLASH_TALLY.into("checks"):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(8, 700, 700, WIDE_D, dt, 2)
            if not torch.equal(ops.flash_attention(q, k, v, True),
                               ops.flash_attention(q, k, v, True)):
                fail(f"flash d={WIDE_D} {dt}: two launches differ")
        del q, k, v
    bf16, fp32 = torch.bfloat16, torch.float32
    entries, rows = [], {}
    for label, bh, kvh, d, dv, dt in (
            (f"single-pass body, d={WIDE_D}", WIDE_BH, WIDE_BH, WIDE_D,
             WIDE_D, bf16),
            ("single-pass body, absorbed MLA", MLA_ABS_BH, 1, MLA_ABS_D,
             MLA_ABS_DV, bf16),
            (f"single-pass body in a cluster, d={CL_D}", WIDE_BH, WIDE_BH,
             CL_D, CL_D, bf16),
            (f"fp32 single-pass body in a cluster, d={CL_D}", WIDE_BH,
             WIDE_BH, CL_D, CL_D, fp32),
            *((lab, bh_, kvh_, d_, d_, fp32) for lab, bh_, kvh_, d_
              in FP32_ROWS)):
        entry, rows[label] = timed_flash_row(torch, ops, ref, gen, label, bh,
                                             kvh, d, dv, dt)
        entries.append(entry)
    seconds = time.perf_counter() - t0
    return entries, ex_launches, {
        "flash_cases": n_flash, "out_dtype_cases": n_out,
        "examples": examples, "timed_rows": rows, "seconds": seconds}


@tallied_as("checks")
def timed_flash_row(torch, ops, ref, gen, label, bh, kvh, d, dv, dt):
    """One timed flash row at T = WIDE_T, causal, with ``bh`` query heads
    over ``kvh`` KV heads: the body ``ops.flash_body`` names, which the C
    entry ``flash_attention_body`` must name too; the one call driven from
    zero launches, a second launch bit for bit, held to the plain version
    (bf16 ``check_rows``, fp32 rtol 1e-5 / atol 1e-4) and timed beside it,
    ``F.scaled_dot_product_attention`` (its backend named by the
    restricted call that gives its bits) and the bound.  Returns (the
    kernels-line entry, the readings)."""
    body = ops.flash_body(dt, d, dv)
    code = ops.entry("flash_body")(int(dt == torch.bfloat16), d, dv)
    if ops.FLASH_BODIES.get(code) != body:
        fail(f"flash {label}: the C entry runs body {code}, ops.flash_body "
             f"says {body}")
    n_cta = ops.flash_cluster(dt, d, dv)
    resident = ops.entry("flash_clusters_resident")(
        int(dt == torch.bfloat16), int(dt == torch.bfloat16), d, dv)
    if n_cta > 1 and resident < 1:
        fail(f"flash {label}: no cluster of {n_cta} CTAs fits the card "
             f"(cudaOccupancyMaxActiveClusters: {resident})")
    t = WIDE_T
    q = torch.randn(bh, t, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(kvh, t, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(kvh, t, dv, generator=gen, device="cuda").to(dt)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, True)
    launches = ops.launch_totals()["flash_attention"]
    name = f"flash {label} at the timed shape"
    if not torch.equal(got, ops.flash_attention(q, k, v, True)):
        fail(f"{name}: two launches differ")
    want = ref.flash_attention_plain(q, k, v, True)
    if dt == torch.bfloat16:
        r_whole, r_row = check_rows(torch, name, got, want)
    else:
        check_close(torch, name, got, want, KERNEL_RTOL, KERNEL_ATOL)
        r_whole, r_row = rows_rel(got, want)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, True),
                    reps=3, launches=5)
    t_p = median_ms(torch, lambda: ref.flash_attention_plain(q, k, v, True),
                    reps=3, launches=3)
    lib, how = sdpa_yardstick(torch, q, k, v)
    t_l = median_ms(torch, lib, reps=3, launches=5)
    backend = sdpa_backend(torch, lib)
    rep = ""
    if kvh < bh:
        # enable_gqa may leave SDPA only its math backend (fp32, or G =
        # 128): the same call on KV heads repeated G times beside it.
        kr, vr = (x.repeat_interleave(bh // kvh, dim=0) for x in (k, v))
        lib_r, _ = sdpa_yardstick(torch, q, kr, vr)
        t_r = median_ms(torch, lib_r, reps=3, launches=5)
        rep = (f"; on KV heads repeated {bh // kvh} times {t_r:.4f} ms "
               f"(backend {sdpa_backend(torch, lib_r)})")
        del kr, vr, lib_r
    peak = PEAK_BF16_FLOP_S if dt == torch.bfloat16 else PEAK_FP32_FLOP_S
    b_ms, b_by = flash_bound(bh, t, t, d, True, q.element_size(), peak,
                             kv_heads=kvh, dv=dv)
    flops = 2.0 * (d + dv) * bh * t * (t + 1) / 2
    shape = (f"BH={bh} over {kvh} KV heads, T={t}, d={d}, dv={dv}, "
             f"{str(dt)[6:]}, causal")
    where = (f"clusters of {n_cta} CTAs, {resident} resident at once"
             if n_cta > 1 else "one CTA a query tile")
    log(f"kernel flash_attention {label} ({body} body, {where}; {shape}): "
        "kernel "
        f"{t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s of useful work, "
        f"{b_ms / t_k:.3f} of the bound), plain {t_p:.4f} ms, "
        f"F.scaled_dot_product_attention ({how}; backend {backend}) "
        f"{t_l:.4f} ms{rep}, bound {b_ms:.4f} ms ({b_by}), relative L2 "
        f"{r_whole:.3e} whole, {r_row:.3e} worst row, max|err| {err:.2e}; "
        f"{launches} launch driven")
    del q, k, v
    torch.cuda.empty_cache()
    entry = {"name": f"flash_attention ({label}: {shape})",
             "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:26",
             "launches": launches, "max_abs_err": err, "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": t_l}
    return entry, {"body": body, "cluster": n_cta,
                   "clusters_resident": resident, "kernel_ms": t_k,
                   "plain_ms": t_p,
                   "sdpa_ms": t_l, "sdpa_backend": backend, "sdpa_call": how,
                   "sdpa_repeated_heads": rep[2:],
                   "bound_ms": b_ms, "tflop_s": flops / t_k / 1e9,
                   "whole": r_whole, "worst_row": r_row}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None,
                    help="also write the run's summary JSON to this path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse")

    from repro_torch.core import graph as G
    from repro_torch.kernels import build, ops, ref
    FLASH_TALLY.install(ops)

    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    t_build = build.build_all()
    for name, rep in build.build_log.items():
        log(f"nvcc {name}.cu:\n{rep.strip()}")
    log(f"build: {len(build.SOURCES)} kernels in {t_build:.2f} s")
    ws_build = ws_nvcc_check(build.build_log.get("flash_attention", ""))
    sp_build = ws_nvcc_check(build.build_log.get("flash_attention", ""),
                             SP_KERNEL, SP_INSTANTIATIONS)
    f32_build = f32_nvcc_check(build.build_log.get("flash_attention", ""))
    gemm_build = gemm_bf16_nvcc_check(build.build_log.get("gemm", ""))
    sparse_build = sparse_nvcc_check(build.build_log.get("gemm", ""),
                                     build.build_log.get("sddmm", ""))

    gemm_entry = kernel_phase(torch, ops, ref)
    bf16_kernels = gemm_entry.pop("bf16")
    launches, fl_prog, responses, peak, engine, co, fl = path_phase(torch)
    spdmm_entry = fl_spdmm_entry(torch, ops, ref, fl_prog)
    t6 = time.perf_counter()
    host_launches, heng, fl_x, host_sum = host_phase(
        torch, engine, fl, fl_prog, responses[-3].output)
    co_launches, co_remap = remap_co_phase(torch, co)
    fl_launches, fl_remap = remap_fl_phase(torch, heng, fl, fl_x)
    densify_entry, gemm_remap = remap_gemm_entry(torch, ops, ref, fl_prog)
    del heng
    log(f"host and remap phase: {time.perf_counter() - t6:.1f} s")
    (rt_launches, gat_prog, rt_resps, rt_peak, rt_wall, rt_reqs,
     rt_pool) = runtime_phase(torch, engine, co, fl)
    sddmm_entry, sddmm_hub = fl_sddmm_entry(torch, ops, ref, gat_prog)
    t7 = time.perf_counter()
    sp_launches, sampled = sampled_phase(torch, G.synthesize("FL"))
    log(f"sampled phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    conf_launches, conformance = conformance_phase(
        torch, co, fl, card, host_sum["budget"], fl_remap)
    log(f"conformance phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    replay_launches, replay = replay_phase(torch, fl, fl_prog, gat_prog,
                                           rt_reqs, rt_pool)
    log(f"replay phase: {time.perf_counter() - t7:.1f} s")
    del engine, fl_prog, gat_prog, rt_pool  # the FL programs of phases 3-5
    gc.collect()
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    live_launches, live = live_phase(torch, card)
    log(f"live phase: {time.perf_counter() - t7:.1f} s")
    t5 = time.perf_counter()
    flash_entry, flash_path, flash_gemma = flash_kernel_phase(torch, ops,
                                                              ref)
    flash_launches, lm = lm_phase(torch, ops, ref)
    lm["flash_path_shape"] = flash_path
    log(f"LM phase (flash checks, prefill, decode, launch.serve): "
        f"{time.perf_counter() - t5:.1f} s")
    t7 = time.perf_counter()
    mesh_launches, mesh = mesh_phase(torch, card)
    log(f"mesh phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    granite_launches, flash_granite, granite = granite_phase(torch, ops, ref)
    log(f"granite phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    gemma_launches, gemma = gemma3_phase(torch, ops, ref)
    gemma["flash_gemma3_shapes"] = flash_gemma
    log(f"gemma3 phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    train_launches, train = train_phase(torch, ops, ref)
    log(f"train phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    flash_nc = flash_noncausal_rows(torch, ops, ref)
    vision_launches, vision_nc, vision = vision_phase(torch, ops, ref)
    log(f"vision phase (non-causal flash rows, prefill, decode, serve): "
        f"{time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    whisper_launches, whisper_nc, whisper = whisper_phase(torch, ops, ref)
    log(f"whisper phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    cross_launches, cross_nc, cross_train = cross_train_phase(torch, ops,
                                                              ref)
    log(f"cross-attention train phase: {time.perf_counter() - t7:.1f} s")
    # Phase 22's cells trace on meta in a subprocess (host work, about a
    # minute) while phases 17-22 use the card.
    cells_proc = start_dryrun_cells()
    try:
        t7 = time.perf_counter()
        hymba_launches, hymba = hymba_phase(torch, ops, ref)
        log(f"hymba phase: {time.perf_counter() - t7:.1f} s")
        t7 = time.perf_counter()
        xlstm = xlstm_phase(torch, ops, ref)
        log(f"xlstm phase: {time.perf_counter() - t7:.1f} s")
        t7 = time.perf_counter()
        kimi_launches, flash_kimi, kimi = kimi_phase(torch, ops, ref)
        log(f"kimi phase: {time.perf_counter() - t7:.1f} s")
        t7 = time.perf_counter()
        mla_launches, flash_mla, deepseek = deepseek_phase(torch, ops, ref)
        log(f"deepseek phase: {time.perf_counter() - t7:.1f} s")
        t7 = time.perf_counter()
        dist_launches, distributed = distributed_phase(torch, ops)
        log(f"distributed phase: {time.perf_counter() - t7:.1f} s")
        t7 = time.perf_counter()
        dry_launches, dryrun = dryrun_phase(torch, ops, cells_proc)
        log(f"dry-run phase: {time.perf_counter() - t7:.1f} s")
    finally:
        if cells_proc.poll() is None:
            cells_proc.kill()
            cells_proc.wait()
    t7 = time.perf_counter()
    wide_entries, ex_launches, contracts = contracts_phase(torch, ops, ref)
    log(f"contracts phase (examples, flash past d = 256, out_dtype): "
        f"{time.perf_counter() - t7:.1f} s")
    ex_bodies = ex_launches.pop("flash_bodies", {})
    flash_nc["vision cross"]["launches"] = vision_nc + cross_nc["vision"]
    flash_nc["whisper encoder"]["launches"] = (whisper_nc
                                               + cross_nc["whisper"])
    flash_entry["launches"] = (flash_launches + granite_launches
                               + gemma_launches + train_launches
                               + vision_launches + whisper_launches
                               + cross_launches + hymba_launches
                               + kimi_launches + mla_launches
                               + dist_launches + dry_launches
                               + ex_launches["flash_attention"])
    kernels = [gemm_entry, spdmm_entry, sddmm_entry]
    for e in kernels:
        e["launches"] = sum(run.get(e["name"], 0) for run in (
            launches, rt_launches, host_launches, co_launches, fl_launches,
            sp_launches, conf_launches, live_launches, mesh_launches,
            replay_launches, ex_launches))
    # The step-list row: the SpDMM kernel's launches on the main path (a
    # launch runs a run of steps; the row above counts the steps).
    block_entry = spdmm_entry.pop("row_block")
    block_entry["launches"] = launches["spdmm_kernel"]
    kernels.append(block_entry)
    kernels.append(flash_entry)
    densify_entry["launches"] = co_launches["densify"] + \
        fl_launches["densify"] + conf_launches["densify"] + \
        live_launches["densify"] + mesh_launches["densify"] + \
        ex_launches["densify"]
    kernels.append(densify_entry)
    kernels.append(flash_shape_entry(
        flash_kimi, "flash_attention (kimi-k2 prefill: G=8, d=112)",
        kimi_launches))
    kernels.append(flash_shape_entry(
        flash_mla, "flash_attention (deepseek-v3 MLA: d=192, dv=128)",
        mla_launches))
    kernels.extend(wide_entries)
    path = bf16_kernels["gemm_4096x128x128"]
    kernels.append({**{k: gemm_entry[k] for k in ("route", "source",
                                                  "replaces")},
                    "name": "gemm (bf16 x / w, the wgmma body: 4096x128x128,"
                            " strided x)",
                    "launches": path["launches"],
                    "max_abs_err": path["max_abs_err"],
                    "ms": path["ms"], "plain_ms": path["plain_ms"],
                    "bound_ms": path["bound_ms"],
                    "bound_by": path["bound_by"],
                    "library_ms": path["torch_matmul_bf16_ms"]})
    for base, tag, row in (
            (spdmm_entry, "bf16 store, FL slice, fp32 h",
             spdmm_entry["bf16_store"]["fp32 h"]),
            (sddmm_entry, "bf16 store, FL slice",
             sddmm_entry["bf16"]["bf16 store"]),
            (sddmm_entry, "bf16 operands, FL slice",
             sddmm_entry["bf16"]["bf16 operands"])):
        kernels.append({**{k: base[k] for k in ("route", "source",
                                                "replaces")},
                        "name": f"{base['name']} ({tag})", **row})
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    spdmm_extra = {k: spdmm_entry[k] for k in ("full_walk_ms",
                                               "padded_bound_ms",
                                               "bf16_store")}
    spdmm_extra["row_block"] = {k: block_entry[k] for k in (
        "library", "one_step_chain_ms", "steps", "nnz", "walked",
        "hub_entries", "hub_walked")}
    kernels = [{k: e[k] for k in order} for e in kernels]
    bodies = {**{k: dict(v) for k, v in FLASH_TALLY.counts.items()},
              "examples": ex_bodies}
    for body in sorted(set().union(*bodies.values())):
        log(f"flash calls on the card, {body} body: "
            f"{bodies['paths'].get(body, 0)} on the driven paths in this "
            f"process (their warm-up and comparison runs included), "
            f"{ex_bodies.get(body, 0)} in the examples, "
            f"{bodies['timing'].get(body, 0)} in timed or profiled repeats "
            f"of a path, {bodies['checks'].get(body, 0)} in kernel checks "
            "and timed kernel rows")
    # The eight path shapes of the bf16 body at d <= 128, as timed above.
    path_row = flash_path["ms"]["bfloat16 G=2"]
    d128_rows = {"qwen3-0.6b prefill": {
        "body": path_row["body"], "ms": path_row["kernel"],
        "library_ms": path_row["sdpa"], "bound_ms": path_row["bound"]}}
    for label, row in (("granite-8b prefill", flash_granite),
                       ("hymba-1.5b prefill", hymba["flash_rows"]["prefill"]),
                       ("kimi-k2 prefill", flash_kimi),
                       ("whisper-base encoder", flash_nc["whisper encoder"]),
                       ("llama-3.2-vision cross", flash_nc["vision cross"]),
                       ("qwen3-0.6b train", train["flash_train_shape"]),
                       ("hymba-1.5b train", hymba["flash_rows"]["train"])):
        d128_rows[label] = {k: row[k] for k in ("body", "ms", "library_ms",
                                                "bound_ms")}
    for label, row in d128_rows.items():
        log(f"flash d <= 128, {label}: {row['body']} body, kernel "
            f"{row['ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (kernel / "
            f"SDPA {row['ms'] / row['library_ms']:.2f}), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.3f} of "
            "it)")
    log(f"flash calls on the paths and in the examples by this tally: "
        f"{sum(bodies['paths'].values()) + sum(ex_bodies.values())} "
        f"(the wrapper's launches in the paths' counted windows: "
        f"{flash_entry['launches']}; a captured call counts here, its "
        "replays there)")
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernels,
                       "spdmm_fl_slice": spdmm_extra,
                       "sddmm_fl_slice": {
                           "padded_bound_ms": sddmm_entry[
                               "padded_bound_ms"],
                           "bf16": sddmm_entry["bf16"]},
                       "sddmm_hub_tile": sddmm_hub,
                       "max_memory_allocated": peak,
                       "requests": [{"id": r.request_id,
                                     "t_loc_s": r.t_loc,
                                     "t_loh_s": r.t_loh,
                                     "cache_hit": r.cache_hit}
                                    for r in responses],
                       "runtime": {
                           "wall_s": rt_wall,
                           "max_memory_allocated": rt_peak,
                           "launches": rt_launches,
                           "requests": [{"id": r.request_id,
                                         "t_loc_s": r.t_loc,
                                         "t_loh_s": r.t_loh,
                                         "batch_size": r.batch_size,
                                         "overlay": r.overlay,
                                         "cache_hit": r.cache_hit}
                                        for r in rt_resps]},
                       "lm": lm,
                       "host_path": host_sum,
                       "remap": {"co": co_remap, "fl": fl_remap,
                                 "gemm_4096x4096x128": gemm_remap},
                       "sampled": sampled, "conformance": conformance,
                       "live": live, "mesh": mesh, "granite": granite,
                       "replay": replay,
                       "flash_granite_shape": flash_granite,
                       "gemma3": gemma, "train": train,
                       "vision": vision, "whisper": whisper,
                       "cross_train": cross_train,
                       "flash_noncausal": flash_nc,
                       "hymba": hymba, "xlstm": xlstm,
                       "kimi": kimi, "deepseek": deepseek,
                       "distributed": distributed, "dryrun": dryrun,
                       "contracts": contracts,
                       "bf16_kernels": bf16_kernels,
                       "flash_ws_build": ws_build,
                       "flash_sp_build": sp_build,
                       "flash_f32_build": f32_build,
                       "flash_bodies": bodies,
                       "flash_d128_rows": d128_rows,
                       "gemm_bf16_build": gemm_build,
                       "densify_sddmm_build": sparse_build,
                       "flash_launches": {
                           "lm": flash_launches, "granite": granite_launches,
                           "gemma3": gemma_launches,
                           "train": train_launches,
                           "vision": vision_launches,
                           "whisper": whisper_launches,
                           "cross_train": cross_launches,
                           "hymba": hymba_launches,
                           "kimi": kimi_launches, "deepseek": mla_launches,
                           "distributed": dist_launches,
                           "dryrun": dry_launches,
                           "examples": ex_launches["flash_attention"]},
                       "seconds": time.perf_counter() - t_start,
                       **result}, fh, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
