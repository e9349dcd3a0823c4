#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``, never the JAX package) through its
slices on the card — the multi-cell serving tick, the paper's
single-instance evaluation, the serving engine's LM-service jobs, the
metro-scale sharded solve with its mesh-resident serving session, the
MoE, RG-LRU, RWKV-6 and encoder-decoder prefills of the other five LM
configs, the decode that continues a prefill, training (K4's gradient
K4′, the train step and the checkpointed loop), the examples, the mesh
forms, dense tensor parallelism over processes that share the card,
with the dry run's count held against it, and the serving, decode and
training of granite-34b, chameleon-34b and h2o-danube-3-4b, with
whisper-tiny's training, and the training of recurrentgemma-9b, rwkv6-1.6b
and qwen3-moe-235b-a22b — and holds every hand-written kernel of those
paths against its plain PyTorch version:

1. prints the card (``nvidia-smi``) and builds every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. K1, both entries of ``kernels/csrc/pg_round.cu``: the one-round
   contract (``kernels/pg/pg.py::batch_round``) against ``batch_round_ref``
   at the serving shape (B = 256, T = 32, A = 300, m = 2, with planted ties
   and all-infeasible instances), on the metro day batch
   (``metro_diurnal_trace(256, n_domains=32)``, 6144 rows), at m = 9
   (A = 2560) and at A = 19200 (m = 4): V bitwise, tau and best_a equal;
   the whole solve in one launch (``batch_solve``) against its plain version
   ``batch_solve_ref`` (the host loop over the torch round) on six batches —
   the serving shape coupled (256 cells in 32 groups of 8, T = 64, planted
   ties, cells with no candidate), the metro day batch, an uncoupled batch,
   one group of 20 cells among singleton groups, m = 9 and A = 19200:
   admitted, alloc_idx, occupied and the link budget used bit for bit, the
   loop's round count the kernel's rounded up to the loop's period;
3. K2, both entries of ``kernels/csrc/masked_argmax.cu``:
   ``masked_argmax`` against ``masked_argmax_ref`` at (T, A) = (50, 300),
   (200, 1280), (4096, 1280) and (77, 999), with planted ties, all-masked
   rows, dead rows and an all-false ``cap_ok`` (g and idx bitwise); the
   admission round (``kernels/pg/pg.py::bind_round``) against
   ``admission_round_ref`` on every round of the T = 200, A = 1280
   instance's solve in all four quadrants, on those (T, A) with planted
   ties and on a nine-resource pool (A = 2560), flexible and MinRes: every
   state tensor bitwise after every round;
4. K3 (``kernels/resize/resize.py::resize_bilinear``, taps derived in the
   kernel) against its plain version at 128×128×3, 640×640×3 and
   1024×2048×3, batch 8, z ∈ {0.04, 0.25, 0.5, 1}, float32, within 1e-5,
   and bitwise against the same 4-tap gather on ``resize_taps`` (so the
   in-kernel taps are those); bf16 within 3e-2;
5. solves the metro day batch coupled with ``inner="kernel"`` (one
   ``batch_solve`` launch a solve, one host sync, no one-round launch) and
   with ``inner="torch"`` (the plain bit-domain round): decisions equal,
   every solution valid, link budgets kept; prints rounds, host syncs,
   ms/solve;
6. SLICE 1'S MAIN PATH: a 256-cell ``MultiCellEngine`` (``multi_cell_pools(
   256, seed=1)``, 32 contiguous backhaul domains at 1.2 per cell) driven by
   ``drive_closed_loop(horizon=HORIZON, process=True)`` (4 steps), with
   the kernel launch counts zeroed just before and read just after (every
   re-slice's solve one ``batch_solve`` launch with one host sync, no
   one-round launch); a twin engine on the same card with ``sesm.inner = "torch"`` runs the same
   traffic and must decide identically at every step;
7. SLICE 2'S MAIN PATH, the paper's evaluation at full width, counts zeroed
   just before and read just after: the Fig. 6 sweep (``fig6_sweep(m)`` for
   m = 2 (A = 300) and m = 4 (A = 1280), 90 instances each) and one
   T = 200, A = 1280 instance through ``run_algorithm(name, inst,
   backend="torch")`` for all six algorithms; Fig. 7's Colosseum periods
   through ``SESM(backend="torch").slice``; ``solve_greedy_many`` on the
   mixed-grid ``multi_cell_trace(4, 8, seed=1, n_grids=2)``. K2's round
   kernel must launch exactly once per single-solve round run, and each
   batched solve is one ``batch_solve`` launch with one host sync. A twin on
   ``inner="torch"`` must decide identically (admitted, alloc, z); against
   the numpy oracle the phase reports the satisfied counts and every
   instance that decides differently, and fails unless each difference
   starts at an f32 near-tie (a float64 replay of the oracle, picking in
   float32 from the same state each round, first disagrees where the two
   picks' float64 values are within 1e-6 of each other). A profile of the
   T = 200 SEM-O-RAN solve reports its launches, wall time and device
   busy share;
8. K4 (``kernels/attn/attn.py::flash_attention_fwd``) against its plain
   version at (B, T, Hq, Hkv, Dh) = (8, 16, 32, 2, 128) (the LM job),
   (2, 2048, 32, 2, 128), (1, 1000, 32, 2, 128), (2, 77, 32, 8, 120),
   (2, 333, 16, 8, 256) and (1, 1, 4, 4, 16), causal, and two non-causal
   shapes with Tq != Tk, and slice 8's: the whisper-tiny encoder (2, 1500,
   6, 6, 64, non-causal), its cross-attention (Tq 448 over Tk 1500,
   non-causal) and decoder (2, 448, causal), and qwen3-moe's (2, 2048, 64,
   4, 128), slice 12's ``train_lm --params-100m --full-attention``
   (8, 256, 12, 4, 64, causal), and slice 17's granite-34b (2, 2048, 48,
   1, 128) and chameleon-34b (2, 2048, 64, 8, 128), causal, on unit
   normals, on both kernels (and Dh = 320,
   which the route sends to the CUDA-core kernel in both types; Dh = 520
   must raise): float32 on the
   CUDA-core kernel (``csrc/flash_attn.cu``, within 2e-5: sums in another
   order), bfloat16 on the tensor-core kernel (``csrc/flash_attn_tc.cu``,
   the route bf16 takes) and on the CUDA-core kernel, each element within
   2^-7 |ref| + 2^-6 rms(ref's row) of the plain version in float32 on the
   same inputs (``K4_BF16_TOL``); at the whisper encoder's shape the
   tensor-core kernel with its 28-key tail tile dropped, or with the tail
   left unmasked (K and V zero-filled to a whole tile), must fail that
   tolerance; each kernel's second launch writes each row's log-sum-exp,
   its output bit for bit the first's and the LSE within ``K4_LSE_TOL``
   (2^-8) of the plain version's;
9. SLICE 3'S MAIN PATH: an ``EdgeServingEngine`` on the Colosseum pool
   with chatglm3-6b at full width (bf16, random weights from a seeded
   generator) registered as ``launch/serve.py`` registers its model,
   the launcher's four requests, ``reslice()`` and three ``process()``
   ticks, the launch counts zeroed just before and read just after (K4
   must launch 28 times per LM job batch, every time on the tensor-core
   kernel); then ``prefill`` at B = 2, T = 2048 (``cache_len=2048``)
   through K4 (28 launches, all on the tensor-core kernel), each K4 call
   of it held against the plain version in float32 on the call's own
   inputs within phase 8's tolerance, and once more with the full-causal
   route pointed at K4's plain version, each block on the K4 run's input
   to it: last-token logits, caches and block outputs agree within a
   bf16 tolerance, and the top-1 tokens are compared; wall ms, device busy
   share, K4's share and peak memory are printed;
10. times each kernel (per call, and its own device time from
   ``torch.profiler`` as ``device_ms``), its plain version and the library
   call (where one exists) at the shapes the main paths gave it — K1's
   solve on the serving loop's own stack and on the metro day (device us
   against its bound, rounds, us a round, registers and spills) beside the
   previous route, the host loop over ``batch_round``, and the plain loop,
   in alternation; K1's one-round entry; K3 and
   both K2 entries beside ``F.interpolate`` and ``torch.max`` in
   alternation (5 repetitions of 200 calls, medians), with a host-side
   breakdown of each wrapper's steps; K4 on both kernels at the LM job's
   shape, at (2, 2048) and at slice 8's qwen3-moe prefill and whisper-tiny
   encoder shapes, beside SDPA, with the tensor-core kernel's ptxas report and
   launch configuration, and K4 writing the LSE at those shapes (output bit
   for bit, LSE within ``K4_LSE_TOL``, its time); at each, the float32
   CUDA-core kernel with and without the LSE and float32 SDPA's forward
   in turn (median, least and largest over 5 repeats), its device µs and
   f32 bound, and the CUDA-core kernels' registers and spills by
   instantiation — and prints the seconds of every phase, the
   ``{"kernels": [...]}`` line (K4's two rows, one a kernel, the CUDA-core
   one's launches from phases 18 and 19; K4′'s two rows, one a route,
   from phases 15, 17 and 18, with the tensor-core K4′'s ptxas report and
   launch configuration), the card's name and power limit, and finally
   the ``{"ok": true, ...}`` line;
11. SLICE 7'S MAIN PATH, the sharded metro solve (run after phase 7): the
   1024-cell day (``metro_diurnal_trace(1024, n_domains=64)``, 24576
   coupled rows in 1536 groups of 16, stacked group-major at Tmax 32)
   through ``solve_greedy_sharded`` over ``make_cells_mesh(n,
   devices=[card])`` for n = 1, 3, 7 and 8 (7 shards pad the plan with
   inert rows, 1, 3 and 8 do not), counts zeroed before each n and
   read after: one ``batch_solve`` launch and one host sync a solve, no
   one-round launch; decisions bit for bit those of the meshless
   ``solve_greedy_batch`` and of its ``inner="torch"`` twin, four sampled
   (hour, domain) groups against ``solve_coupled_ref``; ms a solve, K1's
   device time, bound and cluster count for each n, and K1 against its
   plain version on the 8-shard stack;
12. SLICE 7'S MAIN PATH, the metro serving engine: phase 6's 256-cell
   layout with 4 standing requests a cell on ``make_cells_mesh(8,
   devices=[card])`` beside a meshless twin on the card, through
   ``drive_closed_loop(horizon=HORIZON, process=True)``, an outage and
   recovery,
   ``set_link_budgets(scale=0.6)`` and ``shift_semantics(scale=0.8)``,
   counts zeroed before and read after (one ``batch_solve`` launch a
   re-slice, K3 on the vision jobs): decisions equal at every tick,
   ``shard_replans == fresh_stacks``, the twin's session counters, a
   steady tick with no dirty row, replan or second launch; re-slice ms a
   tick for both and one steady metro tick under ``torch.profiler``;
13. SLICE 8'S MAIN PATH (run after phase 9): recurrentgemma-9b and
   whisper-tiny at full width and depth, mixtral-8x7b and
   qwen3-moe-235b-a22b at most at the layers whose bf16 weights fit the
   card's free memory beside a 16 GiB reserve (their whole weights do not
   fit), all widths as published, bf16, random weights from a seeded
   generator on the card, one model at a time; since slice 17 mixtral,
   qwen3-moe and rwkv6-1.6b at ``SLICE8_LAYERS``' 8, 4 and 8 layers for
   the script's time. The four
   token-only configs serve phase 9's engine path (K4 launches per LM
   batch: qwen3 a layer, all on the tensor-core kernel; the "local", "rec" and
   "rwkv" configs 0); each config's ``prefill`` at B = 2, T = 2048
   (whisper: 1500 frames of seeded stub embeddings and 448 tokens) through
   K4 (qwen3 a launch a layer, whisper 12: 4 encoder, 4 decoder self-, 4
   cross-attention; the others 0) against its plain-attention twin within
   phase 9's bf16 tolerances (each block of the twin on the K4 run's
   input to it), logits finite. An MoE twin takes the K4 run's experts;
   where its own router logits would choose others, the choice must be a
   near-tie (``routing_flips``). Wall ms, device busy
   share, K4's share and peak memory (the K4 run's, and the config's
   whole run's) are printed;
14. SLICE 9'S MAIN PATH, decode (on chatglm3-6b's weights after phase 9,
   on each of phase 13's five models after its prefill checks, then on
   gemma3-12b at full width and ``DECODE_GEMMA_LAYERS`` (12) layers, bf16,
   seed 0: 5 local layers with a 1024 window to 1 global, so a 2048-token
   prompt wraps its ring):
   ``prefill`` at B = 2, T = 2048 (whisper: 416 tokens after its 1500
   frames) with ``cache_len`` T + 32, then 32 teacher-forced
   ``decode_step``s, counts zeroed just before and read just after (K4
   once a full-attention layer in the prefill, on the tensor-core kernel,
   never in a step); the 32 steps again from the same cache, bit for bit,
   timed (ms a step, tokens/s); each step's bound (the weights, every
   expert of a dense MoE, and the cache read once at 3.35 TB/s); 4 steps
   under ``torch.profiler`` (launches a step, device busy share); peak
   memory. ``forward_train`` over the T + 32 tokens: each block fed its
   input there, ``block_prefill`` on its first T rows and
   ``block_decode`` on the next 32, within ``PREFILL_BLOCK_TOL`` of the
   forward's block output row's rms (an MoE block takes the forward's
   experts; where its own logits would choose others, a near-tie), and
   the free-running decode's logits against the forward's at the same
   positions, reported (max abs diff, top-1 agreement), not bounded. Then
   in float32 at two pattern repeats (gemma3-12b six layers) on all seven
   configs: prefill plus 32 steps within ``DECODE_F32_TOL`` of
   ``forward_train``'s logits, and a step at ``pos == cache_len`` whose
   every attention call matches a float64 statement of the reference's
   clamped update (``clamp_oracle``). The phase's time is printed;
15. K4′ (``kernels/attn/attn.py::flash_attention_bwd``, run after phase 8)
   against its plain version ``flash_attention_bwd_ref`` in float32 on the
   same inputs at chatglm3-6b's (2, 2048, 32/2, 128) and gemma3-12b's
   global (2, 2048, 16/8, 256) causal shapes, the whisper-tiny encoder
   (2, 1500, 6/6, 64) and cross-attention (448 over 1500), non-causal,
   slice 15's DP 256 tile edges (Dh 200; (2, 333, 4/2, 256) causal; 40
   over 100 at Dh 256) in bf16, and (2, 512, 8/2, 64), (2, 333, 4/4,
   320), (1, 40 over 100, 4/2, 320) and slice 12's ``train_lm`` (8, 256,
   12/4, 64, causal), chatglm3-6b's and the whisper encoder's in float32,
   and slice 17's granite-34b (2, 2048, 48/1, 128) and chameleon-34b (2,
   2048, 64/8, 128), slice 18's qwen3-moe-235b-a22b (2, 2048, 64/4,
   128) and slice 20's train_4k microbatches, chatglm3-6b's (1, 4096,
   32/2, 128) and gemma3-12b's global (1, 4096, 16/8, 256), causal, in
   bf16,
   element by element, each route given its own K4's LSE: every bf16
   shape with Dh % 8 == 0 and Dh <= 256 on both routes — the tensor-core
   kernel (``csrc/flash_attn_bwd_tc.cu``, the route) within
   ``K4B_TC_TOL`` and the CUDA-core kernel within ``K4B_BF16_TOL`` — and
   the rest on the CUDA-core kernel within ``K4B_BF16_TOL`` or
   ``K4B_F32_TOL`` (float32 again given the plain LSE); on each route a
   repeat bit for bit and a launch a pass (3 on both); once through
   ``FlashAttention``'s backward, bit for bit the direct call's given the
   same LSE; at ``K4B_TIMED``'s shapes (chatglm3-6b's, gemma3-12b's,
   granite-34b's, chameleon-34b's, qwen3-moe-235b-a22b's and the whisper
   encoder's in bf16;
   train_lm's, chatglm3-6b's and the whisper encoder's in float32), on
   each route, ms a call and device µs by
   pass, the plain version and SDPA's backward beside the bound, K4's
   forward beside SDPA's forward and its bound, and the kernels and SDPA
   in turn (median, least and largest over 5 repeats); at every shape
   each route's K4 LSE within ``K4_LSE_TOL`` of the plain version's;
16. SLICE 10's gradient check (after phase 14; slice 17's configs in
   phase 24): chatglm3-6b at 4 layers,
   full width, bf16, B = 2, T = 2048, remat on, ``loss_and_grads`` on a
   ``TokenStream`` batch through K4 and K4′ (2 and 3 launches a layer,
   K4′'s all on its tensor-core route) against a twin whose attention is
   K4's plain version with autograd, each gradient leaf's rms difference
   within ``TRAIN_GRAD_TOL`` of its rms (the largest element's printed),
   and one ``make_train_step`` step a side: loss, grad_norm and lr agree;
   after phase 17, the same check on gemma3-12b at 6 layers (slice 15: one
   whole pattern, whose global layer, Dh 256, launches K4 2 and K4′ 3
   times, on the DP 256 tiles);
17. SLICE 10'S MAIN PATH: ``make_train_step`` on chatglm3-6b at full width
   and the most layers whose 12 bytes a parameter of training state fit
   the card's free memory beside ``TRAIN_RESERVE`` (``fitting_depth``),
   bf16, remat on, ``OptConfig(warmup_steps=1)``, ``TokenStream(
   global_batch=2, seq_len=2048)``, 6 steps, counts zeroed just before and
   read just after: loss and grad_norm finite, K4 2 launches a layer a step
   (all on the tensor-core kernel), K4′ 3, all on its tensor-core route;
   s a step, tokens/s, peak memory, the busy share and K4′'s share of a
   traced step, the step's bound (8 × parameters × tokens at the bf16
   peak); then SLICE 15'S MAIN PATH, the same on gemma3-12b at the whole
   patterns that fit beside ``GEMMA_TRAIN_RESERVE`` (18 of its 48 layers
   on an 80 GB H100: 3 global layers, K4 6 and K4′ 9 launches a step, all
   on the tensor cores), ``GEMMA_TRAIN_STEPS`` steps, and one more step
   whose every K4′ call is held against the plain version on its own
   inputs (``K4BChecked``);
18. the loop end to end: ``python -m repro_torch.launch.train --smoke
   --device cuda --steps 8``, and ``train()`` on the chatglm3-6b smoke
   config with ``checkpoint_every=4`` uninterrupted, crashed at step 6 and
   restarted: the restart resumes at step 5 and ends on the uninterrupted
   run's final loss within rel 1e-4 (whether bit for bit is printed); the
   float32 smoke configs' K4 and K4′ launches all on their CUDA-core
   routes;
19. SLICE 12, THE EXAMPLES on the card, in-process through their ``main``,
   each with the counts zeroed just before and read just after:
   ``quickstart`` (K2's round launched; its six algorithms decide bit for
   bit as the same driver on the CPU), ``slicing_demo`` (the re-slice's K1
   and the frames' K3 launched), ``serve_edge --arch chatglm3-6b`` (K1,
   K3 and K4, each K4 call held against its plain version on its own
   inputs, ``K4Checked``), then ``train_lm --params-100m --steps 100``
   with and without ``--full-attention`` (the loss's last value below its
   first and the mean of its last 10 below that of its first 10; K4 and
   K4′ launched in the full-attention run; its first loss and last-10
   mean within ``EXAMPLE_FIRST_TOL`` and ``EXAMPLE_LAST10_TOL`` of the
   banded run's), and the full-attention run crashed at step 50 and
   resumed from its checkpoint, every K4 and K4′ call of the two held
   against its plain version on its own inputs as it returns
   (``K4Checked``, ``K4BChecked``; phase 8's and 15's tolerances), ending
   on the uninterrupted run's final loss bit for bit; first loss, last-10
   mean and ms a step printed beside the card's name and power limit;
20. SLICE 12, THE MESH FORMS on a one-rank NCCL group (``DeviceMesh``
   (1, 1) over ``data`` and ``model``, TCPStore on 127.0.0.1): two mesh
   train steps of chatglm3-6b at full width and ``MESH_LAYERS`` layers in
   bf16 (B = 2, T = 2048) with the compute and ZeRO layouts (``param_shardings(...,
   extra_batch_dim=True)``) against the meshless step on the same weights
   and batches (loss, grad norm and parameters bit for bit, K4 and K4′
   launched as often); one qwen3-moe MoE layer at full width through the
   ``ep`` and ``tp`` forms (``psum_late`` on and off) within 1e-2 of the
   output's rms of ``_moe_local`` (the share within 1e-4 of ``_moe_dense``
   printed); ``ef_allreduce`` over chatglm3's gradient leaves bit for bit
   ``decompress(*compress(g, 0)[:2])``; each part's wall time printed;
21. SLICE 13, DENSE TENSOR PARALLELISM over processes that share the
   card: 2 and then 4 processes (``chip_smoke.py --tp-worker``), a gloo
   group each (its store on 127.0.0.1; gloo carries sums on CUDA
   tensors, which is all the split forms need), a (1, tp) ``data ×
   model`` mesh. chatglm3-6b at full width in bf16 and
   ``TP_SERVING_LAYERS`` layers, each rank drawing the seeded weights in
   turn and keeping its shards in the compute layout
   (``compute_shardings``): ``prefill(..., mesh=)`` at B = 2, T = 2048,
   counts zeroed just before and read just after (K4 a launch a layer a
   rank, all on the tensor-core kernel, on 16 and 8 local heads), every K4 call held against its plain version on its own
   inputs (``K4Checked``); rank 0 runs the meshless prefill of the whole
   weights beside it: logits within ``PREFILL_LOGIT_TOL``, and each
   block, fed the mesh run's input to it (``BlockLog``), within
   ``PREFILL_BLOCK_TOL`` of the mesh run's output; then 4 ``decode_step``s
   with ``mesh=`` against meshless within ``PREFILL_LOGIT_TOL``. At tp = 2
   (2 KV heads: no rank cuts one) chatglm3-6b at ``MESH_LAYERS`` layers,
   remat on: one ``make_train_step(mesh=)`` step (K4 2 and K4′ 3 launches
   a layer, all on the tensor-core routes; rank 0's peak memory and, in
   a traced warm step, its product device time), and on fresh shards the
   loss within ``TRAIN_LOSS_RTOL`` and each leaf's reduced gradient
   within ``TRAIN_GRAD_TOL`` of its rms of the meshless
   ``loss_and_grads``. Prefill, decode and step times are printed beside
   the meshless ones, labelled as processes sharing one card over gloo:
   not a multi-card number;
22. THE DRY RUN AGAINST THE CARD: ``launch/dryrun.py::count_train_step``
   in a fresh process (a ``fake`` group of 2 ranks, ``meta`` tensors)
   counts rank 0 of phase 21's train step, and (a ``fake`` group of one
   rank, started in phase 27 beside its steps) phase 27's chatglm3-6b
   train_4k step, 16 microbatches; each predicted peak must lie within
   0.8–1.25× of the measured ``max_memory_allocated``, and the counted
   flops are printed beside the measured product device time;
23. SLICE 14, THE REFERENCE'S OPTIMIZED CELLS AND THE SEQUENCE-SPLIT
   CACHE over processes that share the card (phase 21's ``--tp-worker``
   gloo groups, of 2 and then 4, which run these parts after phase 21's,
   ``SLICE14_PARTS``): (a) Megatron-SP (``seq_sp`` →
   ``model``) on chatglm3-6b at ``MESH_LAYERS`` layers, remat on, over
   (1, 2) and (1, 4): one train step, counts zeroed just before and read
   just after (K4 2 and K4′ 3 launches a layer a rank, all on the
   tensor-core routes), every K4 and K4′ call held against its plain
   version on its own inputs (``K4Checked``, ``K4BChecked``; the checked
   K4′ launches must equal the counted ones), each rank's reduced gradient
   (recorded from the step, ``recorded_reduced``) and loss against the
   meshless ``loss_and_grads``
   within ``TRAIN_GRAD_TOL`` and ``TRAIN_LOSS_RTOL`` (each rank's twin in
   turn), rank 0's peak memory beside phase 21's step without SP; (b) at 4
   processes ZeRO-3 of the MoE experts: mixtral-8x7b at full width and
   ``ZERO3_LAYERS`` layer over a ``ZERO3_MESH`` ``data × model`` mesh,
   the step as ``build_cell(optimized=True)`` builds it, each rank's
   expert bytes 1/4 of the whole, and the same checks; (c) the decode
   cache split by sequence (``seq_kv`` → ``model``): chatglm3-6b at full
   width and ``TP_SERVING_LAYERS`` layers over (1, 2) and (1, 4), a B = 2,
   T = 2048 prefill (K4 a launch a layer a rank, each call held) and 4
   decode steps, the logits within
   ``PREFILL_LOGIT_TOL`` of meshless, the cache's bytes a rank beside the
   heads' layout; at 2 processes also gemma3-12b at one repeat of its
   pattern, whose 1024-slot rings wrap in the prefill; (d) the dry run's
   count of (a)'s tp = 2 step (``dryrun_check`` under the SP rules): its
   predicted peak within 0.8–1.25× of rank 0's measured one. Times are
   gloo's copies through host memory: not a multi-card number;
24. SLICE 17'S MAIN PATH (run after phase 10): the three configs no
   earlier phase runs, at full width in bf16 from a seeded generator on
   the card — granite-34b (MQA, 48 query heads on one KV head) and
   chameleon-34b (qk-norm, 64 on 8) served at ``SLICE8_LAYERS``' 30 and
   24 layers (their bf16 weights fit 61 and 46 beside ``SLICE8_RESERVE``;
   trained at the training state's fitting depth), h2o-danube-3-4b (Dh
   120, every layer
   sliding-window at 4096) whole — each through phase 13's engine and
   prefill against its plain-attention twin (K4 a full-attention layer a
   LM batch and a prefill, every call held; h2o-danube 0) and phase 14's
   32 decode steps and float32 two-repeat checks; then slice 10's
   training on granite-34b, chameleon-34b, h2o-danube-3-4b and
   whisper-tiny (4 encoder and 4 decoder layers, 448 tokens over 1500
   frames): the gradient check against ``PlainAttention`` at
   ``SLICE17_CHECK`` layers (whisper whole; skipped, with the reason
   printed, for h2o-danube, whose plain twin is the same function), then
   ``GEMMA_TRAIN_STEPS`` steps at the fitting depth beside
   ``GEMMA_TRAIN_RESERVE``, K4 and K4′ launched exactly as the config's
   layers say (``train_launches``; h2o-danube 0 and 0), all on the
   tensor cores, and one more step with every K4′ call held
   (``K4BChecked``, its references a block of query heads at a time);
25. SLICE 18'S MAIN PATH (after phase 24): the training of the three
   model families no earlier phase trains, bf16 at full width, B = 2,
   T = 2048, remat on, through ``make_train_step`` — recurrentgemma-9b
   (the RG-LRU scan under autograd; its local layers on the banded plain
   path) and rwkv6-1.6b (the WKV chunks under autograd) at the fitting
   depth beside ``GEMMA_TRAIN_RESERVE`` (21 of 38 layers and all 24 on an
   80 GB card), qwen3-moe-235b-a22b (the dense MoE over 128 experts,
   top-8, and qk-normed full attention at 64/4) at 1 of 94 layers:
   ``GEMMA_TRAIN_STEPS`` steps each, loss and grad_norm finite, K4 and K4′
   launched exactly as ``train_launches`` says (qwen3-moe 2 and 1 a step,
   all on the tensor cores; the other two 0 and 0), s a step, tokens/s,
   peak memory, the busy share and device time by kind, and for qwen3-moe
   one more step with every K4′ call held (``K4BChecked``). qwen3-moe's
   gradient check runs at ``SLICE17_CHECK`` layers against its
   plain-attention twin on the K4 run's experts (the step's metrics from
   the two gradients: the 2-layer training state does not fit, nor the
   twin's step at 1 layer); recurrentgemma-9b's and
   rwkv6-1.6b's, which launch no kernel, hold the card's float32
   ``loss_and_grads`` against the host's (``phase_scan_grads``: one whole
   repeat, B = 1, T = 80 at the config's chunk of 32, the vocabulary cut
   to 32,768; the loss within 1e-5 relative, each leaf within 1e-4 of its
   largest magnitude);
26. SLICE 19'S MAIN PATH (after phase 25), the reference's serving cells
   (``launch/specs.py``) at one data rank's batch, bf16 at full width,
   seeded (``--seed``, default 0): the rotary angles of all ten configs
   on the card bit for bit the host's at positions up to 524,287;
   prefill_32k (B = 2, T = 32768, ``cache_len`` 32768) of chatglm3-6b
   whole (K4 at (2, 32768, 32/2, 128), 28 launches) and gemma3-12b at
   ``DECODE_GEMMA_LAYERS`` (2 global layers on K4 at (2, 32768, 16/8,
   256), 10 local ones banded) through phase 9's prefill check — every
   K4 call held against its plain version by blocks of query rows
   (``k4_plain``), the plain twin's blocks on the K4 run's inputs within
   the ``PREFILL_*_TOL`` — and of rwkv6-1.6b whole (its WKV's chunk decays
   in groups of ``models/rwkv.py::WKV_GROUP_BYTES``): wall ms, busy share,
   K4's share, launches, peak memory; decode_32k: chatglm3-6b whole, B =
   8, 32 steps at positions 32736-32767 against a full 32768-slot cache
   drawn on the card; long_500k: recurrentgemma-9b, rwkv6-1.6b and
   h2o-danube-3-4b whole, B = 1, 32 steps at positions 524256-524287
   from a full state and rings: ms a step, tokens/s, launches a step, busy
   share, peak, the byte bound (``phase_long_decode``); each decode held
   in float32 on the card against the host at ``LONG_CHECK_LAYERS``
   (``long_decode_f32``: logits within ``LONG_F32_TOL`` of the host's row
   rms, the top-1 tokens equal). Phases 8 and 10 hold and time K4 at both
   prefill_32k shapes (``K4_LONG_SHAPES``), phase 10 beside SDPA's forward
   in turn;
27. SLICE 20'S MAIN PATH (after phase 26), the reference's train_4k cell
   (``launch/specs.py``) at one data rank's share of its (16, 16) mesh,
   the model axis whole on the card: ``TokenStream(global_batch=16,
   seq_len=4096)`` seeded from ``--seed``, ``make_train_step(cfg,
   OptConfig(warmup_steps=1), n_microbatches=16)`` (one sequence a
   microbatch, as ``build_cell`` builds it), bf16 weights, remat on,
   float32 accumulator and moments, on chatglm3-6b and gemma3-12b at full
   width and the most whole repeats whose 16 bytes a parameter fit beside
   ``TRAIN_RESERVE`` and ``GEMMA_TRAIN_RESERVE`` (``fitting_depth``; the
   arithmetic printed): two steps with the counts zeroed just before and
   read just after — loss and grad_norm finite, K4 and K4′ launched 16 ×
   ``train_launches(cfg)`` a step, all on the tensor-core routes (K4′
   refuses a call without K4's LSE) — s a step, tokens/s, peak memory
   beside 16 bytes a parameter, the step's bound (8 × parameters × 65,536
   tokens at the bf16 peak); one traced step (busy share, K4's and K4′'s
   shares, device time by kind); the accumulation's own device time (its
   copy, 15 float32 adds and the mean over the whole tree, CUDA events)
   beside its byte bound; one microbatch's ``loss_and_grads`` with every
   K4 and K4′ call held against its plain version on its own inputs
   (``K4Checked``, ``K4BChecked``: a block of query heads at a time), the
   checked launches those counted. chatglm3-6b also: its gradient at
   ``SLICE17_CHECK`` layers, B = 1, T = 4096 against its plain-attention
   twin within ``TRAIN_GRAD_TOL`` (``phase_train_grads``), and the
   4-microbatch step at that depth bit for bit against ``opt_update`` on
   the float32 mean of 4 separate ``loss_and_grads`` (``train4k_parts``).
   Phases 8 and 15 hold and time K4 and K4′ at both train_4k shapes.

Any failure raises and exits nonzero before the last line. Without a CUDA
card, or outside the repository, it exits nonzero and prints no result.
Float32 matrix products run in full float32 here (TF32 off for both cuBLAS
and cuDNN), so the plain versions are exact float32 references.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores — the roof each kernel's bound is taken against
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 tensor-core peak: the roof for work on bf16 inputs
BF16_FLOP_PER_S = 989e12

N_CELLS, N_DOMAINS, BACKHAUL_PER_CELL = 256, 32, 1.2
# the closed loop's steps in phases 6 and 12 (8 before slice 17: cut to
# keep the script, with phase 24, inside its time limit)
HORIZON = 4
# standing load per cell: seats every cell in the 64-slot bucket on the
# first tick, so the closed loop never outgrows its device session
STANDING = 33
SHAPES = ((128, 128), (640, 640), (1024, 2048))
K3_ZS = (0.04, 0.25, 0.5, 1.0)
K2_SHAPES = ((50, 300), (200, 1280), (4096, 1280), (77, 999))
FIG6_TASKS, FIG6_SEEDS = (10, 20, 30, 40, 50), (0, 1, 2)
FIG7_FPS = (10.0, 7.0, 5.0, 3.0)
QUADRANTS = ((True, True), (True, False), (False, True), (False, False))
FIG7_ALGOS = {"sem-o-ran": dict(semantic=True, flexible=True),
              "minres-sem": dict(semantic=True, flexible=False),
              "flexres-n-sem": dict(semantic=False, flexible=True)}
# relative float64 gap under which two picks are an f32 near-tie
TIE_RTOL = 1e-6
MIX = [("coco_bags", 0.35, 8.0), ("coco_animals", 0.50, 6.0),
       ("cityscapes_flat", 0.35, 5.0), ("coco_person", 0.20, 5.0)]
# slice 7: the metro day solved over 1, 3 and 8 shards of one card (and 7,
# whose uneven split pads shards with inert rows), and the metro serving
# engine's standing requests a cell
METRO_CELLS, METRO_DOMAINS, METRO_SHARDS = 1024, 64, (1, 3, 7, 8)
METRO_STANDING = 4
# K4 checks: (B, Tq, Tk, Hq, Hkv, Dh, causal)
K4_SHAPES = ((8, 16, 16, 32, 2, 128, True), (2, 2048, 2048, 32, 2, 128, True),
             (1, 1000, 1000, 32, 2, 128, True), (2, 77, 77, 32, 8, 120, True),
             (2, 333, 333, 16, 8, 256, True), (1, 1, 1, 4, 4, 16, True),
             (2, 16, 333, 32, 2, 128, False), (1, 1000, 77, 16, 8, 256, False),
             # slice 8: the whisper-tiny encoder, its cross-attention and
             # decoder (G = 1, Dh 64), qwen3-moe (G = 16)
             (2, 1500, 1500, 6, 6, 64, False), (2, 448, 1500, 6, 6, 64, False),
             (2, 448, 448, 6, 6, 64, True), (2, 2048, 2048, 64, 4, 128, True),
             # slice 9: gemma3-12b's global layers (Dh 256 at T = 2048), and
             # whisper's decoder over a 416-token prompt, not a whole number
             # of 64-row tiles, on itself and on its 1500 frames
             (2, 2048, 2048, 16, 8, 256, True), (2, 416, 416, 6, 6, 64, True),
             (2, 416, 1500, 6, 6, 64, False),
             # slice 12: train_lm --params-100m --full-attention (B 8, T 256)
             (8, 256, 256, 12, 4, 64, True),
             # slice 13: chatglm3-6b's heads on a rank of phase 21's model
             # axis — tp = 2 (its 2 KV heads split, one a rank; the train
             # step's LSE too) and tp = 4 (one whole KV head a rank)
             (2, 2048, 2048, 16, 1, 128, True),
             (2, 2048, 2048, 8, 1, 128, True),
             # slice 17: granite-34b (48 query heads on one KV head) and
             # chameleon-34b (64 on 8) at T = 2048
             (2, 2048, 2048, 48, 1, 128, True),
             (2, 2048, 2048, 64, 8, 128, True),
             # slice 19: prefill_32k's, chatglm3-6b's and gemma3-12b's
             # global layers at T = 32768 (held by blocks of query rows)
             (2, 32768, 32768, 32, 2, 128, True),
             (2, 32768, 32768, 16, 8, 256, True),
             # slice 20: train_4k's microbatch (one sequence of 4096) on
             # chatglm3-6b's and gemma3-12b's global layers
             (1, 4096, 4096, 32, 2, 128, True),
             (1, 4096, 4096, 16, 8, 256, True))
K4_LONG_SHAPES = tuple(x for x in K4_SHAPES if x[1] == 32768)
# K4 heads wider than the tensor-core tiles (route: the CUDA-core kernel's
# Dh <= 512 tile, in both types)
K4_WIDE_SHAPES = ((2, 77, 77, 8, 4, 320, True), (1, 40, 100, 4, 2, 320, False))
# K4 tolerances against the plain version in float32 on the same inputs.
# float32 outputs: atol 2e-5 (sums in another order). bfloat16 outputs,
# element by element: |out - ref| <= 2^-7 |ref| + 2^-6 rms(ref's row over
# Dh). The first term is twice the output's own rounding (half a bf16 ulp,
# <= 2^-8 |ref|); the second covers the tensor-core kernel's bf16 P (a
# relative error <= 2^-8 a key), whose effect scales with the row, so a
# row averaging 1500 keys (rms ~0.04) is held as tightly as a short one
K4_F32_ATOL = 2e-5
K4_BF16_TOL = (2 ** -7, 2 ** -6)
# K4's log-sum-exp (the tensor-core kernel's, written on request) against
# the plain version's in float32 on the same inputs, absolute: the kernel's
# l sums the bf16-rounded P it multiplied, which moves l by at most 2^-9
# relative (one rounding a term) and so the LSE by at most 2^-9; twice that
K4_LSE_TOL = 2 ** -8
# slice 10, K4's gradient K4′: (B, Tq, Tk, Hq, Hkv, Dh, causal, dtype) —
# chatglm3-6b's and gemma3-12b's global layer's training shapes, the
# whisper-tiny encoder and its cross-attention, and float32 at Dh 64 and
# 320 (the CUDA-core tile K4's widest heads take)
K4B_SHAPES = ((2, 2048, 2048, 32, 2, 128, True, "bfloat16"),
              (2, 2048, 2048, 16, 8, 256, True, "bfloat16"),
              (2, 1500, 1500, 6, 6, 64, False, "bfloat16"),
              (2, 448, 1500, 6, 6, 64, False, "bfloat16"),
              (2, 512, 512, 8, 2, 64, True, "float32"),
              (2, 333, 333, 4, 4, 320, True, "float32"),
              (1, 40, 100, 4, 2, 320, False, "float32"),
              # slice 12: train_lm --params-100m --full-attention
              (8, 256, 256, 12, 4, 64, True, "float32"),
              # slice 13: phase 21's tp = 2 train step on each rank;
              # slice 14: phase 23's SP step at tp = 4 (one KV head a rank)
              (2, 2048, 2048, 16, 1, 128, True, "bfloat16"),
              (2, 2048, 2048, 8, 1, 128, True, "bfloat16"),
              # slice 15: the tensor-core route's DP 256 tiles at their
              # edges — Dh 200 (zero-padded to 256), lengths not a whole
              # number of 64-row tiles, and Tq != Tk
              (2, 300, 300, 8, 4, 200, True, "bfloat16"),
              (2, 333, 333, 4, 2, 256, True, "bfloat16"),
              (1, 40, 100, 4, 2, 256, False, "bfloat16"),
              # slice 16: the CUDA-core route in float32 at chatglm3-6b's
              # and the whisper-tiny encoder's shapes
              (2, 2048, 2048, 32, 2, 128, True, "float32"),
              (2, 1500, 1500, 6, 6, 64, False, "float32"),
              # slice 17: granite-34b's training shape (48 query heads on
              # one KV head: K4′'s dK/dV pass in bwd_groups(48) = 4 groups
              # of 12) and chameleon-34b's (64 on 8)
              (2, 2048, 2048, 48, 1, 128, True, "bfloat16"),
              (2, 2048, 2048, 64, 8, 128, True, "bfloat16"),
              # slice 18: qwen3-moe-235b-a22b's (64 query heads on 4 KV
              # heads: G = 16, the dK/dV pass in bwd_groups(16) = 4 groups
              # of 4)
              (2, 2048, 2048, 64, 4, 128, True, "bfloat16"),
              # slice 20: train_4k's microbatch on chatglm3-6b's and
              # gemma3-12b's global layers (twice the key tiles of a dK/dV
              # block, twice the keys of a query row)
              (1, 4096, 4096, 32, 2, 128, True, "bfloat16"),
              (1, 4096, 4096, 16, 8, 256, True, "bfloat16"))
# the K4′ shapes phase 15 times: chatglm3-6b's, gemma3-12b's, granite-34b's,
# chameleon-34b's and qwen3-moe-235b-a22b's training shapes, the
# whisper-tiny encoder, the float32 ones of train_lm, chatglm3-6b and
# the whisper encoder, and train_4k's two (with K4's forward and SDPA's
# forward and backward beside each)
K4B_TIMED = (K4B_SHAPES[0], K4B_SHAPES[1], K4B_SHAPES[2], K4B_SHAPES[7],
             K4B_SHAPES[13], K4B_SHAPES[14], K4B_SHAPES[15], K4B_SHAPES[16],
             K4B_SHAPES[17], K4B_SHAPES[18], K4B_SHAPES[19])
# K4′ against its plain version in float32 on the same inputs, element by
# element: |out - ref| <= a |ref| + b rms(ref's row over Dh) + c rms(ref).
# bfloat16 (a, b, c) = (2^-7, 2^-10, 2^-16): a is twice the outputs'
# rounding (half a bf16 ulp, <= 2^-8 |ref|), and both compute in float32
# from the same inputs, so the rest (another summation order, P from the
# log-sum-exp) is ~1e-6 of a row's terms; float32 (2^-14, 2^-14, 2^-14):
# that order alone, with a margin for sums of thousands of terms. The c
# term is a floor for rows whose value cancels (causal dq rows 0 and 1:
# dP - D is 0 or nearly), where float32 leaves ~1e-6 of the terms, whose
# scale is the tensor's rms, not the row's (a floor of 2^-20 rms(ref)
# failed at 4.6x on the first run, at (2, 512, 8/2, 64))
K4B_BF16_TOL = (2 ** -7, 2 ** -10, 2 ** -16)
K4B_F32_TOL = (2 ** -14, 2 ** -14, 2 ** -14)
# K4′'s tensor-core route (bf16, Dh <= 256; ``csrc/flash_attn_bwd_tc.cu``),
# the shape of K4's own bf16 check: b = 2^-6, since P^T, dS^T and dS are
# rounded to bf16 before their products (about 2^-9.8 of a row's rms an
# element, under 2^-7.2 at 6 sigma), and P comes from K4's LSE. c = 2^-14,
# as for float32: the floor of 2^-16 rms(ref) first set here failed on
# causal dq row 0 at chatglm3's shape, where the exact value is 0 (P = 1,
# dP = D) and the f32 sums of dP and D leave ~1e-6 on both sides (SDPA's
# backward as much); phase 15 prints each tensor-core check's share of
# that first floor, K4B_TC_FLOOR, and the row it peaks on, unbounded
K4B_TC_TOL = (2 ** -7, 2 ** -6, 2 ** -14)
K4B_TC_FLOOR = (2 ** -7, 2 ** -6, 2 ** -16)
# K4′ on a training run's own inputs (``K4BChecked``): its dq and dk
# cancel far more than unit normals' (train_lm's are ~1400x smaller than
# the terms summed into them, and dq is exactly 0 on causal row 0), so
# float32 leaves more than the floor c rms(ref) in both the kernel and the
# plain version (dq row 0: 9.0e-11 each, 125x that floor; both within
# 1.3 u of the terms). Each call is held against the plain version in
# float64 within phase 15's tolerance plus K4B_TERMS times the magnitude
# of the terms of each element (``k4b_terms``): float32's rounding of
# them, with a margin of 16 over the 2^-24 a float32 operation adds
K4B_TERMS = 2 ** -20
# ... and on the tensor-core route, which rounds P and dS to bf16 before
# the products that sum them into dq, dk and dv (a relative error within
# ±2^-8 a term, uniform: 2^-8/√3 of it standard, independent from term to
# term), plus K4B_TC_RSS of the root-sum-square of each element's terms
# (``k4b_rss``): about 6.9 standard deviations of that rounding. Phase
# 15's b rms(row) term stands for it on unit normals, where an element is
# of the size of its terms; on a training run's inputs dq's terms cancel
# 50-350x (chatglm3-6b's SP step), and there an exact emulation of the
# route's roundings is as far from the float64 plain version as the
# kernel (1.74x phase 15's tolerance) while the kernel is within 1 % of
# the emulation (``tools/k4b_rounding_probe.py``)
K4B_TC_RSS = 2 ** -6
# the most score elements a K4 call's plain reference computes in one call
# (``k4_call_excess``; 256 MB of float32), and in one block of query rows
# past that (``k4_plain``: 128 rows of 16 query heads at T = 32768)
K4_REF_WHOLE = 1 << 26
# the most score elements the plain twins of the prefills and phase 8's
# checks compute in one call (2 GB of float32: qwen3-moe's and
# chameleon-34b's (2, 2048, 64 heads), the largest at T = 2048); past it
# (T = 32768) they take ``k4_plain``'s blocks
K4_PLAIN_WHOLE = 1 << 29
LM_ARCH, LM_TICKS = "chatglm3-6b", 3
PREFILL_B, PREFILL_T = 2, 2048
# K4's prefill against its plain twin, each block of the twin on the K4
# run's input to that block: the two attentions round their bf16 outputs
# apart by about an ulp here and there, which one block carries on into
# its output (logits are of order 1). Free-running, the twin would add
# every earlier block's divergence, which grows with depth past any fixed
# bound for every exact attention (SDPA's too, at qwen3-moe's 12 layers).
# Block outputs (the residual stream, which random weights grow to tens)
# are held in units of their row's rms
PREFILL_LOGIT_TOL, PREFILL_CACHE_TOL, PREFILL_BLOCK_TOL = 0.25, 0.25, 0.25
# slice 8: each config at full width in bf16; (name, cut). A cut config
# (the MoE ones: their whole bf16 weights, 93 and 470 GB, do not fit the
# card) takes the most layers whose weights fit the card's free memory
# beside SLICE8_RESERVE: the largest peak over a config's run beyond its
# weights measured on an H100 80GB (14.2 GiB, qwen3-moe at 13 layers:
# the stacked init's extra repeat, then the prefill's float32 attention
# scores of the plain twin and checks) and 2 GiB to spare; the peak over
# each config's run is printed
SLICE8 = (("recurrentgemma-9b", False), ("rwkv6-1.6b", False),
          ("whisper-tiny", False), ("mixtral-8x7b", True),
          ("qwen3-moe-235b-a22b", True))
SLICE8_RESERVE = 16 * 2 ** 30
# the most layers phase 13 (and 14's decode on its weights) runs of a
# config, below its fitting or full depth, cut since slice 17 to keep the
# script, with phase 24, inside its time limit: qwen3-moe's dense MoE runs
# all 128 experts a layer at every decode step (280 ms a step at 12
# layers on an H100, 44 s of phase 14's 121.5), mixtral's 22 fitting layers
# took 14.4 s of decode, rwkv6's 24 layers (its WKV a Python loop) 14.3 s
# and 1.9 s a prefill
SLICE8_LAYERS = {"qwen3-moe-235b-a22b": 4, "mixtral-8x7b": 8,
                 "rwkv6-1.6b": 8,
                 # phase 24's serving of slice 17's two cut configs, at
                 # about half their fitting 61 and 46 layers since slice 20
                 # (phase 27 and a slow host took the script past 1000 s)
                 "granite-34b": 30, "chameleon-34b": 24}
# phase 14's gemma3-12b: two repeats of its pattern (5 local layers to 1
# global, the rings wrapped by the prompt), of 48 since slice 17
DECODE_GEMMA_LAYERS = 12
# whisper-tiny's prefill: 1500 encoder frames (30 s of audio) and its
# longest target, 448 decoder tokens
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
# slice 9: 32 decode steps after each prompt (whisper: 416 tokens, so that
# its 448-token cache is its longest target), on these configs in bf16 (the
# MoE ones at phase 13's fitting depths) and, at two pattern repeats, in
# float32, where prefill plus decode must continue forward_train's logits
# within DECODE_F32_TOL (the reference's own check holds 1e-4 at smoke
# width; full width sums 10-100 times more terms a product) and a step at
# pos == cache_len must match the float64 clamp oracle within
# DECODE_CLAMP_TOL of its output row's rms (float32 against float64)
DECODE_STEPS = 32
# decode steps in phase 14's trace (launches a step, busy share): every
# step launches the same kernels, and the trace gathers each launch on the
# host (qwen3-moe's dense MoE, a loop over its 128 experts a layer, makes
# thousands a step)
DECODE_TRACE_STEPS = 2
SLICE9 = ("chatglm3-6b", "gemma3-12b", "recurrentgemma-9b", "rwkv6-1.6b",
          "whisper-tiny", "mixtral-8x7b", "qwen3-moe-235b-a22b")
DECODE_F32_TOL = 1e-3
DECODE_CLAMP_TOL = 1e-4
# slice 10, training: chatglm3-6b at full width, bf16, B = 2, T = 2048
# (``TokenStream``), remat on. Its training state is 12 bytes a parameter
# (bf16 parameters and gradients, float32 m and v): 74.9 GB at 28 layers,
# so the main path trains at the most whole layers whose state fits the
# card's free memory beside TRAIN_RESERVE, 6 steps. The reserve: the peak
# beyond the state measured on an H100 80GB at 20 layers, 1.33 GiB (the
# logits and the loss's float32 copies, a layer's recompute, the update's
# pieces), and allocator slack
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "chatglm3-6b", 2, 2048, 6
TRAIN_BYTES_PER_PARAM, TRAIN_RESERVE = 12, 6 * 2 ** 30
# slice 12: the examples' training run (the reference's own driver; 60
# of its 300 steps since slice 17, for the script's time limit), crashed
# halfway and resumed; the mesh train step's depth
EXAMPLE_STEPS, EXAMPLE_FAIL_AT = 60, 30
# train_lm at T = 256 under a window of 256: the banded run and the
# full-attention run (K4, K4′) compute the same function on the same
# weights, so their first losses agree within EXAMPLE_FIRST_TOL and their
# last-10 means within EXAMPLE_LAST10_TOL (the predictions written before
# their first card run, PERF.md; it measured 0 and 0.0018)
EXAMPLE_FIRST_TOL, EXAMPLE_LAST10_TOL = 1e-4, 0.05
# the mesh train steps' depth (phases 20, 21 and 23; 4 before slice 17)
MESH_LAYERS, MESH_STEPS = 2, 2
# phase 21: tensor parallelism over processes that share the card (a gloo
# group each); the train part at the first size; a rank's join limit; the
# serving part's depth: 4 of chatglm3-6b's 28 layers (cut to keep the
# script's gloo phases, which vary 1.5x with the host, well inside its
# time limit: 8 before slice 17, which also cut phase 23's seq_kv serving
# from 28 to this depth)
TP_SIZES, TP_DECODE_STEPS, TP_JOIN_S = (2, 4), 4, 600
TP_SERVING_LAYERS = 4
MOE_ARCH, MOE_OUT_TOL = "qwen3-moe-235b-a22b", 1e-2
# phase 23 (slice 14), over the same gloo groups: Megatron-SP's rules (the
# reference's optimized train cells), the sequence-split decode cache's
# (its decode cells), the optimized cells' ZeRO-3 of the MoE experts; the
# ZeRO-3 step's config, depth and mesh (4 processes), and the config whose
# sliding-window ring (1024 slots) wraps in the prefill, at one repeat of
# its pattern (5 local layers, 1 global)
SP_RULES = {"seq_sp": "model"}
KV_RULES = {"seq_kv": "model"}
OPT_RULES = {"seq_sp": "model", "fsdp": ("pod", "data")}
ZERO3_ARCH, ZERO3_LAYERS, ZERO3_MESH = "mixtral-8x7b", 1, (2, 2)
# phase 23's parts by group size, run by phase 21's gloo groups after
# theirs, in the same processes: a group's start took 16-26 s a process
# (imports, the CUDA context, DTensor's first use) on the H100 80GB HBM3
# machine (700 W) these numbers come from, and phase 23 began two more
# groups before slice 18
SLICE14_PARTS = {2: "sp,kv,ring", 4: "sp,kv,zero3"}
KV_RING_ARCH, KV_RING_LAYERS = "gemma3-12b", 6
# the gradient check: 4 layers, K4 and K4′ against a twin whose attention is
# K4's plain version with autograd, on the same card and batch. Each
# gradient leaf as a share of its rms: rms(diff) <= 0.02 rms(ref), rms(ref)
# over the leaf's rows that are not all zero (``leaf_rms``). bf16 products
# everywhere: the two attentions' outputs differ by about a bf16 ulp here
# and there, and every later product rounds that on. The largest element's
# |diff| / rms(ref) is printed, not bounded: a bound on it (0.25, then 2^-6
# |ref| + 0.25 rms(ref)) failed on the first card runs on elements that
# sum many positions coherently — the most frequent token's embedding row
# (10x the leaf's rms), and lm_head's column of the most frequent label on
# a hidden dimension that is small in every row, whose forward value
# differs by a few percent between the two attentions. The loss within
# 1e-3 relative, grad_norm within 1e-2 relative, lr equal
TRAIN_CHECK_LAYERS = 4
TRAIN_GRAD_TOL = 0.02
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-3, 1e-2
# slice 15: gemma3-12b's training, whose 8 global layers (Dh 256) take
# K4′'s DP 256 tiles. The gradient check at one whole pattern (6 layers:
# the first global layer is the 6th, so 4 would launch neither K4 nor
# K4′); the main path at the most whole patterns whose training state
# fits beside GEMMA_TRAIN_RESERVE (the 262,144-entry vocabulary's bf16
# logits and the loss's float32 copies of them, 2 and 4 GiB each at B = 2,
# T = 2048, a pattern's recompute, and the float64 references of
# K4BChecked's held step), GEMMA_TRAIN_STEPS steps
GEMMA_ARCH, GEMMA_CHECK_LAYERS, GEMMA_TRAIN_STEPS = "gemma3-12b", 6, 3
GEMMA_TRAIN_RESERVE = 16 * 2 ** 30
# slice 17: the three configs no earlier phase runs — granite-34b (MQA, 48
# query heads on one KV head), chameleon-34b (qk-norm, 64 on 8) and
# h2o-danube-3-4b (Dh 120, every layer sliding-window) — served, decoded
# and trained as slices 8-10 do, (name, cut) as SLICE8 (granite's 88
# layers and chameleon's 48 are 94.5 and 68.5 GB of bf16 weights); then
# whisper-tiny's encoder-decoder trained on WHISPER_TOKENS decoder tokens
# over WHISPER_FRAMES frames. The gradient checks run at SLICE17_CHECK
# layers (whisper: its whole 4 and 4); the main paths at the fitting depth
# beside GEMMA_TRAIN_RESERVE (the held step's float64 references, a block
# of query heads at a time, ``k4b_refs``), GEMMA_TRAIN_STEPS steps
SLICE17 = (("granite-34b", True), ("chameleon-34b", True),
           ("h2o-danube-3-4b", False))
SLICE17_TRAIN = ("granite-34b", "chameleon-34b", "h2o-danube-3-4b",
                 "whisper-tiny")
SLICE17_CHECK = 2
# slice 18: the three model families whose training had not run on the card
# — recurrentgemma-9b (the RG-LRU scan; its local layers' window of 2048 =
# T: the banded plain path, no K4), rwkv6-1.6b (the WKV chunks, no
# attention) and qwen3-moe-235b-a22b (the dense MoE over 128 experts, top-8;
# qk-normed full attention at 64/4 through K4 and K4′) — trained as slice
# 17's configs are, at the fitting depth beside GEMMA_TRAIN_RESERVE. qwen3's
# gradient check runs at SLICE17_CHECK layers against its plain-attention
# twin; the other two launch no kernel, so a plain twin would be the same
# function, and the card's float32 gradient is held against the host's
# instead (``phase_scan_grads``): one whole repeat of the pattern
# (SCAN_CHECK_LAYERS), B = 1, T = SCAN_CHECK_T at the config's own chunk
# of 32 (two chunk boundaries and a 16-step tail), the vocabulary cut to
# SCAN_CHECK_VOCAB on both sides (the check's one cut); the loss within
# SCAN_LOSS_RTOL relative, each gradient leaf's largest |diff| within
# SCAN_GRAD_TOL of the leaf's largest magnitude (float32 sums in another
# order on the card: cuBLAS against the host's)
SLICE18_TRAIN = ("recurrentgemma-9b", "rwkv6-1.6b", "qwen3-moe-235b-a22b")
SCAN_CHECK_LAYERS = {"recurrentgemma-9b": 3, "rwkv6-1.6b": 2}
SCAN_CHECK_T, SCAN_CHECK_VOCAB = 80, 32768
SCAN_LOSS_RTOL, SCAN_GRAD_TOL = 1e-5, 1e-4
# slice 19: the reference's serving cells (``src/repro/launch/specs.py``:
# prefill_32k, decode_32k, long_500k) at one data rank's batch of its
# (16, 16) mesh on one card — a B = 2, T = 32768 prefill (chatglm3-6b
# whole, gemma3-12b at DECODE_GEMMA_LAYERS, rwkv6-1.6b whole), a B = 8
# decode against 32768 slots (chatglm3-6b), and B = 1 at position 524,287
# (the three LONG_CONTEXT_OK configs that fit the card: gemma3-12b's 8
# global layers would hold 32 GiB of cache beside 22 GiB of weights, and
# decode_step's re-stack copies it again; mixtral's bf16 weights are 87
# GiB). Each decode takes DECODE_STEPS steps, the last at the cell's last
# position, from a full cache drawn from SEED (``--seed``) on the card.
# The float32 checks, the card against the host on the same weights,
# cache and tokens, run at LONG_CHECK_LAYERS (one pattern repeat; for
# decode_32k chatglm3-6b's first two layers of the same cache), the
# long_500k ones with the vocabulary cut to SCAN_CHECK_VOCAB: each step's
# logits within LONG_F32_TOL of the host's row's rms (float32 sums in
# another order), the top-1 tokens equal
LONG_T, LONG_DECODE_B, LONG_POS = 32768, 8, 524287
LONG_500K = ("recurrentgemma-9b", "rwkv6-1.6b", "h2o-danube-3-4b")
LONG_CHECK_LAYERS = {"chatglm3-6b": 2, "recurrentgemma-9b": 3,
                     "rwkv6-1.6b": 1, "h2o-danube-3-4b": 1}
LONG_F32_TOL = 1e-4
LONG_ROTARY_POSITIONS = (0, 2047, 32767, 524287)
# decode_32k's float32 check, the card against the host, runs the cell's
# last LONG_F32_STEPS positions (32 before slice 20: the host's 43.5 s of
# phase 26, cut to keep the script, with phase 27, inside its time limit)
LONG_F32_STEPS = 8
# slice 20: the reference's train_4k cell (``src/repro/launch/specs.py``:
# 256 sequences of 4096 tokens on a (16, 16) mesh, ``n_microbatches =
# batch // n_data``) at one data rank's share on one card, the model axis
# whole: TRAIN4K_B sequences as TRAIN4K_MICRO microbatches of one. Its
# training state is 16 bytes a parameter (bf16 weights and one
# microbatch's gradient, float32 moments and accumulator), so each config
# of TRAIN4K_ARCHS runs at the most whole repeats whose state fits beside
# its reserve (phase 17's chatglm3-6b and gemma3-12b reserves: the
# logits, a repeat's recompute, the update's pieces; gemma3-12b's
# 262,144-word vocabulary's logits take 4.3 GB a microbatch in float32),
# TRAIN4K_STEPS timed steps; the accumulation is held against its parts at
# SLICE17_CHECK layers over TRAIN4K_PARTS microbatches
TRAIN4K_ARCHS = (("chatglm3-6b", TRAIN_RESERVE),
                 ("gemma3-12b", GEMMA_TRAIN_RESERVE))
TRAIN4K_B, TRAIN4K_T, TRAIN4K_MICRO = 16, 4096, 16
TRAIN4K_BYTES_PER_PARAM, TRAIN4K_STEPS, TRAIN4K_PARTS = 16, 2, 4
SEED = 0


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel: str, iters: int = 50):
    """Device time per call of the kernels whose name contains ``kernel``,
    from a ``torch.profiler`` trace of ``iters`` calls (None when the
    profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_time(e) for e in prof.events()
                if kernel in e.name)
    return total / iters if total > 0 else None


def _device_time(event) -> float:
    for attr in ("device_time", "cuda_time"):
        v = getattr(event, attr, None)
        if v:
            return float(v)
    return 0.0


def fmt_us(x) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


# --------------------------------------------------------------- phase 1

def build_kernels():
    """Builds every kernel library; returns the ptxas report of each source
    this run compiled."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    secs = time.perf_counter() - t0
    log(f"[build] {len(report)} kernel libraries in {secs:.1f} s "
        f"-> {_build.BUILD_DIR}")
    for src, rep in sorted(report.items()):
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    return report


# --------------------------------------------------------------- phase 2

def k1_inputs(rng, b, t, a, m, dev):
    """Random K1 inputs with planted ties and all-infeasible instances."""
    import numpy as np
    import torch
    from repro_torch.core.greedy import _pack_bits
    grid = rng.integers(1, 16, (a, m)).astype(np.float32)
    grid[a // 2:a // 2 + 8] = grid[:8]              # duplicate lanes: ties
    price = rng.uniform(0.02, 0.2, (b, m)).astype(np.float32)
    cap = rng.integers(8, 30, (b, m)).astype(np.float32)
    occ = (rng.uniform(0, 0.6, (b, m)) * cap
           * (rng.random((b, m)) < 0.7)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.2
    alive = rng.random((b, t)) < 0.8
    price[::7] = 0.0                                # all-zero PG: full tie
    occ[::7] = 0.0
    lat[1::5, 1::2] = lat[1::5, 0::2][:, :t // 2]   # identical task rows
    lat[3::11] = False                              # nothing feasible
    alive[5::13] = False                            # nothing alive
    lat_t = torch.from_numpy(lat).to(dev)
    rest = [torch.from_numpy(x).to(dev) for x in (alive, grid, price, cap,
                                                   occ)]
    return lat_t, _pack_bits(lat_t), rest


def check_round(lat, words, rest, what: str) -> float:
    import torch
    from repro_torch.kernels.pg import pg as PK
    v, tau, best_a = PK.batch_round(words, *rest)
    rv, rtau, ra = PK.batch_round_ref(lat, *rest)
    torch.cuda.synchronize()
    if not torch.equal(v.view(torch.int32), rv.view(torch.int32)):
        raise AssertionError(f"K1 {what}: V differs from the plain version")
    if not (torch.equal(tau, rtau) and torch.equal(best_a, ra)):
        raise AssertionError(f"K1 {what}: tau/best_a differ")
    found = torch.isfinite(rv)
    err = (v[found] - rv[found]).abs().max().item() if found.any() else 0.0
    log(f"[K1] {what}: B={lat.shape[0]} T={lat.shape[1]} A={lat.shape[2]} "
        f"bitwise equal; {int(found.sum())} instances with a candidate, "
        f"{int((~found).sum())} without")
    return err


def phase_k1(dev, metro_stacked):
    import numpy as np
    import torch
    from repro_torch.core.greedy import _pack_bits
    from repro_torch.core.sfesp import _f32, _solver_tables
    rng = np.random.default_rng(0)
    err = 0.0
    for m in (2, 4):
        lat, words, rest = k1_inputs(rng, 256, 32, 300, m, dev)
        err = max(err, check_round(lat, words, rest, f"serving shape m={m}"))
    lat_ok, alive0, _ = _solver_tables(metro_stacked, True)
    lat = torch.from_numpy(lat_ok).to(dev)
    alive = torch.from_numpy(alive0).to(dev)
    grid = _f32(metro_stacked.grid, dev)
    price = _f32(metro_stacked.price, dev)
    cap = _f32(metro_stacked.capacity, dev)
    for frac in (0.0, 0.4):
        occ = torch.floor(cap * frac * torch.from_numpy(
            rng.random(cap.shape).astype(np.float32)).to(dev))
        err = max(err, check_round(lat, _pack_bits(lat),
                                   [alive, grid, price, cap, occ],
                                   f"metro day batch occupancy<={frac}"))
    for b, t, a, m in ((64, 32, 2560, 9), (16, 16, 19200, 4)):
        lat, words, rest = k1_inputs(rng, b, t, a, m, dev)
        err = max(err, check_round(lat, words, rest, f"m={m} A={a}"))
    return err


def solve_stack(rng, b, t, a, m, dev, group=8, coupled=True):
    """A random DeviceStack for K1's solve with planted ties (duplicated
    lanes, all-zero prices, duplicated task rows) and cells with nothing
    feasible or nothing alive. Coupled: contiguous groups of ``group``
    cells on one link each plus a second link per half group, budgets
    that bind; ``group`` = 0: one group of 20 cells on one link, the rest
    singleton groups."""
    import numpy as np
    import torch
    from repro_torch.core import CouplingSpec
    from repro_torch.core.sfesp import (DeviceStack, group_csr,
                                        lexicographic_cost)
    grid = rng.integers(1, 16, (a, m)).astype(np.float32)
    grid[a // 2:a // 2 + 8] = grid[:8]              # duplicate lanes: ties
    price = rng.uniform(0.02, 0.2, (b, m)).astype(np.float32)
    price[::7] = 0.0                                # all-zero PG: full tie
    cap = rng.integers(8, 30, (b, m)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.2
    lat[1::5, 1::2] = lat[1::5, 0::2][:, :t // 2]   # identical task rows
    lat[3::11] = False                              # nothing feasible
    alive0 = lat.any(2) & (rng.random((b, t)) < 0.9)
    alive0[5::13] = False                           # nothing alive
    load = rng.uniform(0.05, 0.5, (b, t)).astype(np.float32)
    link = dict(link_cap=None, incidence=None, group=None, group_csr=None)
    if coupled:
        if group:
            n = b // group
            inc = np.zeros((b, 3 * n), bool)
            inc[np.arange(b), np.arange(b) // group] = True
            inc[np.arange(b), n + np.arange(b) // max(1, group // 2)] = True
        else:
            inc = np.zeros((b, 1), bool)
            inc[:20, 0] = True
        budgets = rng.uniform(0.5, 2.0, inc.shape[1]) * inc.sum(0)
        groups = CouplingSpec(budgets, inc).groups()
        link = dict(link_cap=torch.tensor(budgets, dtype=torch.float32,
                                          device=dev),
                    incidence=torch.from_numpy(inc).to(dev),
                    group=torch.from_numpy(groups).to(dev),
                    group_csr=group_csr(inc, groups, dev))

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev,
                                                            torch.float32)
    return DeviceStack(grid=f32(grid), cost=f32(lexicographic_cost(grid)),
                       price=f32(price), capacity=f32(cap),
                       lat_ok=torch.from_numpy(lat).to(dev),
                       alive0=torch.from_numpy(alive0).to(dev),
                       link_load=f32(load), semantic=True, batch_size=b,
                       **link)


def check_solve(stack, what: str) -> None:
    """K1's one-launch solve against its plain version (the host loop over
    the torch round) on ``stack``: admitted, alloc_idx, occupied and used
    bitwise; the loop's rounds are the kernel's largest group count rounded
    up to the loop's convergence period."""
    import torch
    from repro_torch.core.greedy import _SYNC_EVERY
    from repro_torch.kernels.pg import pg as PK
    before = PK.SOLVE_KERNEL.launches
    out = PK.batch_solve(stack)
    ref = PK.batch_solve_ref(stack)
    torch.cuda.synchronize()
    if PK.SOLVE_KERNEL.launches != before + 1:
        raise AssertionError(f"K1 solve {what}: not one launch")
    for name, x, y in zip(("admitted", "alloc_idx", "occupied", "used"),
                          out[:4], ref[:4]):
        if (x is None) != (y is None):
            raise AssertionError(f"K1 solve {what}: {name} missing")
        if y is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"K1 solve {what}: {name} differs from the "
                                 "plain version")
    rounds = out[4]
    kernel_rounds = int(rounds.max())
    want = _SYNC_EVERY * -(-kernel_rounds // _SYNC_EVERY)
    if int(rounds.min()) < 0 or int(ref[4][0]) != want:
        raise AssertionError(f"K1 solve {what}: rounds {kernel_rounds} "
                             f"(min {int(rounds.min())}) against the loop's "
                             f"{int(ref[4][0])}")
    info = PK.solve_info()
    rows, t, a = stack.lat_ok.shape
    log(f"[K1] solve {what}: B={rows} T={t} A={a} m={stack.grid.shape[1]}, "
        f"{rounds.numel()} groups, cluster {info['cluster']}, "
        f"{info['cells_per_cta']} cell(s) a CTA, {info['smem_bytes']} B "
        f"shared (place {info['place']}): bitwise equal; "
        f"{int(out[0].sum())} admitted in {kernel_rounds} rounds (loop "
        f"{int(ref[4][0])})")


def phase_k1_solve(dev, metro_stacked):
    """``batch_solve`` against ``batch_solve_ref`` on the six batches."""
    import numpy as np
    from repro_torch.core import device_stack
    rng = np.random.default_rng(8)
    check_solve(solve_stack(rng, 256, 64, 300, 2, dev),
                "serving shape, 32 groups of 8")
    check_solve(device_stack(metro_stacked, device=dev), "metro day batch")
    check_solve(solve_stack(rng, 256, 32, 300, 2, dev, coupled=False),
                "uncoupled")
    check_solve(solve_stack(rng, 64, 32, 300, 2, dev, group=0),
                "one group of 20 among singletons")
    check_solve(solve_stack(rng, 64, 32, 2560, 9, dev, group=4), "m=9")
    check_solve(solve_stack(rng, 16, 16, 19200, 4, dev, group=4),
                "A=19200")


# --------------------------------------------------------------- phase 3

def k2_inputs(rng, t, a, dev, cap_all_false=False):
    """K2 inputs with planted ties (sel takes 8 values), all-masked rows
    and dead rows; ``cap_all_false`` masks every allocation."""
    import numpy as np
    import torch
    sel = (rng.integers(-4, 4, a) * 0.25).astype(np.float32)
    sel[a // 2:a // 2 + 16] = sel[:16]               # equal lanes: ties
    lat = rng.random((t, a)) < 0.3
    lat[::9] = False                                 # nothing feasible
    lat[2::9] = True                                 # everything feasible
    cap = np.zeros(a, bool) if cap_all_false else rng.random(a) < 0.7
    alive = rng.random(t) < 0.8
    alive[3::11] = False                             # dead rows
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (sel, lat, cap, alive)]


def phase_k2(dev):
    """K2's two entries against their plain versions: ``masked_argmax`` on
    ``K2_SHAPES``, and the admission round on every round of the T = 200
    instance's solve in all four quadrants and on ``K2_SHAPES`` with
    planted ties. Returns the max abs error (0 when bitwise) and the
    rounds checked."""
    import numpy as np
    import torch
    from repro_torch.kernels.pg import pg as PK
    rng = np.random.default_rng(3)
    err = 0.0
    for t, a in K2_SHAPES:
        for cap_all_false in (False, True):
            ins = k2_inputs(rng, t, a, dev, cap_all_false)
            g, idx = PK.masked_argmax(*ins)
            rg, ridx = PK.masked_argmax_ref(*ins)
            torch.cuda.synchronize()
            what = f"T={t} A={a} cap_ok all false={cap_all_false}"
            if not torch.equal(g.view(torch.int32), rg.view(torch.int32)):
                raise AssertionError(f"K2 {what}: g differs from the plain "
                                     "version")
            if not torch.equal(idx, ridx):
                raise AssertionError(f"K2 {what}: idx differs")
            found = torch.isfinite(rg)
            if found.any():
                err = max(err, (g[found] - rg[found]).abs().max().item())
            if cap_all_false and (found.any() or (idx != 0).any()):
                raise AssertionError(f"K2 {what}: a masked row was found")
            if not cap_all_false:
                n_found = int(found.sum())
        log(f"[K2] masked_argmax T={t} A={a}: g and idx bitwise equal; "
            f"{n_found} of {t} rows with a candidate, none with cap_ok all "
            "false")
    big = t200_instance()
    checked = 0
    for semantic, flexible in QUADRANTS:
        tables, alive0 = solve_tables(big, semantic, dev)
        n = check_rounds(tables, alive0, flexible,
                         f"T=200 A=1280 semantic={semantic} "
                         f"flexible={flexible}")
        checked += n
    for t, a in K2_SHAPES:
        for flexible in (True, False):
            tables, alive0 = round_inputs(rng, t, a, 4 if a == 1280 else 2,
                                          dev)
            checked += check_rounds(tables, alive0, flexible,
                                    f"planted ties T={t} A={a} "
                                    f"flexible={flexible}", max_rounds=48)
    m9 = m9_instance()
    for flexible in (True, False):
        tables, alive0 = solve_tables(m9, True, dev)
        checked += check_rounds(tables, alive0, flexible,
                                f"m=9 A=2560 flexible={flexible}")
    return err, checked


def m9_instance():
    """Nine resources: the m = 4 numerical pool plus five unit resources
    of capacity 12 (one with two levels), A = 2560, 30 tasks (seed 3)."""
    import numpy as np
    from repro_torch.core import ResourcePool, build_instance, scenarios
    p4 = scenarios.numerical_pool(4)
    pool = ResourcePool(
        names=p4.names + tuple(f"unit{i}" for i in range(5)),
        capacity=np.concatenate([p4.capacity, np.full(5, 12.0)]),
        price=np.concatenate([p4.price, np.full(5, 1 / 12)]),
        levels=tuple(p4.levels) + (np.array([1.0]),) * 4
        + (np.array([1.0, 2.0]),))
    return build_instance(pool, scenarios.numerical_tasks(30, "med", "high",
                                                          seed=3))


def t200_instance():
    """The largest instance of ``benchmarks/solver_perf.py``: T = 200 tasks
    on the m = 4 numerical pool (A = 1280)."""
    from repro_torch.core import build_instance, scenarios
    return build_instance(scenarios.numerical_pool(4),
                          scenarios.numerical_tasks(200, "med", "high"))


def solve_tables(inst, semantic, dev):
    """The single solve's tables on ``dev`` and its first alive mask, as
    ``solve_greedy_torch`` builds them."""
    import torch
    from repro_torch.core import greedy as G
    from repro_torch.core.sfesp import _f32, lexicographic_cost
    lat, z_idx = G._select_tables(inst, semantic)
    lat_ok = lat <= inst.tasks.max_latency[:, None]
    tables = (torch.from_numpy(lat_ok).to(dev), _f32(inst.grid, dev),
              _f32(inst.pool.price, dev), _f32(inst.pool.capacity, dev),
              _f32(lexicographic_cost(inst.grid), dev))
    return tables, torch.from_numpy((z_idx >= 0) & lat_ok.any(axis=1)).to(dev)


def round_state(alive0, m):
    import torch
    t, dev = alive0.shape[0], alive0.device
    return (torch.zeros(t, dtype=torch.bool, device=dev),
            torch.full((t,), -1, dtype=torch.int32, device=dev),
            torch.zeros(m, dtype=torch.float32, device=dev), alive0.clone())


def round_inputs(rng, t, a, m, dev):
    """Round tables with planted ties: duplicated allocations (equal PG
    and cost), duplicated task rows, rows with nothing feasible, tasks dead
    from the start."""
    import numpy as np
    import torch
    grid = rng.integers(1, 8, (a, m)).astype(np.float32)
    grid[a // 2:a // 2 + 16] = grid[:16]
    price = rng.uniform(0.05, 0.3, m).astype(np.float32)
    cap = (rng.integers(10, 30, m) * max(1, t // 50)).astype(np.float32)
    lat = rng.random((t, a)) < 0.3
    lat[1::4] = lat[0::4][:len(lat[1::4])]
    lat[2::9] = False
    alive0 = lat.any(1)
    alive0[3::11] = False
    cost = (grid @ (1000.0 ** np.arange(m))).astype(np.float32)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                   for x in (lat, grid, price, cap, cost))
    return tables, torch.from_numpy(alive0).to(dev)


def check_rounds(tables, alive0, flexible, what, max_rounds=None) -> int:
    """Step the round kernel and its plain version (``admission_round_ref``
    on a copy of the state, on the card) from the same start, round by
    round, to convergence and one no-op round past it (or ``max_rounds``):
    every state tensor bitwise equal after every round. Returns the rounds
    checked."""
    import torch
    from repro_torch.kernels.pg import pg as PK
    state = round_state(alive0, tables[1].shape[1])
    plain = tuple(x.clone() for x in state)
    step = PK.bind_round(state, *tables, flexible=flexible)
    rounds = admitted = 0
    while True:
        done = not bool(state[3].any())
        step()
        PK.admission_round_ref(plain, *tables, flexible)
        torch.cuda.synchronize()
        rounds += 1
        for name, x, y in zip(("admitted", "alloc_idx", "occupied", "alive"),
                              state, plain):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                raise AssertionError(f"K2 round {what}: {name} differs from "
                                     f"the plain version after round "
                                     f"{rounds}")
        admitted = int(state[0].sum())
        if done or rounds == max_rounds:
            break
    log(f"[K2] admission round {what}: {rounds} rounds bitwise equal "
        f"({admitted} admitted{'' if done else ', cut'})")
    return rounds


# --------------------------------------------------------------- phase 4

def tap_gather(img, h, w):
    """K3's arithmetic on ``resize_taps`` as plain torch ops (rows first,
    every product and sum rounded to float32): bitwise what the kernel
    computes if the taps it derives equal ``resize_taps``."""
    import torch
    from repro_torch.kernels.resize import resize as PR
    (ih, wh), (iw, ww) = (
        (torch.from_numpy(i).long().to(img.device),
         torch.from_numpy(wt).to(img.device))
        for i, wt in (PR.resize_taps(h, img.shape[1]),
                      PR.resize_taps(w, img.shape[2])))
    x = img.float()
    a0, a1 = wh[0][None, :, None, None], wh[1][None, :, None, None]
    b0, b1 = ww[0][None, None, :, None], ww[1][None, None, :, None]
    r0, r1 = a0 * x[:, ih[0]], a1 * x[:, ih[1]]
    t0 = r0[:, :, iw[0]] + r1[:, :, iw[0]]
    t1 = r0[:, :, iw[1]] + r1[:, :, iw[1]]
    return (b0 * t0 + b1 * t1).to(img.dtype)


def check_k3(img, ho, wo, tol, what):
    """K3 against its plain version within ``tol`` and bitwise against the
    gather on ``resize_taps``. Returns the max abs error."""
    import torch
    from repro_torch.kernels.resize import resize as PR
    out = PR.resize_bilinear(img, ho, wo)
    ref = PR.resize_bilinear_ref(img, ho, wo)
    taps = tap_gather(img, ho, wo)
    torch.cuda.synchronize()
    e = (out.float() - ref.float()).abs().max().item()
    if out.shape != ref.shape or out.dtype != img.dtype:
        raise AssertionError(f"K3 {what}: output {out.dtype} "
                             f"{tuple(out.shape)}")
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"K3 {what}: max err {e} beyond {tol}")
    if not torch.equal(out, taps):
        raise AssertionError(f"K3 {what}: differs from the gather on "
                             "resize_taps (the in-kernel taps)")
    return e


def phase_k3(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.resize import resize as PR
    rng = np.random.default_rng(1)
    err = 0.0
    for (h, w) in SHAPES:
        img = torch.from_numpy(rng.standard_normal((8, h, w, 3)).astype(
            np.float32)).to(dev)
        for z in K3_ZS:
            ho, wo = PR.out_size_for_z(h, w, z)
            err = max(err, check_k3(img, ho, wo, 1e-5, f"{h}x{w} z={z}"))
            if z == 1.0 and not torch.equal(PR.resize_bilinear(img, ho, wo),
                                            img):
                raise AssertionError(f"K3 {h}x{w}: z=1 is not the identity")
        log(f"[K3] 8x{h}x{w}x3 f32 z in {K3_ZS}: within 1e-5 (max abs err "
            f"so far {err:.3g}), bitwise the gather on resize_taps")
        del img
    img = torch.from_numpy(rng.standard_normal((8, 128, 128, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    check_k3(img, 26, 26, 3e-2, "8x128x128x3 bf16 z=0.04")
    log("[K3] 8x128x128x3 bf16 z=0.04: within 3e-2, bitwise the gather on "
        "resize_taps")
    return err


# --------------------------------------------------------------- phase 5

class SolveLog:
    """Records (rounds, syncs) of every batched solve read back while
    active, through ``greedy.unpack_device_batch`` wherever a caller bound
    it (the serving layer imports it by name), and the K1 launches made:
    ``solve`` (the one-launch solve) and ``round`` (the one-round entry)."""

    def __enter__(self):
        from repro_torch.core import greedy as G
        from repro_torch.kernels.pg import pg as PK
        from repro_torch.serving import admission as AD
        self.results = []
        unpack = self._unpack = G.unpack_device_batch

        def recorded(dispatched):
            res = unpack(dispatched)
            self.results.append((res["rounds"], res["syncs"]))
            return res
        G.unpack_device_batch = AD.unpack_device_batch = recorded
        self._k = (PK.SOLVE_KERNEL, PK.ROUND_KERNEL)
        self._start = [k.launches for k in self._k]
        return self

    def __exit__(self, *exc):
        from repro_torch.core import greedy as G
        from repro_torch.serving import admission as AD
        G.unpack_device_batch = AD.unpack_device_batch = self._unpack
        self.solve, self.round = (k.launches - n
                                  for k, n in zip(self._k, self._start))

    def check_one_launch_each(self, what: str) -> None:
        """Every solve was one ``batch_solve`` launch with one host sync,
        and the one-round entry never launched."""
        syncs = sorted({s for _, s in self.results})
        if not self.results or self.solve != len(self.results) \
                or syncs != [1] or self.round != 0:
            raise AssertionError(
                f"{what}: {len(self.results)} batched solves with host syncs "
                f"{syncs}, {self.solve} batch_solve launches and "
                f"{self.round} one-round launches (one launch and one sync "
                "a solve, no one-round launch expected)")


def phase_metro_solve(dev, stacked):
    import numpy as np
    import torch
    from repro_torch.core import check_solution, device_stack
    from repro_torch.core.greedy import (_SYNC_EVERY, _pack_batch_solutions,
                                         solve_device_batch)
    dstack = device_stack(stacked, device=dev)
    results = {}
    for inner in ("kernel", "torch"):
        with SolveLog() as solves:
            res = solve_device_batch(dstack, inner=inner)        # warm
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_device_batch(dstack, inner=inner)
                times.append((time.perf_counter() - t0) * 1e3)
        if inner == "kernel":
            solves.check_one_launch_each("metro solve")
        results[inner] = res
        log(f"[metro] inner={inner}: {stacked.batch_size} rows, "
            f"{int(res['admitted'].sum())} admitted, rounds={res['rounds']} "
            f"host syncs={res['syncs']} ms/solve={np.median(times):.2f} "
            f"(min {min(times):.2f}); batch_solve launches {solves.solve}")
    k, t = results["kernel"], results["torch"]
    if t["rounds"] != _SYNC_EVERY * -(-k["rounds"] // _SYNC_EVERY):
        raise AssertionError(f"metro solve: the kernel's {k['rounds']} "
                             f"rounds against the loop's {t['rounds']}")
    if not np.array_equal(k["admitted"], t["admitted"]):
        raise AssertionError("metro solve: kernel and torch rounds admit "
                             "differently")
    adm = k["admitted"]
    if not np.array_equal(k["alloc_idx"][adm], t["alloc_idx"][adm]):
        raise AssertionError("metro solve: allocations differ")
    sols = _pack_batch_solutions(stacked, k["admitted"], k["alloc_idx"], True)
    bad = [i for i, (inst, sol) in enumerate(zip(stacked.instances, sols))
           if not check_solution(inst, sol)["valid"]]
    if bad:
        raise AssertionError(f"metro solve: invalid solutions at {bad[:5]}")
    cap = stacked.coupling.link_capacity
    if not (k["link_used"] <= cap + 1e-4).all():
        raise AssertionError("metro solve: a link budget is exceeded")
    if not np.array_equal(k["link_used"], t["link_used"]) \
            or not np.array_equal(k["residual"], t["residual"]):
        raise AssertionError("metro solve: link use or residuals differ")
    log(f"[metro] decisions, residuals and link use equal across routes; "
        f"all {len(sols)} solutions valid; link budgets kept")
    return dstack


# --------------------------------------------------------------- phase 6

def make_engine(dev, inner, mesh=None, standing=STANDING):
    """The 256-cell engine of ``benchmarks/sweep_perf.py:262`` with
    ``standing`` requests a cell from MIX; ``mesh`` puts it in metro mode
    (a mesh-resident session, the solve split over the mesh's shards)."""
    import numpy as np
    from repro_torch.core import CouplingSpec, scenarios
    from repro_torch.serving import MultiCellEngine, SliceRequest
    pools = scenarios.multi_cell_pools(N_CELLS, seed=1)
    domain = (np.arange(N_CELLS) * N_DOMAINS) // N_CELLS
    inc = np.zeros((N_CELLS, N_DOMAINS), bool)
    inc[np.arange(N_CELLS), domain] = True
    budgets = np.bincount(domain, minlength=N_DOMAINS) * BACKHAUL_PER_CELL
    eng = MultiCellEngine(pools, coupling=CouplingSpec(budgets, inc),
                          max_retries=3, device=dev, mesh=mesh)
    eng.sesm.inner = inner
    for c in range(N_CELLS):
        for i in range(standing):
            app, acc, fps = MIX[i % len(MIX)]
            eng.submit(SliceRequest("object-recognition", "yolox", app,
                                    max_latency_s=0.7, min_accuracy=acc,
                                    jobs_per_sec=fps), c)
    return eng


def drive(eng):
    """Run the closed loop, recording each re-slice's decisions and time."""
    import torch
    from repro_torch.serving import drive_closed_loop
    log_, ticks = [], []
    reslice = eng.reslice

    def timed():
        t0 = time.perf_counter()
        out = reslice()
        ticks.append((time.perf_counter() - t0) * 1e3)
        log_.append([[(d.request.app_class, d.admitted, d.z,
                       tuple(sorted(d.alloc.items())), d.evicted)
                      for d in ds] for ds in out])
        return out
    eng.reslice = timed
    t0 = time.perf_counter()
    recs = drive_closed_loop(eng, HORIZON, process=True, seed=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return recs, log_, ticks, wall


def phase_serving(dev):
    import numpy as np
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.kernels.resize import resize as PR
    eng = make_engine(dev, None)                     # inner follows the card
    PK.SOLVE_KERNEL.launches = 0
    PK.ROUND_KERNEL.launches = 0
    PR.RESIZE_KERNEL.launches = 0
    with SolveLog() as solves:
        recs, dec, ticks, wall = drive(eng)
    launches = {"pg_solve": PK.SOLVE_KERNEL.launches,
                "pg_round": PK.ROUND_KERNEL.launches,
                "resize": PR.RESIZE_KERNEL.launches}
    sesm = eng.sesm
    log(f"[serve] {N_CELLS} cells, {HORIZON} steps: "
        f"{sum(r['admitted'] for r in recs)} admissions, "
        f"{sum(r['handovers'] for r in recs)} handovers; K1 launches "
        f"{launches['pg_solve']} (one-round entry {launches['pg_round']}), "
        f"K3 launches {launches['resize']}; solves (rounds, host syncs) "
        f"{solves.results}")
    solves.check_one_launch_each("serving loop")
    log(f"[serve] re-slice ms/tick: median {np.median(ticks):.1f}, "
        f"all {[round(t, 1) for t in ticks]}; loop wall ms/step "
        f"{wall / HORIZON:.1f}")
    log(f"[serve] fresh_stacks={sesm.fresh_stacks} "
        f"session_rebuilds={sesm.session_rebuilds} "
        f"delta_rows={sesm.delta_rows} "
        f"Tmax={sesm._serve_session.max_tasks}")
    if launches["pg_solve"] <= 0 or launches["resize"] <= 0:
        raise AssertionError(f"main path did not run both kernels: "
                             f"{launches}")
    if sesm.fresh_stacks != 1 or sesm.session_rebuilds != 0:
        raise AssertionError("the serving session was rebuilt")
    twin = make_engine(dev, "torch")
    trecs, tdec, tticks, _ = drive(twin)
    if trecs != recs:
        raise AssertionError("twin (torch round) records differ")
    for step, (a, b) in enumerate(zip(dec, tdec)):
        if a != b:
            raise AssertionError(f"twin decisions differ at step {step}")
    log(f"[serve] twin engine (inner=torch) decided identically at all "
        f"{len(dec)} steps; its re-slice ms/tick median "
        f"{np.median(tticks):.1f}")
    zs = [d[2] for step in dec for cell in step for d in cell if d[1]]
    wall_us, kern, count = profile_call(eng.reslice, "steady re-slice tick")
    launches["tick"] = dict(launches=count, wall_ms=wall_us / 1e3,
                            busy_ms=sum(kern.values()) / 1e3,
                            solve_device_us=sum(
                                us for name, us in kern.items()
                                if "pg_solve_kernel" in name))
    return launches, sesm._serve_session.dev, zs


def profile_call(fn, what: str, warm: bool = True):
    """Where one call of ``fn`` spends its time: wall time, device busy
    time (summed kernel time), launches and the top kernels, from a
    ``torch.profiler`` trace of a warm call (launches: every device event,
    kernels and copies); ``warm=False`` where ``fn`` has just run. Only the
    device's activity is recorded: a host event an operator (~10^5 in a
    train_4k step) would slow the host being measured.
    Returns (wall us, device us by kernel name, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the profiler's raw events: parsing them into FunctionEvents
    # (``prof.events()``) took ~150 s on the host for a trace of 254,383
    # launches (rwkv6-1.6b's training step before its WKV was batched, on
    # the H100 80GB HBM3 machine at 700 W)
    kern, count = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kern[e.name()] = kern.get(e.name(), 0.0) + e.duration_ns() / 1e3
            count += 1
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    log(f"[trace] {what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %), {count} "
        f"kernel launches of {len(kern)} names")
    for name, us in top:
        log(f"[trace]   {us:9.1f} us  {name[:90]}")
    return wall_us, kern, count


# --------------------------------------------------------------- phase 7

def eval_instances():
    """The paper's evaluation inputs: the Fig. 6 sweep for m = 2 and 4 and
    the largest instance of ``benchmarks/solver_perf.py``."""
    from repro_torch.core import build_instance, scenarios
    sweep = {}
    for m in (2, 4):
        insts, _ = scenarios.fig6_sweep(m, n_tasks=FIG6_TASKS,
                                        seeds=FIG6_SEEDS)
        sweep[f"fig6 m={m}"] = insts
    sweep["T=200 m=4"] = [build_instance(
        scenarios.numerical_pool(4),
        scenarios.numerical_tasks(200, "med", "high"))]
    return sweep


def fig7_instance(fps):
    """The instance ``SESM.slice`` builds for :func:`fig7_requests`."""
    from repro_torch.core import scenarios
    from repro_torch.serving import SDLA
    return SDLA().build_instance(fig7_requests(fps),
                                 scenarios.colosseum_pool())


def fig7_requests(fps):
    from repro_torch.serving import SliceRequest
    return [SliceRequest("object-recognition", "yolox", app,
                         max_latency_s=0.7, min_accuracy=acc,
                         jobs_per_sec=fps)
            for app, acc in (("coco_bags", 0.30), ("coco_animals", 0.50),
                             ("cityscapes_flat", 0.30))]


def run_evaluation(dev, sweep, backend, inner):
    """Every evaluation front door once: all six algorithms on every
    instance, Fig. 7's periods through ``SESM.slice``, the mixed-grid
    ``solve_greedy_many``."""
    from repro_torch.core import (ALGORITHMS, run_algorithm, scenarios,
                                  solve_greedy_many)
    from repro_torch.serving import SESM
    sols = {key: [{name: run_algorithm(name, inst, backend, inner=inner,
                                       device=dev)
                   for name in ALGORITHMS} for inst in insts]
            for key, insts in sweep.items()}
    fig7 = {}
    for algo, flags in FIG7_ALGOS.items():
        sesm = SESM(scenarios.colosseum_pool(), backend=backend, inner=inner,
                    device=dev)
        sesm.algorithm = dict(flags)
        fig7[algo] = [[(d.admitted, d.z, tuple(sorted(d.alloc.items())))
                       for d in sesm.slice(fig7_requests(fps))]
                      for fps in FIG7_FPS]
    many_insts, _ = scenarios.multi_cell_trace(4, 8, seed=1, n_grids=2)
    if backend == "numpy":
        from repro_torch.core import solve_greedy
        many = [solve_greedy(inst) for inst in many_insts]
    else:
        many = solve_greedy_many(many_insts, inner=inner, device=dev)
    return sols, fig7, many


def same_decision(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.admitted, b.admitted)
            and np.array_equal(a.alloc, b.alloc) and np.array_equal(a.z, b.z))


def f32_divergence(inst, semantic, flexible):
    """Replay Alg. 1 in float64 (the numpy oracle) and, from the same state
    each round, pick (task, allocation) in float32 as the device solve does
    (``greedy._inner_torch`` on host tensors — bitwise the round K2 serves).
    Returns None when every round picks alike, else the relative float64
    gap between the two picks at the first round where they differ: the
    larger of the task-priority gap and the allocation-score gap."""
    import numpy as np
    import torch
    from repro_torch.core import greedy as G
    lat, z_idx = G._select_tables(inst, semantic)
    lat_ok = lat <= inst.tasks.max_latency[:, None]
    alive = (z_idx >= 0) & lat_ok.any(axis=1)
    S, p, grid = inst.pool.capacity, inst.pool.price, inst.grid
    cost = G.lexicographic_cost(grid)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32)

    grid32, p32, s32, cost32 = f32(grid), f32(p), f32(S), f32(cost)
    lat32 = torch.from_numpy(lat_ok)
    occupied = np.zeros_like(S)
    while alive.any():
        cap_ok = (grid <= (S - occupied) + 1e-9).all(axis=1)
        pg = G.primal_gradient(grid, p, S, occupied)
        feas = lat_ok & cap_ok[None, :] & alive[:, None]
        occ32 = f32(occupied)
        g32, a32, h32 = G._inner_torch(grid32, p32, s32, occ32, s32 - occ32,
                                       lat32, torch.from_numpy(alive), cost32,
                                       flexible)
        alive &= feas.any(axis=1)
        if not alive.any():
            return None
        score = np.where(feas, (pg if flexible else -cost)[None, :], -np.inf)
        best_a = score.argmax(axis=1)
        prio = np.where(alive, pg[best_a], -np.inf)
        tau = int(prio.argmax())
        g32 = torch.where(torch.from_numpy(alive) & h32, g32, float("-inf"))
        tau32 = int(torch.argmax(g32))
        pick32 = int(a32[tau32])
        if (tau32, pick32) != (tau, int(best_a[tau])):
            top = score[tau32, best_a[tau32]]
            return max(abs(prio[tau] - prio[tau32]) / abs(prio[tau]),
                       abs(top - score[tau32, pick32]) / abs(top))
        occupied = occupied + grid[best_a[tau]]
        alive[tau] = False
    return None


def phase_evaluation(dev):
    """Slice 2's main path with the launch counts zeroed just before and
    read just after, then its twin (``inner="torch"``) and the numpy
    oracle outside the counted window."""
    import numpy as np
    import torch
    from repro_torch.core import ALGORITHMS
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.kernels.resize import resize as PR
    from repro_torch.core import greedy as G
    sweep = eval_instances()
    kernels = {"pg_solve": PK.SOLVE_KERNEL, "pg_round": PK.ROUND_KERNEL,
               "admission_round": PK.ADMIT_KERNEL,
               "masked_argmax": PK.ARGMAX_KERNEL, "resize": PR.RESIZE_KERNEL}
    run_rounds, rounds = G._run_rounds, {"single": 0, "batched": 0}

    def counted_rounds(body, state, alive_at):
        out = run_rounds(body, state, alive_at)
        rounds["single" if state[alive_at].dim() == 1 else "batched"] \
            += out[1]
        return out
    G._run_rounds = counted_rounds
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with SolveLog() as solves:
            sols, fig7, many = run_evaluation(dev, sweep, "torch", None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        G._run_rounds = run_rounds
    n_inst = sum(len(v) for v in sweep.values())
    log(f"[eval] {n_inst} instances x {len(ALGORITHMS)} algorithms, "
        f"{len(FIG7_FPS)} Fig. 7 periods x {len(FIG7_ALGOS)} algorithms, "
        f"{len(many)} mixed-grid cells in {wall:.1f} s; launches {launches}; "
        f"host-loop rounds run {rounds}; batched solves (rounds, host "
        f"syncs) {solves.results}")
    if launches["admission_round"] <= 0 or launches["pg_solve"] <= 0:
        raise AssertionError(f"the evaluation path did not run K2's round "
                             f"and K1: {launches}")
    solves.check_one_launch_each("solve_greedy_many")
    if launches["admission_round"] != rounds["single"]:
        raise AssertionError(f"K2's round kernel launched "
                             f"{launches['admission_round']} times for "
                             f"{rounds['single']} single-solve rounds")

    t0 = time.perf_counter()
    tsols, tfig7, tmany = run_evaluation(dev, sweep, "torch", "torch")
    log(f"[eval] twin (inner=torch) in {time.perf_counter() - t0:.1f} s")
    for key in sweep:
        for i, (a, b) in enumerate(zip(sols[key], tsols[key])):
            for name in ALGORITHMS:
                if not same_decision(a[name], b[name]):
                    raise AssertionError(f"{key} #{i} {name}: K2 and the "
                                         "torch round decide differently")
    if fig7 != tfig7:
        raise AssertionError("Fig. 7 SESM.slice: K2 and the torch round "
                             "decide differently")
    if not all(same_decision(a, b) for a, b in zip(many, tmany)):
        raise AssertionError("solve_greedy_many: K1 and the torch round "
                             "decide differently")
    log("[eval] decisions (admitted, alloc, z) identical to the twin on "
        "every instance, algorithm, period and cell")

    osols, ofig7, omany = run_evaluation(dev, sweep, "numpy", None)
    flags = {"sem-o-ran": (True, True), "si-edge": (False, False),
             "minres-sem": (True, False), "flexres-n-sem": (False, True)}
    for key, insts in sweep.items():
        for name in ALGORITHMS:
            sat = sum(int(s[name].num_satisfied) for s in sols[key])
            osat = sum(int(s[name].num_satisfied) for s in osols[key])
            diff = [i for i, (a, b) in enumerate(zip(sols[key], osols[key]))
                    if not same_decision(a[name], b[name])]
            gaps = [f32_divergence(insts[i], *flags[name]) for i in diff] \
                if name in flags else [None] * len(diff)
            bad = [i for i, gap in zip(diff, gaps)
                   if gap is None or gap > TIE_RTOL]
            log(f"[eval] {key} {name}: satisfied {sat} (oracle {osat}); "
                f"{len(diff)} of {len(insts)} instances decide differently"
                + (f" at #{diff} (f32 gaps "
                   f"{[float(f'{g:.3g}') if g is not None else None for g in gaps]})"
                   if diff else ""))
            if bad:
                raise AssertionError(f"{key} {name}: instances {bad} differ "
                                     "from the oracle beyond an f32 tie")
    fig7_diff = [(a, p) for a in FIG7_ALGOS for p in range(len(FIG7_FPS))
                 if fig7[a][p] != ofig7[a][p]]
    many_diff = [i for i, (a, b) in enumerate(zip(many, omany))
                 if not same_decision(a, b)]
    log(f"[eval] Fig. 7 (algorithm, period) differing from the numpy "
        f"backend: {fig7_diff or 'none'}; mixed-grid cells differing from "
        f"the oracle: {many_diff or 'none'}")
    from repro_torch.core import scenarios
    many_insts, _ = scenarios.multi_cell_trace(4, 8, seed=1, n_grids=2)
    fig7_insts = [fig7_instance(fps) for fps in FIG7_FPS]
    for what, inst, semantic, flexible in (
            [(f"Fig. 7 {a} period {p}", fig7_insts[p],
              FIG7_ALGOS[a]["semantic"], FIG7_ALGOS[a]["flexible"])
             for a, p in fig7_diff]
            + [(f"mixed-grid cell {i}", many_insts[i], True, True)
               for i in many_diff]):
        gap = f32_divergence(inst, semantic, flexible)
        log(f"[eval] {what}: first f32 divergence gap {gap}")
        if gap is None or gap > TIE_RTOL:
            raise AssertionError(f"{what}: differs from the oracle beyond "
                                 "an f32 tie")
    sem = fig7["sem-o-ran"][0]
    log(f"[eval] Fig. 7 p0 (10 fps) SEM-O-RAN: admitted "
        f"{[d[0] for d in sem]}, z {[round(d[1], 3) for d in sem]}; "
        f"MinRes-SEM admits Animals: {fig7['minres-sem'][0][1][0]}")
    from repro_torch.core import run_algorithm
    big = sweep["T=200 m=4"][0]
    wall_us, kern, count = profile_call(
        lambda: run_algorithm("sem-o-ran", big, "torch", device=dev),
        "SEM-O-RAN single solve, T=200 A=1280")
    launches["t200_solve"] = dict(launches=count, wall_ms=wall_us / 1e3,
                                  busy_ms=sum(kern.values()) / 1e3)
    return launches, big

# --------------------------------------------------------------- phase 8

def k4_inputs(rng, shape, dev, dtype):
    """Unit-normal q, k, v for a K4 shape (B, Tq, Tk, Hq, Hkv, Dh, causal)."""
    import numpy as np
    import torch
    b, tq, tk, hq, hkv, dh, _ = shape
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, getattr(torch, dtype))
        for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh))]


def k4_card_inputs(shape, dev, dtype, seed=5):
    """Unit-normal q, k, v for a K4 shape drawn on the card from a seeded
    generator: at T = 32768 a host draw of q alone is 268 M numbers."""
    import torch
    b, tq, tk, hq, hkv, dh, _ = shape
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(s, device=dev, generator=gen).to(getattr(torch,
                                                                 dtype))
            for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh))]


def k4_excess(out, ref) -> float:
    """K4's error against ``ref`` (its plain version in float32 on the
    same inputs) as a share of the tolerance: at most 1 passes. float32:
    max |out - ref| / ``K4_F32_ATOL``; bfloat16: the largest ratio of
    |out - ref| to ``K4_BF16_TOL``'s 2^-7 |ref| + 2^-6 rms(ref's row)."""
    import torch
    d = (out.float() - ref).abs()
    if out.dtype == torch.float32:
        return d.max().item() / K4_F32_ATOL
    rel, row = K4_BF16_TOL
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return (d / (rel * ref.abs() + row * rms)).max().item()


def k4_tail_faults(dev):
    """Planted faults the bf16 tolerance must catch where a row averages
    many keys: at the whisper encoder's shape (Tk 1500, a 28-key tail in
    64-key tiles) the tensor-core kernel run with the tail tile dropped,
    and with the tail unmasked (K and V zero-filled to a whole tile, what
    an unmasked tile would read), must each fail ``k4_excess``. Returns
    the two excesses."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn import attn as PA
    shape, tile = (2, 1500, 1500, 6, 6, 64, False), 64
    q, k, v = k4_inputs(np.random.default_rng(6), shape, dev, "bfloat16")
    causal, tk = shape[-1], shape[2]
    ref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
    cut, pad = tk - tk % tile, -tk % tile
    faults = {
        "tail tile dropped": (k[:, :cut].contiguous(),
                              v[:, :cut].contiguous()),
        "tail unmasked": (F.pad(k, (0, 0, 0, 0, 0, pad)),
                          F.pad(v, (0, 0, 0, 0, 0, pad)))}
    out = {}
    for what, (kf, vf) in faults.items():
        got = PA.launch("tensor_cores", q, kf, vf, causal=causal)
        out[what] = k4_excess(got, ref)
        if out[what] <= 1.0:
            raise AssertionError(f"K4 {shape}: the tensor-core kernel with "
                                 f"its {what} passes the bf16 tolerance "
                                 f"({out[what]:.3g} of it)")
    log(f"[K4] planted faults at {shape}, tensor cores bf16: "
        + ", ".join(f"{w} {x:.3g}x the tolerance" for w, x in out.items())
        + " (both must exceed it)")
    return out


def phase_k4(dev, shapes=K4_SHAPES):
    """K4 against its plain version on both kernels: float32 on the
    CUDA-core kernel, bfloat16 on the tensor-core kernel (the route
    ``flash_attention_fwd`` takes) and, held there by ``launch``, on the
    CUDA-core kernel; a second launch on the same inputs must agree bit
    for bit, and writes the log-sum-exp too, which must lie within
    ``K4_LSE_TOL`` of the plain version's. Returns the max abs error by
    (kernel, dtype), against the plain version in float32 on the same
    inputs (the LSE's under (kernel, "lse"))."""
    import numpy as np
    import torch
    from repro_torch.kernels.attn import attn as PA
    rng = np.random.default_rng(5)
    err, excess = {}, {}
    checks = (("cuda_cores", "float32"), ("tensor_cores", "bfloat16"),
              ("cuda_cores", "bfloat16"))

    def check(q, out, again, ref, what, key):
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K4 {what}: two launches on the same "
                                 "inputs differ")
        if out.dtype != q.dtype or out.shape != q.shape:
            raise AssertionError(f"K4 {what}: output {out.dtype} "
                                 f"{tuple(out.shape)}")
        x = k4_excess(out, ref)
        e = (out.float() - ref).abs().max().item()
        if not x <= 1.0:
            raise AssertionError(f"K4 {what}: max abs err {e}, {x:.3g}x "
                                 "the tolerance")
        err[key] = max(err.get(key, 0.0), e)
        excess[key] = max(excess.get(key, 0.0), x)
        return x
    for kernel, dtype in checks:
        by_shape, lse_err = [], []
        for shape in shapes:
            q, k, v = k4_inputs(rng, shape, dev, dtype) \
                if shape[1] <= PREFILL_T else k4_card_inputs(shape, dev, dtype)
            causal = shape[-1]
            if kernel == PA.route(q.dtype, q.shape[3]):
                out = PA.flash_attention_fwd(q, k, v, causal=causal)
            else:
                out = PA.launch(kernel, q, k, v, causal=causal)
            # the second launch writes the LSE: its output must still be
            # the first's, bit for bit
            again, lse = PA.launch(kernel, q, k, v, causal=causal,
                                   with_lse=True)
            ref, lref = k4_plain(q.float(), k.float(), v.float(), causal,
                                 with_lse=True, whole=K4_PLAIN_WHOLE)
            torch.cuda.synchronize()
            e = (lse - lref).abs().max().item()
            if not e <= K4_LSE_TOL:
                raise AssertionError(f"K4 {kernel} {shape} {dtype}: the LSE "
                                     f"is {e:.3g} from the plain LSE (bound "
                                     f"{K4_LSE_TOL})")
            lse_err.append(e)
            del lse, lref
            by_shape.append(check(q, out, again, ref,
                                  f"{kernel} {shape} {dtype}",
                                  (kernel, dtype)))
            del q, k, v, out, again, ref
        log(f"[K4] {kernel} {dtype}: {len(shapes)} shapes (B, Tq, Tk, Hq, "
            f"Hkv, Dh, causal) within the tolerance; max abs err "
            f"{err[kernel, dtype]:.3g}; share of the tolerance by shape "
            + " ".join(f"{x:.3f}" for x in by_shape))
        err[kernel, "lse"] = max(err.get((kernel, "lse"), 0.0), *lse_err)
        log(f"[K4] {kernel} {dtype} with the LSE written: the output bit for "
            f"bit the same at all {len(shapes)} shapes; the LSE within "
            f"{max(lse_err):.3g} of the plain LSE (bound {K4_LSE_TOL}), by "
            "shape " + " ".join(f"{x:.2g}" for x in lse_err))
    for dtype in ("float32", "bfloat16"):
        key = ("cuda_cores", f"{dtype} Dh=320")
        for shape in K4_WIDE_SHAPES:
            q, k, v = k4_inputs(rng, shape, dev, dtype)
            if PA.route(q.dtype, q.shape[3]) != "cuda_cores":
                raise AssertionError(f"K4 {shape} {dtype}: not routed to the "
                                     "CUDA-core kernel")
            before = PA.FLASH_CORE_KERNEL.launches
            out = PA.flash_attention_fwd(q, k, v, causal=shape[-1])
            again = PA.flash_attention_fwd(q, k, v, causal=shape[-1])
            ref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                             causal=shape[-1])
            if PA.FLASH_CORE_KERNEL.launches != before + 2:
                raise AssertionError(f"K4 {shape} {dtype}: the CUDA-core "
                                     "kernel did not launch")
            check(q, out, again, ref, f"{shape} {dtype}", key)
        log(f"[K4] Dh=320 {dtype} on the CUDA-core kernel (the route): "
            f"{len(K4_WIDE_SHAPES)} shapes within the tolerance; max abs err "
            f"{err[key]:.3g}, {excess[key]:.3f} of the tolerance")
    k4_tail_faults(dev)
    wide = torch.zeros(1, 4, 2, 520, device=dev)
    try:
        PA.flash_attention_fwd(wide, wide, wide)
    except ValueError as e:
        log(f"[K4] Dh=520 raises: {e}")
    else:
        raise AssertionError("K4 took Dh=520, which no kernel has a tile for")
    return err


def k4b_excess(out, ref, tol=None) -> float:
    """K4′'s error against ``ref`` (its plain version in float32 on the
    same inputs) as a share of ``tol`` (a, b, c) — by default
    ``K4B_BF16_TOL`` or ``K4B_F32_TOL`` by the output's type: the largest
    |out - ref| / (a |ref| + b rms(ref's row) + c rms(ref)); at most 1
    passes."""
    return k4b_ratio(out, ref, tol).max().item()


def k4b_ratio(out, ref, tol=None):
    """|out - ref| / (a |ref| + b rms(ref's row) + c rms(ref)), element by
    element (``k4b_excess``)."""
    import torch
    a, b, c = tol or (K4B_F32_TOL if out.dtype == torch.float32
                      else K4B_BF16_TOL)
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    floor = c * ref.pow(2).mean().sqrt()
    return (out.float() - ref).abs() / (a * ref.abs() + b * rms + floor)


def k4b_work(shape, esize):
    """(bytes, flops) of K4's gradient at ``shape``: q, k, v, o and dO read
    once, dq, dk and dv written once; 10·Dh flops (five products) per
    (query, key) pair the mask keeps, 2.5 times the forward's."""
    b, tq, tk, hq, hkv, dh, causal = shape[:7]
    _, fwd = k4_work(shape[:7], esize)
    nbytes = (4 * b * tq * hq * dh + 4 * b * tk * hkv * dh) * esize
    return nbytes, fwd * 10 // 4


def peak_of(dtype: str) -> float:
    """The card's peak FLOP/s for work on ``dtype`` inputs: float32 outside
    the tensor cores, bf16 on them."""
    return F32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S


# K4′'s kernels by route, as torch.profiler names them
K4B_PASS_NAMES = {
    "cuda_cores": ("bwd_dq_kernel", "bwd_dkdv_kernel", "bwd_reduce_kernel"),
    "tensor_cores": ("bwd_tc_dq_kernel", "bwd_tc_dkdv_kernel",
                     "bwd_tc_reduce_kernel")}


def k4b_pass_us(fn, route="cuda_cores", iters: int = 5) -> dict:
    """Device µs a call of each of K4′'s passes on ``route``, from
    one ``torch.profiler`` trace of ``iters`` calls (empty when the
    profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        for name in K4B_PASS_NAMES[route]:
            if name in e.name:
                out[name] = out.get(name, 0.0) + _device_time(e) / iters
    return {k: v for k, v in out.items() if v > 0}


def k4b_kernel(route):
    """The launch counter of K4′'s ``route``."""
    from repro_torch.kernels.attn import attn as PA
    return {"tensor_cores": PA.FLASH_BWD_TC_KERNEL,
            "cuda_cores": PA.FLASH_BWD_CORE_KERNEL}[route]


def phase_k4_bwd(dev, shapes=K4B_SHAPES, timed=K4B_TIMED):
    """K4′ against its plain version ``flash_attention_bwd_ref`` in float32
    on the same inputs (q, k, v and dO unit normals, o K4's output) on both
    routes, each given its own K4's LSE (within ``K4_LSE_TOL`` of the
    plain LSE): every bf16 shape the tensor-core route takes (Dh % 8 == 0,
    Dh <= 256) on it — ``flash_attention_bwd``, the path's route — within
    ``K4B_TC_TOL``, and held on the CUDA-core kernel (``bwd_launch``)
    within ``K4B_BF16_TOL``; the other shapes on the CUDA-core route, the
    float32 ones within ``K4B_F32_TOL`` and once more given the plain
    version's LSE. On each route: a repeat bit for bit, a launch a pass
    (``BWD_PASSES``) on that route's kernel. Once through
    ``FlashAttention``'s backward (autograd, its forward writing the LSE),
    bit for bit the direct call given the same LSE. The shapes in
    ``timed`` are timed on each route: ms a call (CUDA events), device µs
    by pass (``torch.profiler``), the plain version and SDPA's backward
    (``enable_gqa``, a yardstick the port never calls), beside the bound;
    K4's forward and SDPA's forward at the shape beside theirs; and the
    kernels' and SDPA's median, least and largest ms over interleaved
    repeats (``interleaved``). Returns the kernels-line rows, tensor-core
    route first."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn import attn as PA
    rng = np.random.default_rng(9)
    rows = {
        "tensor_cores": dict(
            name="flash_attn_bwd_tc", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attn_bwd_tc.cu",
            replaces="src/repro/models/attention.py:79",
            k4b_route="tensor_cores", shapes={}),
        "cuda_cores": dict(
            name="flash_attn_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
            replaces="src/repro/models/attention.py:79",
            k4b_route="cuda_cores", shapes={})}
    err, worst = {}, {}
    for n, shape in enumerate(shapes):
        *geo, causal, dtype = shape
        q, k, v = k4_inputs(rng, tuple(geo) + (causal,), dev, dtype)
        dout = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(
            np.float32)).to(dev, q.dtype)
        path = PA.route(q.dtype, q.shape[3])
        routes = ("tensor_cores", "cuda_cores") if path == "tensor_cores" \
            else ("cuda_cores",)
        # each route's K4 and its LSE, against the plain version's: the
        # path's output and LSE, and the CUDA-core K4's LSE for a bf16 call
        # held on the CUDA-core K4′
        _, lref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                             causal=causal, with_lse=True)
        lses = {}
        for route in routes:
            o_r, lses[route] = PA.launch(route, q, k, v, causal=causal,
                                         with_lse=True)
            if route == path:
                out, lse = o_r, lses[route]
            del o_r
            lse_err = (lses[route] - lref).abs().max().item()
            if not lse_err <= K4_LSE_TOL:
                raise AssertionError(f"K4 {shape} {route}: the LSE is "
                                     f"{lse_err:.3g} from the plain LSE "
                                     f"(bound {K4_LSE_TOL})")
            log(f"[K4′] {shape}: K4's LSE on {route} within {lse_err:.3g} "
                f"of the plain LSE (bound {K4_LSE_TOL})")
            key = "k4_lse" if route == "tensor_cores" else "k4_lse_core"
            err[key] = max(err.get(key, 0.0), lse_err)
        del lref
        ref = PA.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         out.float(), dout.float(),
                                         causal=causal)
        calls = {}
        for route in routes:
            tc = route == "tensor_cores"
            tol = K4B_TC_TOL if tc else K4B_F32_TOL \
                if dtype == "float32" else K4B_BF16_TOL
            counter = k4b_kernel(route)
            before, total = counter.launches, PA.FLASH_BWD_KERNEL.launches

            def call(route=route):
                if route == path:
                    return PA.flash_attention_bwd(q, k, v, out, dout,
                                                  causal=causal, lse=lse)
                return PA.bwd_launch(route, q, k, v, out, dout,
                                     causal=causal, lse=lses[route])
            calls[route] = call
            got, again = call(), call()
            torch.cuda.synchronize()
            n_l = counter.launches - before
            if n_l != 2 * PA.BWD_PASSES[route] \
                    or PA.FLASH_BWD_KERNEL.launches - total != n_l:
                raise AssertionError(f"K4′ {shape} {route}: {n_l} launches "
                                     "for two calls")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K4′ {shape} {route}: a repeat differs")
            shares, where, first = [], "", []
            for what, g, r, like in zip(("dq", "dk", "dv"), got, ref,
                                        (q, k, v)):
                if g.dtype != like.dtype or g.shape != like.shape:
                    raise AssertionError(f"K4′ {shape} {what}: {g.dtype} "
                                         f"{tuple(g.shape)}")
                ratio = k4b_ratio(g, r, tol)
                x = ratio.max().item()
                e = (g.float() - r).abs().max().item()
                at = tuple(int(i) for i in np.unravel_index(
                    int(ratio.argmax()), ratio.shape))
                if what == "dq":
                    where = f"dq's worst at t = {int(at[1])}"
                if tc:
                    r16 = k4b_ratio(g, r, K4B_TC_FLOOR)
                    at16 = np.unravel_index(int(r16.argmax()), r16.shape)
                    first.append(f"{what} {r16.max().item():.3f} at t = "
                                 f"{int(at16[1])}")
                if not x <= 1.0:
                    raise AssertionError(
                        f"K4′ {shape} {route} {what}: max abs err {e}, {x:.3g}x "
                        f"the tolerance {tol}, worst at (b, t, h, d) = "
                        f"{at}: ref "
                        f"{r[at].item():.4g}, got {g[at].item():.4g}, the "
                        f"row's rms {r[at[:-1]].pow(2).mean().sqrt().item():.4g}")
                shares.append(x)
                key = (route, dtype)
                err[key] = max(err.get(key, 0.0), e)
                worst[key] = max(worst.get(key, 0.0), x)
            log(f"[K4′] {shape} {route}{' (the route)' if route == path else ''}"
                f": dq, dk, dv within the tolerance {tol} ("
                + ", ".join(f"{x:.3f}" for x in shares) + f" of it; {where}),"
                " a repeat bit for bit"
                + (f"; of the first floor {K4B_TC_FLOOR} (unbounded): "
                   + ", ".join(first) if first else ""))
            if shape in timed:
                row = rows[route]
                iters = 20 if tc else 5
                ms = cuda_ms(call, iters=iters, warmup=1)
                passes = k4b_pass_us(call, route)
                dev_us = sum(passes.values()) if passes else None
                row["shapes"]["_".join(str(x) for x in geo)
                              + ("_causal" if causal else "")] = dict(
                    dtype=dtype, ms=ms, pass_device_us=passes,
                    device_ms=None if dev_us is None else dev_us / 1e3)
                log(f"[time] K4′ {shape} {route}: {ms:.4f} ms a call (device "
                    f"{fmt_us(dev_us)}: "
                    + ", ".join(f"{k.split('bwd_')[1].removesuffix('_kernel')}"
                                f" {x:.1f}" for k, x in passes.items()) + ")")
            del got, again
        if dtype == "float32":
            # the CUDA-core route given the forward's LSE: its first pass
            # then computes D only
            _, lref = PA.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 with_lse=True)
            given = PA.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                           lse=lref)
            xs = [k4b_excess(g, r) for g, r in zip(given, ref)]
            if not max(xs) <= 1.0:
                raise AssertionError(f"K4′ {shape}: given the plain LSE, "
                                     f"{max(xs):.3g}x the tolerance")
            log(f"[K4′] {shape} cuda_cores given the plain LSE: within the "
                "tolerance (" + ", ".join(f"{x:.3f}" for x in xs) + " of it)")
            del given, lref
        del ref
        if n == 0:
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = k4b_kernel(path).launches
            PA.flash_attention_fwd(*ins, causal=causal).backward(dout)
            n_l = k4b_kernel(path).launches - before
            want = PA.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                          lse=lse)
            torch.cuda.synchronize()
            if n_l != PA.BWD_PASSES[path]:
                raise AssertionError(f"K4′ {shape}: FlashAttention's backward "
                                     f"made {n_l} launches on the {path} route")
            if not all(torch.equal(t.grad, g) for t, g in zip(ins, want)):
                raise AssertionError(f"K4′ {shape}: FlashAttention's backward "
                                     "differs from flash_attention_bwd given "
                                     "K4's LSE")
            log(f"[K4′] {shape}: FlashAttention's backward (its forward "
                f"writing the LSE; {n_l} launches on the {path} route) bit for "
                "bit the direct call's given K4's LSE")
            del ins, want
        if shape in timed:
            plain = cuda_ms(lambda: PA.flash_attention_bwd_ref(
                q, k, v, out, dout, causal=causal), iters=2, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True)
            do_lib = dout.transpose(1, 2)
            lib = cuda_ms(lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_lib, retain_graph=True), iters=10)
            del qt, kt, vt, o_lib
            # K4's own device time at the shape, while the profiler still
            # reports every launch (late in a run it drops records, §7),
            # its time a call and SDPA's forward's beside its bound
            fwd_us = device_us(lambda: PA.flash_attention_fwd(
                q, k, v, causal=causal), "flash_", iters=20)
            fwd_ms = cuda_ms(lambda: PA.flash_attention_fwd(
                q, k, v, causal=causal), iters=20)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20)
            # the same calls in turn: median and range over the repeats
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal,
                                                   enable_gqa=True)
            fns = {f"k4b_{r}": calls[r] for r in routes}
            fns.update(
                sdpa_bwd=lambda: torch.autograd.grad(
                    o_lib, (qg, kg, vg), do_lib, retain_graph=True),
                k4_fwd=lambda: PA.flash_attention_fwd(q, k, v,
                                                      causal=causal),
                sdpa_fwd=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            spread = interleaved(fns, reps=5,
                                 iters=5 if max(geo[1:3]) >= 1024 else 20,
                                 warm=2)
            del qt, kt, vt, qg, kg, vg, o_lib
            log(f"[time] K4′ {shape} in turn, 5 repeats, median [least, "
                "largest]: " + ", ".join(f"{n} {fmt_spread(x)}"
                                         for n, x in spread.items()))
            fb, ff = k4_work(tuple(geo) + (causal,), q.element_size())
            fwd_bound = max(fb / HBM_BYTES_PER_S, ff / peak_of(dtype)) * 1e3
            nbytes, flops = k4b_work(shape, q.element_size())
            peak = peak_of(dtype)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak \
                else "operations"
            f32_bound = max(nbytes / HBM_BYTES_PER_S,
                            flops / F32_FLOP_PER_S) * 1e3
            key = "_".join(str(x) for x in geo) + ("_causal" if causal
                                                   else "")
            mss = {r: rows[r]["shapes"][key]["ms"] for r in routes}
            log(f"[time] K4′ {shape}: "
                + ", ".join(f"{r} {m:.4f} ms" for r, m in mss.items())
                + f"; plain {plain:.3f} ms; SDPA backward {lib:.3f} ms; "
                f"K4 forward {fwd_ms:.4f} ms (device {fmt_us(fwd_us)}), "
                f"SDPA forward {lib_fwd:.4f} ms, bound {fwd_bound:.4f} ms; "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB: bound "
                f"{bound:.4f} ms ({by}), f32 CUDA-core bound "
                f"{f32_bound:.3f} ms")
            for r in routes:
                row = rows[r]
                row["shapes"][key].update(
                    plain_ms=plain, library_ms=lib, bound_ms=bound,
                    bound_by=by, bound_ms_f32_cuda_cores=f32_bound,
                    k4_fwd_device_ms=None if fwd_us is None
                    else fwd_us / 1e3, k4_fwd_ms=fwd_ms,
                    sdpa_fwd_ms=lib_fwd, k4_fwd_bound_ms=fwd_bound,
                    interleaved=spread)
                if "ms" not in row:
                    row.update({x: row["shapes"][key][x] for x in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "device_ms")}, shape=list(shape))
        del q, k, v, dout, out, lse, lses
        torch.cuda.empty_cache()
    for (route, dtype), x in sorted(worst.items()):
        log(f"[K4′] {route} {dtype}: max abs err {err[route, dtype]:.3g}, "
            f"{x:.3f} of the tolerance")
    for route, row in rows.items():
        row.update(max_abs_err=err.get((route, "bfloat16")),
                   tolerance_share={d: x for (r, d), x in worst.items()
                                    if r == route})
    rows["cuda_cores"]["max_abs_err_f32"] = err.get(("cuda_cores", "float32"))
    rows["tensor_cores"]["k4_lse_max_abs_err"] = err.get("k4_lse")
    rows["cuda_cores"]["k4_lse_max_abs_err"] = err.get("k4_lse_core")
    rows["tensor_cores"]["tolerance"] = list(K4B_TC_TOL)
    rows["cuda_cores"]["tolerance"] = dict(bfloat16=list(K4B_BF16_TOL),
                                           float32=list(K4B_F32_TOL))
    return rows


# --------------------------------------------------------------- phase 9

def lm_model(dev, cfg):
    """``cfg``'s parameters from a seeded generator on ``dev``."""
    import torch
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[lm] {cfg.name}: {n / 1e9:.3f} B parameters ({cfg.param_dtype}, "
        f"param_count() {cfg.param_count() / 1e9:.3f} B) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_lm_serving(dev, cfg, params, ticks=LM_TICKS, k4_layers=None):
    """Slice 3's serving path (and slice 8's, for each token-only config):
    the launcher's engine, model and requests on the card, counts zeroed
    just before the re-slice and the ticks and read just after; K4 must
    launch ``k4_layers`` times (default: every layer) per LM job batch, all
    on the tensor-core kernel. Returns the launch counts (with the LM job
    batches) and the shapes K4 was given."""
    k4_layers = cfg.n_layers if k4_layers is None else k4_layers
    import torch
    from repro_torch.core import scenarios
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.kernels.resize import resize as PR
    from repro_torch.launch import serve
    from repro_torch.serving import EdgeServingEngine
    eng = EdgeServingEngine(scenarios.colosseum_pool(), device=dev)
    eng.register_model(cfg.name, cfg, params, serve.infer_fn(cfg))
    for req in serve.requests(cfg.name):
        eng.submit(req)
    cell = eng.runtime
    batches, shapes = [], set()
    run_lm, flash = cell._run_lm_job, PA.flash_attention_fwd

    def counted_job(rt, b):
        batches.append(b)
        return run_lm(rt, b)

    def seen_flash(q, k, v, *, causal=True):
        shapes.add((tuple(q.shape), tuple(k.shape), str(q.dtype), causal))
        return flash(q, k, v, causal=causal)
    cell._run_lm_job, PA.flash_attention_fwd = counted_job, seen_flash
    kernels = {"pg_solve": PK.SOLVE_KERNEL, "pg_round": PK.ROUND_KERNEL,
               "resize": PR.RESIZE_KERNEL, "flash_attn": PA.FLASH_KERNEL,
               "flash_attn_tc": PA.FLASH_TC_KERNEL,
               "flash_attn_core": PA.FLASH_CORE_KERNEL}
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        decisions = eng.reslice()
        t1 = time.perf_counter()
        for _ in range(ticks):
            eng.process(wall_dt=1.0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {name: k.launches for name, k in kernels.items()}
        launches["lm_batches"] = len(batches)
    finally:
        del cell._run_lm_job
        PA.flash_attention_fwd = flash
    for d in decisions:
        log(f"[lm] {d.request.app_class:16s} {d.request.model:12s} "
            f"admitted={d.admitted} z={d.z:.3f} alloc={d.alloc}")
    lm = [rt for rt in eng.tasks.values()
          if rt.decision.request.model == cfg.name]
    if len(lm) != 1 or lm[0].jobs_done <= 0:
        raise AssertionError("the LM task was not admitted or ran no job")
    for rid, m in eng.metrics().items():
        log(f"[lm] task {rid} {m['app']:16s} jobs={m['jobs_done']} "
            f"p50={m['p50_latency_s']}")
    if launches["flash_attn_tc"] != k4_layers * len(batches) \
            or launches["flash_attn"] != launches["flash_attn_tc"]:
        raise AssertionError(f"K4 launched {launches} times for "
                             f"{len(batches)} LM batches of {k4_layers} "
                             f"full-attention layers: all must be on the "
                             f"tensor-core kernel")
    if launches["resize"] <= 0:
        raise AssertionError(f"the vision jobs did not run K3: {launches}")
    log(f"[lm] re-slice {1e3 * (t1 - t0):.1f} ms; {ticks} ticks in "
        f"{1e3 * (t2 - t1):.1f} ms; LM job batches {batches} "
        f"({lm[0].jobs_done} jobs); launches {launches}; K4 shapes "
        f"{sorted(shapes)}")
    return launches, sorted(shapes)


def prefill_batch(dev, cfg, b, t):
    """Seeded tokens (b, t) on ``dev`` and, for an encoder-decoder, its
    (b, WHISPER_FRAMES, d_model) frame embeddings from a seeded
    generator."""
    import numpy as np
    import torch
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, t), dtype=np.int32)).to(dev)}
    if cfg.is_encdec:
        batch["enc_input"] = torch.randn(
            (b, WHISPER_FRAMES, cfg.d_model), device=dev,
            generator=torch.Generator(dev).manual_seed(8))
    return batch


class RouteLog:
    """Records each MoE routing of a prefill, a layer at a time (router
    logits and the experts chosen), by wrapping ``models/moe.py::_route``.
    With ``force`` (an earlier run's log) every layer takes that run's
    experts, with gates from its own logits."""

    def __init__(self, force=None):
        self.logits, self.idx, self.force = [], [], force

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MM
        self._mm, self._route = MM, MM._route

        def route(params, x, cfg):
            logits = x.float() @ params["router"].float()
            if self.force is None:
                gates, idx = self._route(params, x, cfg)
            else:
                idx = self.force.idx[len(self.idx)]
                gates = torch.softmax(logits.gather(-1, idx), dim=-1)
            self.logits.append(logits.detach())
            self.idx.append(idx)
            return gates, idx
        MM._route = route
        return self

    def __exit__(self, *exc):
        self._mm._route = self._route


def routing_flips(run, twin, k):
    """Where the twin's own router logits would choose other top-k experts
    than the run's (RouteLogs ``run`` and ``twin``, the twin forced onto the
    run's experts), by layer; and the largest ratio, at those positions, of
    the twin's gap between its k-th and (k+1)-th logit to twice the two
    runs' largest logit difference. A choice that differs only because the
    logits moved has a ratio of at most 1 (a near-tie)."""
    flips, worst = [], 0.0
    for la, lb, ia in zip(run.logits, twin.logits, run.idx, strict=True):
        top = lb.topk(k + 1, dim=-1)
        own = top.indices[..., :k].sort(-1).values
        flip = (own != ia.sort(-1).values).any(-1)
        flips.append(int(flip.sum()))
        if flip.any():
            gap = (top.values[..., k - 1] - top.values[..., k])[flip]
            moved = 2 * (la - lb).abs().amax(-1)[flip]
            worst = max(worst, (gap / moved.clamp(min=1e-30)).max().item())
    return flips, worst


class BlockLog:
    """Records each block of a prefill (``models/blocks.py``'s
    ``block_prefill`` and ``block_train``, in call order): its input, the
    encoder output it attends to and its output. With ``force`` (an earlier
    run's log) every block instead takes that run's input and encoder
    output at the same call, so a twin's blocks differ from that run's by
    their own arithmetic only, not by what earlier blocks passed on."""

    def __init__(self, force=None):
        self.calls, self.force = [], force

    def __enter__(self):
        from repro_torch.models import blocks as MB
        self._mb, self._fns = MB, (MB.block_prefill, MB.block_train)

        def wrap(fn):
            def block(params, x, *args, **kw):
                if self.force is not None:
                    x, enc, _ = self.force.calls[len(self.calls)]
                    if enc is not None:
                        kw["enc"] = enc
                out = fn(params, x, *args, **kw)
                self.calls.append((x, kw.get("enc"),
                                   out[0] if isinstance(out, tuple) else out))
                return out
            return block
        MB.block_prefill, MB.block_train = map(wrap, self._fns)
        return self

    def __exit__(self, *exc):
        self._mb.block_prefill, self._mb.block_train = self._fns

    def apart(self, other) -> float:
        """Largest abs difference between the two logs' block outputs, in
        units of the root mean square of ``other``'s output row: the scale
        at which the next block's pre-norm reads the residual stream, which
        random weights grow to tens."""
        worst = 0.0
        for a, b in zip(self.calls, other.calls, strict=True):
            ref = b[2].float()
            rms = ref.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
            worst = max(worst, ((a[2].float() - ref).abs() / rms).max()
                        .item())
        return worst


def phase_lm_prefill(dev, cfg, params, b=PREFILL_B, t=PREFILL_T, k4=None):
    """``prefill`` at (b, t) through K4 (``k4`` launches, default one a
    layer, all on the tensor-core kernel), each K4 call held to phase 8's
    tolerance on its own inputs; then its twin with the full-attention
    route pointed at K4's plain version (``k4_plain``: by blocks of query
    rows at T = 32768) (and, where K4 launched and t <= ``PREFILL_T``, as
    yardsticks, at K4's CUDA-core kernel and at SDPA), every block of it
    on the K4 run's input to that block (``BlockLog``) and, in an MoE
    model, with the K4 run's experts (where the twin's own router logits
    would choose others, the choice must be a near-tie,
    ``routing_flips``): logits, caches and block outputs held to the bf16
    tolerances. Returns the run's numbers."""
    import types
    import torch
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import attention as MA
    from repro_torch.models import prefill
    k4 = cfg.n_layers if k4 is None else k4
    batch = prefill_batch(dev, cfg, b, t)

    def run():
        return prefill(params, batch, cfg, cache_len=t)
    kernel_route = MA.attn_kernel
    # the first run warms and checks; the second is timed
    with RouteLog() as routes, BlockLog() as blocks, K4Checked() as checked:
        logits, cache = run()
    per_call = checked.held(f"{cfg.name} prefill")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.FLASH_KERNEL.launches = 0
    t0 = time.perf_counter()
    timed = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = PA.FLASH_KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    if PA.FLASH_TC_KERNEL.launches != k4 or launches != k4:
        raise AssertionError(
            f"the prefill launched K4 {launches} times, "
            f"{PA.FLASH_TC_KERNEL.launches} on the tensor-core kernel; "
            f"{k4} on it expected")
    for out in (logits, timed[0]):
        if out.shape != (b, cfg.vocab_size) \
                or not torch.isfinite(out.float()).all():
            raise AssertionError("prefill logits are not finite of shape "
                                 f"{(b, cfg.vocab_size)}")
    del timed

    def plain(q, k, v, *, causal=True):
        return k4_plain(q, k, v, causal, whole=K4_PLAIN_WHOLE)
    MA.attn_kernel = types.SimpleNamespace(flash_attention_fwd=plain)
    try:
        with RouteLog(force=routes) as twin, \
                BlockLog(force=blocks) as twin_blocks:
            t0 = time.perf_counter()
            plogits, pcache = run()
            torch.cuda.synchronize()
            plain_wall = (time.perf_counter() - t0) * 1e3
    finally:
        MA.attn_kernel = kernel_route
    flips = None
    if cfg.is_moe:
        flips, worst = routing_flips(routes, twin, cfg.top_k)
        log(f"[prefill] {cfg.name}: the plain twin's own router logits "
            f"would choose other experts than K4's run at {sum(flips)} of "
            f"{len(flips) * b * t} (layer, token) pairs (by layer {flips}); "
            f"largest logit gap over twice the logit change there "
            f"{worst:.3g} (<= 1: near-ties)")
        if worst > 1.0:
            raise AssertionError("a routing differs from the twin's beyond "
                                 "a near-tie")
    if PA.FLASH_KERNEL.launches != launches:
        raise AssertionError("the plain twin launched K4")
    d_logit = (logits.float() - plogits.float()).abs()
    d_cache = max((a.float() - c.float()).abs().max().item()
                  for a, c in zip(_leaves(cache), _leaves(pcache),
                                  strict=True))
    d_block = blocks.apart(twin_blocks)
    cache_max = max(c.float().abs().max().item() for c in _leaves(pcache))
    top = (logits.argmax(-1) == plogits.argmax(-1)).sum().item()
    # the twin's lead of its top-1 token over the token K4 ranks first, by
    # row: a top-1 that differs is a near-tie only if the lead is within
    # what the two runs' logits differ by (twice the max diff)
    pl = plogits.float()
    lead = (pl.max(-1).values
            - pl.gather(-1, logits.argmax(-1, keepdim=True))[:, 0])
    top2 = pl.topk(2, dim=-1).values
    twin = "the plain attention on K4's block inputs" + (
        " and experts" if cfg.is_moe else "")
    log(f"[prefill] {cfg.name} B={b} T={t}: {wall:.1f} ms through K4 "
        f"({launches} launches, all on the tensor-core kernel), "
        f"{plain_wall:.1f} ms with the plain attention; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[prefill] K4 vs {twin}: logits max abs diff "
        f"{d_logit.max().item():.4g} (mean {d_logit.mean().item():.3g}, "
        f"|logits| max {logits.float().abs().max().item():.3g}); caches "
        f"max abs diff {d_cache:.4g} (|cache| max {cache_max:.3g}); block "
        f"outputs max abs diff {d_block:.4g} of their row's rms over "
        f"{len(blocks.calls)} blocks; top-1 token equal in {top} of {b}; "
        f"the twin's top-2 margin by row {(top2[:, 0] - top2[:, 1]).tolist()}"
        f", its lead over K4's top-1 {lead.tolist()}")
    if not (lead <= 2 * d_logit.max()).all():
        raise AssertionError("K4's top-1 token differs from the twin's "
                             "beyond a near-tie")
    if not d_logit.max().item() <= PREFILL_LOGIT_TOL:
        raise AssertionError(f"prefill logits differ beyond "
                             f"{PREFILL_LOGIT_TOL}")
    if not d_cache <= PREFILL_CACHE_TOL:
        raise AssertionError(f"prefill caches differ beyond "
                             f"{PREFILL_CACHE_TOL}")
    if not d_block <= PREFILL_BLOCK_TOL:
        raise AssertionError(f"a block's output differs beyond "
                             f"{PREFILL_BLOCK_TOL} of its row's rms")
    # past T = 2048 (the serving cells) the yardsticks, a prefill each, are
    # left out, and the timed run and the twin have warmed every kernel
    if k4 and t <= PREFILL_T:
        yardsticks(run, kernel_route, routes, blocks, logits, pl)
    wall_us, kern, count = profile_call(run, f"{cfg.name} prefill B={b} "
                                        f"T={t}", warm=t <= PREFILL_T)
    busy = sum(kern.values())
    k4_us = sum(us for name, us in kern.items() if "flash_tc_kernel" in name)
    log(f"[trace] {cfg.name} prefill B={b} T={t}: K4 (flash_tc_kernel) "
        f"{k4_us / 1e3:.3f} ms of the device time, "
        f"{100 * k4_us / max(busy, 1e-9):.1f} % of it, "
        f"{100 * k4_us / wall_us:.1f} % of the wall time")
    return dict(shape=[b, t], k4_launches=launches, wall_ms=wall,
                plain_twin_ms=plain_wall, peak_gib=peak / 2**30,
                k4_calls_share_of_tolerance=per_call,
                logit_max_diff=d_logit.max().item(), cache_max_diff=d_cache,
                block_max_diff=d_block,
                routing_flips=flips, trace_wall_ms=wall_us / 1e3,
                device_busy_ms=busy / 1e3, device_busy_share=busy / wall_us,
                trace_launches=count, k4_device_ms=k4_us / 1e3,
                k4_share_of_busy=k4_us / max(busy, 1e-9))


def k4_block_ref(q, k, v, causal, row0):
    """K4's plain version on a block of query rows: q (B, R, Hq, Dh) the
    rows ``row0``..``row0`` + R - 1 of a call, k and v (B, Tk', Hkv, Dh)
    its first Tk' keys (every key a causal row of the block may see), in
    float32 with ``flash_attention_fwd_ref``'s arithmetic — scale, NEG,
    GQA map, ``acc / max(l, 1e-30)`` — and its causal mask shifted by
    ``row0`` (key j is seen by row i where j <= row0 + i). Returns
    (out float32 (B, R, Hq, Dh), lse (B, Hq, R))."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    b, rows, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh = (q.float() * dh ** -0.5).reshape(b, rows, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    if causal:
        seen = torch.arange(tk, device=q.device)[None, :] \
            <= row0 + torch.arange(rows, device=q.device)[:, None]
        s.masked_fill_(~seen, PA.NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()            # in place: the block's one score tensor
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(dim=-1)                                    # (B, Hkv, G, R)
    del p
    out = pv / torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return out.reshape(b, rows, hq, dh), lse.reshape(b, hq, rows)


def k4_plain(q, k, v, causal, with_lse=False, whole=None):
    """K4's plain version on any call, computed in float32 and cast to q's
    type as ``flash_attention_fwd_ref`` casts (the checks pass float32
    inputs): that function in one call where the call's scores have at
    most ``whole`` elements (default ``K4_REF_WHOLE``); else a KV head of
    a batch row at a time, in blocks of query rows whose scores have at
    most ``K4_REF_WHOLE`` elements (``k4_block_ref``: 128 rows of 16
    query heads at T = 32768; a causal block against the keys up to its
    last row). With ``with_lse`` also each row's float32 log-sum-exp (B,
    Hq, Tq)."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    b, tq, hq, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if b * hq * tq * tk <= (K4_REF_WHOLE if whole is None else whole):
        return PA.flash_attention_fwd_ref(q, k, v, causal=causal,
                                          with_lse=with_lse)
    g = hq // hkv
    rows = max(1, K4_REF_WHOLE // (g * tk))
    ref = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    for i in range(b):
        for h in range(hkv):
            heads = slice(h * g, (h + 1) * g)
            qs = q[i:i + 1, :, heads]
            ks, vs = k[i:i + 1, :, h:h + 1], v[i:i + 1, :, h:h + 1]
            for r0 in range(0, tq, rows):
                r1 = min(r0 + rows, tq)
                keys = min(r1, tk) if causal else tk
                o, l = k4_block_ref(qs[:, r0:r1], ks[:, :keys],
                                    vs[:, :keys], causal, r0)
                ref[i:i + 1, r0:r1, heads] = o
                lse[i:i + 1, heads, r0:r1] = l
    out = ref.to(q.dtype)
    return (out, lse) if with_lse else out


def k4_call_excess(q, k, v, causal, out) -> float:
    """One K4 call against the plain version in float32 on its inputs, as
    a share of the phase-8 tolerance (``k4_excess``), computed by
    ``k4_plain``: in one call where its scores have at most
    ``K4_REF_WHOLE`` elements, else a KV head of a batch row at a time, by
    blocks of query rows past that (T = 32768)."""
    return k4_excess(out, k4_plain(q.float(), k.float(), v.float(), causal))


class K4Checked:
    """K4 on the full-attention route, each call checked as it returns
    against the plain version in float32 on its own inputs, within the
    phase-8 tolerance (``k4_call_excess``), and dropped, so that no call's
    tensors outlive it: the kernel held at the inputs the path gave it,
    layer by layer, whatever the depth. ``calls`` counts them, ``worst``
    is the largest share of the tolerance and ``check_s`` the seconds the
    checks took, which a timed run takes out (each check starts on a
    synchronized card)."""

    def __enter__(self):
        import types
        import torch
        from repro_torch.kernels.attn import attn as PA
        from repro_torch.models import attention as MA
        self._ma, self._route = MA, MA.attn_kernel
        self.calls, self.worst, self.check_s = 0, 0.0, 0.0

        def checked(q, k, v, *, causal=True):
            out = PA.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():     # no graph of the check under autograd
                self.worst = max(self.worst,
                                 k4_call_excess(q, k, v, causal, out))
            self.check_s += time.perf_counter() - t0
            self.calls += 1
            return out
        MA.attn_kernel = types.SimpleNamespace(flash_attention_fwd=checked)
        return self

    def __exit__(self, *exc):
        self._ma.attn_kernel = self._route

    def held(self, what: str) -> float:
        """Logs the checked calls of ``what`` and fails if one was beyond
        the tolerance. Returns the largest share of it."""
        if self.calls:
            log(f"[prefill] {what}: each of its {self.calls} K4 calls within "
                f"{self.worst:.3f} of the tolerance of the plain version in "
                "float32 on the call's own inputs")
        if self.worst > 1.0:
            raise AssertionError(f"{what}: a K4 call differs from its plain "
                                 f"version by {self.worst:.3g}x the "
                                 "tolerance")
        return self.worst


def k4b_terms(q, k, v, out, dout, causal):
    """The magnitude of the terms K4′ sums into each element, in float64:
    (dq, dk, dv) of the plain version (``flash_attention_bwd_ref``) with
    every product of its sums taken in absolute value, |dS| =
    P∘(|dO| |V|ᵀ + rowsum(|dO|∘|O|)); float32 rounds an element by about
    2^-24 of its terms a step, however far they cancel."""
    import torch
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.double().reshape(b, tq, hkv, g, dh)
    kf, vf = k.double(), v.double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * dh ** -0.5, kf)
    if causal:
        valid = torch.arange(tk, device=q.device)[None, :] \
            <= torch.arange(tq, device=q.device)[:, None]
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    do = dout.double().abs().reshape(b, tq, hkv, g, dh)
    d = (do * out.double().abs().reshape(b, tq, hkv, g, dh)).sum(-1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf.abs())
              + d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf.abs()) * dh ** -0.5
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf.abs()) * dh ** -0.5
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return dq.reshape(q.shape), dk, dv


def k4b_rss(q, k, v, out, dout, causal):
    """The root-sum-square of the terms K4′ sums into each element, in
    float64, with the exact P and signed dS of the plain version:
    c sqrt(Σ_k dS² K²) for dq, c sqrt(Σ_q dS² Q²) for dk (over the
    group's query heads too) and sqrt(Σ_q P² dO²) for dv."""
    import torch
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = dh ** -0.5
    qf = q.double().reshape(b, tq, hkv, g, dh)
    kf, vf = k.double(), v.double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * c, kf)
    if causal:
        valid = torch.arange(tk, device=q.device)[None, :] \
            <= torch.arange(tq, device=q.device)[:, None]
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    do = dout.double().reshape(b, tq, hkv, g, dh)
    d = (do * out.double().reshape(b, tq, hkv, g, dh)).sum(-1)
    ds2 = (p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
                - d.permute(0, 2, 3, 1)[..., None])).pow(2)
    dq = c * torch.einsum("bhgqk,bkhd->bqhgd", ds2, kf.pow(2)).sqrt()
    dk = c * torch.einsum("bhgqk,bqhgd->bkhd", ds2, qf.pow(2)).sqrt()
    del ds2
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.pow(2), do.pow(2)).sqrt()
    return dq.reshape(q.shape), dk, dv


def k4b_refs(q, k, v, out, dout, causal, tc):
    """One K4′ call's references on its own inputs, each (dq, dk, dv) whole:
    the plain version in float32 and in float64, ``k4b_terms`` and, on the
    tensor-core route (``tc``), ``k4b_rss`` (else Nones). In one piece where
    the call's scores have at most ``K4_REF_WHOLE`` elements; else a batch
    row, a KV head and a block of its query heads at a time, a block's
    scores at most ``K4_REF_WHOLE`` (a float64 score tensor of granite-34b's
    whole call is 3.2 GB), dk and dv summed over the blocks and the
    root-sum-square the root of the summed squares."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    b, tq, hq, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv

    def refs(*ins):
        return (PA.flash_attention_bwd_ref(*(t.float() for t in ins),
                                           causal=causal),
                PA.flash_attention_bwd_ref(*(t.double() for t in ins),
                                           causal=causal),
                k4b_terms(*ins, causal),
                k4b_rss(*ins, causal) if tc else (None,) * 3)
    if b * hq * tq * tk <= K4_REF_WHOLE:
        return refs(q, k, v, out, dout)
    per = max(1, min(g, K4_REF_WHOLE // (tq * tk)))
    whole = [[torch.zeros(t.shape, dtype=dt, device=q.device)
              for t in (q, k, v)]
             for dt in (torch.float32, torch.float64, torch.float64)
             + ((torch.float64,) if tc else ())]
    for i in range(b):
        for h in range(hkv):
            kv = (slice(i, i + 1), slice(None), slice(h, h + 1))
            for j in range(0, g, per):
                rows = (slice(i, i + 1), slice(None),
                        slice(h * g + j, h * g + min(g, j + per)))
                got = refs(q[rows], k[kv], v[kv], out[rows], dout[rows])
                for n, acc in enumerate(whole):
                    dq, dk, dv = got[n]
                    if n == 3:
                        dq, dk, dv = dq.pow(2), dk.pow(2), dv.pow(2)
                    acc[0][rows] = dq
                    acc[1][kv] += dk
                    acc[2][kv] += dv
                del got
    if tc:
        whole[3] = [x.sqrt() for x in whole[3]]
    else:
        whole.append((None,) * 3)
    return tuple(tuple(x) for x in whole)


def k4b_terms_excess(out, ref64, terms, tol, rss=None) -> float:
    """K4′'s error against ``ref64`` (its plain version in float64) as a
    share of ``tol`` (a, b, c) plus ``K4B_TERMS`` of the element's
    ``terms`` (``k4b_terms``) and, on the tensor-core route,
    ``K4B_TC_RSS`` of their root-sum-square ``rss`` (``k4b_rss``): the
    largest |out - ref64| / (a |ref64| + b rms(ref64's row) + c
    rms(ref64) + K4B_TERMS terms [+ K4B_TC_RSS rss]); at most 1
    passes."""
    a, b, c = tol
    rms = ref64.pow(2).mean(-1, keepdim=True).sqrt()
    bound = a * ref64.abs() + b * rms + c * ref64.pow(2).mean().sqrt() \
        + K4B_TERMS * terms
    if rss is not None:
        bound = bound + K4B_TC_RSS * rss
    return ((out.double() - ref64).abs() / bound).max().item()


class K4BChecked:
    """K4′ as autograd calls it (``FlashAttention``'s backward), each call
    checked as it returns against ``flash_attention_bwd_ref`` on its own
    inputs and dropped: in float64, within phase 15's tolerance for the
    route it took (``K4B_TC_TOL``, ``K4B_BF16_TOL`` or ``K4B_F32_TOL``)
    plus ``K4B_TERMS`` of the magnitude of each element's terms and, on
    the tensor-core route, ``K4B_TC_RSS`` of their root-sum-square
    (``k4b_terms_excess``). ``phase15`` is the largest share of phase
    15's tolerance against the float32 plain version, as phase 15 holds
    unit normals (reported, not held), and ``over`` the calls beyond it.
    The references (``k4b_refs``) materialize a call's scores in one piece
    for the examples' small training shapes, and a block of query heads
    at a time at T = 2048. ``calls``, ``worst`` and ``check_s`` as in
    :class:`K4Checked`; ``launches`` the kernel passes the checked calls
    made (``BWD_PASSES`` a call on its route)."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.attn import attn as PA
        self._pa, self._bwd = PA, PA.flash_attention_bwd
        self.calls, self.launches, self.worst, self.check_s = 0, 0, 0.0, 0.0
        self.phase15, self.over, self.no_rss = 0.0, 0, 0.0

        def checked(q, k, v, out, dout, *, causal=True, lse=None):
            got = self._bwd(q, k, v, out, dout, causal=causal, lse=lse)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            route = PA.route(q.dtype, q.shape[-1])
            tol = K4B_TC_TOL if route == "tensor_cores" else K4B_F32_TOL \
                if q.dtype == torch.float32 else K4B_BF16_TOL
            plain, ref64, terms, rss = k4b_refs(
                q, k, v, out, dout, causal, route == "tensor_cores")
            old = max(k4b_excess(g, p, tol) for g, p in zip(got, plain))
            self.phase15 = max(self.phase15, old)
            self.over += old > 1.0
            del plain
            self.worst = max([self.worst] + [
                k4b_terms_excess(g, r, m, tol, e)
                for g, r, m, e in zip(got, ref64, terms, rss)])
            if route == "tensor_cores":
                # reported, not held: the share without the route's term
                self.no_rss = max([self.no_rss] + [
                    k4b_terms_excess(g, r, m, tol)
                    for g, r, m in zip(got, ref64, terms)])
            del ref64, terms, rss
            self.check_s += time.perf_counter() - t0
            self.calls += 1
            self.launches += PA.BWD_PASSES[route]
            return got
        PA.flash_attention_bwd = checked
        return self

    def __exit__(self, *exc):
        self._pa.flash_attention_bwd = self._bwd

    def held(self, what: str) -> float:
        """Logs the checked calls of ``what`` and fails if one was beyond
        the tolerance. Returns the largest share of it."""
        if self.calls:
            tc = (f"; without the tensor-core route's {K4B_TC_RSS:.3g} of "
                  f"their root-sum-square, {self.no_rss:.3f}"
                  if self.no_rss else "")
            log(f"[train] {what}: each of its {self.calls} K4′ calls within "
                f"{self.worst:.3f} of the tolerance (phase 15's plus "
                f"{K4B_TERMS:.3g} of each element's terms) of the plain "
                f"version in float64 on the call's own inputs{tc}; against "
                f"the float32 plain version, {self.over} beyond phase 15's "
                f"tolerance alone, the worst at {self.phase15:.3f} of it")
        if self.worst > 1.0:
            raise AssertionError(f"{what}: a K4′ call differs from its "
                                 f"plain version by {self.worst:.3g}x the "
                                 "tolerance")
        return self.worst


def yardsticks(run, kernel_route, routes, blocks, logits, pl):
    """The twin with K4 held on its CUDA-core kernel (bf16 in, f32
    arithmetic, the first design) and with SDPA, on the K4 run's block
    inputs and experts, each against the plain twin (logits ``pl``) and
    K4 (reports, not checks)."""
    import types
    import torch.nn.functional as F
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import attention as MA

    def sdpa(q, k, v, *, causal=True):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2).contiguous()

    def core(q, k, v, *, causal=True):
        return PA.launch("cuda_cores", q, k, v, causal=causal)
    for name, fn in (("CUDA-core K4", core), ("SDPA", sdpa)):
        MA.attn_kernel = types.SimpleNamespace(flash_attention_fwd=fn)
        try:
            with RouteLog(force=routes), BlockLog(force=blocks) as ys:
                ylogits = run()[0].float()
        finally:
            MA.attn_kernel = kernel_route
        log(f"[prefill] {name} twin: logits max abs diff "
            f"{(ylogits - pl).abs().max().item():.4g} to the plain twin, "
            f"{(ylogits - logits.float()).abs().max().item():.4g} to K4; "
            f"block outputs {ys.apart(blocks):.4g} of K4's row rms; "
            f"top-1 {ylogits.argmax(-1).tolist()} (K4 "
            f"{logits.argmax(-1).tolist()}, plain {pl.argmax(-1).tolist()})")


# --------------------------------------------------------------- phase 13

def attention_layers(cfg) -> tuple[int, int]:
    """K4 launches of one pass of ``cfg``: (decoder, encoder-decoder
    total). One a full-attention ("attn") layer; an encoder-decoder adds
    its encoder layers and a cross-attention a decoder layer."""
    kinds = cfg.block_pattern * cfg.n_repeats + cfg.remainder_kinds
    dec = sum(k == "attn" for k in kinds)
    if cfg.is_encdec:
        return dec, dec + cfg.encoder_layers + cfg.n_layers
    return dec, dec


def train_launches(cfg) -> tuple[int, int]:
    """(K4 launches, K4′ calls) of one training step of ``cfg``, from its
    layers: a K4 call a full-attention layer (the decoder's "attn" layers;
    an encoder-decoder's encoder layers and a cross-attention a decoder
    layer), and a K4′ call each. Under remat (``models/model.py::
    _maybe_remat``) every checkpointed body — an encoder layer, a repeat
    of the decoder's pattern — runs its K4 calls again in the backward;
    the remainder layers are not checkpointed. Sliding-window ("local")
    layers take the banded plain path: no K4, no K4′."""
    reps = cfg.block_pattern * cfg.n_repeats
    rem = cfg.remainder_kinds
    body = sum(k == "attn" for k in reps)
    tail = sum(k == "attn" for k in rem)
    if cfg.is_encdec:
        body += cfg.encoder_layers + len(reps)
        tail += len(rem)
    return (2 if cfg.remat else 1) * body + tail, body + tail


def fitting_depth(cfg, free: int, bytes_per_param: int = 2,
                  reserve: int = SLICE8_RESERVE):
    """``cfg`` at the most layers (whole repeats of its block pattern, up to
    its own depth) whose ``bytes_per_param`` a parameter (2: bf16 weights;
    12: a bf16 model's training state) fit ``free`` bytes beside
    ``reserve``; a layer's bytes are ``param_count``'s step."""
    import dataclasses
    step = len(cfg.block_pattern)

    def nbytes(layers):
        return dataclasses.replace(cfg, n_layers=layers).param_count() \
            * bytes_per_param
    per_repeat = nbytes(2 * step) - nbytes(step)
    base = nbytes(step) - per_repeat
    repeats = (free - reserve - base) // per_repeat
    layers = min(cfg.n_layers, max(1, int(repeats)) * step)
    return dataclasses.replace(cfg, n_layers=layers)


def phase_slice8(dev, archs=SLICE8, decode=None):
    """Slice 8's main path: each config at full width in bf16 (random
    weights from a seeded generator on the card, one model at a time),
    depth cut where stated. The four token-only configs serve the
    launcher's engine (``phase_lm_serving``); every config runs its
    prefill against its plain-attention twin (``phase_lm_prefill``), then
    ``decode(cfg, params)`` where given (slice 9's path on the same
    weights). Every config runs even after one fails; the phase then
    raises with every failure. Returns each config's numbers, with the peak
    memory over the config's whole run (init, engine, prefill and
    twins)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    out, failed = {}, []
    for name, cut in archs:
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        cfg = get_config(name)
        full = cfg.n_layers
        if cut:
            cfg = fitting_depth(cfg, free)
        fits, fit_gb = cfg.n_layers, cfg.param_count() * 2 / 1e9
        if SLICE8_LAYERS.get(name, fits) < fits:
            cfg = dataclasses.replace(cfg, n_layers=SLICE8_LAYERS[name])
        weights = cfg.param_count() * 2
        why = []
        if cut:
            why.append(f"the full model's bf16 weights, "
                       f"{get_config(name).param_count() * 2 / 1e9:.1f} GB, "
                       f"do not fit the card; {fits} layers, {fit_gb:.1f} "
                       f"GB, are the most that fit its {free / 2**30:.2f} "
                       f"GiB free beside a {SLICE8_RESERVE / 2**30:.0f} GiB "
                       "reserve")
        if cfg.n_layers < fits:
            why.append(f"cut to {cfg.n_layers} ({weights / 1e9:.1f} GB) for "
                       "the script's time")
        log(f"[slice8] {name}: {cfg.n_layers} of {full} layers"
            + (f" (depth cut: {'; '.join(why)}; widths unchanged)" if why
               else ", full depth"))
        k4_dec, k4_all = attention_layers(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = lm_model(dev, cfg)
        row = dict(layers=cfg.n_layers, full_layers=full,
                   fitting_layers=fits, params_b=cfg.param_count() / 1e9,
                   free_gib=free / 2**30)
        try:
            if not cfg.is_encdec:
                launches, _ = phase_lm_serving(dev, cfg, params,
                                               k4_layers=k4_dec)
                row.update(engine_k4_launches=launches["flash_attn_tc"],
                           engine_lm_batches=launches["lm_batches"],
                           engine_resize_launches=launches["resize"])
            t = WHISPER_TOKENS if cfg.is_encdec else PREFILL_T
            before = torch.cuda.max_memory_allocated()
            row["prefill"] = phase_lm_prefill(dev, cfg, params, t=t,
                                              k4=k4_all)
            row["peak_gib"] = max(before,
                                  torch.cuda.max_memory_allocated()) / 2**30
            log(f"[slice8] {name}: peak memory over the config's run "
                f"{row['peak_gib']:.2f} GiB (weights "
                f"{weights / 2**30:.2f} GiB; {free / 2**30:.2f} GiB free "
                "before it)")
            if decode is not None:
                decode(cfg, params)
        except AssertionError as e:
            log(f"[slice8] {name} FAILED: {e}")
            failed.append(f"{name}: {e}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = row
    if failed:
        raise AssertionError("slice 8: " + "; ".join(failed))
    return out


# --------------------------------------------------------------- phase 14

def decode_layers(cfg, params):
    """The decoder's blocks in call order: (parameters, kind) for each
    repeat of the pattern, then the remainder layers."""
    from repro_torch.tree import tree_map
    out = []
    for r in range(cfg.n_repeats):
        for i, kind in enumerate(cfg.block_pattern):
            out.append((tree_map(lambda t, r=r: t[r],
                                 params["scan"][f"pos{i}"]), kind))
    out += list(zip(params.get("rem", ()), cfg.remainder_kinds))
    return out


def decode_bytes(cfg, params, cache, b) -> tuple[int, int]:
    """(weight bytes, cache bytes) one decode step must read: every
    decoder weight (every expert of a dense MoE) and the head, ``b`` rows
    of an untied embedding, and every cache leaf; the encoder's weights
    are not read."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))
    weights = sum(nbytes(v) for k, v in params.items()
                  if k not in ("embed", "enc", "enc_in_proj"))
    emb = params["embed"]
    weights += nbytes(emb) if cfg.tie_embeddings \
        else b * emb.shape[1] * emb.element_size()
    return weights, nbytes(cache)


def decode_run(params, cache, toks, t, n, cfg):
    """``n`` teacher-forced ``decode_step``s from ``cache`` (the prefill's
    of ``t`` tokens): step j takes ``toks[:, t + j]`` at position t + j.
    Returns the logits of each step and the last cache."""
    from repro_torch.models import decode_step
    out = []
    for j in range(n):
        lg, cache = decode_step(params, cache, toks[:, t + j], t + j, cfg)
        out.append(lg)
    return out, cache


def block_fed(cfg, params, blocks, routes, t, n):
    """Each block's prefill and decode on ``forward_train``'s input to it
    (``BlockLog`` ``blocks``): the block's cache from ``block_prefill`` on
    its first t input rows, then ``block_decode`` on rows t..t+n-1, each
    output against ``forward_train``'s block output at that row, in units
    of the row's rms. In an MoE model every step takes the forward's
    experts (``RouteLog`` ``routes``); where its own router logits would
    choose others, ``routing_flips`` must find a near-tie. Returns (largest
    excess, flips, largest near-tie ratio)."""
    import types
    from repro_torch.models import blocks as MB
    calls = blocks.calls[cfg.encoder_layers:]       # the decoder's
    layers = decode_layers(cfg, params)
    if len(calls) != len(layers):
        raise AssertionError(f"forward_train ran {len(calls)} decoder "
                             f"blocks, the model has {len(layers)}")
    worst, flips, ratio, moe = 0.0, 0, 0.0, 0
    for (p, kind), (x, enc, y) in zip(layers, calls):
        force = None
        if cfg.is_moe and "ffn" in p:
            lg, idx = routes.logits[moe], routes.idx[moe]
            moe += 1
            cut = [slice(0, t)] + [slice(t + j, t + j + 1) for j in range(n)]
            force = types.SimpleNamespace(idx=[idx[:, s] for s in cut],
                                          logits=[lg[:, s] for s in cut])
        with RouteLog(force=force) as own:
            _, c = MB.block_prefill(p, x[:, :t], cfg, kind, t + n, enc=enc)
            for j in range(n):
                out, c = MB.block_decode(p, x[:, t + j:t + j + 1], c, t + j,
                                         cfg, kind)
                ref = y[:, t + j:t + j + 1].float()
                rms = ref.pow(2).mean(-1, keepdim=True).sqrt().clamp(
                    min=1e-30)
                worst = max(worst, ((out.float() - ref).abs() / rms).max()
                            .item())
        if force is not None:
            f, r = routing_flips(force, own, cfg.top_k)
            flips += sum(f)
            ratio = max(ratio, r)
    return worst, flips, ratio


def phase_decode(dev, cfg, params, t=PREFILL_T, n=DECODE_STEPS):
    """Slice 9's main path on one bf16 model: ``prefill`` of B = 2 seeded
    prompts of ``t`` tokens (``cache_len`` t + n) through K4, each K4 call
    held to phase 8's tolerance on its own inputs (``K4Checked``, its
    checks' time taken out of the prefill's), then ``n`` teacher-forced
    ``decode_step``s, counts zeroed just before and read just after (K4
    launches once a full-attention layer in the prefill, never in a step);
    the steps again from the same cache, bit for bit (timed: ms a step,
    tokens/s); one step's bound; a trace of ``DECODE_TRACE_STEPS`` steps
    (launches a step, busy share). Then ``forward_train`` over the t + n
    tokens, its K4 calls checked as the prefill's: each block fed its input
    there (``block_fed``) within ``PREFILL_BLOCK_TOL`` of its row's rms,
    and the free-running decode's logits against its logits at the same
    positions (reported, not bounded). Returns the run's numbers."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import forward_train, prefill
    b = PREFILL_B
    start = time.perf_counter()
    if cfg.is_encdec:
        t = WHISPER_TOKENS - n
    batch = prefill_batch(dev, cfg, b, t + n)
    toks = batch["tokens"]
    k4 = attention_layers(cfg)[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.FLASH_KERNEL.launches = 0
    with K4Checked() as pre:
        t0 = time.perf_counter()
        logits0, cache = prefill(params, dict(batch, tokens=toks[:, :t]),
                                 cfg, cache_len=t + n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    prefill_ms = 1e3 * (t1 - t0 - pre.check_s)
    k4_prefill = PA.FLASH_KERNEL.launches
    run, _ = decode_run(params, cache, toks, t, n, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = PA.FLASH_KERNEL.launches
    if k4_prefill != k4 or launches != k4 \
            or PA.FLASH_TC_KERNEL.launches != k4:
        raise AssertionError(
            f"{cfg.name}: K4 launched {k4_prefill} times in the prefill and "
            f"{launches - k4_prefill} in the steps; {k4} (one a "
            "full-attention layer, on the tensor-core kernel) and 0 "
            "expected")
    for lg in [logits0] + run:
        if lg.shape != (b, cfg.vocab_size) or lg.device.type != dev.type \
                or not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{cfg.name}: decode logits are not finite "
                                 f"of shape {(b, cfg.vocab_size)} on the "
                                 "card")
    t3 = time.perf_counter()
    again, last = decode_run(params, cache, toks, t, n, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t3) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.equal(a, c) for a, c in zip(run, again, strict=True)):
        raise AssertionError(f"{cfg.name}: a repeat of the decode gave "
                             "other logits")
    w_bytes, c_bytes = decode_bytes(cfg, params, last, b)
    bound_ms = (w_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    del again, last
    steps = DECODE_TRACE_STEPS
    wall_us, kern, count = profile_call(
        lambda: decode_run(params, cache, toks, t, steps, cfg),
        f"{cfg.name} {steps} decode steps B={b} after {t}", warm=False)
    busy = sum(kern.values())
    # the functional cache's copies (each attention cache rewritten with its
    # new slot, then re-stacked over the repeats) run as cat/stack kernels,
    # as do the rotary's and the conv carry's small ones: an upper bound
    copy_us = sum(us for name, us in kern.items()
                  if "CatArrayBatchedCopy" in name)

    with RouteLog() as routes, BlockLog() as blocks, K4Checked() as fwd:
        full = forward_train(params, batch, cfg)
    pre.held(f"{cfg.name} decode prefill")
    fwd.held(f"{cfg.name} forward_train over {t + n} tokens")
    if pre.calls != k4 or fwd.calls != k4:
        raise AssertionError(f"{cfg.name}: {pre.calls} K4 calls checked in "
                             f"the prefill, {fwd.calls} in forward_train; "
                             f"{k4} each expected")
    if full.shape != (b, t + n, cfg.vocab_size) \
            or not torch.isfinite(full.float()).all():
        raise AssertionError(f"{cfg.name}: forward_train logits are not "
                             "finite of the expected shape")
    ref = full[:, t - 1:t + n].float()
    got = torch.stack([logits0] + run, dim=1).float()
    free = (got - ref).abs().max().item()
    top1 = (got.argmax(-1) == ref.argmax(-1)).sum().item()
    del full, ref, got
    excess, flips, ratio = block_fed(cfg, params, blocks, routes, t, n)
    del blocks, routes
    log(f"[decode] {cfg.name} ({cfg.n_layers} layers, bf16) B={b}, prompt "
        f"{t}, {n} steps: prefill {prefill_ms:.1f} ms (less its K4 checks' "
        f"{pre.check_s:.2f} s; {k4_prefill} K4 launches, none in the steps); {step_ms:.2f} ms a step, "
        f"{b * 1e3 / step_ms:.1f} tokens/s; {count / steps:.0f} launches a "
        f"step, device busy {100 * busy / wall_us:.1f} % over {steps} "
        f"steps, the cache copies (cat/stack kernels) "
        f"{copy_us / steps / 1e3:.3f} ms a step "
        f"({100 * copy_us / max(busy, 1e-9):.1f} % of the busy time); "
        f"bound {bound_ms:.3f} ms a step ({w_bytes / 1e9:.2f} GB of "
        f"weights, {c_bytes / 1e9:.3f} GB of cache at 3.35 TB/s); peak "
        f"memory {peak / 2**30:.2f} GiB; a repeat bit for bit; on "
        f"{nvidia_smi()}")
    log(f"[decode] {cfg.name}: each block fed forward_train's input within "
        f"{excess:.4g} of its output row's rms (bound {PREFILL_BLOCK_TOL})"
        + (f"; the forward's experts taken, own logits would differ at "
           f"{flips} (layer, token) pairs, largest near-tie ratio "
           f"{ratio:.3g}" if cfg.is_moe else "")
        + f"; free-running logits vs forward_train's at the {n + 1} "
        f"positions: max abs diff {free:.4g}, top-1 equal in {top1} of "
        f"{b * (n + 1)} (reported, not bounded)")
    if excess > PREFILL_BLOCK_TOL:
        raise AssertionError(f"{cfg.name}: a block's decode differs from "
                             f"forward_train beyond {PREFILL_BLOCK_TOL} of "
                             "its row's rms")
    if ratio > 1.0:
        raise AssertionError(f"{cfg.name}: a block's decode routes "
                             "differently from forward_train beyond a "
                             "near-tie")
    return dict(layers=cfg.n_layers, prompt=t, steps=n, batch=b,
                phase_s=time.perf_counter() - start,
                k4_launches=k4_prefill, prefill_ms=prefill_ms,
                k4_calls_share_of_tolerance=dict(prefill=pre.worst,
                                                 forward_train=fwd.worst),
                first_steps_ms=1e3 * (t2 - t1), step_ms=step_ms,
                tokens_per_s=b * 1e3 / step_ms, bound_ms=bound_ms,
                weight_gb=w_bytes / 1e9, cache_gb=c_bytes / 1e9,
                launches_per_step=count / steps,
                copy_ms=copy_us / steps / 1e3, busy_ms=busy / steps / 1e3,
                busy_share=busy / wall_us, peak_gib=peak / 2**30,
                block_max_excess=excess, routing_flips=flips,
                near_tie_ratio=ratio, free_running_max_diff=free,
                free_running_top1=[top1, b * (n + 1)])


def clamp_oracle(p, x, cache, pos, cfg, kind):
    """``attn_decode``'s semantics at ``pos`` written out in float64 for a
    step past a full cache: the new K/V (the port's projection) go to
    slot ``min(pos, L - 1)`` of a full cache, as the reference's clamped
    update, or to ``pos mod L`` of a ring, whose slot s then holds position
    s + L·floor((pos - s) / L), valid within the window; every valid slot
    scores. Returns (the new k, the new v, y)."""
    import torch
    from repro_torch.models import attention as MA
    b, dh = x.shape[0], cfg.d_head
    q, k, v = MA._project(p, x, cfg, torch.full((b, 1), pos,
                                                device=x.device))
    length = cache["k"].shape[1]
    s = torch.arange(length, device=x.device)
    if kind == "local":
        slot = pos % length
        held = s + length * torch.div(pos - s, length, rounding_mode="floor")
        valid = (held >= 0) & (held > pos - cfg.window)
    else:
        slot = min(pos, length - 1)
        valid = torch.ones(length, dtype=torch.bool, device=x.device)
    k_c, v_c = cache["k"].clone(), cache["v"].clone()
    k_c[:, slot], v_c[:, slot] = k[:, 0], v[:, 0]
    g = cfg.n_heads // cfg.n_kv_heads
    qh = (q * dh ** -0.5).reshape(b, cfg.n_kv_heads, g, dh).double()
    sc = torch.einsum("bhgd,bkhd->bhgk", qh, k_c.double())
    sc = sc.masked_fill(~valid, float("-inf"))
    o = torch.einsum("bhgk,bkhd->bhgd", sc.softmax(-1), v_c.double())
    y = o.reshape(b, 1, cfg.n_heads * dh) @ p["wo"].double()
    return k_c, v_c, y


def phase_decode_f32(dev, archs=SLICE9, n=DECODE_STEPS):
    """Decode's exactness in float32 on the card, each config at full width
    and a depth of two pattern repeats (gemma3-12b: six layers, five local
    and one global, its ring wrapped by the prompt), B = 2: the prefill of
    ``PREFILL_T`` tokens (whisper: 416 after 1500 frames) plus ``n``
    teacher-forced steps within ``DECODE_F32_TOL`` of ``forward_train``'s
    logits at the same positions; then a step at ``pos == cache_len``,
    whose every attention call must match ``clamp_oracle`` (new K/V bit
    for bit, output within ``DECODE_CLAMP_TOL`` of its row's rms) and
    leave every other slot as it was. Returns each config's numbers."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as MA
    from repro_torch.models import decode_step, forward_train, prefill
    out = {}
    for name in archs:
        base = get_config(name)
        depth = 6 if name == "gemma3-12b" else 2 * len(base.block_pattern)
        cfg = dataclasses.replace(base, n_layers=depth,
                                  param_dtype="float32")
        t = WHISPER_TOKENS - n if cfg.is_encdec else PREFILL_T
        params = lm_model(dev, cfg)
        batch = prefill_batch(dev, cfg, PREFILL_B, t + n)
        toks = batch["tokens"]
        full = forward_train(params, batch, cfg)[:, t - 1:].clone()
        logits0, cache = prefill(params, dict(batch, tokens=toks[:, :t]),
                                 cfg, cache_len=t + n)
        run, last = decode_run(params, cache, toks, t, n, cfg)
        got = torch.stack([logits0] + run, dim=1)
        err = (got - full).abs().max().item()
        scale = full.abs().max().item()
        calls = []
        attn_decode = MA.attn_decode

        def seen(p, x, c, pos, cfg_, kind, *rest):
            y, new = attn_decode(p, x, c, pos, cfg_, kind, *rest)
            calls.append((p, x, c, pos, kind, y, new))
            return y, new
        MA.attn_decode = seen
        try:
            lg, _ = decode_step(params, last, toks[:, 0], t + n, cfg)
        finally:
            MA.attn_decode = attn_decode
        clamp, slots_kept = 0.0, True
        for p, x, c, pos, kind, y, new in calls:
            k_c, v_c, y64 = clamp_oracle(p, x, c, pos, cfg, kind)
            if not (torch.equal(new["k"], k_c) and torch.equal(new["v"], v_c)):
                slots_kept = False
            rms = y64.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
            clamp = max(clamp, ((y.double() - y64).abs() / rms).max().item())
        kinds = sorted({c[4] for c in calls})
        log(f"[decode f32] {name} ({depth} layers, float32) B={PREFILL_B}, "
            f"prompt {t}: prefill + {n} steps vs forward_train's logits: max "
            f"abs diff {err:.4g} (|logits| max {scale:.3g}; bound "
            f"{DECODE_F32_TOL}); a step at pos == cache_len ({t + n}): "
            + (f"{len(calls)} attention calls ({', '.join(kinds)}) "
               f"against the float64 clamp oracle: new K/V "
               f"{'bit for bit' if slots_kept else 'DIFFER'}, output "
               f"within {clamp:.3g} of its row's rms (bound "
               f"{DECODE_CLAMP_TOL})" if calls else "no attention layer, "
               "the states step")
            + f"; logits finite {bool(torch.isfinite(lg).all())}")
        failed = []
        if not err <= DECODE_F32_TOL:
            failed.append(f"decode differs from forward_train by {err:.4g}")
        if not slots_kept or not clamp <= DECODE_CLAMP_TOL \
                or not torch.isfinite(lg).all():
            failed.append("the step at pos == cache_len breaks the clamp")
        if failed:
            raise AssertionError(f"{name} in float32: " + "; ".join(failed))
        out[name] = dict(layers=depth, prompt=t, max_abs_diff=err,
                         logits_max=scale, clamp_calls=len(calls),
                         clamp_excess=clamp)
        del params, cache, last, run, full, got, calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 11

# -------------------------------------------------------------- slice 10

class PlainAttention:
    """Within it, ``kernels/attn/attn.py::flash_attention_fwd`` (the route
    every window-free attention takes) is K4's plain version, with its
    own autograd: the twin of the gradient check."""

    def __enter__(self):
        from repro_torch.kernels.attn import attn as PA
        self._pa, self._fwd = PA, PA.flash_attention_fwd
        PA.flash_attention_fwd = PA.flash_attention_fwd_ref
        return self

    def __exit__(self, *exc):
        self._pa.flash_attention_fwd = self._fwd


def _named_leaves(tree, prefix=""):
    """[(path, leaf)] in the reference's flattening order; a stacked leaf's
    per-repeat tuple is one entry per repeat."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def leaf_rms(w) -> float:
    """A gradient leaf's rms over its rows (last axis) that are not all
    zero: the embedding's gradient is zero on every row whose token the
    batch lacks, which would otherwise shrink its scale by the share of
    the vocabulary the batch uses."""
    rows = w.reshape(-1, w.shape[-1]) if w.dim() else w.reshape(1, 1)
    live = rows[rows.abs().amax(dim=-1) > 0]
    return live.pow(2).mean().sqrt().item() if live.numel() else 0.0


def train_batch(dev, cfg, b, t, step=0, seed=0):
    """``TokenStream`` batch ``step`` (seeded by ``seed``) on ``dev``; an
    encoder-decoder's also carries (b, WHISPER_FRAMES, d_model) frame
    embeddings from a generator seeded by the step (``models/model.py::
    _frames`` encodes them)."""
    import torch
    from repro_torch.data import DataConfig, TokenStream
    data = TokenStream(DataConfig(global_batch=b, seq_len=t,
                                  vocab_size=cfg.vocab_size, seed=seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(step).items()}
    if cfg.is_encdec:
        batch["enc_input"] = torch.randn(
            (b, WHISPER_FRAMES, cfg.d_model), device=dev,
            generator=torch.Generator(dev).manual_seed(8 + step))
    return batch


def phase_train_grads(dev, cfg=None, b=TRAIN_B, t=TRAIN_T):
    """The training step at full width, gradient check: ``cfg`` (by default
    chatglm3-6b at ``TRAIN_CHECK_LAYERS`` layers; gemma3-12b at
    ``GEMMA_CHECK_LAYERS``; slice 17's configs at ``SLICE17_CHECK`` and
    whisper-tiny whole), bf16, one ``TokenStream`` batch (an
    encoder-decoder's with ``WHISPER_FRAMES`` frames, ``train_batch``):
    ``loss_and_grads`` through K4 and K4′, launched as often as the config's
    layers say (``train_launches``: at least one full-attention layer; K4′'s
    passes on its route for the config: the tensor cores, 3, given K4's
    LSE), against a twin whose attention is K4's plain version with
    autograd (``PlainAttention``), each gradient leaf's rms difference
    within ``TRAIN_GRAD_TOL`` of its rms (``leaf_rms``); then one
    ``make_train_step`` step on each side from the same weights: loss,
    grad_norm and lr agree. In an MoE config the twin takes the K4 run's
    experts (``RouteLog(force=)``, gates from its own router logits), as
    the prefill's twin does: the two attentions' outputs differ by a bf16
    ulp here and there, which flips a token's top-k choice where two of
    its router logits nearly tie, and a flipped token's whole FFN
    gradient with it; the flips the twin's own logits would make are
    printed (``routing_flips``)."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import (global_norm, loss_and_grads,
                                                lr_schedule)
    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config(TRAIN_ARCH),
                                     n_layers=TRAIN_CHECK_LAYERS, remat=True)
    want, layers = train_launches(cfg)
    if layers == 0:
        raise AssertionError(f"{cfg.name} at {cfg.n_layers} layers has no "
                             "full-attention layer: K4 and K4′ would not "
                             "launch")
    route = PA.route(torch.bfloat16, cfg.d_head)
    params = lm_model(dev, cfg)
    batch = train_batch(dev, cfg, b, t)
    def routes(force=None):
        return RouteLog(force) if cfg.is_moe else contextlib.nullcontext()
    PA.FLASH_KERNEL.launches = 0
    PA.FLASH_BWD_KERNEL.launches = 0
    with routes() as run_routes:
        loss, _, grads = loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    fwd, bwd = PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches
    if fwd != want or bwd != PA.BWD_PASSES[route] * layers \
            or k4b_kernel(route).launches != bwd:
        raise AssertionError(f"train grads: K4 {fwd} and K4′ {bwd} launches "
                             f"({k4b_kernel(route).launches} on the {route} "
                             f"route); {want} and {layers} calls expected of "
                             f"{cfg.name}'s layers (remat {cfg.remat})")
    with PlainAttention(), routes(run_routes) as twin_routes:
        tloss, _, tgrads = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
    if PA.FLASH_KERNEL.launches != fwd or PA.FLASH_BWD_KERNEL.launches != bwd:
        raise AssertionError("the plain-attention twin launched K4 or K4′")
    flips = None
    if cfg.is_moe:
        flips = routing_flips(run_routes, twin_routes, cfg.top_k)
        log(f"[train] {cfg.name}: the twin on the K4 run's experts; its own "
            f"router logits would choose other top-{cfg.top_k} experts for "
            f"{flips[0]} tokens by call (forward and recompute a layer), "
            f"each a near-tie at most {flips[1]:.3g} of twice the runs' "
            "largest logit difference")
        del run_routes, twin_routes
    if not abs(float(loss) - float(tloss)) <= TRAIN_LOSS_RTOL * abs(
            float(tloss)):
        raise AssertionError(f"train grads: loss {float(loss)} against the "
                             f"twin's {float(tloss)}")
    worst_rms, worst_max, rows, bad = 0.0, 0.0, [], []
    counts = torch.bincount(batch["tokens"].reshape(-1).long(),
                            minlength=cfg.vocab_size)
    for (path, g), (_, w) in zip(_named_leaves(grads),
                                 _named_leaves(tgrads)):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"train grads: {path} is not finite")
        scale = leaf_rms(w)
        d = g - w
        r_rms = d.pow(2).mean().sqrt().item() / max(scale, 1e-30)
        r_max = d.abs().max().item() / max(scale, 1e-30)
        rows.append((path, r_rms, r_max))
        if not r_rms <= TRAIN_GRAD_TOL:
            at = int(d.abs().argmax())
            row = at // w.shape[-1]
            w2 = w.reshape(-1, w.shape[-1])
            bad.append(f"{path} by rms {r_rms:.3g} of its rms {scale:.3g}, "
                       f"max {r_max:.3g} of it at row {row} (ref "
                       f"{w.reshape(-1)[at].item():.4g}, got "
                       f"{g.reshape(-1)[at].item():.4g}; the row's rms "
                       f"{w2[row].pow(2).mean().sqrt().item():.4g}"
                       + (f", its token {int(counts[row])} times in the "
                          "batch" if path == "/embed" else "") + ")")
        worst_rms, worst_max = max(worst_rms, r_rms), max(worst_max, r_max)
    for path, r_rms, r_max in sorted(rows, key=lambda r: -r[1])[:4]:
        log(f"[train]   {cfg.name} {path}: rms {r_rms:.4f}, max "
            f"{r_max:.4f} of its rms")
    if bad:
        raise AssertionError("train grads: differ from the twin's: "
                             + "; ".join(bad))
    norms = (float(global_norm(grads)), float(global_norm(tgrads)))
    del grads, tgrads
    log(f"[train] gradient check, {cfg.name} at {cfg.n_layers} layers, B = "
        f"{b}, T = {t}, bf16: loss {float(loss):.6f} (twin "
        f"{float(tloss):.6f}); {len(rows)} gradient leaves within the "
        f"twin's, worst rms {worst_rms:.4f} of a leaf's rms (bound "
        f"{TRAIN_GRAD_TOL}); the largest element's difference {worst_max:.4f}"
        f" of its leaf's rms (printed, not bounded); K4 {fwd}, K4′ {bwd} "
        f"launches (all on its {route} route)")
    opt = OptConfig(warmup_steps=1)
    # the step's clone of the weights, its moments and gradient beside the
    # weights: where they do not fit (qwen3-moe-235b-a22b at 2 layers: 6.2
    # B parameters, 12 bytes each; at 1 layer the twin's step, its plain
    # attention's float32 scores under autograd beside the 3.7 B
    # parameters' state, ran out of an H100 80GB HBM3's memory at 700 W),
    # the step's metrics are
    # those of the two gradients above: their loss, the global norm the
    # step reports as grad_norm, and the schedule's lr of the first step
    n_params = sum(x.numel() for x in _leaves(params))
    gc.collect()
    torch.cuda.empty_cache()
    stepped = n_params * TRAIN_BYTES_PER_PARAM + GEMMA_TRAIN_RESERVE \
        <= torch.cuda.mem_get_info()[0]
    metrics = []
    for twin in (False, True):
        if not stepped:
            lr = float(lr_schedule(opt, torch.ones((), dtype=torch.int32)))
            metrics.append(dict(loss=float(tloss if twin else loss),
                                grad_norm=norms[twin], lr=lr))
            continue
        p = params if twin else _clone(params)
        state = opt_init(p)
        step = make_train_step(cfg, opt)
        if twin:
            with PlainAttention(), routes(step_routes):
                _, _, m = step(p, state, batch)
        else:
            with routes() as step_routes:
                _, _, m = step(p, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        del p, state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    if not stepped:
        log(f"[train] {cfg.name}: the step's training state at "
            f"{cfg.n_layers} layers ({n_params * TRAIN_BYTES_PER_PARAM / 1e9:.1f}"
            f" GB) does not fit beside {GEMMA_TRAIN_RESERVE / 2 ** 30:.0f} "
            "GiB: the step's metrics from the two gradients")
    got, want = metrics
    if got["lr"] != want["lr"] \
            or abs(got["loss"] - want["loss"]) > TRAIN_LOSS_RTOL * abs(
                want["loss"]) \
            or abs(got["grad_norm"] - want["grad_norm"]) > TRAIN_NORM_RTOL \
            * abs(want["grad_norm"]):
        raise AssertionError(f"train step: {got} against the twin's {want}")
    log(f"[train] {cfg.name}, "
        + ("one make_train_step step each" if stepped else
           "the step's metrics from each gradient") + ": loss "
        f"{got['loss']:.6f} / {want['loss']:.6f}, grad_norm "
        f"{got['grad_norm']:.6f} / {want['grad_norm']:.6f}, lr "
        f"{got['lr']:.3g} / {want['lr']:.3g} "
        f"(K4 / twin); phase {time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, stepped=stepped,
                routing_flips=flips,
                loss=float(loss),
                twin_loss=float(tloss), worst_rms_share=worst_rms,
                worst_max_share=worst_max, step=got, twin_step=want,
                k4_launches=fwd, k4_bwd_launches=bwd, k4b_route=route,
                phase_s=time.perf_counter() - t0)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def train_step_groups(kern: dict) -> dict:
    """A traced step's device µs by kind of kernel: K4′, K4, matrix
    products (cuBLAS), elementwise and reductions (the update, the norms,
    the loss), the rest."""
    def kind(name):
        if "bwd_" in name and "_kernel" in name:
            return "K4′"
        if "flash_" in name:
            return "K4"
        if any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass",
                                   "gemv", "splitK")):
            return "matmul"
        if any(x in name for x in ("elementwise", "reduce", "softmax",
                                   "Reduce")):
            return "elementwise"
        return "other"
    out = {}
    for name, us in kern.items():
        out[kind(name)] = out.get(kind(name), 0.0) + us
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_train(dev, cfg=None, b=TRAIN_B, t=TRAIN_T, steps=TRAIN_STEPS,
                arch=TRAIN_ARCH, reserve=TRAIN_RESERVE, held=False):
    """SLICE 10'S MAIN PATH: ``make_train_step`` on ``arch`` (chatglm3-6b;
    slice 15's gemma3-12b; slice 17's granite-34b, chameleon-34b,
    h2o-danube-3-4b and whisper-tiny) at full width and the fitting depth
    (``fitting_depth`` at 12 bytes a parameter beside ``reserve``), bf16,
    remat on, ``OptConfig(warmup_steps=1)``, ``TokenStream(global_batch=2,
    seq_len=t)`` (an encoder-decoder's batches with their frames,
    ``train_batch``), ``steps`` steps, the counts zeroed just before and
    read just after: loss and grad_norm finite at every step, K4 and K4′
    launched exactly as the config's layers say (``train_launches``: a K4
    call a full-attention layer a step, twice under remat, all on the
    tensor-core kernel, writing the LSE; a K4′ call each, its passes on its
    tensor-core route; none where every layer is sliding-window). Reports
    s a step, tokens/s, peak memory, one more step's two halves
    (``loss_and_grads``, ``opt_update``) timed apart, the busy share, K4′'s
    share and the device time by kind of a step (``torch.profiler`` over
    one more step) and the step's bound (8 × parameters × tokens at the
    bf16 peak). With ``held``, one more step under ``K4BChecked``: every
    K4′ call of it held against the plain version on its own inputs, the
    checked launches those counted."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.training import (OptConfig, make_train_step, opt_init,
                                      opt_update)
    from repro_torch.training.optimizer import loss_and_grads
    t_phase = time.perf_counter()
    gc.collect()              # autograd's checkpoint hooks leave cycles
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    log(f"[train] before the main path: {free / 2 ** 30:.2f} GiB free, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved by "
        "PyTorch")
    if cfg is None:
        cfg = fitting_depth(dataclasses.replace(get_config(arch),
                                                remat=True), free,
                            TRAIN_BYTES_PER_PARAM, reserve)
    want, layers = train_launches(cfg)
    route = PA.route(torch.bfloat16, cfg.d_head)
    params = lm_model(dev, cfg)
    state = opt_init(params)
    n_params = sum(x.numel() for x in _leaves(params))
    torch.cuda.synchronize()
    log(f"[train] {cfg.name} at {cfg.n_layers} layers (of "
        f"{get_config(cfg.name).n_layers}): {n_params / 1e9:.3f} B "
        f"parameters, training state {n_params * TRAIN_BYTES_PER_PARAM / 1e9:.2f}"
        f" GB (12 bytes a parameter) of {free / 2 ** 30:.2f} GiB free, "
        f"reserve {reserve / 2 ** 30:.0f} GiB; K4 {want} and K4′ {layers} "
        "calls a step expected of its layers")
    opt = OptConfig(warmup_steps=1)
    step = make_train_step(cfg, opt)
    batches = [train_batch(dev, cfg, b, t, s) for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.FLASH_KERNEL.launches = 0
    PA.FLASH_BWD_KERNEL.launches = 0
    history, secs = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        m = {k: float(v) for k, v in m.items()}
        secs.append(time.perf_counter() - t0)
        history.append(m)
    fwd, bwd = PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches
    tc = PA.FLASH_TC_KERNEL.launches
    bwd_routes = {r: k4b_kernel(r).launches for r in PA.BWD_PASSES}
    peak = torch.cuda.max_memory_allocated()
    for s, m in enumerate(history):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"train step {s}: {m}")
        log(f"[train] {cfg.name} step {s}: loss {m['loss']:.4f}, grad_norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.3g}, {secs[s]:.3f} s")
    if fwd != want * steps or tc != fwd:
        raise AssertionError(f"train: K4 launched {fwd} times ({tc} on the "
                             f"tensor cores), not {want} x {steps} "
                             f"({cfg.name}'s layers, remat {cfg.remat})")
    if bwd != PA.BWD_PASSES[route] * layers * steps \
            or bwd_routes[route] != bwd:
        raise AssertionError(f"train: K4′ launched {bwd_routes} times, not "
                             f"{PA.BWD_PASSES[route]} x {layers} x {steps} "
                             f"on its {route} route")
    # one more step in its two halves, timed apart
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(params, batches[1], cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt_update(opt, params, grads, state)
    torch.cuda.synchronize()
    split = (t1 - t0, time.perf_counter() - t1)
    del grads
    log(f"[train] {cfg.name}, a step's halves: loss_and_grads "
        f"{split[0]:.3f} s, opt_update {split[1]:.3f} s")
    wall_us, kern, count = profile_call(
        lambda: step(params, state, batches[0]), f"train step {cfg.name} "
        f"{cfg.n_layers} layers", warm=False)
    busy = sum(kern.values())
    k4b = sum(us for name, us in kern.items() if "bwd_" in name
              and "_kernel" in name)
    k4 = sum(us for name, us in kern.items() if "flash_tc_kernel" in name)
    groups = train_step_groups(kern)
    log(f"[train] {cfg.name}, the traced step's device time by kind: "
        + ", ".join(f"{g} {us / 1e3:.1f} ms" for g, us in groups.items()))
    checked = None
    if held:
        before = PA.FLASH_BWD_KERNEL.launches
        torch.cuda.reset_peak_memory_stats()
        with K4BChecked() as kc:
            step(params, state, batches[0])
        torch.cuda.synchronize()
        n_l = PA.FLASH_BWD_KERNEL.launches - before
        kc.held(f"{cfg.name} at {cfg.n_layers} layers, one train step")
        if kc.calls != layers or kc.launches != n_l:
            raise AssertionError(f"train: {kc.calls} K4′ calls checked "
                                 f"({kc.launches} launches) of {n_l} "
                                 f"launches, {layers} calls expected")
        checked = dict(calls=kc.calls, launches=kc.launches,
                       worst=kc.worst, phase15_share=kc.phase15,
                       over_phase15=kc.over, without_rss=kc.no_rss,
                       check_s=kc.check_s,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"[train] {cfg.name}, the held step's peak "
            f"{checked['peak_gib']:.2f} GiB, its checks {kc.check_s:.1f} s")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    tokens = b * t
    bound = 8 * n_params * tokens / BF16_FLOP_PER_S
    log(f"[train] {cfg.name}, {steps} steps: {steady:.3f} s a step (median "
        f"of steps 1-{steps - 1}; first {secs[0]:.3f} s), "
        f"{tokens / steady:.0f} tokens/s, peak {peak / 2 ** 30:.2f} GiB; "
        f"K4 {fwd} launches "
        f"({fwd // steps} a step), K4′ {bwd} ({bwd // steps} a step; by "
        f"route {bwd_routes}); the "
        f"traced step: busy {100 * busy / wall_us:.1f} %, K4′ "
        f"{k4b / 1e3:.1f} ms ({100 * k4b / wall_us:.1f} % of the step), K4 "
        f"{k4 / 1e3:.1f} ms, {count} launches; bound {bound:.3f} s (8 x "
        f"{n_params / 1e9:.3f} B x {tokens} tokens at the bf16 peak), "
        f"{100 * bound / steady:.1f} % of it; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers,
                attention_layers=layers, params_b=n_params / 1e9,
                state_gb=n_params * TRAIN_BYTES_PER_PARAM / 1e9,
                step_s=secs, step_s_median=steady,
                tokens_per_s=tokens / steady, peak_gib=peak / 2 ** 30,
                k4_launches=fwd, k4_bwd_launches=bwd,
                k4_bwd_launches_by_route=bwd_routes, k4b_route=route,
                traced_wall_ms=wall_us / 1e3, busy_share=busy / wall_us,
                k4_bwd_share=k4b / wall_us, k4_bwd_traced_ms=k4b / 1e3,
                k4_traced_ms=k4 / 1e3, bound_s=bound,
                traced_ms_by_kind={g: us / 1e3 for g, us in groups.items()},
                grads_s=split[0], update_s=split[1],
                loss=[m["loss"] for m in history],
                grad_norm=[m["grad_norm"] for m in history], held=checked,
                phase_s=time.perf_counter() - t_phase)


def phase_train_loop(dev, steps=8):
    """The loop end to end on the card: ``python -m
    repro_torch.launch.train --smoke --device cuda --steps 8`` (the
    default arch), then ``train()`` on the chatglm3-6b smoke config
    (float32: K4 and K4′ on the CUDA-core route) with ``checkpoint_every=4``
    uninterrupted, crashed at step 6, and restarted: the restart restores
    step 5 and ends on the uninterrupted run's final loss within the
    reference's rel 1e-4; whether it is bit for bit is reported."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.training import TrainLoopConfig, train
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--device", "cuda", "--steps", str(steps), "--ckpt-dir",
             os.path.join(tmp, "cli")], capture_output=True, text=True,
            env=env, timeout=600, cwd=ROOT)
        if r.returncode != 0:
            raise AssertionError(f"launch.train exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        for line in r.stdout.strip().splitlines()[-2:]:
            log(f"[train] launch.train: {line}")
        cfg = get_smoke_config("chatglm3-6b")

        def loop(d):
            return TrainLoopConfig(total_steps=steps, checkpoint_every=4,
                                   log_every=100, global_batch=4, seq_len=32,
                                   checkpoint_dir=os.path.join(tmp, d))
        PA.FLASH_KERNEL.launches = 0
        PA.FLASH_BWD_KERNEL.launches = 0
        ref = train(cfg, loop("ref"), device=dev)
        try:
            train(cfg, loop("ft"), device=dev, inject_failure_at=6)
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the injected failure did not raise")
        resumed = train(cfg, loop("ft"), device=dev)
        torch.cuda.synchronize()
        got = [h["step"] for h in resumed["history"]]
        if got != list(range(5, steps)):
            raise AssertionError(f"the restart stepped {got}, not from 5")
        a, b = resumed["final_loss"], ref["final_loss"]
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"the restart ended on loss {a}, the "
                                 f"uninterrupted run on {b}")
        bitwise = a == b and all(
            torch.equal(x, y) for (_, x), (_, y) in zip(
                _named_leaves(resumed["params"]), _named_leaves(ref["params"])))
        fwd, bwd = PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches
        bwd_routes = {r: k4b_kernel(r).launches for r in PA.BWD_PASSES}
        fwd_routes = {"cuda_cores": PA.FLASH_CORE_KERNEL.launches,
                      "tensor_cores": PA.FLASH_TC_KERNEL.launches}
        # float32: the CUDA-core route of both
        if fwd == 0 or bwd == 0 or bwd_routes["cuda_cores"] != bwd \
                or fwd_routes["cuda_cores"] != fwd:
            raise AssertionError(f"the smoke loop launched K4 {fwd_routes}, "
                                 f"K4′ {bwd_routes} times")
        log(f"[train] crash at 6 and restart: resumed at step 5, final loss "
            f"{a:.6f} against {b:.6f} uninterrupted ("
            + ("bit for bit, parameters too" if bitwise else
               f"not bit for bit: {abs(a - b):.3g} apart") + f"); K4 {fwd}, "
            f"K4′ {bwd} launches over the three runs (by route "
            f"{bwd_routes}); {time.perf_counter() - t0:.1f} s")
        return dict(final_loss=a, uninterrupted_final_loss=b,
                    bitwise=bitwise, k4_launches=fwd,
                    k4_launches_by_route=fwd_routes,
                    k4_bwd_launches_by_route=bwd_routes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------------- slice 17

def phase_slice17(dev, decode):
    """SLICE 17'S MAIN PATH: the configs of ``SLICE17`` through slices 8 and
    9's paths (``phase_slice8``: the engine, the prefill against its
    plain-attention twin, then ``decode(cfg, params)``, slice 9's decode on
    the same weights; fitting depth where cut) and the float32 decode
    checks (``phase_decode_f32``); then each of ``SLICE17_TRAIN`` through
    slice 10's: the gradient check (``phase_train_grads``, at
    ``SLICE17_CHECK`` layers, an encoder-decoder whole) and the main path
    (``phase_train``, ``GEMMA_TRAIN_STEPS`` steps at the fitting depth
    beside ``GEMMA_TRAIN_RESERVE``, one more step with every K4′ call
    held). A config with no full-attention layer (h2o-danube-3-4b: every
    layer sliding-window) launches neither K4 nor K4′, so its plain twin
    would be the same function: its gradient check is skipped with that
    reason, and its step must launch neither. Every part runs even after
    one fails; the phase then raises with every failure. Returns each
    part's numbers."""
    import dataclasses
    from repro_torch.configs import get_config
    out, failed = {"train": {}}, []

    def part(what, fn):
        try:
            return fn()
        except AssertionError as e:
            log(f"[slice17] {what} FAILED: {e}")
            failed.append(f"{what}: {e}")
            return None
    out["serving"] = part("serving", lambda: phase_slice8(
        dev, archs=SLICE17, decode=decode))
    out["decode_f32"] = part("float32 decode", lambda: phase_decode_f32(
        dev, archs=[name for name, _ in SLICE17]))
    for name in SLICE17_TRAIN:
        base = dataclasses.replace(get_config(name), remat=True)
        t = WHISPER_TOKENS if base.is_encdec else TRAIN_T
        check = dataclasses.replace(
            base, n_layers=base.n_layers if base.is_encdec else SLICE17_CHECK)
        row = out["train"][name] = {}
        if train_launches(check)[1]:
            row["gradient_check"] = part(f"{name}'s gradient check",
                                         lambda: phase_train_grads(
                                             dev, check, t=t))
        else:
            row["gradient_check"] = None
            log(f"[train] {name}: gradient check skipped — no "
                f"full-attention layer (its {base.n_layers} layers are "
                f"{sorted(set(base.block_pattern))}, the banded plain path), "
                "so K4 and K4′ never launch and the plain-attention twin "
                "computes the same function as the step")
        held = train_launches(base)[1] > 0
        row["main"] = part(f"{name}'s training step", lambda: phase_train(
            dev, t=t, steps=GEMMA_TRAIN_STEPS, arch=name,
            reserve=GEMMA_TRAIN_RESERVE, held=held))
    if failed:
        raise AssertionError("slice 17: " + "; ".join(failed))
    return out


# -------------------------------------------------------------- slice 18

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def phase_scan_grads(dev, name, t=SCAN_CHECK_T, vocab=SCAN_CHECK_VOCAB):
    """The gradient check of a config that launches no kernel (its plain
    twin would be the same function): ``loss_and_grads`` of ``name`` at
    full width in float32 and one whole repeat of its pattern
    (``SCAN_CHECK_LAYERS``), the vocabulary cut to ``vocab``, on the card
    against the same function of the port on the host, on the same
    weights (drawn once on the host, seeded) and the same B = 1, T = ``t``
    ``TokenStream`` batch, at the config's own ``chunk_rec``: the loss
    within ``SCAN_LOSS_RTOL`` relative, each gradient leaf's largest
    |diff| within ``SCAN_GRAD_TOL`` of the leaf's largest magnitude on the
    host; K4 and K4′ launch 0 times. Returns the worst leaf and both
    losses."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import loss_and_grads
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(name),
                              n_layers=SCAN_CHECK_LAYERS[name],
                              vocab_size=vocab, param_dtype="float32")
    host = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = train_batch("cpu", cfg, 1, t)
    t_draw = time.perf_counter() - t0
    PA.FLASH_KERNEL.launches = 0
    PA.FLASH_BWD_KERNEL.launches = 0
    t1 = time.perf_counter()
    loss, _, grads = loss_and_grads(_to(host, dev), _to(batch, dev), cfg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    launches = (PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches)
    if launches != (0, 0):
        raise AssertionError(f"{name}'s float32 check launched K4 and K4′ "
                             f"{launches} times; its layers "
                             f"{sorted(set(cfg.block_pattern))} take none")
    t1 = time.perf_counter()
    hloss, _, hgrads = loss_and_grads(host, batch, cfg)
    t_host = time.perf_counter() - t1
    rows, bad = [], []
    for (path, g), (_, w) in zip(_named_leaves(grads),
                                 _named_leaves(hgrads), strict=True):
        g = g.cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            bad.append(f"{path}: shape {tuple(g.shape)} against "
                       f"{tuple(w.shape)}, or not finite")
            continue
        share = (g - w).abs().max().item() / max(w.abs().max().item(),
                                                  1e-30)
        rows.append((path, share))
        if not share <= SCAN_GRAD_TOL:
            bad.append(f"{path} at {share:.3g} of its largest magnitude")
    rel = abs(float(loss) - float(hloss)) / abs(float(hloss))
    if not rel <= SCAN_LOSS_RTOL:
        bad.append(f"the loss {float(loss)} against the host's "
                   f"{float(hloss)} ({rel:.3g} relative)")
    worst = max(rows, key=lambda r: r[1]) if rows else (None, float("nan"))
    for path, share in sorted(rows, key=lambda r: -r[1])[:3]:
        log(f"[scan]   {name} {path}: {share:.3g} of its largest magnitude")
    if bad:
        raise AssertionError(f"{name}'s float32 gradient on the card "
                             "against the host's: " + "; ".join(bad))
    n_params = sum(x.numel() for x in _leaves(host))
    out = dict(arch=name, layers=cfg.n_layers, vocab=vocab, b=1, t=t,
               chunk_rec=cfg.chunk_rec, params_b=n_params / 1e9,
               loss=float(loss), host_loss=float(hloss), loss_rel=rel,
               leaves=len(rows), worst_leaf=worst[0], worst_share=worst[1],
               draw_s=t_draw, card_s=t_card, host_s=t_host,
               phase_s=time.perf_counter() - t0)
    log(f"[scan] {name} at {cfg.n_layers} layers ({n_params / 1e9:.3f} B "
        f"parameters, float32, the vocabulary cut to {vocab}), B = 1, T = "
        f"{t}, chunk {cfg.chunk_rec}: loss {float(loss):.7f} on the card, "
        f"{float(hloss):.7f} on the host ({rel:.3g} relative, bound "
        f"{SCAN_LOSS_RTOL}); {len(rows)} gradient leaves, the worst "
        f"{worst[0]} at {worst[1]:.3g} of its largest magnitude (bound "
        f"{SCAN_GRAD_TOL}); K4 and K4′ 0 launches; drawn on the host in "
        f"{t_draw:.1f} s, the card's gradient {t_card:.1f} s, the host's "
        f"{t_host:.1f} s; phase {out['phase_s']:.1f} s")
    del host, grads, hgrads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_slice18(dev):
    """SLICE 18'S MAIN PATH: the training of ``SLICE18_TRAIN`` on the card,
    each config's gradient check, then its main path (``phase_train``,
    ``GEMMA_TRAIN_STEPS`` bf16 steps at full width, B = 2, T = 2048,
    remat on, at the fitting depth beside ``GEMMA_TRAIN_RESERVE``; K4 and
    K4′ launched exactly as ``train_launches`` says: qwen3-moe 2 and 1 a
    layer a step, the other two 0 and 0; for a config with attention
    layers one more step with every K4′ call held). The gradient check of
    a config with full-attention layers (qwen3-moe) is
    ``phase_train_grads`` at ``SLICE17_CHECK`` layers against its
    plain-attention twin; of one without, ``phase_scan_grads`` (the card
    against the host in float32). Every part runs even after another
    fails; the phase then raises with every failure. Returns each part's
    numbers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    out, failed = {}, []

    def part(what, fn):
        try:
            return fn()
        except (AssertionError, torch.OutOfMemoryError) as e:
            log(f"[slice18] {what} FAILED: {e}")
            failed.append(f"{what}: {e}")
            gc.collect()
            torch.cuda.empty_cache()
            return None
    for name in SLICE18_TRAIN:
        base = dataclasses.replace(get_config(name), remat=True)
        row = out[name] = {}
        held = train_launches(base)[1] > 0
        if held:
            row["gradient_check"] = part(
                f"{name}'s gradient check", lambda: phase_train_grads(
                    dev, dataclasses.replace(base, n_layers=SLICE17_CHECK)))
        else:
            row["gradient_check"] = part(
                f"{name}'s float32 gradient check, the card against the host",
                lambda: phase_scan_grads(dev, name))
        row["main"] = part(f"{name}'s training step", lambda: phase_train(
            dev, steps=GEMMA_TRAIN_STEPS, arch=name,
            reserve=GEMMA_TRAIN_RESERVE, held=held))
    if failed:
        raise AssertionError("slice 18: " + "; ".join(failed))
    return out


# -------------------------------------------------------------- slice 19

def rotary_on_card(dev) -> dict:
    """``models/layers.py::rotary_angles`` of every config at its own
    (d_head · rope_fraction, rope_theta) on the card against the host's,
    bit for bit, at positions 0, 2047, 32767 and 524,287 (the host's is
    the reference's table, ``tests/test_torch_long_context.py``); cos and
    sin, each side's libm, reported. Returns cos/sin's largest difference
    by config."""
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.layers import rotary_angles
    pos = torch.tensor(LONG_ROTARY_POSITIONS)
    out, bad = {}, []
    for name in ARCHS:
        cfg = get_config(name)
        d_rot = int(cfg.d_head * cfg.rope_fraction)
        host = rotary_angles(pos, d_rot, cfg.rope_theta)
        card = rotary_angles(pos.to(dev), d_rot, cfg.rope_theta).cpu()
        if not torch.equal(host, card):
            bad.append(name)
        out[name] = max((torch.cos(card.to(dev)).cpu() - torch.cos(host))
                        .abs().max().item(),
                        (torch.sin(card.to(dev)).cpu() - torch.sin(host))
                        .abs().max().item())
    log(f"[slice19] rotary angles of all {len(out)} configs at positions "
        f"{list(LONG_ROTARY_POSITIONS)}: the card's "
        + ("equal the host's bit for bit" if not bad
           else f"DIFFER from the host's for {bad}")
        + f"; cos and sin (each side's libm) within "
        f"{max(out.values()):.3g} of the host's")
    if bad:
        raise AssertionError(f"the card's rotary angles differ from the "
                             f"host's for {bad}")
    return out


def draw_cache(cfg, b, cache_len, dev, gen, dtype=None):
    """A full decode cache of ``cfg`` for ``b`` rows and ``cache_len``
    slots (a ring of the window for "local" layers), every leaf — K and V,
    the RG-LRU's ``h`` and conv carry, the WKV state and shifts — drawn
    unit normal from ``gen`` on ``dev``, in the leaf's type or ``dtype``."""
    import torch
    from repro_torch.models import cache_specs
    from repro_torch.tree import tree_map
    return tree_map(lambda s: torch.randn(
        s.shape, generator=gen, device=dev,
        dtype=s.dtype if dtype is None else dtype),
        cache_specs(cfg, b, cache_len))


def long_decode_run(params, cache, toks, pos0, cfg):
    """``decode_step`` once a row of ``toks`` (n, B) at positions pos0,
    pos0 + 1, ...: the logits of each step and the last cache."""
    from repro_torch.models import decode_step
    out = []
    for j in range(toks.shape[0]):
        lg, cache = decode_step(params, cache, toks[j], pos0 + j, cfg)
        out.append(lg)
    return out, cache


def phase_long_decode(dev, cfg, params, b, cache_len, pos0, seed,
                      n=DECODE_STEPS):
    """A reference serving cell's decode on the card: ``cfg`` (bf16) at
    ``b`` rows against a full cache of ``cache_len`` slots drawn from
    ``seed`` on the card (``draw_cache``), ``n`` ``decode_step``s at
    positions pos0 .. pos0 + n - 1 on seeded tokens, counts zeroed just
    before and read just after (no K4: decode attends in plain PyTorch);
    the steps again from the same cache, bit for bit (timed: ms a step,
    tokens/s); the step's bound (the weights and the cache read once at
    3.35 TB/s); ``DECODE_TRACE_STEPS`` steps traced (launches a step,
    busy share); peak memory. Returns (the run's numbers, the cache)."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    start = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    cache = draw_cache(cfg, b, cache_len, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (n, b), generator=gen,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run, _ = long_decode_run(params, cache, toks, pos0, cfg)
    torch.cuda.synchronize()
    if PA.FLASH_KERNEL.launches:
        raise AssertionError(f"{cfg.name}: the decode launched K4 "
                             f"{PA.FLASH_KERNEL.launches} times")
    for lg in run:
        if lg.shape != (b, cfg.vocab_size) \
                or not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{cfg.name}: decode logits are not finite "
                                 f"of shape {(b, cfg.vocab_size)}")
    t0 = time.perf_counter()
    again, last = long_decode_run(params, cache, toks, pos0, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.equal(a, c) for a, c in zip(run, again, strict=True)):
        raise AssertionError(f"{cfg.name}: a repeat of the decode gave "
                             "other logits")
    w_bytes, c_bytes = decode_bytes(cfg, params, last, b)
    bound_ms = (w_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    del again, last, run
    steps = DECODE_TRACE_STEPS
    wall_us, kern, count = profile_call(
        lambda: long_decode_run(params, cache, toks[:steps], pos0, cfg),
        f"{cfg.name} {steps} decode steps B={b} at {pos0}", warm=False)
    busy = sum(kern.values())
    copy_us = sum(us for name, us in kern.items()
                  if "CatArrayBatchedCopy" in name)
    row = dict(layers=cfg.n_layers, batch=b, cache_len=cache_len,
               positions=[pos0, pos0 + n - 1], steps=n, step_ms=step_ms,
               tokens_per_s=b * 1e3 / step_ms, bound_ms=bound_ms,
               weight_gb=w_bytes / 1e9, cache_gb=c_bytes / 1e9,
               launches_per_step=count / steps, busy_share=busy / wall_us,
               copy_ms=copy_us / steps / 1e3, peak_gib=peak / 2**30,
               k4_launches=0, phase_s=time.perf_counter() - start)
    log(f"[slice19] {cfg.name} ({cfg.n_layers} layers, bf16) decode B={b} "
        f"against {cache_len} slots at positions {pos0}-{pos0 + n - 1}: "
        f"{step_ms:.2f} ms a step, {b * 1e3 / step_ms:.1f} tokens/s; "
        f"{count / steps:.0f} launches a step, device busy "
        f"{100 * busy / wall_us:.1f} % over {steps} steps, the cache copies "
        f"(cat/stack kernels) {copy_us / steps / 1e3:.3f} ms a step; bound "
        f"{bound_ms:.3f} ms a step ({w_bytes / 1e9:.2f} GB of weights, "
        f"{c_bytes / 1e9:.3f} GB of cache and state at 3.35 TB/s); peak "
        f"memory {peak / 2**30:.2f} GiB; K4 0 launches; a repeat bit for "
        f"bit; on {nvidia_smi()}")
    return row, cache


def long_decode_f32(dev, name, layers, b, cache_len, pos0, seed, vocab=None,
                    cache=None, n=DECODE_STEPS):
    """A serving cell's decode in float32 on the card against the same
    steps of the port on the host: ``name`` at full width and ``layers``
    layers (the vocabulary cut to ``vocab`` where given), the weights
    drawn on the card from ``seed`` and copied to the host, the cache
    ``cache`` (a host tree, float32) or one drawn from ``seed``, ``n``
    steps at pos0 .. on the same seeded tokens: each step's logits within
    ``LONG_F32_TOL`` of the host's row's rms, and each step's top-1 token
    equal. Returns the worst share and the seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    base = get_config(name)
    cfg = dataclasses.replace(base, n_layers=layers, param_dtype="float32",
                              vocab_size=vocab or base.vocab_size)
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_params(gen, cfg, dev)
    if cache is None:
        cache = _to(draw_cache(cfg, b, cache_len, dev, gen), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (n, b), generator=gen,
                         device=dev)
    card, _ = long_decode_run(params, _to(cache, dev), toks, pos0, cfg)
    card = torch.stack(card).cpu()
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    params = _to(params, "cpu")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    host, _ = long_decode_run(params, cache, toks.cpu(), pos0, cfg)
    host = torch.stack(host)
    t_host = time.perf_counter() - t1
    rms = host.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
    share = ((card - host).abs() / rms).max().item() / LONG_F32_TOL
    same = (card.argmax(-1) == host.argmax(-1)).all().item()
    log(f"[slice19] {name} float32 at {layers} layers"
        + (f", the vocabulary cut to {vocab}" if vocab else "")
        + f", B={b}, {n} steps at positions {pos0}-{pos0 + n - 1}: the "
        f"card's logits within {share:.3g} of {LONG_F32_TOL} of the host's "
        f"row rms; top-1 tokens {'equal' if same else 'DIFFER'}; card "
        f"{t_card:.1f} s, host {t_host:.1f} s")
    if not (share <= 1.0 and same):
        raise AssertionError(f"{name} in float32: the card's decode differs "
                             f"from the host's ({share:.3g} of the bound, "
                             f"top-1 equal {same})")
    return dict(layers=layers, vocab=cfg.vocab_size, share=share,
                top1_equal=same, card_s=t_card, host_s=t_host,
                phase_s=time.perf_counter() - t0)


def phase_long_prefill(dev, cfg, params, b, t):
    """A prefill of a config with no full-attention layer (no K4): seeded
    tokens (b, t) through ``prefill`` with ``cache_len`` t, counts zeroed
    just before and read just after (K4 0); a warm run, a timed one, a
    trace (launches, busy share); logits finite; peak memory against the
    card's. Returns the run's numbers."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import prefill
    batch = prefill_batch(dev, cfg, b, t)

    def run():
        return prefill(params, batch, cfg, cache_len=t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    logits, _ = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    if PA.FLASH_KERNEL.launches:
        raise AssertionError(f"{cfg.name}'s prefill launched K4")
    for out in (logits, timed):
        if out.shape != (b, cfg.vocab_size) \
                or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{cfg.name}: prefill logits are not "
                                 f"finite of shape {(b, cfg.vocab_size)}")
    del logits, timed
    wall_us, kern, count = profile_call(run, f"{cfg.name} prefill B={b} "
                                        f"T={t}", warm=False)
    busy = sum(kern.values())
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"[slice19] {cfg.name} ({cfg.n_layers} layers, bf16) prefill B={b} "
        f"T={t}: {wall:.1f} ms, {count} launches, device busy "
        f"{100 * busy / wall_us:.1f} %, K4 0 launches; peak memory "
        f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f}")
    return dict(shape=[b, t], wall_ms=wall, trace_wall_ms=wall_us / 1e3,
                trace_launches=count, device_busy_share=busy / wall_us,
                peak_gib=peak / 2**30, k4_launches=0)


def phase_slice19(dev, seed=SEED):
    """SLICE 19'S MAIN PATH, the reference's serving cells
    (``launch/specs.py``: prefill_32k, decode_32k, long_500k) at one data
    rank's batch on the card, through ``prefill`` and ``decode_step``,
    bf16 at full width from seeded generators. Every part runs even after
    another fails; the phase then raises with every failure. Returns each
    part's numbers."""
    import torch
    from repro_torch.configs import get_config
    out, failed = {}, []

    def part(what, fn):
        t0 = time.perf_counter()
        try:
            got = fn()
        except (AssertionError, torch.OutOfMemoryError) as e:
            log(f"[slice19] {what} FAILED: {e}")
            failed.append(f"{what}: {e}")
            got = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[slice19] {what}: {time.perf_counter() - t0:.1f} s")
        return got
    out["rotary"] = part("the rotary angles on the card",
                         lambda: rotary_on_card(dev))
    # chatglm3-6b, phase 9's weights: prefill_32k, then decode_32k
    cfg = get_config(LM_ARCH)
    params = lm_model(dev, cfg)
    out["prefill_32k"] = {LM_ARCH: part(
        f"{LM_ARCH}'s prefill_32k", lambda: phase_lm_prefill(
            dev, cfg, params, b=PREFILL_B, t=LONG_T))}
    held = {}

    def decode_32k():
        row, cache = phase_long_decode(dev, cfg, params, LONG_DECODE_B,
                                       LONG_T, LONG_T - DECODE_STEPS, seed)
        layers = LONG_CHECK_LAYERS[LM_ARCH]
        held["cache"] = _to({"scan": {k: {n: x[:layers].float() for n, x
                                          in c.items()}
                                      for k, c in cache["scan"].items()}},
                            "cpu")
        return row
    out["decode_32k"] = {LM_ARCH: part(f"{LM_ARCH}'s decode_32k",
                                       decode_32k)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if "cache" in held:
        out["decode_32k_f32"] = {LM_ARCH: part(
            f"{LM_ARCH}'s decode_32k in float32, the card against the host",
            lambda: long_decode_f32(
                dev, LM_ARCH, LONG_CHECK_LAYERS[LM_ARCH], LONG_DECODE_B,
                LONG_T, LONG_T - LONG_F32_STEPS, seed,
                cache=held.pop("cache"), n=LONG_F32_STEPS))}
    # gemma3-12b at phase 14's 12 layers: 2 global layers on K4 at Dh 256
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              n_layers=DECODE_GEMMA_LAYERS)
    params = lm_model(dev, cfg)
    out["prefill_32k"]["gemma3-12b"] = part(
        "gemma3-12b's prefill_32k", lambda: phase_lm_prefill(
            dev, cfg, params, b=PREFILL_B, t=LONG_T,
            k4=attention_layers(cfg)[1]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # long_500k, and rwkv6-1.6b's prefill_32k on its weights
    out["long_500k"], out["long_500k_f32"] = {}, {}
    for name in LONG_500K:
        cfg = get_config(name)
        params = lm_model(dev, cfg)
        if name == "rwkv6-1.6b":
            out["prefill_32k"][name] = part(
                f"{name}'s prefill_32k", lambda: phase_long_prefill(
                    dev, cfg, params, PREFILL_B, LONG_T))
        out["long_500k"][name] = part(
            f"{name}'s long_500k", lambda: phase_long_decode(
                dev, cfg, params, 1, LONG_POS + 1,
                LONG_POS + 1 - DECODE_STEPS, seed)[0])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["long_500k_f32"][name] = part(
            f"{name}'s long_500k in float32, the card against the host",
            lambda: long_decode_f32(
                dev, name, LONG_CHECK_LAYERS[name], 1, LONG_POS + 1,
                LONG_POS + 1 - DECODE_STEPS, seed, vocab=SCAN_CHECK_VOCAB))
    if failed:
        raise AssertionError("slice 19: " + "; ".join(failed))
    return out


# -------------------------------------------------------------- slice 20

def train4k_parts(dev, cfg, seed=SEED):
    """The accumulation against its parts: ``make_train_step(cfg, opt,
    n_microbatches=TRAIN4K_PARTS)`` on a (``TRAIN4K_PARTS``, ``TRAIN4K_T``)
    ``TokenStream`` batch, one sequence a microbatch, against
    ``opt_update`` applied, on a copy of the same weights and moments, to
    the float32 mean of ``TRAIN4K_PARTS`` separate ``loss_and_grads``
    calls (one a sequence, summed in order, then divided): the loss, the
    grad norm, the parameters and both moments bit for bit. It holds the
    step's loop, not the kernels. Returns its numbers."""
    import torch
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import loss_and_grads, opt_update
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    m = TRAIN4K_PARTS
    opt = OptConfig(warmup_steps=1)
    params = lm_model(dev, cfg)
    parts = _clone(params)
    batch = train_batch(dev, cfg, m, TRAIN4K_T, 0, seed)
    state, parts_state = opt_init(params), opt_init(parts)
    params, state, got = make_train_step(cfg, opt, n_microbatches=m)(
        params, state, batch)
    acc, losses = None, []
    for i in range(m):
        loss, _, g = loss_and_grads(
            parts, {k: v[i:i + 1] for k, v in batch.items()}, cfg)
        acc = tree_map(lambda x: x.float(), g) if acc is None \
            else tree_map(lambda a, x: a + x.float(), acc, g)
        losses.append(loss)
        del g
    parts, parts_state, want = opt_update(
        opt, parts, tree_map(lambda a: a / m, acc), parts_state)
    want["loss"] = torch.stack(losses).mean()
    torch.cuda.synchronize()
    same = {k: torch.equal(got[k], want[k])
            for k in ("loss", "grad_norm", "lr")}
    same["params"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(params), _leaves(parts)))
    same["moments"] = all(torch.equal(a, b) for a, b in zip(
        _leaves((state["m"], state["v"])),
        _leaves((parts_state["m"], parts_state["v"]))))
    log(f"[train4k] {cfg.name} at {cfg.n_layers} layers, {m} microbatches of "
        f"one {TRAIN4K_T}-token sequence: the step against opt_update on the "
        f"float32 mean of {m} separate loss_and_grads — loss "
        f"{float(got['loss']):.6f} / {float(want['loss']):.6f}, grad_norm "
        f"{float(got['grad_norm']):.6f} / {float(want['grad_norm']):.6f}; "
        "bit for bit: " + ", ".join(f"{k} {v}" for k, v in same.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    if not all(same.values()):
        raise AssertionError(f"train_4k: the {m}-microbatch step differs "
                             f"from its parts: {same}")
    del params, parts, state, parts_state, acc
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, microbatches=m,
                loss=float(got["loss"]), grad_norm=float(got["grad_norm"]),
                bit_for_bit=same, s=time.perf_counter() - t0)


def train4k_step(dev, name, reserve, seed=SEED, dry=False):
    """SLICE 20'S MAIN PATH on ``name``: the reference's train_4k step at
    one data rank's share (docstring item 27), at the most whole repeats
    whose ``TRAIN4K_BYTES_PER_PARAM`` a parameter fit the card's free
    memory beside ``reserve``. With ``dry``, the dry run's count of the
    same step on a one-rank ``fake`` group (phase 22), started once the
    depth is known and run beside the steps (device-bound: 97 % busy on
    chatglm3-6b), is held against the measured peak. Returns the step's
    numbers."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training import optimizer as TO
    t_phase = time.perf_counter()
    gc.collect()              # autograd's checkpoint hooks leave cycles
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    base = dataclasses.replace(get_config(name), remat=True)
    cfg = fitting_depth(base, free, TRAIN4K_BYTES_PER_PARAM, reserve)
    n_params = cfg.param_count()
    state_b = n_params * TRAIN4K_BYTES_PER_PARAM
    more = dataclasses.replace(cfg, n_layers=cfg.n_layers
                               + len(cfg.block_pattern))
    log(f"[train4k] {name}: {free / 2 ** 30:.2f} GiB free; at {cfg.n_layers} "
        f"of {base.n_layers} layers {n_params / 1e9:.3f} B parameters x "
        f"{TRAIN4K_BYTES_PER_PARAM} bytes = {state_b / 2 ** 30:.2f} GiB, with "
        f"the {reserve / 2 ** 30:.0f} GiB reserve "
        f"{(state_b + reserve) / 2 ** 30:.2f} GiB"
        + (f"; {more.n_layers} layers would need "
           f"{(more.param_count() * TRAIN4K_BYTES_PER_PARAM + reserve) / 2 ** 30:.2f}"
           " GiB" if more.n_layers <= base.n_layers else ""))
    proc = dryrun_start(world=1, layers=cfg.n_layers, b=TRAIN4K_B,
                        t=TRAIN4K_T, arch=name, micro=TRAIN4K_MICRO) \
        if dry else None
    want, layers = train_launches(cfg)
    route = PA.route(torch.bfloat16, cfg.d_head)
    if layers == 0 or route != "tensor_cores":
        raise AssertionError(f"{name}: {layers} full-attention layers on the "
                             f"{route} route")
    params = lm_model(dev, cfg)
    state = opt_init(params)
    opt = OptConfig(warmup_steps=1)
    step = make_train_step(cfg, opt, n_microbatches=TRAIN4K_MICRO)
    batches = [train_batch(dev, cfg, TRAIN4K_B, TRAIN4K_T, s, seed)
               for s in range(TRAIN4K_STEPS + 1)]
    tokens = TRAIN4K_B * TRAIN4K_T
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    history, secs = [], []
    for s in range(TRAIN4K_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        history.append({k: float(v) for k, v in m.items()})
        secs.append(time.perf_counter() - t0)
    counts = kernel_counts()
    tc = PA.FLASH_TC_KERNEL.launches
    bwd_routes = {r: k4b_kernel(r).launches for r in PA.BWD_PASSES}
    peak = torch.cuda.max_memory_allocated()
    segments = torch.cuda.memory_snapshot()
    expandable = sum(bool(x.get("is_expandable")) for x in segments)
    log(f"[train4k] {name}: {expandable} of the allocator's {len(segments)} "
        f"segments expandable; {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
        "GiB reserved after the steps")
    for s, m in enumerate(history):
        log(f"[train4k] {name} step {s}: loss {m['loss']:.4f}, grad_norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.3g}, {secs[s]:.3f} s")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"train_4k {name} step {s}: {m}")
    k4_step = TRAIN4K_MICRO * want
    k4b_step = TRAIN4K_MICRO * PA.BWD_PASSES[route] * layers
    if counts["K4"] != k4_step * TRAIN4K_STEPS or tc != counts["K4"]:
        raise AssertionError(f"train_4k {name}: K4 launched {counts['K4']} "
                             f"times ({tc} on the tensor cores), not "
                             f"{k4_step} x {TRAIN4K_STEPS}")
    if counts["K4′"] != k4b_step * TRAIN4K_STEPS \
            or bwd_routes[route] != counts["K4′"]:
        raise AssertionError(f"train_4k {name}: K4′ launched {bwd_routes}, "
                             f"not {k4b_step} x {TRAIN4K_STEPS} on its "
                             f"{route} route")
    # one more step traced
    t_trace = time.perf_counter()
    wall_us, kern, count = profile_call(
        lambda: step(params, state, batches[-1]),
        f"train_4k step {name} {cfg.n_layers} layers", warm=False)
    t_trace = time.perf_counter() - t_trace
    busy = sum(kern.values())
    groups = train_step_groups(kern)
    k4_us, k4b_us = groups.get("K4", 0.0), groups.get("K4′", 0.0)
    log(f"[train4k] {name}, the traced step's device time by kind: "
        + ", ".join(f"{g} {us / 1e3:.1f} ms" for g, us in groups.items()))
    # the accumulation alone: the first microbatch's copy, the other 15
    # float32 adds and the mean, over the whole tree, as the step runs them
    micro = TO._micro(batches[0], TRAIN4K_MICRO, 0)
    _, _, g = TO.loss_and_grads(params, micro, cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    gacc = TO._accumulate(None, g, torch.float32)
    for _ in range(TRAIN4K_MICRO - 1):
        TO._accumulate(gacc, g, torch.float32)
    TO._mean_(gacc, TRAIN4K_MICRO)
    end.record()
    torch.cuda.synchronize()
    acc_ms = start.elapsed_time(end)
    del g, gacc
    t_held = time.perf_counter()
    acc_bound_ms = n_params * (6 + 10 * (TRAIN4K_MICRO - 1) + 8) \
        / HBM_BYTES_PER_S * 1e3
    # one microbatch with every K4 and K4′ call held
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with K4Checked() as fwd, K4BChecked() as bwd:
        _, _, g = TO.loss_and_grads(params, micro, cfg)
    torch.cuda.synchronize()
    del g
    held_counts = kernel_counts()
    if held_counts["K4"] != want \
            or held_counts["K4′"] != PA.BWD_PASSES[route] * layers:
        raise AssertionError(f"train_4k {name}: the held microbatch launched "
                             f"{held_counts}, not K4 {want}, K4′ "
                             f"{PA.BWD_PASSES[route] * layers}")
    held = every_call_held(f"{name}'s train_4k microbatch at {cfg.n_layers} "
                           "layers", held_counts, fwd, bwd)
    held.update(check_s=fwd.check_s + bwd.check_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                s=time.perf_counter() - t_held)
    steady = secs[-1]
    bound = 8 * n_params * tokens / BF16_FLOP_PER_S
    log(f"[train4k] {name} at {cfg.n_layers} layers, B = {TRAIN4K_B}, T = "
        f"{TRAIN4K_T} as {TRAIN4K_MICRO} microbatches: {steady:.3f} s a step "
        f"(steps {', '.join(f'{x:.3f}' for x in secs)}), "
        f"{tokens / steady:.0f} tokens/s; peak {peak / 2 ** 30:.2f} GiB "
        f"against {state_b / 2 ** 30:.2f} GiB of {TRAIN4K_BYTES_PER_PARAM} "
        f"bytes a parameter (+{(peak - state_b) / 2 ** 30:.2f}; "
        f"{before / 2 ** 30:.2f} allocated before the steps); K4 "
        f"{counts['K4'] // TRAIN4K_STEPS} and K4′ "
        f"{counts['K4′'] // TRAIN4K_STEPS} launches a step ({TRAIN4K_MICRO} x "
        f"{want} and {TRAIN4K_MICRO} x {PA.BWD_PASSES[route]} x {layers}); "
        "the traced "
        f"step: busy {100 * busy / wall_us:.1f} %, K4 {k4_us / 1e3:.1f} ms "
        f"({100 * k4_us / wall_us:.2f} %), K4′ {k4b_us / 1e3:.1f} ms "
        f"({100 * k4b_us / wall_us:.2f} %), {count} launches; the "
        f"accumulation {acc_ms:.1f} ms of device time (bound "
        f"{acc_bound_ms:.1f} ms, bytes); bound {bound:.3f} s (8 x "
        f"{n_params / 1e9:.3f} B x {tokens} tokens at the bf16 peak), "
        f"{100 * bound / steady:.1f} % of it; seconds: the steps "
        f"{sum(secs):.1f}, the trace {t_trace:.1f}, the held microbatch "
        f"{held['s']:.1f} (its checks {held['check_s']:.1f}); "
        f"{time.perf_counter() - t_phase:.1f} s")
    row = dict(arch=name, layers=cfg.n_layers, of_layers=base.n_layers,
               free_gib=free / 2 ** 30, reserve_gib=reserve / 2 ** 30,
               params_b=n_params / 1e9, state_gib=state_b / 2 ** 30,
               step_s=secs, tokens_per_s=tokens / steady,
               peak_gib=peak / 2 ** 30, before_gib=before / 2 ** 30,
               k4_launches_per_step=counts["K4"] // TRAIN4K_STEPS,
               k4_bwd_launches_per_step=counts["K4′"] // TRAIN4K_STEPS,
               k4_bwd_launches_by_route=bwd_routes,
               traced_wall_ms=wall_us / 1e3, busy_share=busy / wall_us,
               k4_share=k4_us / wall_us, k4_bwd_share=k4b_us / wall_us,
               traced_launches=count, trace_s=t_trace,
               traced_ms_by_kind={g: us / 1e3 for g, us in groups.items()},
               accumulation_ms=acc_ms, accumulation_bound_ms=acc_bound_ms,
               bound_s=bound, held=held,
               loss=[m["loss"] for m in history],
               grad_norm=[m["grad_norm"] for m in history])
    if proc is not None:
        t0 = time.perf_counter()
        pred = dryrun_check(proc)
        ratio = peak / pred["peak_bytes"]
        product_ms = (groups.get("matmul", 0.0) + k4_us + k4b_us) / 1e3
        rate = pred["flops"] / (product_ms * 1e-3) if product_ms else 0.0
        row["dryrun"] = dict(predicted=pred, peak_ratio=ratio,
                             product_device_ms=product_ms,
                             counted_flops_per_product_s=rate,
                             wait_s=time.perf_counter() - t0)
        log(f"[dryrun] phase 22: the dry run's count of phase 27's {name} "
            f"train_4k step ({cfg.n_layers} layers, B = {TRAIN4K_B}, T = "
            f"{TRAIN4K_T}, {TRAIN4K_MICRO} microbatches; meta tensors on a "
            f"fake group of one): peak {pred['peak_bytes'] / 2 ** 30:.3f} GiB "
            f"(arguments {pred['argument_bytes'] / 2 ** 30:.3f}), "
            f"{pred['flops'] / 1e12:.1f} TFLOP of products; measured peak "
            f"{peak / 2 ** 30:.3f} GiB ({ratio:.3f}x the prediction), the "
            f"traced step's products (matmul, K4, K4′) {product_ms:.1f} ms "
            f"of device time ({rate / 1e12:.1f} TFLOP/s of the counted "
            f"flops); waited {row['dryrun']['wait_s']:.1f} s for the count")
        if not 0.8 <= ratio <= 1.25:
            raise AssertionError(f"train_4k {name}: the measured peak is "
                                 f"{ratio:.3f}x the dry run's prediction, "
                                 "outside 0.8-1.25")
    del params, state, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def expandable_segments() -> bool:
    """Whether the process's CUDA allocator grows its segments by pages, as
    ``PYTORCH_ALLOC_CONF`` (or the older ``PYTORCH_CUDA_ALLOC_CONF``) set
    it at start; False by default."""
    conf = os.environ.get("PYTORCH_ALLOC_CONF",
                          os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""))
    opts = dict(x.split(":", 1) for x in conf.split(",") if ":" in x)
    return opts.get("expandable_segments", "").strip() == "True"


def phase_train_4k(dev, seed=SEED):
    """Phase 27 (docstring item 27): chatglm3-6b's gradient at T = 4096
    against its plain-attention twin and its accumulation against its
    parts, both at ``SLICE17_CHECK`` layers, then the train_4k step of each
    of ``TRAIN4K_ARCHS`` (chatglm3-6b's held against phase 22's dry run).
    Every part runs even after another fails; the phase then raises with
    every failure. Returns each part's numbers."""
    import torch
    from repro_torch.configs import get_config
    out, failed = {}, []

    def part(what, fn):
        t0 = time.perf_counter()
        try:
            got = fn()
        except (AssertionError, torch.OutOfMemoryError) as e:
            log(f"[train4k] {what} FAILED: {e}")
            failed.append(f"{what}: {e}")
            got = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[train4k] {what}: {time.perf_counter() - t0:.1f} s")
        return got
    name = TRAIN4K_ARCHS[0][0]
    check = dataclasses.replace(get_config(name), n_layers=SLICE17_CHECK,
                                remat=True)
    out["gradient_check"] = part(
        f"{name}'s gradient at T = {TRAIN4K_T} against its twin",
        lambda: phase_train_grads(dev, check, b=1, t=TRAIN4K_T))
    out["parts"] = part(f"{name}'s accumulation against its parts",
                        lambda: train4k_parts(dev, check, seed))
    # a work-around for this script, not the port: the steps fill 88-94 %
    # of the card, and after phases 1-26 in this process gemma3-12b's step
    # found fixed segments split into ~10 GiB of free blocks too small for
    # its 4 GiB float32 logits and ran out of memory (in a process of its
    # own it fitted); segments that grow and shrink by pages do not split.
    # The process's own setting is restored after the steps.
    was = expandable_segments()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch, reserve in TRAIN4K_ARCHS:
            out[arch] = part(f"{arch}'s train_4k step", lambda: train4k_step(
                dev, arch, reserve, seed, dry=arch == name))
    finally:
        torch.cuda.memory._set_allocator_settings(
            f"expandable_segments:{was}")
    if failed:
        raise AssertionError("slice 20: " + "; ".join(failed))
    return out


# -------------------------------------------------------------- slice 12

def kernel_counts() -> dict:
    """Every kernel's launch count, by the kernel's id."""
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.kernels.pg import pg
    from repro_torch.kernels.resize import resize as PR
    return {"K1": pg.SOLVE_KERNEL.launches, "K2": pg.ADMIT_KERNEL.launches,
            "K3": PR.RESIZE_KERNEL.launches, "K4": PA.FLASH_KERNEL.launches,
            "K4′": PA.FLASH_BWD_KERNEL.launches}


def zero_counts() -> None:
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.kernels.pg import pg
    from repro_torch.kernels.resize import resize as PR
    for k in (pg.SOLVE_KERNEL, pg.ADMIT_KERNEL, PR.RESIZE_KERNEL,
              PA.FLASH_KERNEL, PA.FLASH_BWD_KERNEL):
        k.launches = 0


def launched(what: str, need) -> dict:
    """The counts since :func:`zero_counts`; fails unless each kernel of
    ``need`` launched."""
    got = kernel_counts()
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing}: {got}")
    return got


def run_train_lm(dev, card, ckpt, *args):
    """``train_lm --params-100m --steps EXAMPLE_STEPS`` with ``args``; →
    its output and a summary row."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--device", dev.type, "--params-100m", "--steps",
                         str(EXAMPLE_STEPS), "--ckpt-dir", ckpt, *args])
    losses = [h["loss"] for h in out["history"]]
    secs = sorted(h["step_time_s"] for h in out["history"])
    row = dict(first_loss=losses[0], final_loss=out["final_loss"],
               first10_mean=sum(losses[:10]) / 10,
               last10_mean=sum(losses[-10:]) / 10,
               ms_per_step_median=1e3 * secs[len(secs) // 2],
               steps=len(losses))
    if not row["last10_mean"] < row["first10_mean"]:
        raise AssertionError(f"train_lm {args}: the last 10 losses' mean "
                             f"{row['last10_mean']} is not below the first "
                             f"10's {row['first10_mean']}")
    log(f"[examples] train_lm --params-100m {' '.join(args)}: loss "
        f"{row['first_loss']:.4f} -> {row['final_loss']:.4f} (last-10 mean "
        f"{row['last10_mean']:.4f}, first-10 mean {row['first10_mean']:.4f}), "
        f"{row['ms_per_step_median']:.1f} ms a step (median) on {card}")
    return out, row


def every_call_held(what: str, counts: dict, fwd, bwd=None) -> dict:
    """Fails unless ``fwd`` (:class:`K4Checked`) and ``bwd``
    (:class:`K4BChecked`) checked every K4 and K4′ launch of ``counts``
    and held each within its tolerance; → the checks' summary."""
    got = dict(k4_calls=fwd.calls, k4_worst=fwd.held(what))
    if fwd.calls != counts["K4"]:
        raise AssertionError(f"{what}: {fwd.calls} K4 calls checked of "
                             f"{counts['K4']} launches")
    if bwd is not None:
        got.update(k4b_calls=bwd.calls, k4b_worst=bwd.held(what))
        if bwd.launches != counts["K4′"]:
            raise AssertionError(f"{what}: {bwd.launches} K4′ launches "
                                 f"checked of {counts['K4′']}")
    return got


def phase_examples(dev, card):
    """SLICE 12: the four examples on the card through their ``main``, each
    with the counts zeroed just before and read just after (docstring
    item 19)."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.examples import quickstart, serve_edge, slicing_demo
    t_phase = time.perf_counter()
    out = {}
    zero_counts()
    gpu = quickstart.main(["--device", dev.type])
    out["quickstart"] = launched("quickstart", ["K2"])
    cpu = quickstart.main(["--device", "cpu"])
    for name, sol in gpu.items():
        ref = cpu[name]
        if (sol.num_allocated, sol.num_satisfied, sol.objective) != (
                ref.num_allocated, ref.num_satisfied, ref.objective) or not (
                np.array_equal(sol.admitted, ref.admitted)
                and np.array_equal(sol.alloc, ref.alloc)
                and np.array_equal(sol.z, ref.z)):
            raise AssertionError(f"quickstart {name} decides otherwise on "
                                 "the card than on the CPU")
    zero_counts()
    slicing_demo.main(["--device", dev.type])
    out["slicing_demo"] = launched("slicing_demo", ["K1", "K3"])
    zero_counts()
    with K4Checked() as fwd:
        serve_edge.main(["--device", dev.type, "--ticks", "3", "--arch",
                         "chatglm3-6b"])
    out["serve_edge"] = launched("serve_edge", ["K1", "K3", "K4"])
    every_call_held("serve_edge", out["serve_edge"], fwd)
    log(f"[examples] launches: {out} ({time.perf_counter() - t_phase:.1f} "
        "s)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_examples_")
    try:
        zero_counts()
        _, out["train_lm"] = run_train_lm(dev, card, f"{tmp}/local")
        out["train_lm"]["launches"] = kernel_counts()
        shutil.rmtree(f"{tmp}/local")
        zero_counts()
        whole, out["train_lm_full_attention"] = run_train_lm(
            dev, card, f"{tmp}/full", "--full-attention")
        out["train_lm_full_attention"]["launches"] = launched(
            "train_lm --full-attention", ["K4", "K4′"])
        shutil.rmtree(f"{tmp}/full")
        banded, full = out["train_lm"], out["train_lm_full_attention"]
        first_gap = abs(full["first_loss"] - banded["first_loss"])
        last_gap = abs(full["last10_mean"] - banded["last10_mean"])
        log(f"[examples] full attention against banded (T = window): first "
            f"losses {first_gap:.3g} apart (at most {EXAMPLE_FIRST_TOL}), "
            f"last-10 means {last_gap:.3g} (at most {EXAMPLE_LAST10_TOL})")
        if not (first_gap <= EXAMPLE_FIRST_TOL
                and last_gap <= EXAMPLE_LAST10_TOL):
            raise AssertionError("train_lm with K4 and K4′ does not train "
                                 "as the banded plain path does")
        # the same run again, crashed and resumed, with every K4 and K4′
        # call held against its plain version on its own inputs
        zero_counts()
        with K4Checked() as fwd, K4BChecked() as bwd:
            try:
                run_train_lm(dev, card, f"{tmp}/crash", "--full-attention",
                             "--inject-failure-at", str(EXAMPLE_FAIL_AT))
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            else:
                raise AssertionError("the injected failure did not raise")
            resumed, row = run_train_lm(dev, card, f"{tmp}/crash",
                                        "--full-attention")
        counts = launched("train_lm --full-attention, crashed and resumed",
                          ["K4", "K4′"])
        out["train_lm_checked"] = every_call_held(
            "train_lm --full-attention, crashed and resumed", counts, fwd,
            bwd)
        if row["final_loss"] != whole["final_loss"]:
            raise AssertionError(f"the resumed run ended on loss "
                                 f"{row['final_loss']!r}, the uninterrupted "
                                 f"one on {whole['final_loss']!r}")
        out["train_lm_resumed"] = dict(
            resumed_at=resumed["history"][0]["step"],
            final_loss=row["final_loss"])
        log(f"[examples] crashed at step {EXAMPLE_FAIL_AT}, resumed at step "
            f"{resumed['history'][0]['step']}: final loss "
            f"{row['final_loss']!r}, bit for bit the uninterrupted run's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[examples] phase 19: {out['phase_s']:.1f} s on {card}")
    return out


def one_rank_mesh(dev):
    """A (1, 1) ``data × model`` ``DeviceMesh`` on a one-rank group of the
    card's backend, its store on 127.0.0.1."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def phase_mesh(dev, card, b=TRAIN_B, t=TRAIN_T, cfg=None, moe_cfg=None,
               moe_t=TRAIN_T):
    """SLICE 12: the mesh forms on a one-rank group (docstring item 20)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import grad_compression as G
    from repro_torch.distributed import sharding as S
    from repro_torch.models import moe as M
    from repro_torch.models import param_specs
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import loss_and_grads
    t_phase = time.perf_counter()
    out = {}
    mesh = one_rank_mesh(dev)
    try:
        # the train step: mesh (compute + ZeRO layouts) against meshless
        t0 = time.perf_counter()
        cfg = cfg or dataclasses.replace(get_config(TRAIN_ARCH),
                                         n_layers=MESH_LAYERS, remat=True)
        specs = param_specs(cfg)
        osh = S.compute_shardings(specs, mesh, cfg)
        zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
        base = lm_model(dev, cfg)
        mesh_p = _clone(base)
        mesh_s = opt_init(mesh_p, zero_shardings=zsh, out_shardings=osh)
        opt = OptConfig(warmup_steps=1)
        mesh_step = make_train_step(cfg, opt, mesh=mesh, grad_shardings=zsh,
                                    param_out_shardings=osh)
        plain_s = opt_init(base)
        plain_step = make_train_step(cfg, opt)
        rows = []
        for i in range(MESH_STEPS):
            batch = train_batch(dev, cfg, b, t, i)
            zero_counts()
            t1 = time.perf_counter()
            mesh_p, mesh_s, mm = mesh_step(mesh_p, mesh_s, batch)
            torch.cuda.synchronize()
            mesh_ms = 1e3 * (time.perf_counter() - t1)
            mesh_n = kernel_counts()
            zero_counts()
            t1 = time.perf_counter()
            base, plain_s, pm = plain_step(base, plain_s, batch)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t1)
            plain_n = kernel_counts()
            same = all(torch.equal(x, y) for x, y in zip(
                _leaves(mesh_p), _leaves(base)))
            row = dict(loss=float(mm["loss"]), grad_norm=float(
                mm["grad_norm"]), meshless_loss=float(pm["loss"]),
                meshless_grad_norm=float(pm["grad_norm"]),
                params_bit_for_bit=same, launches=mesh_n, ms=mesh_ms,
                meshless_ms=plain_ms)
            rows.append(row)
            if mesh_n != plain_n or mesh_n["K4"] == 0 or mesh_n["K4′"] == 0:
                raise AssertionError(f"mesh step {i}: launches {mesh_n}, "
                                     f"meshless {plain_n}")
            if not (same and row["loss"] == row["meshless_loss"]
                    and row["grad_norm"] == row["meshless_grad_norm"]):
                raise AssertionError(f"mesh step {i} is not the meshless "
                                     f"step bit for bit: {row}")
        moments = sum(x.numel() for x in _leaves(mesh_s["m"]))
        out["train_step"] = dict(steps=rows, moment_elements=moments,
                                 s=time.perf_counter() - t0)
        log(f"[mesh] {cfg.name} at {cfg.n_layers} layers, B = {b}, T = {t}: "
            f"{MESH_STEPS} mesh steps (ZeRO layout) bit for bit the meshless "
            f"steps (losses {[r['loss'] for r in rows]}), launches "
            f"{rows[-1]['launches']} a step as meshless; ms a step "
            f"{[round(r['ms'], 1) for r in rows]} against meshless "
            f"{[round(r['meshless_ms'], 1) for r in rows]}; "
            f"{out['train_step']['s']:.1f} s")

        # ef_allreduce over the gradient leaves of the first batch
        t0 = time.perf_counter()
        _, _, grads = loss_and_grads(base, train_batch(dev, cfg, b, t), cfg)
        leaves = _leaves(grads)
        del mesh_p, mesh_s, plain_s
        mean, _ = G.ef_allreduce(leaves, G.init_error(leaves), mesh, "data")
        for g, got in zip(leaves, mean):
            q, sc, _ = G.compress(g, torch.zeros((), device=g.device))
            if not torch.equal(got, G.decompress(q, sc)):
                raise AssertionError("ef_allreduce on one rank is not the "
                                     "local decompress")
        out["ef_allreduce"] = dict(leaves=len(leaves), elements=sum(
            g.numel() for g in leaves), s=time.perf_counter() - t0)
        log(f"[mesh] ef_allreduce over {len(leaves)} gradient leaves "
            f"({out['ef_allreduce']['elements'] / 1e9:.3f} B elements): bit "
            f"for bit the local decompress; {out['ef_allreduce']['s']:.1f} s")
        del base, grads, leaves, mean
        gc.collect()
        torch.cuda.empty_cache()

        # one MoE layer at full width through ep and tp
        t0 = time.perf_counter()
        mcfg = moe_cfg or get_config(MOE_ARCH)
        gen = torch.Generator(device=dev).manual_seed(12)
        p = M.moe_init(gen, mcfg, getattr(torch, mcfg.param_dtype),
                       device=dev)
        x = (torch.randn((b, moe_t, mcfg.d_model), generator=gen,
                         device=dev)).to(p["w_gate"].dtype)
        local = M._moe_local(p, x, mcfg)
        dense = M._moe_dense(p, x, mcfg)
        rms = local.float().pow(2).mean().sqrt().item()
        moe = {}
        for impl, late in (("ep", False), ("tp", False), ("tp", True)):
            got = M.moe_apply(p, x, dataclasses.replace(mcfg, moe_impl=impl),
                              impl=impl, mesh=mesh, psum_late=late)
            err = (got.float() - local.float()).abs().max().item()
            share = ((got.float() - dense.float()).abs() < 1e-4).float() \
                .mean().item()
            key = impl + ("_late" if late else "")
            moe[key] = dict(max_abs_err=err, rms=rms, dense_share=share,
                            bit_for_bit=bool(torch.equal(got, local)))
            if not err <= MOE_OUT_TOL * rms:
                raise AssertionError(f"MoE {key}: {err} from _moe_local, "
                                     f"rms {rms}")
            log(f"[mesh] {mcfg.name} MoE layer {key} (B = {b}, T = {moe_t}, "
                f"{x.dtype}): max |diff| to _moe_local {err:.3g} (rms "
                f"{rms:.3g}; bit for bit: {moe[key]['bit_for_bit']}); share "
                f"within 1e-4 of _moe_dense {share:.4f}")
        moe["s"] = time.perf_counter() - t0
        out["moe"] = moe
        del p, x, local, dense
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 20: {out['phase_s']:.1f} s on {card}")
    return out


# ------------------------------------------------------------ phases 21-22

# a worker part's seconds by stage (``stage``), reset before each part
STAGES: dict = {}
_STAGE_T = [0.0]


def stage(what: str) -> None:
    """Adds the seconds since the last mark (or the part's start) to
    ``STAGES[what]``: where a gloo worker part's time goes, its lockstep
    waits included in the stage that waits."""
    now = time.perf_counter()
    STAGES[what] = STAGES.get(what, 0.0) + now - _STAGE_T[0]
    _STAGE_T[0] = now


def tp_shards(whole, mesh, cfg, osh=None):
    """This rank's parameters in the layout ``osh`` (the compute layout by
    default), cut from ``whole`` (fresh tensors)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.models import param_specs
    from repro_torch.tree import tree_map
    if osh is None:
        osh = S.compute_shardings(param_specs(cfg), mesh, cfg)
    return tree_map(lambda t, sh: S.shard_of(t, sh).clone(), whole, osh), osh


def tp_draw(dev, cfg, mesh, rank, world, keep: bool, osh=None):
    """Each rank in turn draws ``cfg``'s whole seeded parameters on the
    card (``lm_model``) and cuts its shards (in the layout ``osh``, the
    compute layout by default), so that one whole copy exists at a time;
    → (shards, their layout, the whole copy if ``keep``)."""
    import torch
    import torch.distributed as dist
    whole = local = None
    for r in range(world):
        if r == rank:
            stage("draw, waits")
            whole = lm_model(dev, cfg)
            stage("draw, weights")
            local, osh = tp_shards(whole, mesh, cfg, osh)
            stage("draw, shards")
            if not keep:
                whole = None
                gc.collect()
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            stage("draw, free")
        torch.cuda.synchronize()
        dist.barrier()
    stage("draw, waits")
    return local, osh, whole


def tp_lockstep_ms(fn, reps: int = 1) -> float:
    """The median ms of ``fn`` over ``reps`` runs (after a warm one), every
    rank starting together (a barrier before each)."""
    import torch
    import torch.distributed as dist
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def tp_serving(dev, mesh, rank, world, b=PREFILL_B, t=PREFILL_T,
               steps=TP_DECODE_STEPS):
    """Phase 21's serving part on one rank: chatglm3-6b's prefill at (b, t)
    and ``TP_SERVING_LAYERS`` layers and ``steps`` decode steps over the
    (1, world) mesh, every K4 call of
    the prefill checked on its own inputs (``K4Checked``); rank 0 holds
    the whole model too and runs the meshless prefill (free-running, and
    block by block on the mesh run's block inputs, ``BlockLog``) and
    decode beside it."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, prefill
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TP_SERVING_LAYERS)
    local, _, whole = tp_draw(dev, cfg, mesh, rank, world, keep=rank == 0)
    batch = prefill_batch(dev, cfg, b, t)
    cache_len = t + steps
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (steps, b), dtype=np.int32)).to(dev)
    stage("inputs")

    def run():
        return prefill(local, batch, cfg, cache_len, mesh=mesh)
    zero_counts()
    with BlockLog() as blocks, K4Checked() as checked:
        logits, cache = run()
    torch.cuda.synchronize()
    stage("checked prefill")
    counts = kernel_counts()
    per_call = checked.held(f"tp={world} rank {rank} prefill")
    out = dict(layers=cfg.n_layers, k4_launches=counts["K4"],
               k4_calls_checked=checked.calls, k4_worst_share=per_call,
               heads_local=cfg.n_heads // world)
    from repro_torch.kernels.attn import attn as PA
    if counts["K4"] != cfg.n_layers or checked.calls != cfg.n_layers \
            or PA.FLASH_TC_KERNEL.launches != cfg.n_layers:
        raise AssertionError(f"tp={world} rank {rank}: the prefill launched "
                             f"K4 {counts['K4']} times ({checked.calls} "
                             f"checked); {cfg.n_layers} on the tensor "
                             "cores expected")
    out["prefill_ms"] = tp_lockstep_ms(run)
    stage("prefill")
    dec = []
    c = cache
    for j in range(steps):
        lg, c = decode_step(local, c, toks[j], t + j, cfg, mesh=mesh)
        dec.append(lg)

    def decode_run():
        cc = cache
        for j in range(steps):
            _, cc = decode_step(local, cc, toks[j], t + j, cfg, mesh=mesh)
    out["decode_ms_per_step"] = tp_lockstep_ms(decode_run) / steps
    stage("decode")
    if rank == 0:
        def meshless():
            return prefill(whole, batch, cfg, cache_len)
        plogits, pcache = meshless()
        out["meshless_prefill_ms"] = sorted(
            _timed(meshless) for _ in range(3))[1]
        with BlockLog(force=blocks) as twin:
            meshless()
        out["block_max_diff"] = blocks.apart(twin)
        del twin
        out["logit_max_diff"] = (logits.float() - plogits.float()).abs() \
            .max().item()
        out["logit_abs_max"] = plogits.float().abs().max().item()
        pdec, pc = [], pcache
        for j in range(steps):
            lg, pc = decode_step(whole, pc, toks[j], t + j, cfg)
            pdec.append(lg)

        def meshless_decode():
            cc = pcache
            for j in range(steps):
                _, cc = decode_step(whole, cc, toks[j], t + j, cfg)
        out["meshless_decode_ms_per_step"] = sorted(
            _timed(meshless_decode) for _ in range(3))[1] / steps
        out["decode_logit_max_diff"] = max(
            (a.float() - p.float()).abs().max().item()
            for a, p in zip(dec, pdec))
        out["top1_equal"] = int((logits.argmax(-1)
                                 == plogits.argmax(-1)).sum())
        finite = all(torch.isfinite(x.float()).all() for x in dec + [logits])
        if not finite or logits.shape != (b, cfg.vocab_size):
            raise AssertionError("tp prefill logits are not finite of shape "
                                 f"{(b, cfg.vocab_size)}")
        for key, tol in (("logit_max_diff", PREFILL_LOGIT_TOL),
                         ("decode_logit_max_diff", PREFILL_LOGIT_TOL),
                         ("block_max_diff", PREFILL_BLOCK_TOL)):
            if not out[key] <= tol:
                raise AssertionError(f"tp={world}: {key} {out[key]:.4g} "
                                     f"beyond {tol}")
    stage("meshless")
    del local, whole, cache, logits, blocks
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    stage("free")
    return out


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def tp_train(dev, mesh, rank, world, b=TRAIN_B, t=TRAIN_T):
    """Phase 21's training part on one rank: chatglm3-6b at
    ``MESH_LAYERS`` layers over the (1, world) mesh. One train step
    (``make_train_step(mesh=)``; no ZeRO layout: gloo carries only sums on
    CUDA tensors) on freshly cut shards, its peak memory (from the shards,
    their moments and the batch), launches and ms; a traced warm step's
    product time on rank 0; then the first step's loss and each leaf's
    reduced gradient (the split leaves' own, the whole leaves' shares
    summed over ``model``; ``recorded_reduced``) against the meshless
    ``loss_and_grads`` (``held_against_meshless``), and the meshless
    step's ms on rank 0."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import recorded_reduced
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS,
                              remat=True)
    opt = OptConfig(warmup_steps=1)
    local, osh, _ = tp_draw(dev, cfg, mesh, rank, world, keep=False)
    state = opt_init(local)
    batch = train_batch(dev, cfg, b, t)
    step = make_train_step(cfg, opt, mesh=mesh)
    stage("inputs")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with recorded_reduced("cpu") as red:
        local, state, m = step(local, state, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = kernel_counts()
    from repro_torch.kernels.attn import attn as PA
    out = dict(layers=MESH_LAYERS, first_step_ms=first_ms,
               peak_bytes=torch.cuda.max_memory_allocated(),
               allocated_before_bytes=before, launches=counts,
               k4b_tc_launches=PA.FLASH_BWD_TC_KERNEL.launches,
               loss=float(m["loss"]))
    if counts["K4"] != 2 * MESH_LAYERS \
            or PA.FLASH_BWD_TC_KERNEL.launches != 3 * MESH_LAYERS \
            or counts["K4′"] != 3 * MESH_LAYERS:
        raise AssertionError(f"tp={world} rank {rank}: the train step "
                             f"launched {counts}; K4 {2 * MESH_LAYERS} and "
                             f"K4′ {3 * MESH_LAYERS} on its tensor-core "
                             "route expected")
    stage("first step")
    out["step_ms"] = tp_lockstep_ms(lambda: step(local, state, batch))
    stage("step")
    if rank == 0:
        _, kern, _ = profile_call(lambda: step(local, state, batch),
                                  f"tp={world} rank 0 train step",
                                  warm=False)
        out["product_device_ms"] = sum(
            us for name, us in kern.items()
            if any(k in name.lower() for k in ("gemm", "nvjet", "cutlass",
                                               "flash"))) / 1e3
        out["device_busy_ms"] = sum(kern.values()) / 1e3
    else:
        step(local, state, batch)
    torch.cuda.synchronize()
    dist.barrier()
    stage("traced step")
    del local, state
    gc.collect()
    torch.cuda.empty_cache()

    mloss, worst, leaf = held_against_meshless(
        dev, cfg, batch, red, osh, rank, world,
        f"tp={world} rank {rank}")
    stage("meshless gradient")
    out.update(mesh_loss=out["loss"], meshless_loss=mloss,
               grad_worst_rms_share=worst, grad_worst_leaf=leaf)
    check_twin(out, f"tp={world} rank {rank}")
    del red
    if rank == 0:
        whole = lm_model(dev, cfg)
        pstate = opt_init(whole)
        pstep = make_train_step(cfg, opt)
        pstep(whole, pstate, batch)
        out["meshless_step_ms"] = sorted(
            _timed(lambda: pstep(whole, pstate, batch)) for _ in range(3))[1]
        del pstate, whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_worker(argv) -> int:
    """One rank of phases 21 and 23 (``chip_smoke.py --tp-worker WORLD RANK
    PORT OUT PARTS``): a gloo group of WORLD processes on the one card, its
    store on 127.0.0.1:PORT, a (1, WORLD) ``data × model`` mesh (``zero3``:
    ``ZERO3_MESH``); runs the PARTS (``serving``, ``train``; phase 23's
    ``sp``, ``kv``, ``ring``, ``zero3``) and writes its numbers to
    ``OUT.rankRANK.json``."""
    world, rank, port, out, parts = int(argv[0]), int(argv[1]), argv[2], \
        argv[3], argv[4].split(",")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        # the first CUDA work of a process and its first cut of shards (a
        # smoke model's), on every rank at once: the parts draw and cut
        # their weights a rank at a time, and each rank's first turn took
        # ~10 s (H100 80GB HBM3 machine, 700 W), most of it importing
        # DTensor
        t0 = time.perf_counter()
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import init_params
        smoke = get_smoke_config(TRAIN_ARCH)
        tp_shards(init_params(torch.Generator(dev).manual_seed(0), smoke,
                              dev), mesh, smoke)
        torch.cuda.synchronize()
        res = {"start_s": time.perf_counter() - T_START,
               "warm_s": time.perf_counter() - t0}
        runs = {
            "serving": lambda: tp_serving(dev, mesh, rank, world),
            "train": lambda: tp_train(dev, mesh, rank, world),
            "sp": lambda: sp_train(dev, mesh, rank, world),
            "kv": lambda: kv_serving(dev, mesh, rank, world, TRAIN_ARCH,
                                     layers=TP_SERVING_LAYERS),
            "ring": lambda: kv_serving(dev, mesh, rank, world, KV_RING_ARCH,
                                       layers=KV_RING_LAYERS),
            "zero3": lambda: zero3_train(dev, init_device_mesh(
                "cuda", ZERO3_MESH, mesh_dim_names=("data", "model")),
                rank, world)}
        for part in parts:
            t0 = time.perf_counter()
            STAGES.clear()
            _STAGE_T[0] = t0
            res[part] = runs[part]()
            # each part's seconds on this rank, its lockstep waits included
            res[part]["part_s"] = time.perf_counter() - t0
            stage("rest")
            res[part]["stages_s"] = dict(STAGES)
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_workers(world: int, parts: str, out: str) -> list:
    """``world`` processes of ``tp_worker`` running ``parts`` over a gloo
    group on the card (a free port on 127.0.0.1), each joined within
    ``TP_JOIN_S`` seconds or all killed; their output is logged, and any
    rank's failure raises. → each rank's numbers."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker",
         str(world), str(r), str(port), out, parts],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TP_JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"[{parts} world={world} r{r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"{parts} over {world} processes: rank {r} "
                                 f"failed (exit {p.returncode})")
    ranks = []
    for r in range(world):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    log(f"[{parts} world={world}] seconds on rank 0: to the first part "
        f"{ranks[0]['start_s']:.1f} (the first CUDA work "
        f"{ranks[0]['warm_s']:.1f} of it), " + ", ".join(
            f"{p} {ranks[0][p]['part_s']:.1f} (" + ", ".join(
                f"{k} {v:.1f}" for k, v in ranks[0][p]["stages_s"].items())
            + ")" for p in parts.split(",")))
    return ranks


def phase_tp(dev, card, sizes=TP_SIZES):
    """Phase 21 (docstring item 21): for each ``world`` of ``sizes``, that
    many processes share the card over a gloo group (``tp_worker``); the
    train part at the first; then, in the same processes, phase 23's parts
    (``SLICE14_PARTS``). Returns {world: [each rank's numbers]} and, as
    ``slice14_s``, rank 0's seconds in phase 23's parts."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "tp_phase")
    os.makedirs(out_dir, exist_ok=True)
    results, slice14_s = {}, 0.0
    for i, world in enumerate(sizes):
        parts = ("serving,train" if i == 0 else "serving") + "," \
            + SLICE14_PARTS[world]
        t0 = time.perf_counter()
        ranks = run_workers(world, parts, os.path.join(out_dir, f"tp{world}"))
        results[world] = ranks
        slice14_s += sum(ranks[0][p]["part_s"]
                         for p in SLICE14_PARTS[world].split(","))
        sv = ranks[0]["serving"]
        log(f"[tp] chatglm3-6b at {sv['layers']} layers over tp={world} "
            f"processes sharing one card over gloo ({card}; not a multi-card number): prefill B = "
            f"{PREFILL_B}, T = {PREFILL_T} {sv['prefill_ms']:.1f} ms a rank "
            f"in lockstep against {sv['meshless_prefill_ms']:.1f} meshless; "
            f"{sv['heads_local']} heads a rank, K4 {sv['k4_launches']} "
            f"launches a rank, every call within {max(x['serving']['k4_worst_share'] for x in ranks):.3f} "
            f"of its tolerance; logits max abs diff to meshless "
            f"{sv['logit_max_diff']:.4g} (|logits| max "
            f"{sv['logit_abs_max']:.3g}), block outputs on the same inputs "
            f"{sv['block_max_diff']:.4g} of their row's rms, top-1 equal in "
            f"{sv['top1_equal']} of {PREFILL_B}; {TP_DECODE_STEPS} decode "
            f"steps {sv['decode_ms_per_step']:.1f} ms a step against "
            f"{sv['meshless_decode_ms_per_step']:.1f} meshless, logits max "
            f"abs diff {sv['decode_logit_max_diff']:.4g}; "
            f"{time.perf_counter() - t0:.1f} s with phase 23's parts")
        if "train" in ranks[0]:
            tr = ranks[0]["train"]
            log(f"[tp] chatglm3-6b at {tr['layers']} layers, B = {TRAIN_B}, "
                f"T = {TRAIN_T}, tp={world} (processes sharing one card over "
                f"gloo): a train step {tr['step_ms']:.1f} ms (first "
                f"{tr['first_step_ms']:.1f}) against "
                f"{tr['meshless_step_ms']:.1f} meshless; launches "
                f"{tr['launches']} a rank (K4′ all on its tensor-core "
                f"route); loss {tr['mesh_loss']:.6f} against meshless "
                f"{tr['meshless_loss']:.6f}; worst gradient leaf "
                f"{tr['grad_worst_leaf']} at {tr['grad_worst_rms_share']:.4g} "
                f"of its rms; rank 0 peak {tr['peak_bytes'] / 2**30:.3f} GiB "
                f"({tr['allocated_before_bytes'] / 2**30:.3f} before the "
                f"step), product device time {tr['product_device_ms']:.1f} "
                f"ms of {tr['device_busy_ms']:.1f} busy")
    results["slice14_s"] = slice14_s
    results["phase_s"] = time.perf_counter() - t_phase - slice14_s
    log(f"[tp] phase 21: {results['phase_s']:.1f} s on {card} (and "
        f"{slice14_s:.1f} s of phase 23's parts in its groups)")
    return results


DRYRUN_CHECK = """
import json, sys, dataclasses
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
world, layers, b, t, micro = (int(x) for x in sys.argv[2:7])
dryrun.start_fake_group(world)
mesh = make_test_mesh(1, world, device_type="cpu")
cfg = dataclasses.replace(get_config(sys.argv[7]), n_layers=layers,
                          remat=True)
c = dryrun.count_train_step(cfg, mesh, b, t, rules=json.loads(sys.argv[8]),
                            n_microbatches=micro)
print(json.dumps(dict(peak_bytes=c.peak_bytes, flops=c.flops,
                      argument_bytes=c.argument_bytes,
                      product_bytes=c.product_bytes,
                      collective_bytes=c.collective_bytes,
                      collective_counts=c.collective_counts)))
"""


# the dry runs started and not yet read: stopped at exit
_DRYRUNS: list = []


def _stop_dryruns() -> None:
    for proc in _DRYRUNS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_start(rules=None, *, world=TP_SIZES[0], layers=MESH_LAYERS,
                 b=TRAIN_B, t=TRAIN_T, arch=TRAIN_ARCH, micro=1):
    """Starts the dry run's count (a fresh process, a ``fake`` group of
    ``world`` ranks, ``meta`` tensors) of rank 0's train step of ``arch``
    at ``layers`` layers over (1, ``world``) on a (``b``, ``t``) batch in
    ``micro`` microbatches, under the axis ``rules`` — by default phase
    21's step — and returns the process for :func:`dryrun_check`: the
    count needs no card, so the script need not wait for it alone."""
    if not _DRYRUNS:
        import atexit
        atexit.register(_stop_dryruns)
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHECK, os.path.join(ROOT, "src"),
         *(str(x) for x in (world, layers, b, t, micro)), arch,
         json.dumps(rules or {})], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _DRYRUNS.append(proc)
    return proc


def dryrun_check(proc) -> dict:
    """The count a :func:`dryrun_start` process printed."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("the dry run's count took over 600 s")
    if proc.returncode != 0:
        raise AssertionError(f"the dry run's count failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_dryrun(card, tp, proc):
    """Phase 22 (docstring item 22): the dry run's count (``proc``, from
    :func:`dryrun_start`) of the step phase 21 trained (rank 0 of tp = the
    first size, ``MESH_LAYERS`` layers) on a ``fake`` group of that many
    ranks, against rank 0's measured peak memory and product time."""
    world = TP_SIZES[0]
    tr = tp[world][0]["train"]
    t0 = time.perf_counter()
    pred = dryrun_check(proc)
    ratio = tr["peak_bytes"] / pred["peak_bytes"]
    rate = pred["flops"] / (tr["product_device_ms"] * 1e-3) \
        if tr["product_device_ms"] else 0.0
    out = dict(predicted=pred, measured_peak_bytes=tr["peak_bytes"],
               measured_before_bytes=tr["allocated_before_bytes"],
               measured_product_ms=tr["product_device_ms"],
               peak_ratio=ratio, counted_flops_per_product_s=rate,
               s=time.perf_counter() - t0)
    log(f"[dryrun] phase 22: the dry run's count of rank 0's tp={world} "
        f"train step ({TRAIN_ARCH}, {MESH_LAYERS} layers, B = {TRAIN_B}, "
        f"T = {TRAIN_T}; meta tensors on a fake group of {world}): peak "
        f"{pred['peak_bytes'] / 2**30:.3f} GiB (arguments "
        f"{pred['argument_bytes'] / 2**30:.3f}), {pred['flops'] / 1e12:.3f} "
        f"TFLOP of products, collectives {pred['collective_counts']}; "
        f"measured on {card}: peak {tr['peak_bytes'] / 2**30:.3f} GiB "
        f"({ratio:.3f}x the prediction; {tr['allocated_before_bytes'] / 2**30:.3f} "
        f"allocated before the step), product device time "
        f"{tr['product_device_ms']:.1f} ms ({rate / 1e12:.1f} TFLOP/s of "
        f"the counted flops); {out['s']:.1f} s")
    if not 0.8 <= ratio <= 1.25:
        raise AssertionError(f"the measured peak is {ratio:.3f}x the dry "
                             "run's prediction, outside 0.8-1.25")
    return out


# ------------------------------------------------------------ phase 23

def held_against_meshless(dev, cfg, batch, blocks, shardings, rank, world,
                          what):
    """Each rank in turn draws ``cfg``'s whole seeded weights, takes the
    meshless ``loss_and_grads`` and holds its reduced gradient ``blocks``
    (laid out as ``shardings``, a stacked leaf's repeats in turn) against
    its blocks of the meshless gradient: → (meshless loss, the worst
    leaf's rms(diff) / rms(meshless), that leaf)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.training import optimizer as O
    out = None
    for r in range(world):
        if r == rank:
            whole = lm_model(dev, cfg)
            mloss, _, grads = O.loss_and_grads(whole, batch, cfg)
            worst, worst_leaf, it = 0.0, None, iter(blocks)
            for (name, sh), (_, w, stacked) in zip(
                    _named_leaves(shardings), O._param_leaves(whole, grads)):
                spec = S.NamedSharding(sh.mesh, sh.spec[1:] if stacked
                                       else sh.spec)
                for wu in (w if stacked else [w]):
                    want = S.shard_of(wu, spec)
                    g = next(it).to(want.device)
                    if g.shape != want.shape:
                        raise AssertionError(f"{what}: {name}'s block is "
                                             f"{tuple(g.shape)}, not "
                                             f"{tuple(want.shape)}")
                    d = (g.float() - want.float()).pow(2).mean().sqrt() \
                        .item() / (leaf_rms(want) or 1.0)
                    if d > worst:
                        worst, worst_leaf = d, name
            out = (float(mloss), worst, worst_leaf)
            del whole, grads
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier()
    return out


def check_twin(out, what):
    if not abs(out["mesh_loss"] - out["meshless_loss"]) \
            <= TRAIN_LOSS_RTOL * abs(out["meshless_loss"]) \
            or not out["grad_worst_rms_share"] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"{what}: loss {out['mesh_loss']} vs "
                             f"{out['meshless_loss']}, worst gradient leaf "
                             f"{out['grad_worst_leaf']} at "
                             f"{out['grad_worst_rms_share']:.4g} of its rms")


def sp_train(dev, mesh, rank, world, b=TRAIN_B, t=TRAIN_T):
    """Phase 23 (a) on one rank: chatglm3-6b at ``MESH_LAYERS`` layers,
    remat on, over the (1, world) mesh with Megatron-SP (``seq_sp`` →
    ``model``): one ``make_train_step(mesh=, rules=)`` step, every K4 and
    K4′ call held against its plain version on its own inputs
    (``K4Checked``, ``K4BChecked``; ``every_call_held``), its launches; a
    second
    step's peak memory and ms (the checks' float32 attention no longer
    beside it); the first step's reduced gradient and loss against the
    meshless ``loss_and_grads`` (``held_against_meshless``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import recorded_reduced
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS,
                              remat=True)
    what = f"SP tp={world} rank {rank} train step"
    local, osh, _ = tp_draw(dev, cfg, mesh, rank, world, keep=False)
    state = opt_init(local)
    batch = train_batch(dev, cfg, b, t)
    step = make_train_step(cfg, OptConfig(warmup_steps=1), mesh=mesh,
                           rules=SP_RULES)
    stage("inputs")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with K4Checked() as checked, K4BChecked() as bwd, \
            recorded_reduced("cpu") as red:
        local, state, m = step(local, state, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    stage("checked step")
    counts = kernel_counts()
    out = dict(layers=MESH_LAYERS, first_step_ms=first_ms,
               check_s=checked.check_s + bwd.check_s,
               checked_peak_bytes=torch.cuda.max_memory_allocated(),
               allocated_before_bytes=before, launches=counts,
               k4_tc_launches=PA.FLASH_TC_KERNEL.launches,
               k4b_tc_launches=PA.FLASH_BWD_TC_KERNEL.launches,
               k4b_phase15_share=bwd.phase15, mesh_loss=float(m["loss"]),
               **every_call_held(what, counts, checked, bwd))
    if counts["K4"] != 2 * MESH_LAYERS \
            or out["k4_tc_launches"] != 2 * MESH_LAYERS \
            or out["k4b_tc_launches"] != 3 * MESH_LAYERS \
            or counts["K4′"] != 3 * MESH_LAYERS:
        raise AssertionError(f"{what} launched {counts}; K4 "
                             f"{2 * MESH_LAYERS} and K4′ {3 * MESH_LAYERS} "
                             "on the tensor cores expected")
    # the peak of a step without the checks' attention beside it
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = tp_lockstep_ms(lambda: step(local, state, batch))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    stage("step")
    del local, state
    gc.collect()
    torch.cuda.empty_cache()
    mloss, worst, leaf = held_against_meshless(dev, cfg, batch, red, osh,
                                               rank, world, what)
    stage("meshless gradient")
    out.update(meshless_loss=mloss, grad_worst_rms_share=worst,
               grad_worst_leaf=leaf)
    check_twin(out, what)
    return out


def kv_serving(dev, mesh, rank, world, arch, layers=None, b=PREFILL_B,
               t=PREFILL_T, steps=TP_DECODE_STEPS):
    """Phase 23 (c) on one rank: ``arch`` (at ``layers`` layers where
    given) over the (1, world) mesh with the decode cache split by
    sequence (``seq_kv`` → ``model``): a (b, t) prefill, every K4 call
    held against its plain version, then ``steps`` decode steps; the cache
    bytes a rank (and in the heads' layout), and on rank 0 the logits
    against the meshless prefill and decode of the whole weights."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, prefill
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    what = f"seq_kv {cfg.name} tp={world} rank {rank}"
    local, _, whole = tp_draw(dev, cfg, mesh, rank, world, keep=rank == 0)
    stage("inputs")
    batch = prefill_batch(dev, cfg, b, t)
    cache_len = t + steps
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (steps, b), dtype=np.int32)).to(dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with K4Checked() as checked:
        logits, cache = prefill(local, batch, cfg, cache_len, mesh=mesh,
                                rules=KV_RULES)
    torch.cuda.synchronize()
    counts = kernel_counts()
    n_k4 = attention_layers(cfg)[0]
    out = dict(arch=cfg.name, layers=cfg.n_layers, k4_launches=counts["K4"],
               k4_calls_checked=checked.calls, k4_worst_share=checked.held(
                   what),
               prefill_ms=1e3 * (time.perf_counter() - t0)
               - 1e3 * checked.check_s,
               cache_bytes=sum(x.numel() * x.element_size()
                               for x in _leaves(cache)))
    if counts["K4"] != n_k4 or checked.calls != n_k4:
        raise AssertionError(f"{what}: the prefill launched K4 "
                             f"{counts['K4']} times ({checked.calls} "
                             f"checked); {n_k4} expected")

    def nbytes(c):
        return sum(x.numel() * x.element_size() for x in _leaves(c))
    out["init_cache_bytes"] = nbytes(init_cache(
        cfg, b, cache_len, device="meta", mesh=mesh, rules=KV_RULES))
    out["init_cache_heads_layout_bytes"] = nbytes(init_cache(
        cfg, b, cache_len, device="meta", mesh=mesh))
    out["init_cache_whole_bytes"] = nbytes(init_cache(
        cfg, b, cache_len, device="meta"))

    def decode_run():
        c, res = cache, []
        for j in range(steps):
            lg, c = decode_step(local, c, toks[j], t + j, cfg, mesh=mesh,
                                rules=KV_RULES, cache_len=cache_len)
            res.append(lg)
        return res
    dec = decode_run()
    out["decode_ms_per_step"] = tp_lockstep_ms(decode_run) / steps
    if rank == 0:
        plogits, pc = prefill(whole, batch, cfg, cache_len)
        pdec = []
        for j in range(steps):
            lg, pc = decode_step(whole, pc, toks[j], t + j, cfg)
            pdec.append(lg)
        out["logit_max_diff"] = (logits.float() - plogits.float()).abs() \
            .max().item()
        out["logit_abs_max"] = plogits.float().abs().max().item()
        out["decode_logit_max_diff"] = max(
            (a.float() - p.float()).abs().max().item()
            for a, p in zip(dec, pdec))
        finite = all(torch.isfinite(x.float()).all() for x in dec + [logits])
        if not finite or logits.shape != (b, cfg.vocab_size):
            raise AssertionError(f"{what}: logits are not finite of shape "
                                 f"{(b, cfg.vocab_size)}")
        for key in ("logit_max_diff", "decode_logit_max_diff"):
            if not out[key] <= PREFILL_LOGIT_TOL:
                raise AssertionError(f"{what}: {key} {out[key]:.4g} beyond "
                                     f"{PREFILL_LOGIT_TOL}")
        del plogits, pc, pdec
    del local, whole, cache, logits, dec
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def zero3_train(dev, mesh, rank, world, b=TRAIN_B, t=TRAIN_T):
    """Phase 23 (b) on one rank: mixtral-8x7b at full width and
    ``ZERO3_LAYERS`` layers over the ``ZERO3_MESH`` ``data × model`` mesh,
    the train step as ``launch/specs.py::build_cell(optimized=True)``
    builds it: Megatron-SP, the ``tp`` form's ``psum_late``, the expert
    stacks stored split over ``data`` too (ZeRO-3, gathered a layer at a
    time), the moments and the gradient in the ZeRO layout, the parameters
    written back to their storage layout, a bf16 accumulator. The
    capacity factor is E / top-k, so that no bucket drops a token and the
    ``tp`` form computes the function of the meshless dense form it is
    held against. Each rank's expert bytes must be 1/(mesh size) of the
    whole; the loss and its reduced gradient against meshless."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.models import param_specs
    from repro_torch.training import OptConfig, make_train_step, opt_init
    from repro_torch.training.optimizer import recorded_reduced
    full = get_config(ZERO3_ARCH)
    cfg = dataclasses.replace(full, n_layers=ZERO3_LAYERS, remat=True,
                              moe_psum_late=True,
                              capacity_factor=full.n_experts / full.top_k)
    what = f"ZeRO-3 {cfg.name} {ZERO3_MESH} rank {rank} train step"
    specs = param_specs(cfg)
    osh = S.compute_shardings(specs, mesh, cfg, moe_fsdp=True,
                              rules=OPT_RULES)
    zsh = S.param_shardings(specs, mesh, cfg, OPT_RULES,
                            extra_batch_dim=True, moe_fsdp=True)
    local, _, _ = tp_draw(dev, cfg, mesh, rank, world, keep=False, osh=osh)
    stage("inputs")
    ffn = [local["scan"]["pos0"]["ffn"][k] for k in ("w_gate", "w_up",
                                                     "w_down")]
    expert_bytes = sum(x.numel() * x.element_size() for x in ffn)
    whole_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.d_expert \
        * cfg.n_layers * ffn[0].element_size()
    if expert_bytes * world != whole_bytes:
        raise AssertionError(f"{what}: the rank stores {expert_bytes} bytes "
                             f"of experts, not 1/{world} of {whole_bytes}")
    state = opt_init(local, zero_shardings=zsh, out_shardings=osh)
    batch = train_batch(dev, cfg, b, t)
    step = make_train_step(cfg, OptConfig(warmup_steps=1), mesh=mesh,
                           grad_shardings=zsh, param_out_shardings=osh,
                           accum_dtype=torch.bfloat16, rules=OPT_RULES)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with recorded_reduced("cpu") as red:
        local, state, m = step(local, state, batch)
    torch.cuda.synchronize()
    out = dict(layers=cfg.n_layers, first_step_ms=1e3 * (
        time.perf_counter() - t0), peak_bytes=torch.cuda.max_memory_allocated(),
        allocated_before_bytes=before, launches=kernel_counts(),
        expert_bytes=expert_bytes, expert_whole_bytes=whole_bytes,
        mesh_loss=float(m["loss"]))
    stage("step")
    del local, state
    gc.collect()
    torch.cuda.empty_cache()
    mloss, worst, leaf = held_against_meshless(dev, cfg, batch, red, zsh,
                                               rank, world, what)
    stage("meshless gradient")
    out.update(meshless_loss=mloss, grad_worst_rms_share=worst,
               grad_worst_leaf=leaf)
    check_twin(out, what)
    return out


def phase_slice14(dev, card, tp, dry_sp):
    """Phase 23 (docstring item 23): Megatron-SP, the sequence-split decode
    cache and (at 4 processes) ZeRO-3 of the MoE experts over processes
    that share the card (``tp_worker``'s gloo groups: phase 21's, ``tp``,
    which ran these parts after its own), then the dry run's count of the
    SP step (``dry_sp``, from :func:`dryrun_start`) against its measured
    peak. → the ranks' numbers and the count; its seconds include its
    parts' in phase 21's groups."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {w: tp[w] for w in SLICE14_PARTS}
    for w, ranks in res.items():
        sp = ranks[0]["sp"]
        base = tp[TP_SIZES[0]][0]["train"] if w == TP_SIZES[0] else None
        log(f"[sp] chatglm3-6b at {sp['layers']} layers, B = {TRAIN_B}, T = "
            f"{TRAIN_T}, remat, Megatron-SP over tp={w} processes sharing "
            f"one card over gloo ({card}; not a multi-card number): a train "
            f"step {sp['step_ms']:.1f} ms (first {sp['first_step_ms']:.1f}, "
            f"{sp['check_s']:.1f} s of it K4 and K4′ checks); launches "
            f"{sp['launches']} a rank, K4 and K4′ all on the tensor cores, "
            f"each K4 call within "
            f"{max(r['sp']['k4_worst'] for r in ranks):.3f} and each of the "
            f"{sp['k4b_calls']} K4′ calls a rank within "
            f"{max(r['sp']['k4b_worst'] for r in ranks):.3f} of its "
            f"tolerance on its own inputs; loss {sp['mesh_loss']:.6f} against "
            f"meshless {sp['meshless_loss']:.6f}; worst gradient leaf "
            f"{max((r['sp'] for r in ranks), key=lambda x: x['grad_worst_rms_share'])['grad_worst_leaf']}"
            f" at {max(r['sp']['grad_worst_rms_share'] for r in ranks):.4g} "
            f"of its rms; rank 0 peak {sp['peak_bytes'] / 2**30:.3f} GiB "
            f"({sp['checked_peak_bytes'] / 2**30:.3f} with the K4 and K4′ "
            "checks)"
            + (f" against {base['peak_bytes'] / 2**30:.3f} without SP "
               f"(phase 21)" if base else ""))
        for part in ("kv", "ring"):
            if part not in ranks[0]:
                continue
            kv = ranks[0][part]
            log(f"[kv] {kv['arch']} at {kv['layers']} layers, seq_kv over "
                f"tp={w} processes ({card}, gloo): prefill B = {PREFILL_B}, "
                f"T = {PREFILL_T} {kv['prefill_ms']:.1f} ms, K4 "
                f"{kv['k4_launches']} launches a rank, each call within "
                f"{max(r[part]['k4_worst_share'] for r in ranks):.3f} of its "
                f"tolerance; cache {kv['init_cache_bytes'] / 2**20:.1f} MiB a "
                f"rank (heads' layout "
                f"{kv['init_cache_heads_layout_bytes'] / 2**20:.1f}, whole "
                f"{kv['init_cache_whole_bytes'] / 2**20:.1f}); logits "
                f"{kv['logit_max_diff']:.4g} from meshless (|logits| "
                f"{kv['logit_abs_max']:.3g}); {TP_DECODE_STEPS} decode steps "
                f"{kv['decode_ms_per_step']:.1f} ms a step, logits "
                f"{kv['decode_logit_max_diff']:.4g} from meshless")
    z = res[4][0]["zero3"]
    log(f"[zero3] mixtral-8x7b at {z['layers']} layer, optimized over "
        f"{ZERO3_MESH} processes ({card}, gloo): the train step "
        f"{z['first_step_ms']:.1f} ms; experts "
        f"{[r['zero3']['expert_bytes'] / 2**30 for r in res[4]]} GiB a rank "
        f"of {z['expert_whole_bytes'] / 2**30:.3f}; loss {z['mesh_loss']:.6f}"
        f" against meshless {z['meshless_loss']:.6f}; worst gradient leaf at "
        f"{max(r['zero3']['grad_worst_rms_share'] for r in res[4]):.4g} of "
        f"its rms; rank 0 peak {z['peak_bytes'] / 2**30:.3f} GiB")
    dry = dryrun_check(dry_sp)
    sp = res[2][0]["sp"]
    ratio = sp["peak_bytes"] / dry["peak_bytes"]
    log(f"[dryrun] phase 23: the dry run's count of rank 0's SP tp=2 step: "
        f"peak {dry['peak_bytes'] / 2**30:.3f} GiB, collectives "
        f"{dry['collective_counts']}; measured {sp['peak_bytes'] / 2**30:.3f}"
        f" GiB ({ratio:.3f}x)")
    if not 0.8 <= ratio <= 1.25:
        raise AssertionError(f"the SP step's measured peak is {ratio:.3f}x "
                             "the dry run's prediction, outside 0.8-1.25")
    out = dict(ranks={str(w): [{p: x[p] for p in SLICE14_PARTS[w].split(
        ",")} for x in r] for w, r in res.items()}, dryrun=dict(
        predicted=dry, peak_ratio=ratio),
        phase_s=time.perf_counter() - t_phase + tp["slice14_s"])
    log(f"[slice14] phase 23: {out['phase_s']:.1f} s on {card}")
    return out


def metro_day(cells, domains):
    """The metro day (``metro_diurnal_trace(cells, n_domains=domains)``,
    24 hours) stacked group-major at a pow2 Tmax, as
    ``solve_greedy_sharded`` stacks it."""
    from repro_torch.core import next_pow2, scenarios, stack_instances
    t0 = time.perf_counter()
    insts, meta = scenarios.metro_diurnal_trace(cells, n_domains=domains)
    natural = max(i.num_tasks for i in insts)
    stacked = stack_instances(insts, group_major=True,
                              tmax=next_pow2(natural))
    log(f"[sharded] metro day {cells} cells x 24 h: {stacked.batch_size} "
        f"rows, {stacked.num_groups} coupling groups, "
        f"{int(stacked.task_mask.sum())} tasks, Tmax {natural} -> "
        f"{stacked.max_tasks}, built in {time.perf_counter() - t0:.1f} s")
    return insts, meta, stacked


def same_solutions(want, got, what: str) -> None:
    import numpy as np
    for i, (a, b) in enumerate(zip(want, got)):
        if not (np.array_equal(a.admitted, b.admitted)
                and np.array_equal(a.alloc, b.alloc)
                and np.array_equal(a.z, b.z)):
            raise AssertionError(f"{what}: instance {i} decides otherwise")
    if len(want) != len(got):
        raise AssertionError(f"{what}: {len(got)} solutions, not "
                             f"{len(want)}")


def phase_sharded_solve(dev, cells=METRO_CELLS, domains=METRO_DOMAINS,
                        shards=METRO_SHARDS, reps=3):
    """SLICE 7'S MAIN PATH, the sharded metro solve: ``solve_greedy_sharded``
    over ``make_cells_mesh(n, devices=[card])`` for each n, decisions bit
    for bit those of the meshless ``solve_greedy_batch`` (K1) and of its
    ``inner="torch"`` twin, sampled coupling groups against
    ``solve_coupled_ref``; one ``batch_solve`` launch and one host sync a
    solve, no one-round launch (counts zeroed before each n, read after).
    Returns {n: ms a solve, K1 device us, clusters, launches}."""
    import numpy as np
    import torch
    from repro_torch.core import (device_stack, device_stack_sharded,
                                  solve_coupled_ref, solve_greedy_batch,
                                  solve_greedy_sharded)
    from repro_torch.core.greedy import _to_input_order
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.launch.mesh import make_cells_mesh
    insts, meta, stacked = metro_day(cells, domains)
    t0 = time.perf_counter()
    want = _to_input_order(stacked, solve_greedy_batch(
        stacked, inner="kernel", device=dev))
    meshless_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    twin = _to_input_order(stacked, solve_greedy_batch(
        stacked, inner="torch", device=dev))
    twin_ms = (time.perf_counter() - t0) * 1e3
    same_solutions(want, twin, "meshless solve, kernel vs torch round")
    admitted = sum(int(s.admitted.sum()) for s in want)
    log(f"[sharded] meshless: {admitted} admitted; first solve "
        f"{meshless_ms:.1f} ms (upload included), torch twin "
        f"{twin_ms:.1f} ms; equal")
    rng = np.random.default_rng(5)
    steps = sorted({m["step"] for m in meta})
    for step, domain in zip(rng.choice(steps, 4, replace=False),
                            rng.choice(domains, 4, replace=False)):
        idxs = [i for i, m in enumerate(meta)
                if m["step"] == step and m["domain"] == domain]
        for i, ref in zip(idxs, solve_coupled_ref([insts[i]
                                                   for i in idxs])):
            if not np.array_equal(want[i].admitted, ref.admitted):
                raise AssertionError(f"sharded: cell {i} (hour {step}, "
                                     f"domain {domain}) against "
                                     "solve_coupled_ref")
        log(f"[sharded] hour {step} domain {domain}: {len(idxs)} cells "
            "equal to solve_coupled_ref")
    out = {}
    for n in shards:
        mesh = make_cells_mesh(n, devices=[dev])
        PK.SOLVE_KERNEL.launches = 0
        PK.ROUND_KERNEL.launches = 0
        with SolveLog() as solves:
            t0 = time.perf_counter()
            got = solve_greedy_sharded(stacked, mesh=mesh)      # + upload
            first = (time.perf_counter() - t0) * 1e3
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = solve_greedy_sharded(stacked, mesh=mesh)
                times.append((time.perf_counter() - t0) * 1e3)
        solves.check_one_launch_each(f"sharded solve, {n} shards")
        if solves.solve != reps + 1 or PK.SOLVE_KERNEL.launches != reps + 1:
            raise AssertionError(f"sharded solve, {n} shards: "
                                 f"{solves.solve} launches for {reps + 1} "
                                 "solves")
        same_solutions(want, got, f"sharded solve, {n} shards")
        stack = device_stack(stacked, device=dev) if n == 1 \
            else device_stack_sharded(stacked, mesh).stacks[0]
        dus = device_us(lambda: PK.batch_solve(stack), "pg_solve_kernel",
                        iters=5)
        info = PK.solve_info()
        clusters = stack.group_csr.num_groups
        bound, by = bound_of(*solve_work(stack, PK.batch_solve(stack)))
        out[n] = dict(ms=float(np.median(times)), first_ms=first,
                      device_ms=None if dus is None else dus / 1e3,
                      bound_ms=bound, bound_by=by,
                      clusters=clusters, rows=int(stack.lat_ok.shape[0]),
                      cluster=info["cluster"], launches=solves.solve,
                      rounds=solves.results[-1][0])
        log(f"[sharded] {n} shard(s) on one card: {stack.lat_ok.shape[0]} "
            f"rows ({stack.lat_ok.shape[0] - stacked.batch_size} inert), "
            f"{clusters} clusters of {info['cluster']} CTAs, K1 bound "
            f"{bound * 1e3:.1f} us ({by}); "
            f"ms/solve median {np.median(times):.2f} (all "
            f"{[round(t, 2) for t in times]}; first {first:.1f} with the "
            f"upload); K1 device {fmt_us(dus)}; rounds "
            f"{solves.results[-1][0]}; {solves.solve} batch_solve launches "
            f"for {len(solves.results)} solves; decisions equal")
        if n == max(shards):
            check_solve(stack, f"metro {cells}-cell day, {n} shards")
    del stacked, insts
    return out


# --------------------------------------------------------------- phase 12

def fault_ticks(eng):
    """Outage, recovery, budget drift and semantic drift, each followed by
    a re-slice; returns each re-slice's (admitted, z) per cell."""
    def decided(out):
        return [[(d.admitted, d.z) for d in ds] for ds in out]
    cell = N_CELLS // 3
    steps = []
    eng.fail_cell(cell)
    steps.append(decided(eng.reslice()))
    eng.recover_cell(cell)
    steps.append(decided(eng.reslice()))
    eng.set_link_budgets(scale=0.6)
    steps.append(decided(eng.reslice()))
    eng.shift_semantics(scale=0.8)
    steps.append(decided(eng.reslice()))
    return steps


def session_counters(sesm):
    return dict(fresh_stacks=sesm.fresh_stacks,
                session_rebuilds=sesm.session_rebuilds,
                delta_rows=sesm.delta_rows, link_updates=sesm.link_updates,
                semantic_updates=sesm.semantic_updates,
                shard_replans=sesm.shard_replans)


def phase_metro_serving(dev, shards=8, standing=METRO_STANDING):
    """SLICE 7'S MAIN PATH, the metro serving engine: the 256-cell engine
    of ``benchmarks/sweep_perf.py:262-275`` (``standing`` requests a cell)
    on ``make_cells_mesh(shards, devices=[card])`` beside a meshless twin
    on the same card, through ``drive_closed_loop(horizon=HORIZON,
    process=True)``, an outage and recovery, budget and semantic drift;
    decisions equal at every tick, the counters as the twin's, one
    ``batch_solve`` launch and one host sync a re-slice (counts zeroed
    before, read after)."""
    import numpy as np
    import torch
    from repro_torch.core.sfesp import ShardedStack
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.kernels.resize import resize as PR
    from repro_torch.launch.mesh import make_cells_mesh
    metro = make_engine(dev, None, mesh=make_cells_mesh(shards,
                                                        devices=[dev]),
                        standing=standing)
    twin = make_engine(dev, None, standing=standing)
    PK.SOLVE_KERNEL.launches = 0
    PK.ROUND_KERNEL.launches = 0
    PR.RESIZE_KERNEL.launches = 0
    with SolveLog() as solves:
        recs, dec, ticks, wall = drive(metro)
        # the wrapped reslice goes on logging; keep the loop's own steps
        dec, ticks = list(dec), list(ticks)
        faults = fault_ticks(metro)
    launches = {"pg_solve": PK.SOLVE_KERNEL.launches,
                "pg_round": PK.ROUND_KERNEL.launches,
                "resize": PR.RESIZE_KERNEL.launches}
    sesm = metro.sesm
    sess = sesm._serve_session
    log(f"[metro-serve] {N_CELLS} cells on {shards} shards of one card, "
        f"{HORIZON} steps + 4 fault ticks: "
        f"{sum(r['admitted'] for r in recs)} admissions; K1 launches "
        f"{launches['pg_solve']} (one-round entry {launches['pg_round']}), "
        f"K3 launches {launches['resize']}; solves (rounds, host syncs) "
        f"{solves.results}")
    solves.check_one_launch_each("metro serving loop")
    if launches["pg_solve"] <= 0 or launches["resize"] <= 0:
        raise AssertionError(f"metro path did not run both kernels: "
                             f"{launches}")
    if not isinstance(sess.dev, ShardedStack) \
            or sess.dev.num_shards != shards:
        raise AssertionError("the metro session is not mesh-resident")
    trecs, tdec, tticks, twall = drive(twin)
    tdec, tticks = list(tdec), list(tticks)
    tfaults = fault_ticks(twin)
    if trecs != recs:
        raise AssertionError("metro vs meshless: loop records differ")
    if len(dec) != len(tdec) or dec != tdec:
        raise AssertionError("metro vs meshless: decisions differ in the "
                             "closed loop")
    if faults != tfaults:
        raise AssertionError("metro vs meshless: decisions differ in the "
                             "fault ticks")
    mc, tc = session_counters(sesm), session_counters(twin.sesm)
    log(f"[metro-serve] counters metro {mc}; meshless {tc}")
    if mc["shard_replans"] != mc["fresh_stacks"] or tc["shard_replans"]:
        raise AssertionError("shard_replans != fresh_stacks")
    for key in ("fresh_stacks", "session_rebuilds", "delta_rows",
                "link_updates", "semantic_updates"):
        if mc[key] != tc[key]:
            raise AssertionError(f"metro vs meshless: {key} differs")
    if mc["link_updates"] < 1 or mc["semantic_updates"] < 1:
        raise AssertionError("drift did not ride the in-place scatters")
    # steady ticks: with no event, a tick's rejected requests use up their
    # retries and drop (dirty rows) until the cells settle; from then on a
    # tick scatters nothing and replans nothing, with one solve launch.
    # Both engines tick in lockstep and must still decide alike.
    def decided(out):
        return [[(d.admitted, d.z) for d in ds] for ds in out]
    settle = 0
    while True:
        before = session_counters(sesm)
        solves_before = PK.SOLVE_KERNEL.launches
        got = decided(metro.reslice())
        after = session_counters(sesm)
        if PK.SOLVE_KERNEL.launches != solves_before + 1:
            raise AssertionError("a steady metro tick was not one launch")
        if got != decided(twin.reslice()):
            raise AssertionError("metro vs meshless: a settling tick "
                                 "decides otherwise")
        if after == before:
            break
        settle += 1
        if settle > 2 * 3 + 2:                  # max_retries is 3
            raise AssertionError(f"the metro session never settled: "
                                 f"{before} -> {after}")
    check_solve(sess.dev.stacks[0], f"metro serving session, {shards} shards")
    log(f"[metro-serve] metro and meshless decided identically at all "
        f"{len(dec)} loop steps, 4 fault ticks and {settle + 1} steady "
        f"ticks; after {settle} settling tick(s) a steady tick scattered "
        f"0 dirty rows, made 0 replans and 1 batch_solve launch")
    log(f"[metro-serve] re-slice ms/tick in the loop (vision jobs between "
        f"ticks): metro median {np.median(ticks):.1f} (all "
        f"{[round(t, 1) for t in ticks]}), meshless median "
        f"{np.median(tticks):.1f} (all {[round(t, 1) for t in tticks]}); "
        f"loop wall ms/step metro {wall / HORIZON:.1f}, meshless "
        f"{twall / HORIZON:.1f}")
    # steady ticks in alternation, so order and warm-up fall on both
    steady = {"metro": [], "meshless": []}
    for r in range(6):
        pair = (("metro", metro), ("meshless", twin))
        for name, eng in pair if r % 2 == 0 else pair[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.reslice()
            torch.cuda.synchronize()
            steady[name].append((time.perf_counter() - t0) * 1e3)
    log(f"[metro-serve] steady re-slice ms, alternating: metro median "
        f"{np.median(steady['metro']):.2f} (all "
        f"{[round(t, 2) for t in steady['metro']]}), meshless median "
        f"{np.median(steady['meshless']):.2f} (all "
        f"{[round(t, 2) for t in steady['meshless']]})")
    stack = sess.dev.stacks[0]
    k1_us = device_us(lambda: PK.batch_solve(stack), "pg_solve_kernel",
                      iters=20)
    log(f"[metro-serve] K1 on the session stack ({stack.lat_ok.shape[0]} "
        f"rows, {stack.group_csr.num_groups} clusters): device "
        f"{fmt_us(k1_us)}")
    # a trace of this tick has come back without its first kernels (no
    # pg_solve_kernel, 11 of 20 launches) although K1 launched: profile
    # again, and say so, rather than report a busy time without the solve
    for attempt in range(3):
        solves_before = PK.SOLVE_KERNEL.launches
        wall_us, kern, count = profile_call(metro.reslice,
                                            "steady metro tick")
        solve_us = sum(us for name, us in kern.items()
                       if "pg_solve_kernel" in name)
        if solve_us > 0:
            break
        log(f"[trace] that trace holds no pg_solve_kernel, though K1 "
            f"launched {PK.SOLVE_KERNEL.launches - solves_before} times "
            f"(warm and profiled call); trace {attempt + 1} of 3")
    launches.update(
        reslice_ms_median=float(np.median(ticks)),
        meshless_reslice_ms_median=float(np.median(tticks)),
        steady_ms_median=float(np.median(steady["metro"])),
        meshless_steady_ms_median=float(np.median(steady["meshless"])),
        session_solve_device_ms=None if k1_us is None else k1_us / 1e3,
        tick=dict(launches=count, wall_ms=wall_us / 1e3,
                  busy_ms=sum(kern.values()) / 1e3,
                  solve_device_us=solve_us if solve_us > 0 else None,
                  traces=attempt + 1))
    return launches


# --------------------------------------------------------------- phase 10

def interleaved(fns: dict, reps: int = 5, iters: int = 200,
                warm: int = 5) -> dict:
    """Per-call ms of each of ``fns``: CUDA events around ``iters``
    back-to-back calls, the functions taken in turn, ``reps`` times →
    {name: {"median", "min", "max"}} over the repeats. Comparing within
    one alternation keeps a host or a card that drifts during the run from
    favouring either side, and the range shows how far it drifted."""
    import statistics
    times = {k: [] for k in fns}
    for fn in fns.values():
        cuda_ms(fn, iters=warm, warmup=warm)
    for _ in range(reps):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=iters, warmup=1))
    return {k: dict(median=statistics.median(v), min=min(v), max=max(v))
            for k, v in times.items()}


def fmt_spread(x: dict) -> str:
    return f"{x['median']:.4f} ms [{x['min']:.4f}, {x['max']:.4f}]"


def alternating_ms(fns: dict, reps: int = 5, iters: int = 200) -> dict:
    """The median of each of :func:`interleaved`'s times."""
    return {k: v["median"] for k, v in interleaved(fns, reps, iters).items()}


def host_us(steps: dict, iters: int = 2000, reps: int = 5) -> dict:
    """Host time per call of each step of a wrapper, in µs: the median over
    ``reps`` runs of ``iters`` calls timed with ``perf_counter_ns`` (the
    device is synchronized between runs, so a launch step measures the
    enqueue)."""
    import statistics
    import torch
    out = {}
    for name, fn in steps.items():
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter_ns() - t0) / iters / 1e3)
        torch.cuda.synchronize()
        out[name] = statistics.median(runs)
    return out


def fmt_steps(steps: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in steps.items())


def bound_of(nbytes, ops):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``ops`` float32
    operations on the H100's peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def k2_path_inputs(inst, dev):
    """K2's inputs on the first round of ``inst``'s SEM-O-RAN solve:
    sel = the gradient at zero occupancy, the instance's latency mask, every
    allocation within capacity, the candidate tasks alive."""
    import numpy as np
    import torch
    from repro_torch.core.greedy import primal_gradient
    from repro_torch.core.sfesp import _f32
    lat_ok = inst.lat <= inst.tasks.max_latency[:, None]
    alive = (inst.z_star_idx >= 0) & lat_ok.any(axis=1)
    grid, cap = _f32(inst.grid, dev), _f32(inst.pool.capacity, dev)
    sel = primal_gradient(grid, _f32(inst.pool.price, dev), cap,
                          torch.zeros_like(cap))
    cap_ok = (grid <= cap[None, :] + 1e-9).all(dim=1)
    return [sel, torch.from_numpy(lat_ok).to(dev), cap_ok,
            torch.from_numpy(np.ascontiguousarray(alive)).to(dev)]


def time_k2(dev, big, launches, k2_err):
    """K2 at the evaluation path's shape (T = 200, A = 1280, the first
    round of the SEM-O-RAN solve): the admission round (the path's entry)
    and the ``masked_argmax`` entry, each beside its plain version, the
    masked entry beside ``torch.max`` over the materialized score, in
    alternation; device times; a host breakdown of each wrapper."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import current_stream
    from repro_torch.kernels.pg import pg as PK
    ins = k2_path_inputs(big, dev)
    t, a = ins[1].shape
    neg = torch.tensor(float("-inf"), device=dev)
    score = torch.where(ins[1] & ins[2][None, :] & ins[3][:, None],
                        ins[0][None, :], neg)
    g = ins[0].new_empty(t)
    idx = ins[0].new_empty(t, dtype=torch.int32)
    ptrs = [x.data_ptr() for x in ins]
    am = alternating_ms({
        "kernel": lambda: PK.masked_argmax(*ins),
        "library": lambda: torch.max(score, dim=1),
        "plain": lambda: PK.masked_argmax_ref(*ins)})
    k2_dev = device_us(lambda: PK.masked_argmax(*ins), "masked_argmax")
    # each input read once (mask T*A, sel 4A, cap_ok A, alive T), each
    # output written once (g 4T, idx 4T); one compare per (task, lane)
    a_bound, a_by = bound_of(t * a + 5 * a + t + 8 * t, t * a)
    a_host = host_us({
        "checks": lambda: PK._check_argmax(*ins),
        "outputs (new_empty, unbind, view)": lambda: (
            lambda o: (o[0].view(torch.float32), o[1]))(
                ins[0].new_empty((2, t), dtype=torch.int32).unbind(0)),
        "stream": lambda: current_stream(0),
        "ctypes call, T=0 (no launch)": lambda: PK.ARGMAX_KERNEL(
            *ptrs, 0, a, g.data_ptr(), idx.data_ptr(), current_stream(0)),
        "ctypes launch": lambda: PK.ARGMAX_KERNEL(
            *ptrs, t, a, g.data_ptr(), idx.data_ptr(), current_stream(0)),
        "whole call": lambda: PK.masked_argmax(*ins),
        "torch.max": lambda: torch.max(score, dim=1)})
    log(f"[time] K2 masked_argmax entry T={t} A={a} (first round of the "
        f"T=200 instance), alternating medians: kernel {am['kernel']*1e3:.1f}"
        f" us per call (device {fmt_us(k2_dev)}), torch.max over the score "
        f"{am['library']*1e3:.1f} us, plain {am['plain']*1e3:.1f} us, bound "
        f"{a_bound*1e3:.3f} us ({a_by}); host us per step: "
        f"{fmt_steps(a_host)}")
    for t2, a2 in ((50, 300), (50, 1280), (4096, 1280)):
        ins2 = k2_inputs(np.random.default_rng(4), t2, a2, dev)
        ms = cuda_ms(lambda: PK.masked_argmax(*ins2), iters=200)
        dus = device_us(lambda: PK.masked_argmax(*ins2), "masked_argmax")
        log(f"[time] K2 masked_argmax entry T={t2} A={a2}: kernel "
            f"{ms*1e3:.1f} us per call (device {fmt_us(dus)}), bound "
            f"{(t2 * a2 + 5 * a2 + 9 * t2) / HBM_BYTES_PER_S * 1e6:.3f} us")

    # the admission round along the T = 200 SEM-O-RAN solve: the solve's
    # rounds back to back from its first state (restored once per solve:
    # the round writes the state), the restore alone timed in the same
    # alternation and taken off; per round
    tables, alive0 = solve_tables(big, True, dev)
    m = tables[1].shape[1]
    state0 = round_state(alive0, m)
    state = tuple(x.clone() for x in state0)
    step = PK.bind_round(state, *tables, flexible=True)

    def restore():
        for x, x0 in zip(state, state0):
            x.copy_(x0)
    restore()
    n_rounds = 0
    while bool(state[3].any()):
        step()
        n_rounds += 1
    n_rounds += 1                      # and the no-op round that ends it

    def solve_rounds():
        restore()
        for _ in range(n_rounds):
            step()

    def plain_rounds():
        restore()
        for _ in range(n_rounds):
            PK.admission_round_ref(state, *tables, True)
    rm = alternating_ms({"restore": restore, "kernel": solve_rounds},
                        iters=20)
    rm["plain"] = alternating_ms({"restore": restore, "plain": plain_rounds},
                                 reps=3, iters=2)["plain"]
    r_dev = device_us(solve_rounds, "admission_round", iters=20)
    r_dev = None if r_dev is None else r_dev / n_rounds
    # mask T*A bytes, grid 4*A*m, price and cap 8m, the state read (alive
    # T, occupied 4m) and written (alive T, admitted 1, alloc_idx 4,
    # occupied 4m); T*A compares and the gradient's A*(10m+8) flops
    r_bound, r_by = bound_of(t * a + 4 * a * m + 8 * m + 2 * t + 8 * m + 5,
                             t * a + a * (10 * m + 8))
    r_host = host_us({
        "restore": restore,
        "ctypes launch": lambda: PK.ADMIT_KERNEL(step._ptr,
                                                 current_stream(0)),
        "whole call": step}, iters=500)
    row = dict(name="masked_argmax", route="cuda",
               source="src/repro_torch/kernels/csrc/masked_argmax.cu",
               replaces="src/repro/kernels/pg/pg.py:73",
               entry="admission_round",
               launches=launches["admission_round"], max_abs_err=k2_err,
               ms=(rm["kernel"] - rm["restore"]) / n_rounds,
               plain_ms=(rm["plain"] - rm["restore"]) / n_rounds,
               rounds_per_solve=n_rounds, bound_ms=r_bound,
               bound_by=r_by, library_ms=None,
               device_ms=None if r_dev is None else r_dev / 1e3,
               restore_ms=rm["restore"],
               argmax_launches=launches["masked_argmax"],
               argmax_ms=am["kernel"], argmax_plain_ms=am["plain"],
               argmax_library_ms=am["library"], argmax_bound_ms=a_bound,
               argmax_bound_by=a_by,
               argmax_device_ms=None if k2_dev is None else k2_dev / 1e3,
               argmax_host_us=a_host, host_us=r_host,
               t200_solve=launches["t200_solve"])
    log(f"[time] K2 admission round T={t} A={a} m={m}, the {n_rounds} "
        f"rounds of the T=200 SEM-O-RAN solve back to back, alternating "
        f"medians less the state restore ({rm['restore']*1e3:.1f} us), per "
        f"round: kernel "
        f"{row['ms']*1e3:.1f} us per call (device {fmt_us(r_dev)}), plain "
        f"{row['plain_ms']*1e3:.1f} us, bound {r_bound*1e3:.3f} us ({r_by});"
        f" host us per step: {fmt_steps(r_host)}")
    return row


def host_loop_over_batch_round(stack):
    """The previous route of the flexible batched solve: the host loop
    (a convergence sync every few rounds, the latency table re-packed per
    solve) with each round one launch of K1's one-round entry — the plain
    loop with ``greedy._flex_round_fn`` pointed at ``batch_round``."""
    from repro_torch.core import greedy as G
    from repro_torch.kernels.pg import pg as PK
    flex = G._flex_round_fn

    def kernel_round(lat_bits, grid, price, cap, a):
        return lambda occupied, alive: PK.batch_round(
            lat_bits, alive, grid, price, cap, occupied)
    G._flex_round_fn = kernel_round
    try:
        return PK.batch_solve_ref(stack)
    finally:
        G._flex_round_fn = flex


def solve_work(stack, out):
    """(bytes, flops) the solve must move and do on this run's data: each
    input read once (the bool mask, alive0, load, the grid, the pool state,
    the link budgets and the group rows), each output written once; the
    gradient of every lane once per cell and once more per admission."""
    rows, t, a = stack.lat_ok.shape
    m = stack.grid.shape[1]
    links = 0 if stack.link_cap is None else stack.link_cap.numel()
    csr = stack.group_csr
    groups = out[4].numel()
    ints = 0 if csr is None else sum(x.numel() for x in (
        csr.rows, csr.offsets, csr.links, csr.link_offsets, csr.cell_links,
        csr.cell_link_offsets))
    nbytes = (rows * t * a + rows * t + (4 * rows * t if links else 0)
              + 4 * a * m + 8 * rows * m + 4 * links + 4 * ints
              + rows * t + 4 * rows * t + 4 * rows * m + 4 * links
              + 4 * groups)
    flops = (rows + int(out[0].sum())) * a * (10 * m + 8)
    return nbytes, flops


def solve_breakdown(stack, rounds: int = 64) -> dict:
    """CTA 0's time in one solve of ``stack`` (``batch_solve``'s trace:
    ``%globaltimer`` stamps), the medians over its rounds in us: its
    candidates (with the rescore after an admission), its round pick, the
    wait at the cluster barrier with the read of the group's pick (the
    slowest CTA of the group sets it), and the admission."""
    import numpy as np
    import torch
    from repro_torch.kernels.pg import pg as PK
    trace = torch.zeros(2 + PK.TRACE_POINTS * rounds, dtype=torch.int64,
                        device=stack.grid.device)
    out = PK.batch_solve(stack, trace=trace)
    torch.cuda.synchronize()
    t = trace.cpu().numpy()
    n = min(int(out[4][0]), rounds) - 1     # the last round stops early
    steps = np.diff(t[2:2 + PK.TRACE_POINTS * n].reshape(
        n, PK.TRACE_POINTS), axis=1) / 1e3
    med = np.median(steps, axis=0) if n > 0 else np.zeros(4)
    out = dict(prologue=(t[1] - t[0]) / 1e3, candidates=med[0],
               pick=med[1], cluster_barrier=med[2], admission=med[3],
               rounds_of_group0=n + 1)
    log("[time] K1 serving solve, CTA 0's rounds (median us): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()))
    return out


def time_k1(dev, serve_stack, metro_stack, launches, k1_err):
    """K1 on the path: ``batch_solve`` on the serving loop's own stack and
    on the metro day, beside the previous route (the host loop over
    ``batch_round``) and the plain loop, in alternation; its device time
    against its bound, rounds, device us a round, and the kernel's
    registers and spills. Then the one-round entry at the serving shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.pg import pg as PK
    row = dict(name="pg_round", route="cuda",
               source="src/repro_torch/kernels/csrc/pg_round.cu",
               replaces="src/repro/kernels/pg/pg.py:182",
               entry="batch_solve", launches=launches["pg_solve"],
               launches_round_entry=launches["pg_round"],
               max_abs_err=k1_err, library_ms=None)
    for what, st in (("serving", serve_stack), ("metro", metro_stack)):
        out = PK.batch_solve(st)
        prev = host_loop_over_batch_round(st)
        torch.cuda.synchronize()
        info = PK.solve_info()
        for x, y in zip(out[:4], prev[:4]):
            if y is not None and not torch.equal(x, y):
                raise AssertionError(f"K1 {what}: the host loop over "
                                     "batch_round decides otherwise")
        rounds = int(out[4].max())
        am = alternating_ms({
            "kernel": lambda: PK.batch_solve(st),
            "host_loop": lambda: host_loop_over_batch_round(st),
            "plain": lambda: PK.batch_solve_ref(st)}, reps=3, iters=5)
        dus = device_us(lambda: PK.batch_solve(st), "pg_solve_kernel",
                        iters=20)
        nbytes, flops = solve_work(st, out)
        bound, by = bound_of(nbytes, flops)
        rows, t, a = st.lat_ok.shape
        pre = "" if what == "serving" else "metro_"
        row.update({f"{pre}ms": am["kernel"], f"{pre}plain_ms": am["plain"],
                    f"{pre}host_loop_ms": am["host_loop"],
                    f"{pre}device_ms": None if dus is None else dus / 1e3,
                    f"{pre}bound_ms": bound, f"{pre}bound_by": by,
                    f"{pre}rounds": rounds,
                    f"{pre}device_us_per_round":
                        None if dus is None else dus / max(rounds, 1),
                    f"{pre}shape": [rows, t, a, st.grid.shape[1],
                                    out[4].numel()],
                    f"{pre}plan": info})
        log(f"[time] K1 batch_solve {what} B={rows} T={t} A={a} "
            f"m={st.grid.shape[1]} ({out[4].numel()} groups, cluster "
            f"{info['cluster']}, {info['smem_bytes']} B shared, "
            f"{info['registers']} registers, {info['local_bytes']} B local "
            f"(spills)): {am['kernel'] * 1e3:.1f} us per call (device "
            f"{fmt_us(dus)}) for {rounds} rounds ("
            + ("not measured" if dus is None else f"{dus / max(rounds, 1):.2f}")
            + f" us a round); the previous route (host loop over "
            f"batch_round) {am['host_loop']:.3f} ms, plain loop "
            f"{am['plain']:.3f} ms; bound {bound * 1e3:.3f} us ({by}, "
            f"{nbytes / 1e6:.2f} MB)")

    # where a round of the serving solve goes: CTA 0's phase stamps
    row["round_breakdown_us"] = solve_breakdown(serve_stack)

    # the one-round entry (the Pallas contract) at the serving shape
    rng = np.random.default_rng(2)
    tmax = serve_stack.max_tasks
    lat, words, rest = k1_inputs(rng, N_CELLS, tmax, 300, 2, dev)
    b, t, w = words.shape
    a, m = rest[1].shape
    rm = alternating_ms({
        "kernel": lambda: PK.batch_round(words, *rest),
        "plain": lambda: PK.batch_round_ref(lat, *rest)}, reps=3, iters=50)
    # per lane: m subs, muls, 2 divs, 2 muls, 3 adds, 1 compare
    r_bound, r_by = bound_of(
        b * t * w * 4 + b * t + a * m * 4 + 3 * b * m * 4 + b * 12,
        b * a * (10 * m + 8))
    r_dev = device_us(lambda: PK.batch_round(words, *rest), "pg_round")
    row.update(round_ms=rm["kernel"], round_plain_ms=rm["plain"],
               round_bound_ms=r_bound, round_bound_by=r_by,
               round_device_ms=None if r_dev is None else r_dev / 1e3)
    log(f"[time] K1 batch_round (one round, on no path) B={b} T={t} W={w} "
        f"A={a}: {rm['kernel'] * 1e3:.1f} us per call (device "
        f"{fmt_us(r_dev)}), plain {rm['plain'] * 1e3:.1f} us, bound "
        f"{r_bound * 1e3:.3f} us ({r_by})")
    return row


def time_kernels(dev, zs, launches, k3_err):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels._build import current_stream
    from repro_torch.kernels.resize import ops as PO
    from repro_torch.kernels.resize import resize as PR
    rng = np.random.default_rng(2)

    # K3 at the main path's shape: a job batch of 5 frames of 128x128x3 at
    # the compression the engine admitted most often, through the wrapper
    # and the path's entry (compress_frames), beside F.interpolate, in
    # alternation
    vals, counts = np.unique(np.round(zs, 6), return_counts=True)
    z = float(vals[counts.argmax()])
    img = torch.from_numpy(rng.standard_normal((5, 128, 128, 3)).astype(
        np.float32)).to(dev)
    ho, wo = PR.out_size_for_z(128, 128, z)
    nchw = img.permute(0, 3, 1, 2)
    out = PR.resize_bilinear(img, ho, wo)
    k3 = dict(name="resize", route="cuda",
              source="src/repro_torch/kernels/csrc/resize.cu",
              replaces="src/repro/kernels/resize/resize.py:40",
              launches=launches["resize"], max_abs_err=k3_err)
    k3m = alternating_ms({
        "kernel": lambda: PR.resize_bilinear(img, ho, wo),
        "library": lambda: F.interpolate(nchw, size=(ho, wo),
                                         mode="bilinear",
                                         align_corners=False),
        "compress_frames": lambda: PO.compress_frames(img, z),
        "plain": lambda: PR.resize_bilinear_ref(img, ho, wo)})
    k3.update(ms=k3m["kernel"], library_ms=k3m["library"],
              plain_ms=k3m["plain"], compress_frames_ms=k3m["compress_frames"])
    # bytes: the input pixels the taps touch (rows x columns used), once
    rows, cols = (len(np.unique(i[wt > 0])) for i, wt in (
        PR.resize_taps(ho, 128), PR.resize_taps(wo, 128)))
    k3["bound_ms"], k3["bound_by"] = bound_of(
        5 * rows * cols * 3 * 4 + 5 * ho * wo * 3 * 4, 5 * ho * wo * 3 * 6)
    k3_dev = device_us(lambda: PR.resize_bilinear(img, ho, wo), "resize")
    k3["device_ms"] = None if k3_dev is None else k3_dev / 1e3
    k3["host_us"] = host_us({
        "out_size_for_z": lambda: PR.out_size_for_z(128, 128, z),
        "checks": lambda: PR._check(img, ho, wo),
        "new_empty": lambda: img.new_empty((5, ho, wo, 3)),
        "stream": lambda: current_stream(0),
        "ctypes call, B=0 (no launch)": lambda: PR.RESIZE_KERNEL(
            img.data_ptr(), 0, 0, 128, 128, 3, ho, wo, out.data_ptr(),
            current_stream(0)),
        "ctypes launch": lambda: PR.RESIZE_KERNEL(
            img.data_ptr(), 0, 5, 128, 128, 3, ho, wo, out.data_ptr(),
            current_stream(0)),
        "whole call": lambda: PR.resize_bilinear(img, ho, wo),
        "compress_frames": lambda: PO.compress_frames(img, z),
        "F.interpolate": lambda: F.interpolate(
            nchw, size=(ho, wo), mode="bilinear", align_corners=False)})
    log(f"[time] K3 5x128x128x3 z={z:.4f} -> {ho}x{wo}, alternating "
        f"medians: kernel {k3['ms']*1e3:.1f} us per call (device "
        f"{fmt_us(k3_dev)}), compress_frames "
        f"{k3m['compress_frames']*1e3:.1f} us, "
        f"F.interpolate {k3['library_ms']*1e3:.1f} us, plain "
        f"{k3['plain_ms']*1e3:.1f} us, bound {k3['bound_ms']*1e3:.3f} us "
        f"({k3['bound_by']}); host us per step: {fmt_steps(k3['host_us'])}")

    # the largest frames of phase 4, for the record
    big = torch.from_numpy(rng.standard_normal((8, 1024, 2048, 3)).astype(
        np.float32)).to(dev)
    bh, bw = PR.out_size_for_z(1024, 2048, 0.25)
    bigm = alternating_ms({
        "kernel": lambda: PR.resize_bilinear(big, bh, bw),
        "library": lambda: F.interpolate(
            big.permute(0, 3, 1, 2), size=(bh, bw), mode="bilinear",
            align_corners=False)}, reps=3, iters=20)
    big_dev = device_us(lambda: PR.resize_bilinear(big, bh, bw), "resize",
                        10)
    big_bytes = (8 * 1024 * 2048 * 3 + 8 * bh * bw * 3) * 4
    k3.update(big_ms=bigm["kernel"],
              big_device_ms=None if big_dev is None else big_dev / 1e3,
              big_library_ms=bigm["library"],
              big_bound_ms=big_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"[time] K3 8x1024x2048x3 z=0.25: kernel {bigm['kernel']:.3f} ms "
        f"(device {fmt_us(big_dev)}), F.interpolate {bigm['library']:.3f} ms, full-input byte bound "
        f"{k3['big_bound_ms']:.3f} ms")
    return k3


def k4_work(shape, esize):
    """(bytes, flops) K4 must move and do for ``shape``: q, k, v read once
    and o written once; 4·Dh flops (two products) per (query, key) pair the
    mask keeps."""
    b, tq, tk, hq, hkv, dh, causal = shape
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    nbytes = (2 * b * tq * hq * dh + 2 * b * tk * hkv * dh) * esize
    return nbytes, 4 * dh * pairs * b * hq


def tc_report(log_text: str | None):
    """The tensor-core kernel's ptxas lines (when this run built it) and
    each instantiation's launch configuration, from the library itself."""
    import ctypes
    from repro_torch.kernels.attn import attn as PA
    for line in (log_text or "").splitlines():
        if "flash_tc_kernel" in line or "registers" in line \
                or "spill" in line or "smem" in line:
            log(f"[ptxas] flash_attn_tc.cu: {line.strip()[:160]}")
    fn = PA.FLASH_TC_KERNEL.library().flash_attn_tc_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    report = {}
    for dh in (64, 128, 256):
        code = fn(dh, out)
        if code != 0:
            raise RuntimeError(f"flash_attn_tc_info({dh}): CUDA error {code}")
        report[dh] = dict(threads=out[0], smem_bytes=out[1],
                          registers=out[2], spill_bytes=out[3],
                          stages=out[4], keys_per_tile=out[5])
        log(f"[ptxas] flash_tc_kernel for Dh <= {dh}: {out[0]} threads, "
            f"{out[1]} B dynamic shared memory, {out[2]} registers at "
            f"launch (setmaxnreg: producer 24, consumers 240), {out[3]} B "
            f"local (spills), {out[4]} K/V stages of {out[5]} keys")
    return report


def bwd_tc_report(log_text: str | None):
    """The tensor-core K4′'s ptxas lines (when this run built it) and the
    launch configuration of its dQ and dK/dV kernels at each padded head
    width, from the library."""
    import ctypes
    from repro_torch.kernels.attn import attn as PA
    for line in (log_text or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] flash_attn_bwd_tc.cu: {line.strip()[:160]}")
    fn = PA.FLASH_BWD_TC_KERNEL.library().flash_attn_bwd_tc_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    report = {}
    for p, what in ((0, "dq"), (1, "dkdv")):
        for dh in (64, 128, 256):
            code = fn(p, dh, out)
            if code != 0:
                raise RuntimeError(f"flash_attn_bwd_tc_info({p}, {dh}): CUDA "
                                   f"error {code}")
            report[f"{what}_{dh}"] = dict(
                threads=out[0], smem_bytes=out[1], registers=out[2],
                spill_bytes=out[3], stages=out[4], producer_regs=out[5],
                consumer_regs=out[6], keys=out[7])
            log(f"[ptxas] bwd_tc_{what}_kernel for Dh <= {dh}: {out[0]} "
                f"threads, {out[1]} B dynamic shared memory, {out[2]} "
                f"registers at launch (setmaxnreg: producer {out[5]}, "
                f"consumers {out[6]}), {out[3]} B local (spills), {out[4]} "
                f"stages, {out[7]} keys a {'tile' if p == 0 else 'block'}")
    return report


def core_report() -> dict:
    """The CUDA-core K4's and K4′'s instantiations (``flash_fwd_kernel``,
    with its 64-row tiles for short grids at Dh <= 128, ``bwd_dq_kernel``,
    ``bwd_dkdv_kernel``, by type and head-width tile),
    from the libraries (``cudaFuncGetAttributes``): threads, dynamic
    shared memory, registers and local (spill) bytes a thread, stages of
    the ring, query rows and keys a tile. Logs each and the spills."""
    import ctypes
    from repro_torch.kernels.attn import attn as PA
    fwd = PA.FLASH_CORE_KERNEL.library().flash_attn_info
    fwd.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
    bwd = PA.FLASH_BWD_CORE_KERNEL.library().flash_attn_bwd_info
    bwd.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
    fwd.restype = bwd.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    report = {}
    for dtype, tname in ((0, "f32"), (1, "bf16")):
        for dh in (64, 128, 256, 512):
            short = (("flash_fwd_short_grid", fwd, (dtype, dh, 1)),) \
                if dh <= 128 else ()
            for what, fn, args in (("flash_fwd", fwd, (dtype, dh, 0)),
                                   *short,
                                   ("bwd_dq", bwd, (0, dtype, dh)),
                                   ("bwd_dkdv", bwd, (1, dtype, dh))):
                code = fn(*args, out)
                if code != 0:
                    raise RuntimeError(f"{what} info {tname} Dh {dh}: CUDA "
                                       f"error {code}")
                report[f"{what}_{tname}_{dh}"] = x = dict(
                    threads=out[0], smem_bytes=out[1], registers=out[2],
                    spill_bytes=out[3], stages=out[4], rows=out[5],
                    keys=out[6])
                log(f"[ptxas] {what}_kernel {tname} Dh <= {dh}: "
                    f"{x['threads']} threads, {x['smem_bytes']} B dynamic "
                    f"shared memory, {x['registers']} registers, "
                    f"{x['spill_bytes']} B local (spills), {x['stages']} "
                    f"stages, {x['rows']} x {x['keys']} tiles")
    spills = {k: x["spill_bytes"] for k, x in report.items()
              if x["spill_bytes"]}
    log(f"[ptxas] the CUDA-core K4 and K4′: {len(report)} instantiations, "
        + (f"local bytes in {spills}" if spills else "none spills"))
    return report


def time_k4(dev, engine_shapes, launches, prefill_launches, err, ptxas):
    """K4 at the engine's LM job shape and at the 2048-token prefill: the
    tensor-core kernel (the path's), the CUDA-core kernel on the same bf16
    inputs (the old design) and in float32, its plain version and SDPA;
    then each kernel writing the LSE (as a training forward does): its
    output bit for bit the path's, the LSE within ``K4_LSE_TOL`` of the
    plain version's, and its time; the float32 kernel, with and without
    the LSE, and float32 SDPA in turn (median and range over 5 repeats).
    Returns the tensor-core kernel's row and the CUDA-core kernel's."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn import attn as PA
    rng = np.random.default_rng(6)
    row = dict(name="flash_attn", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attn_tc.cu",
               replaces="src/repro/kernels/attn/attn.py:63",
               k4_route="tensor_cores",
               launches=launches["flash_attn_tc"],
               launches_prefill_2048=prefill_launches,
               max_abs_err=err["tensor_cores", "bfloat16"],
               lse_max_abs_err=err["tensor_cores", "lse"],
               max_abs_err_f32=err["cuda_cores", "float32"],
               max_abs_err_bf16_cuda_cores=err["cuda_cores", "bfloat16"],
               cuda_core_source="src/repro_torch/kernels/csrc/flash_attn.cu",
               tc_kernel=tc_report(ptxas))
    core_row = dict(name="flash_attn_cuda_cores", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attn.cu",
                replaces="src/repro/kernels/attn/attn.py:63",
                k4_route="cuda_cores", dtype="float32",
                max_abs_err=err["cuda_cores", "float32"],
                max_abs_err_bf16=err["cuda_cores", "bfloat16"],
                lse_max_abs_err=err["cuda_cores", "lse"],
                kernel_info=core_report(), shapes={})
    qs, ks, dt, causal = max(engine_shapes)     # the largest LM batch
    big = (PREFILL_B, PREFILL_T, PREFILL_T, 32, 2, 128, True)
    engine = (qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], causal)
    # the engine's LM batches, batches of 8 LM jobs, the prefill; slice 8's
    # qwen3-moe prefill (G = 16) and whisper-tiny encoder (non-causal, G = 1)
    lm8 = (8, 16, 16, 32, 2, 128, True)
    for what, shape in (("engine", engine), ("lm_job_b8", lm8),
                        ("prefill", big),
                        ("qwen3", (2, 2048, 2048, 64, 4, 128, True)),
                        ("whisper_enc", (2, 1500, 1500, 6, 6, 64, False))):
        q, k, v = k4_inputs(rng, shape, dev, dt.removeprefix("torch."))
        causal = shape[-1]
        iters = 200 if what in ("engine", "lm_job_b8") else 20
        tc = PA.flash_attention_fwd
        if PA.route(q.dtype, q.shape[3]) != "tensor_cores":
            raise AssertionError(f"K4 {shape} {q.dtype} is not routed to the "
                                 "tensor cores")
        ms = cuda_ms(lambda: tc(q, k, v, causal=causal), iters=iters)
        dev_us = device_us(lambda: tc(q, k, v, causal=causal),
                           "flash_tc_kernel", iters=iters)
        core = cuda_ms(lambda: PA.launch("cuda_cores", q, k, v,
                                         causal=causal), iters=iters)
        core_us = device_us(lambda: PA.launch("cuda_cores", q, k, v,
                                              causal=causal),
                            "flash_fwd_kernel", iters=iters)
        qf, kf, vf = (x.float() for x in (q, k, v))
        core32 = cuda_ms(lambda: PA.flash_attention_fwd(qf, kf, vf,
                                                        causal=causal),
                         iters=iters)
        core32_us = device_us(lambda: PA.flash_attention_fwd(
            qf, kf, vf, causal=causal), "flash_fwd_kernel", iters=iters)
        qft, kft, vft = (x.transpose(1, 2) for x in (qf, kf, vf))
        f32 = interleaved({
            "k4": lambda: PA.flash_attention_fwd(qf, kf, vf, causal=causal),
            "k4_lse": lambda: PA.launch("cuda_cores", qf, kf, vf,
                                        causal=causal, with_lse=True),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qft, kft, vft, is_causal=causal, enable_gqa=True)},
            reps=5, iters=max(iters // 4, 5), warm=2)
        del qft, kft, vft
        plain = cuda_ms(lambda: PA.flash_attention_fwd_ref(
            q, k, v, causal=causal), iters=10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=iters)
        lib_err = (F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
            .float() - tc(q, k, v, causal=causal).float()).abs().max().item()
        nbytes, flops = k4_work(shape, q.element_size())
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S \
            else "operations"
        f32_bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) \
            * 1e3
        tflops = None if dev_us is None else flops / dev_us / 1e6
        log(f"[time] K4 {what} {shape} {q.dtype}: tensor-core kernel "
            f"{ms * 1e3:.1f} us per call (device {fmt_us(dev_us)}"
            + ("" if tflops is None else f", {tflops:.0f} TFLOP/s, "
               f"{100 * bound * 1e3 / dev_us:.1f} % of the bound")
            + f"); CUDA-core kernel bf16 {core * 1e3:.1f} us (device "
            f"{fmt_us(core_us)}), f32 {core32 * 1e3:.1f} us (device "
            f"{fmt_us(core32_us)}); plain {plain * 1e3:.1f} us; SDPA "
            f"{lib * 1e3:.1f} us (max diff to K4 {lib_err:.3g}); "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP: bound "
            f"{bound * 1e3:.3f} us ({by}, bf16 peak), f32 CUDA-core bound "
            f"{f32_bound * 1e3:.1f} us")
        ms_of = (lambda us: None if us is None else us / 1e3)
        pre = {"prefill": "", "engine": "engine_", "lm_job_b8": "lm8_",
               "qwen3": "qwen3_", "whisper_enc": "whisper_enc_"}[what]
        row.update({f"{pre}ms": ms, f"{pre}device_ms": ms_of(dev_us),
                    f"{pre}plain_ms": plain, f"{pre}library_ms": lib,
                    f"{pre}bound_ms": bound, f"{pre}shape": list(shape[:6]),
                    f"{pre}cuda_core_bf16_ms": core,
                    f"{pre}cuda_core_bf16_device_ms": ms_of(core_us),
                    f"{pre}cuda_core_f32_ms": core32,
                    f"{pre}cuda_core_f32_device_ms": ms_of(core32_us)})
        if what == "prefill":
            row.update(bound_by=by, bound_ms_f32_cuda_cores=f32_bound)
        # the training forward's launch: the same output, and the LSE
        out_l, lse = PA.launch("tensor_cores", q, k, v, causal=causal,
                               with_lse=True)
        _, lref = PA.flash_attention_fwd_ref(qf, kf, vf, causal=causal,
                                             with_lse=True)
        lse_err = (lse - lref).abs().max().item()
        if not torch.equal(out_l, tc(q, k, v, causal=causal)) \
                or not lse_err <= K4_LSE_TOL:
            raise AssertionError(f"K4 {what} {shape}: with the LSE written "
                                 "the output differs, or the LSE is "
                                 f"{lse_err:.3g} from the plain LSE")
        del out_l, lse
        lse_ms = cuda_ms(lambda: PA.launch("tensor_cores", q, k, v,
                                           causal=causal, with_lse=True),
                         iters=iters)
        log(f"[time] K4 {what} {shape}: writing the LSE {lse_ms * 1e3:.1f} "
            f"us per call (without {ms * 1e3:.1f}); the output bit for bit "
            f"the same, the LSE within {lse_err:.3g} of the plain LSE (bound "
            f"{K4_LSE_TOL})")
        row.update({f"{pre}lse_ms": lse_ms, f"{pre}lse_max_abs_err": lse_err})
        # the float32 kernel writing the LSE: the same output, the LSE
        # within the bound; its times in turn with float32 SDPA's
        out_l, lse = PA.launch("cuda_cores", qf, kf, vf, causal=causal,
                               with_lse=True)
        lse32_err = (lse - lref).abs().max().item()
        if not torch.equal(out_l, PA.flash_attention_fwd(
                qf, kf, vf, causal=causal)) or not lse32_err <= K4_LSE_TOL:
            raise AssertionError(f"K4 {what} {shape} float32: with the LSE "
                                 "written the output differs, or the LSE is "
                                 f"{lse32_err:.3g} from the plain LSE")
        del out_l, lse
        f32_by = "bytes" if 2 * nbytes / HBM_BYTES_PER_S \
            >= flops / F32_FLOP_PER_S else "operations"
        f32_bound_ms = max(2 * nbytes / HBM_BYTES_PER_S,
                           flops / F32_FLOP_PER_S) * 1e3
        log(f"[time] K4 {what} {shape} float32 on the CUDA cores, in turn "
            f"(5 repeats, median [least, largest]): "
            + ", ".join(f"{n} {fmt_spread(x)}" for n, x in f32.items())
            + f"; device {fmt_us(core32_us)}; bound {f32_bound_ms:.4f} ms "
            f"({f32_by}); the LSE within {lse32_err:.3g} of the plain LSE, "
            "the output bit for bit")
        core_row["shapes"][what] = dict(
            shape=list(shape), interleaved=f32, device_ms=ms_of(core32_us),
            plain_ms=plain, bound_ms=f32_bound_ms, bound_by=f32_by,
            lse_max_abs_err=lse32_err)
        if what == "prefill":
            core_row.update(
                ms=f32["k4"]["median"], device_ms=ms_of(core32_us),
                plain_ms=plain, library_ms=f32["sdpa"]["median"],
                bound_ms=f32_bound_ms, bound_by=f32_by,
                shape=list(shape[:6]), lse_ms=f32["k4_lse"]["median"])
        # what the dry run's operator would cost the card, which skips it:
        # the entry (autograd Function, then the direct launch), the
        # operator (``torch.library`` dispatch, then the same launch) and
        # the direct launch, in one alternation; at the small shapes, each
        # one's host time a call too
        paths = {"entry": lambda: tc(q, k, v, causal=causal),
                 "op": lambda: PA._fwd_op(q, k, v, causal, False),
                 "launch": lambda: PA.launch("tensor_cores", q, k, v,
                                             causal=causal)}
        alt = alternating_ms(paths, iters=iters)
        host = host_us(paths, iters=500) if iters > 20 else None
        log(f"[time] K4 {what} {shape}: per call, in one alternation, "
            f"entry {alt['entry'] * 1e3:.2f} us, operator "
            f"{alt['op'] * 1e3:.2f} us, direct launch "
            f"{alt['launch'] * 1e3:.2f} us (operator - launch "
            f"{(alt['op'] - alt['launch']) * 1e3:.2f} us)"
            + ("" if host is None else f"; host us a call: "
               f"{fmt_steps(host)}"))
        row.update({f"{pre}dispatch_ms": alt, f"{pre}dispatch_host_us": host})
        del q, k, v, qt, kt, vt, qf, kf, vf, lref
    return row, core_row


def time_k4_long(dev) -> dict:
    """K4 at slice 19's prefill_32k shapes (``K4_LONG_SHAPES``), bf16 on
    the tensor cores (the route), and SDPA's forward on the same inputs in
    turn (median, least and largest of 5 repeats), beside the bound; its
    plain version (``k4_plain``, by blocks of query rows) once, and the
    kernel's device time from the profiler. Returns the rows by shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.attn import attn as PA
    rows = {}
    for shape in K4_LONG_SHAPES:
        q, k, v = k4_card_inputs(shape, dev, "bfloat16", seed=7)
        causal = shape[-1]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            # the memory-bounded backends only: the math one would hold
            # the (2, Hq, 32768, 32768) scores
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
        times = interleaved({
            "k4": lambda: PA.flash_attention_fwd(q, k, v, causal=causal),
            "sdpa": sdpa}, reps=5, iters=3, warm=1)
        dev_us = device_us(lambda: PA.flash_attention_fwd(
            q, k, v, causal=causal), "flash_tc_kernel", iters=3)
        lib_err = (sdpa().transpose(1, 2).float() - PA.flash_attention_fwd(
            q, k, v, causal=causal).float()).abs().max().item()
        plain = cuda_ms(lambda: k4_plain(q, k, v, causal), iters=1,
                        warmup=0)
        nbytes, flops = k4_work(shape, q.element_size())
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S \
            else "operations"
        key = f"{shape[3]}/{shape[4]}/{shape[5]}"
        rows[key] = dict(shape=list(shape[:6]), ms=times["k4"]["median"],
                         k4=times["k4"], sdpa=times["sdpa"],
                         library_ms=times["sdpa"]["median"],
                         device_ms=None if dev_us is None else dev_us / 1e3,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         sdpa_max_diff=lib_err)
        log(f"[time] K4 prefill_32k {shape} bf16, in turn with SDPA's "
            f"forward (5 repeats of 3 calls, median [least, largest]): K4 "
            f"{fmt_spread(times['k4'])}, SDPA {fmt_spread(times['sdpa'])} "
            f"({times['k4']['median'] / times['sdpa']['median']:.2f}x); K4's "
            f"device {fmt_us(dev_us)}; plain (by blocks) {plain:.1f} ms; "
            f"bound {bound:.3f} ms ({by}, {flops / 1e12:.2f} TFLOP at the "
            f"bf16 peak); SDPA's max diff to K4 {lib_err:.3g}")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# seconds by phase (the docstring's items), summed over a phase's parts
PHASE_S: dict = {}


class Phase:
    """Times one part of phase ``n`` (``what``) into ``PHASE_S`` and logs
    its seconds."""

    def __init__(self, n: int, what: str):
        self.n, self.what = n, what

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        secs = time.perf_counter() - self.t0
        PHASE_S[self.n] = PHASE_S.get(self.n, 0.0) + secs
        if exc[0] is None:
            log(f"[phase {self.n}] {self.what}: {secs:.1f} s")


def main() -> int:
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(sys.argv[2:])
    seed = SEED
    if sys.argv[1:2] == ["--seed"]:
        seed = int(sys.argv[2])
    elif sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; usage: "
              "chip_smoke.py [--seed N]", file=sys.stderr)
        return 2
    try:
        import numpy as np  # noqa: F401
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    with Phase(1, "the card and the kernels' build"):
        built = build_kernels()

    from repro_torch.core import next_pow2, scenarios, stack_instances
    t0 = time.perf_counter()
    insts, _ = scenarios.metro_diurnal_trace(N_CELLS, n_domains=N_DOMAINS)
    metro = stack_instances(
        insts, tmax=next_pow2(max(i.num_tasks for i in insts)))
    log(f"[metro] day batch: {metro.batch_size} rows, Tmax="
        f"{metro.max_tasks}, {int(metro.task_mask.sum())} tasks, built in "
        f"{time.perf_counter() - t0:.1f} s")

    with Phase(2, "K1"):
        k1_err = phase_k1(dev, metro)
        phase_k1_solve(dev, metro)
    with Phase(3, "K2"):
        k2_err, k2_rounds = phase_k2(dev)
    with Phase(4, "K3"):
        k3_err = phase_k3(dev)
    with Phase(8, "K4"):
        k4_err = phase_k4(dev)
    with Phase(15, "K4′"):
        k4b_rows = phase_k4_bwd(dev)
    with Phase(5, "the metro day's solve"):
        metro_stack = phase_metro_solve(dev, metro)
    with Phase(6, "slice 1, the serving loop"):
        launches, serve_stack, zs = phase_serving(dev)
    with Phase(7, "slice 2, the evaluation"):
        eval_launches, big = phase_evaluation(dev)
    with Phase(11, "slice 7, the sharded solve"):
        sharded = phase_sharded_solve(dev)
    with Phase(12, "slice 7, the metro serving engine"):
        metro_launches = phase_metro_serving(dev)
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    with Phase(9, "slice 3, chatglm3-6b's engine and prefill"):
        params = lm_model(dev, cfg)
        lm_launches, k4_shapes = phase_lm_serving(dev, cfg, params)
        phase_lm_prefill(dev, cfg, params)
    # slice 9 on the weights phases 9 and 13 draw, then gemma3-12b's
    decode = {}

    def decode_on(cfg, params):
        decode[cfg.name] = phase_decode(dev, cfg, params)
    decode_on(cfg, params)
    del params
    torch.cuda.empty_cache()
    with Phase(13, "slice 8, with slice 9's decodes of its models"):
        slice8 = phase_slice8(dev, decode=decode_on)
    PHASE_S[13] -= sum(decode[a]["phase_s"] for a in slice8
                       if a in decode)
    t0 = time.perf_counter()
    cfg9 = dataclasses.replace(get_config("gemma3-12b"),
                               n_layers=DECODE_GEMMA_LAYERS)
    params = lm_model(dev, cfg9)
    decode_on(cfg9, params)
    del params
    torch.cuda.empty_cache()
    decode_f32 = phase_decode_f32(dev)
    phase14_s = time.perf_counter() - t0 - decode[cfg9.name]["phase_s"] \
        + sum(row["phase_s"] for row in decode.values())
    log(f"[decode] phase 14: {phase14_s:.1f} s on {card} (the decode "
        "checks of the seven bf16 models, gemma3-12b's draw and the float32 "
        "checks)")
    PHASE_S[14] = phase14_s
    if sorted(decode) != sorted(SLICE9):
        raise AssertionError(f"slice 9 decoded {sorted(decode)}, not "
                             f"{sorted(SLICE9)}")
    t0 = time.perf_counter()
    with Phase(16, "chatglm3-6b's gradient check"):
        train_grads = phase_train_grads(dev)
    with Phase(17, "chatglm3-6b's training step"):
        train_main = phase_train(dev)
    # slice 15: gemma3-12b, its global layers on K4′'s DP 256 tiles
    with Phase(16, "gemma3-12b's gradient check"):
        gemma_grads = phase_train_grads(dev, dataclasses.replace(
            get_config(GEMMA_ARCH), n_layers=GEMMA_CHECK_LAYERS,
            remat=True))
    with Phase(17, "gemma3-12b's training step"):
        gemma_main = phase_train(dev, steps=GEMMA_TRAIN_STEPS,
                                 arch=GEMMA_ARCH,
                                 reserve=GEMMA_TRAIN_RESERVE, held=True)
    with Phase(18, "the training loop"):
        train_loop = phase_train_loop(dev)
    log(f"[train] phases 16-18: {time.perf_counter() - t0:.1f} s on {card} "
        f"(gemma3-12b's check and main path {gemma_grads['phase_s']:.1f} "
        f"and {gemma_main['phase_s']:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(19, "slice 12, the examples"):
        examples = phase_examples(dev, card)
    with Phase(20, "slice 12, the mesh forms"):
        mesh = phase_mesh(dev, card)
    with Phase(21, "slice 13, tensor parallelism, and phase 23's parts in "
               "its groups"):
        tp = phase_tp(dev, card)
    PHASE_S[21] -= tp["slice14_s"]
    PHASE_S[23] = tp["slice14_s"]
    # phases 22 and 23's dry-run counts need no card: they run beside each
    # other, and beside no phase whose times are reported
    dry_tp, dry_sp = dryrun_start(), dryrun_start(SP_RULES)
    with Phase(22, "the dry run against the card"):
        dry = phase_dryrun(card, tp, dry_tp)
    with Phase(23, "slice 14"):
        slice14 = phase_slice14(dev, card, tp, dry_sp)
    timing = Phase(10, "the kernels' times")
    timing.__enter__()
    k1 = time_k1(dev, serve_stack, metro_stack, launches, k1_err)
    k1["launches_eval"] = eval_launches["pg_solve"]
    k1["tick"] = launches["tick"]
    k1["launches_sharded_solve"] = {n: r["launches"]
                                    for n, r in sharded.items()}
    k1["sharded_solve"] = sharded
    k1["launches_metro_serving"] = metro_launches["pg_solve"]
    k1["metro_serving"] = {k: metro_launches[k] for k in (
        "reslice_ms_median", "meshless_reslice_ms_median",
        "steady_ms_median", "meshless_steady_ms_median",
        "session_solve_device_ms", "tick")}
    k3 = time_kernels(dev, zs, launches, k3_err)
    k3["launches_metro_serving"] = metro_launches["resize"]
    k2 = time_k2(dev, big, eval_launches, k2_err)
    k2["rounds_checked"] = k2_rounds
    k4, k4_core = time_k4(dev, k4_shapes, lm_launches, cfg.n_layers, k4_err,
                          built.get("flash_attn_tc.cu", {}).get("log"))
    k4["prefill_32k_shapes"] = time_k4_long(dev)
    timing.__exit__(None, None, None)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(24, "slice 17, granite-34b, chameleon-34b, h2o-danube-3-4b "
               "and whisper-tiny's training"):
        slice17 = phase_slice17(dev, decode_on)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(25, "slice 18, recurrentgemma-9b, rwkv6-1.6b and "
               "qwen3-moe-235b-a22b's training"):
        slice18 = phase_slice18(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(26, "slice 19, the reference's serving cells: prefill_32k, "
               "decode_32k and long_500k"):
        slice19 = phase_slice19(dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(27, "slice 20, the reference's train_4k cell"):
        slice20 = phase_train_4k(dev, seed)
    want = sorted(SLICE9 + tuple(name for name, _ in SLICE17))
    if sorted(decode) != want:
        raise AssertionError(f"slices 9 and 17 decoded {sorted(decode)}, not "
                             f"{want}")
    k4["launches_slice8"] = {
        name: {"engine": row.get("engine_k4_launches"),
               "prefill": row["prefill"]["k4_launches"]}
        for name, row in slice8.items()}
    k4["slice8"] = slice8
    k4["launches_decode"] = {name: row["k4_launches"]
                             for name, row in decode.items()}
    k4["decode"] = dict(decode, float32=decode_f32, phase_s=phase14_s)
    # slice 17's launches: each config's engine (a LM batch), prefill,
    # decode prefill and training step (phase 24)
    s17 = slice17["serving"]
    k4["launches_slice17"] = {
        name: {"engine": s17[name].get("engine_k4_launches"),
               "engine_lm_batches": s17[name].get("engine_lm_batches"),
               "prefill": s17[name]["prefill"]["k4_launches"],
               "decode_prefill": decode[name]["k4_launches"]}
        for name, _ in SLICE17}
    for name, row in slice17["train"].items():
        k4["launches_slice17"].setdefault(name, {})["train_steps"] = \
            row["main"]["k4_launches"]
    k4["slice17"] = dict(serving=s17, decode_f32=slice17["decode_f32"])
    k4["launches_train"] = train_main["k4_launches"]
    k4["launches_train_gemma3"] = gemma_main["k4_launches"]
    k4["phase15_shapes"] = {
        key: {x: row.get(x) for x in ("k4_fwd_ms", "k4_fwd_device_ms",
                                      "sdpa_fwd_ms", "k4_fwd_bound_ms")}
        for key, row in k4b_rows["cuda_cores"]["shapes"].items()}
    k4["device_ms_phase15"] = {
        key: row["k4_fwd_device_ms"]
        for key, row in k4b_rows["cuda_cores"]["shapes"].items()}
    # K4′'s rows: each route's launches on the path that runs it — the
    # tensor cores on the 28-layer training step (phase 17), the CUDA cores
    # on the float32 smoke loop (phase 18)
    k4b, k4b_core = k4b_rows["tensor_cores"], k4b_rows["cuda_cores"]
    k4b["tc_kernel"] = bwd_tc_report(
        built.get("flash_attn_bwd_tc.cu", {}).get("log"))
    k4b["launches"] = train_main["k4_bwd_launches_by_route"]["tensor_cores"]
    k4b["launches_path"] = "phase 17, the training step"
    k4b["launches_train_gemma3"] = \
        gemma_main["k4_bwd_launches_by_route"]["tensor_cores"]
    k4b["train"] = dict(train_main, gradient_check=train_grads,
                        loop=train_loop)
    k4b["train_gemma3"] = dict(gemma_main, gradient_check=gemma_grads)
    k4b_core["launches"] = \
        train_loop["k4_bwd_launches_by_route"]["cuda_cores"]
    k4b_core["launches_path"] = "phase 18, the float32 smoke loop"
    k4_core["launches"] = train_loop["k4_launches_by_route"]["cuda_cores"]
    k4b_core["kernel_info"] = k4_core["kernel_info"]
    k4_core["launches_path"] = "phase 18, the float32 smoke loop"
    k4b_core["launches_train_step"] = \
        train_main["k4_bwd_launches_by_route"]["cuda_cores"]
    k3["launches_slice17"] = {name: s17[name].get("engine_resize_launches")
                              for name, _ in SLICE17}
    k4b["launches_slice17"] = {
        name: {"train_steps": row["main"]["k4_bwd_launches"],
               "held_step_calls": (row["main"]["held"] or {}).get("calls"),
               "gradient_check": None if row["gradient_check"] is None
               else row["gradient_check"]["k4_bwd_launches"]}
        for name, row in slice17["train"].items()}
    k4b["slice17"] = slice17["train"]
    # slice 18's launches: each config's training steps (phase 25)
    k4["launches_slice18"] = {
        name: {"train_steps": row["main"]["k4_launches"]}
        for name, row in slice18.items()}
    k4b["launches_slice18"] = {
        name: {"train_steps": row["main"]["k4_bwd_launches"],
               "held_step_calls": (row["main"]["held"] or {}).get("calls"),
               "gradient_check": row["gradient_check"].get(
                   "k4_bwd_launches")}
        for name, row in slice18.items()}
    k4b["slice18"] = slice18
    # slice 19's launches: each prefill_32k (phase 26)
    k4["launches_slice19"] = {
        name: {"prefill_32k": row["k4_launches"]}
        for name, row in slice19["prefill_32k"].items()}
    k4["slice19"] = slice19
    # slice 20's launches: a train_4k step of each config (phase 27)
    k4["launches_train_4k"] = {
        name: slice20[name]["k4_launches_per_step"]
        for name, _ in TRAIN4K_ARCHS}
    k4b["launches_train_4k"] = {
        name: slice20[name]["k4_bwd_launches_per_step"]
        for name, _ in TRAIN4K_ARCHS}
    k4b["slice20"] = slice20
    # slice 12's launches: the examples (phase 19) and the mesh step (20)
    k1["launches_examples"] = {k: v["K1"] for k, v in examples.items()
                               if isinstance(v, dict) and "K1" in v}
    k2["launches_examples"] = {"quickstart": examples["quickstart"]["K2"]}
    k3["launches_examples"] = {k: v["K3"] for k, v in examples.items()
                               if isinstance(v, dict) and "K3" in v}
    k4["launches_examples"] = {
        "serve_edge": examples["serve_edge"]["K4"],
        "train_lm_full_attention":
            examples["train_lm_full_attention"]["launches"]["K4"]}
    k4["launches_mesh_step"] = mesh["train_step"]["steps"][-1][
        "launches"]["K4"]
    k4b_core["launches_train_lm_full_attention"] = \
        examples["train_lm_full_attention"]["launches"]["K4′"]
    k4_core["launches_train_lm_full_attention"] = \
        examples["train_lm_full_attention"]["launches"]["K4"]
    k4b["launches_mesh_step"] = mesh["train_step"]["steps"][-1][
        "launches"]["K4′"]
    k4b["slice12"] = dict(examples=examples, mesh=mesh)
    # slice 13's launches: phase 21's prefills (a rank) and train step
    k4["launches_tp"] = {
        f"tp{w}": {"prefill_per_rank": tp[w][0]["serving"]["k4_launches"],
                   **({"train_step_per_rank":
                       tp[w][0]["train"]["launches"]["K4"]}
                      if "train" in tp[w][0] else {})}
        for w in TP_SIZES}
    k4b["launches_tp"] = {
        f"tp{w}": {"train_step_per_rank": tp[w][0]["train"]["k4b_tc_launches"]}
        for w in TP_SIZES if "train" in tp[w][0]}
    k4b["slice13"] = dict(tp={w: [{p: x[p] for p in x if p not in set(
        SLICE14_PARTS[w].split(","))} for x in tp[w]] for w in TP_SIZES},
        dryrun=dry)
    # slice 14's launches: a rank of phase 23's SP train steps and its
    # prefills over the sequence-split cache
    s14 = slice14["ranks"]
    k4["launches_slice14"] = {
        f"tp{w}": {"sp_train_step_per_rank": s14[str(w)][0]["sp"]["launches"][
            "K4"], **{f"{p}_prefill_per_rank": s14[str(w)][0][p]["k4_launches"]
                      for p in ("kv", "ring") if p in s14[str(w)][0]}}
        for w in (2, 4)}
    k4b["launches_slice14"] = {
        f"tp{w}": {"sp_train_step_per_rank":
                   s14[str(w)][0]["sp"]["k4b_tc_launches"]} for w in (2, 4)}
    k4b["slice14"] = slice14
    kernels = [k1, k2, k3, k4, k4_core, k4b, k4b_core]
    k4_core["smoke_phase_s"] = {str(n): round(x, 1)
                                for n, x in sorted(PHASE_S.items())}
    log("[phases] seconds by phase: " + ", ".join(
        f"{n} {x:.1f}" for n, x in sorted(PHASE_S.items())))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
