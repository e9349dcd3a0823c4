#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``, never the JAX package) through its
slices on the card — the multi-cell serving tick, the paper's
single-instance evaluation, the serving engine's LM-service jobs, the
metro-scale sharded solve with its mesh-resident serving session, the
MoE, RG-LRU, RWKV-6 and encoder-decoder prefills of the other five LM
configs, and the decode that continues a prefill — and
holds every hand-written kernel of those paths against its plain PyTorch
version:

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
   ``drive_closed_loop(horizon=8, process=True)``, with the kernel launch
   counts zeroed just before and read just after (every re-slice's solve
   one ``batch_solve`` launch with one host sync, no one-round launch); a
   twin engine on the same card with ``sesm.inner = "torch"`` runs the same
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
   4, 128), on unit normals, on both kernels (and Dh = 320,
   which the route sends to the CUDA-core kernel in both types; Dh = 520
   must raise): float32 on the
   CUDA-core kernel (``csrc/flash_attn.cu``, within 2e-5: sums in another
   order), bfloat16 on the tensor-core kernel (``csrc/flash_attn_tc.cu``,
   the route bf16 takes) and on the CUDA-core kernel, each element within
   2^-7 |ref| + 2^-6 rms(ref's row) of the plain version in float32 on the
   same inputs (``K4_BF16_TOL``); at the whisper encoder's shape the
   tensor-core kernel with its 28-key tail tile dropped, or with the tail
   left unmasked (K and V zero-filled to a whole tile), must fail that
   tolerance;
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
   launch configuration — and prints the ``{"kernels": [...]}`` line, the
   card's name and power limit, and finally the ``{"ok": true, ...}`` line;
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
   ``drive_closed_loop(horizon=8, process=True)``, an outage and recovery,
   ``set_link_budgets(scale=0.6)`` and ``shift_semantics(scale=0.8)``,
   counts zeroed before and read after (one ``batch_solve`` launch a
   re-slice, K3 on the vision jobs): decisions equal at every tick,
   ``shard_replans == fresh_stacks``, the twin's session counters, a
   steady tick with no dirty row, replan or second launch; re-slice ms a
   tick for both and one steady metro tick under ``torch.profiler``;
13. SLICE 8'S MAIN PATH (run after phase 9): recurrentgemma-9b,
   rwkv6-1.6b and whisper-tiny at full width and depth, mixtral-8x7b and
   qwen3-moe-235b-a22b at the most layers whose bf16 weights fit the
   card's free memory beside a 16 GiB reserve (their whole weights do
   not fit), all widths as published, bf16, random weights
   from a seeded generator on the card, one model at a time. The four
   token-only configs serve phase 9's engine path (K4 launches per LM
   batch: qwen3 8, all on the tensor-core kernel; the "local", "rec" and
   "rwkv" configs 0); each config's ``prefill`` at B = 2, T = 2048
   (whisper: 1500 frames of seeded stub embeddings and 448 tokens) through
   K4 (qwen3 8 launches, whisper 12: 4 encoder, 4 decoder self-, 4
   cross-attention; the others 0) against its plain-attention twin within
   phase 9's bf16 tolerances (each block of the twin on the K4 run's
   input to it), logits finite. An MoE twin takes the K4 run's experts;
   where its own router logits would choose others, the choice must be a
   near-tie (``routing_flips``). Wall ms, device busy
   share, K4's share and peak memory (the K4 run's, and the config's
   whole run's) are printed;
14. SLICE 9'S MAIN PATH, decode (on chatglm3-6b's weights after phase 9,
   on each of phase 13's five models after its prefill checks, then on
   gemma3-12b at full width and depth, bf16, seed 0: 5 local layers with
   a 1024 window to 1 global, so a 2048-token prompt wraps its ring):
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
   clamped update (``clamp_oracle``). The phase's time is printed.

Any failure raises and exits nonzero before the last line. Without a CUDA
card, or outside the repository, it exits nonzero and prints no result.
Float32 matrix products run in full float32 here (TF32 off for both cuBLAS
and cuDNN), so the plain versions are exact float32 references.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores — the roof each kernel's bound is taken against
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 tensor-core peak: the roof for work on bf16 inputs
BF16_FLOP_PER_S = 989e12

N_CELLS, N_DOMAINS, BACKHAUL_PER_CELL = 256, 32, 1.2
HORIZON = 8
# standing load per cell: seats every cell in the 64-slot bucket on the
# first tick, so the 8-step closed loop never outgrows its device session
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
             (2, 416, 1500, 6, 6, 64, False))
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
    kernels and copies); ``warm=False`` where ``fn`` has just run. Returns
    (wall us, device us by kernel name, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + _device_time(e)
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
    for bit. Returns the max abs error by (kernel, dtype), against the
    plain version in float32 on the same inputs."""
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
        by_shape = []
        for shape in shapes:
            q, k, v = k4_inputs(rng, shape, dev, dtype)
            causal = shape[-1]
            if kernel == PA.route(q.dtype, q.shape[3]):
                out = PA.flash_attention_fwd(q, k, v, causal=causal)
            else:
                out = PA.launch(kernel, q, k, v, causal=causal)
            again = PA.launch(kernel, q, k, v, causal=causal)
            ref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                             causal=causal)
            by_shape.append(check(q, out, again, ref,
                                  f"{kernel} {shape} {dtype}",
                                  (kernel, dtype)))
            del q, k, v, out, again, ref
        log(f"[K4] {kernel} {dtype}: {len(shapes)} shapes (B, Tq, Tk, Hq, "
            f"Hkv, Dh, causal) within the tolerance; max abs err "
            f"{err[kernel, dtype]:.3g}; share of the tolerance by shape "
            + " ".join(f"{x:.3f}" for x in by_shape))
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
            self.logits.append(logits)
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
    route pointed at K4's plain version (and, where K4 launched, as
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

    MA.attn_kernel = types.SimpleNamespace(
        flash_attention_fwd=PA.flash_attention_fwd_ref)
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
    if k4:
        yardsticks(run, kernel_route, routes, blocks, logits, pl)
    wall_us, kern, count = profile_call(run, f"{cfg.name} prefill B={b} "
                                        f"T={t}")
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


def k4_call_excess(q, k, v, causal, out) -> float:
    """One K4 call against the plain version in float32 on its inputs, as
    a share of the phase-8 tolerance (``k4_excess``). A KV head of a batch
    row at a time: float32 scores of one head group (0.27 GB at qwen3's 16
    query heads a KV head, T = 2048)."""
    import torch
    from repro_torch.kernels.attn import attn as PA
    ref = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    g = q.shape[2] // k.shape[2]
    for b in range(q.shape[0]):
        for h in range(k.shape[2]):
            heads = slice(h * g, (h + 1) * g)
            ref[b:b + 1, :, heads] = PA.flash_attention_fwd_ref(
                q[b:b + 1, :, heads].float(),
                k[b:b + 1, :, h:h + 1].float(),
                v[b:b + 1, :, h:h + 1].float(), causal=causal)
    return k4_excess(out, ref)


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


def fitting_depth(cfg, free: int):
    """``cfg`` at the most layers (whole repeats of its block pattern, up to
    its own depth) whose bf16 weights fit ``free`` bytes beside
    ``SLICE8_RESERVE``; a layer's bytes are ``param_count``'s step."""
    import dataclasses
    step = len(cfg.block_pattern)

    def nbytes(layers):
        return dataclasses.replace(cfg, n_layers=layers).param_count() * 2
    per_repeat = nbytes(2 * step) - nbytes(step)
    base = nbytes(step) - per_repeat
    repeats = (free - SLICE8_RESERVE - base) // per_repeat
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
        weights = cfg.param_count() * 2
        log(f"[slice8] {name}: {cfg.n_layers} of {full} layers"
            + (f" (depth cut: the full model's bf16 weights, "
               f"{get_config(name).param_count() * 2 / 1e9:.1f} GB, do not "
               f"fit the card; {cfg.n_layers} layers, {weights / 1e9:.1f} "
               f"GB, are the most that fit its {free / 2**30:.2f} GiB free "
               f"beside a {SLICE8_RESERVE / 2**30:.0f} GiB reserve; widths "
               "unchanged)" if cut else ", full depth"))
        k4_dec, k4_all = attention_layers(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = lm_model(dev, cfg)
        row = dict(layers=cfg.n_layers, full_layers=full,
                   params_b=cfg.param_count() / 1e9, free_gib=free / 2**30)
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
    from repro_torch.models.model import _tree_map
    out = []
    for r in range(cfg.n_repeats):
        for i, kind in enumerate(cfg.block_pattern):
            out.append((_tree_map(lambda t, r=r: t[r],
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

        def seen(p, x, c, pos, cfg_, kind):
            y, new = attn_decode(p, x, c, pos, cfg_, kind)
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
    on the same card, through ``drive_closed_loop(horizon=8,
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

def alternating_ms(fns: dict, reps: int = 5, iters: int = 200) -> dict:
    """Per-call ms of each of ``fns``: CUDA events around ``iters``
    back-to-back calls, the functions taken in turn, ``reps`` times; the
    median of each. Comparing within one alternation keeps a host that
    drifts during the run from favouring either side."""
    import statistics
    times = {k: [] for k in fns}
    for fn in fns.values():
        cuda_ms(fn, iters=5, warmup=5)
    for _ in range(reps):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=iters, warmup=1))
    return {k: statistics.median(v) for k, v in times.items()}


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


def time_k4(dev, engine_shapes, launches, prefill_launches, err, ptxas):
    """K4 at the engine's LM job shape and at the 2048-token prefill: the
    tensor-core kernel (the path's), the CUDA-core kernel on the same bf16
    inputs (the old design) and in float32, its plain version and SDPA."""
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
               max_abs_err_f32=err["cuda_cores", "float32"],
               max_abs_err_bf16_cuda_cores=err["cuda_cores", "bfloat16"],
               cuda_core_source="src/repro_torch/kernels/csrc/flash_attn.cu",
               tc_kernel=tc_report(ptxas))
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
        del q, k, v, qt, kt, vt, qf, kf, vf
    return row


def main() -> int:
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
    built = build_kernels()

    from repro_torch.core import next_pow2, scenarios, stack_instances
    t0 = time.perf_counter()
    insts, _ = scenarios.metro_diurnal_trace(N_CELLS, n_domains=N_DOMAINS)
    metro = stack_instances(
        insts, tmax=next_pow2(max(i.num_tasks for i in insts)))
    log(f"[metro] day batch: {metro.batch_size} rows, Tmax="
        f"{metro.max_tasks}, {int(metro.task_mask.sum())} tasks, built in "
        f"{time.perf_counter() - t0:.1f} s")

    k1_err = phase_k1(dev, metro)
    phase_k1_solve(dev, metro)
    k2_err, k2_rounds = phase_k2(dev)
    k3_err = phase_k3(dev)
    k4_err = phase_k4(dev)
    metro_stack = phase_metro_solve(dev, metro)
    launches, serve_stack, zs = phase_serving(dev)
    eval_launches, big = phase_evaluation(dev)
    sharded = phase_sharded_solve(dev)
    metro_launches = phase_metro_serving(dev)
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
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
    slice8 = phase_slice8(dev, decode=decode_on)
    t0 = time.perf_counter()
    cfg9 = get_config("gemma3-12b")
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
    if sorted(decode) != sorted(SLICE9):
        raise AssertionError(f"slice 9 decoded {sorted(decode)}, not "
                             f"{sorted(SLICE9)}")
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
    k4 = time_k4(dev, k4_shapes, lm_launches, cfg.n_layers, k4_err,
                 built.get("flash_attn_tc.cu", {}).get("log"))
    k4["launches_slice8"] = {
        name: {"engine": row.get("engine_k4_launches"),
               "prefill": row["prefill"]["k4_launches"]}
        for name, row in slice8.items()}
    k4["slice8"] = slice8
    k4["launches_decode"] = {name: row["k4_launches"]
                             for name, row in decode.items()}
    k4["decode"] = dict(decode, float32=decode_f32, phase_s=phase14_s)
    kernels = [k1, k2, k3, k4]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
