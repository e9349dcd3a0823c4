#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``, never the JAX package) through its
serving tick on the card and holds every hand-written kernel of that path
against its plain PyTorch version:

1. prints the card (``nvidia-smi``) and builds every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. K1 (``kernels/pg/pg.py::batch_round``) against ``batch_round_ref`` at the
   serving shape (B = 256, T = 32, A = 300, m = 2, with planted ties and
   all-infeasible instances) and on the metro day batch
   (``metro_diurnal_trace(256, n_domains=32)``, 6144 rows): V bitwise,
   tau and best_a equal;
3. K3 (``kernels/resize/resize.py::resize_bilinear``) against its plain
   version at 128×128×3, 640×640×3 and 1024×2048×3, batch 8,
   z ∈ {0.04, 0.25, 0.5, 1}, float32, within 1e-5;
4. solves the metro day batch coupled with ``inner="kernel"`` and with
   ``inner="torch"`` (the plain bit-domain round): decisions equal, every
   solution valid, link budgets kept; prints rounds, host syncs, ms/solve;
5. THE MAIN PATH: a 256-cell ``MultiCellEngine`` (``multi_cell_pools(256,
   seed=1)``, 32 contiguous backhaul domains at 1.2 per cell) driven by
   ``drive_closed_loop(horizon=8, process=True)``, with the kernel launch
   counts zeroed just before and read just after; a twin engine on the same
   card with ``sesm.inner = "torch"`` runs the same traffic and must decide
   identically at every step;
6. times each kernel, its plain version and (K3) the library call at the
   shapes the main path gave it, and prints the ``{"kernels": [...]}`` line,
   the card's name and power limit, and finally the ``{"ok": true, ...}``
   line.

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

N_CELLS, N_DOMAINS, BACKHAUL_PER_CELL = 256, 32, 1.2
HORIZON = 8
# standing load per cell: seats every cell in the 64-slot bucket on the
# first tick, so the 8-step closed loop never outgrows its device session
STANDING = 33
SHAPES = ((128, 128), (640, 640), (1024, 2048))
MIX = [("coco_bags", 0.35, 8.0), ("coco_animals", 0.50, 6.0),
       ("cityscapes_flat", 0.35, 5.0), ("coco_person", 0.20, 5.0)]


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
    return secs


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
    return err


# --------------------------------------------------------------- phase 3

def phase_k3(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.resize import resize as PR
    rng = np.random.default_rng(1)
    err = 0.0
    for (h, w) in SHAPES:
        img = torch.from_numpy(rng.standard_normal((8, h, w, 3)).astype(
            np.float32)).to(dev)
        for z in (0.04, 0.25, 0.5, 1.0):
            ho, wo = PR.out_size_for_z(h, w, z)
            taps = (PR.device_taps(ho, h, dev), PR.device_taps(wo, w, dev))
            out = PR.resize_bilinear(img, *taps)
            ref = PR.resize_bilinear_ref(img, *taps)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"K3 {h}x{w} z={z}: max err {e}")
            if z == 1.0 and not torch.equal(out, img):
                raise AssertionError(f"K3 {h}x{w}: z=1 is not the identity")
            err = max(err, e)
        log(f"[K3] 8x{h}x{w}x3 f32 z in (0.04, 0.25, 0.5, 1): "
            f"within 1e-5 (max abs err so far {err:.3g})")
    img = torch.from_numpy(rng.standard_normal((8, 128, 128, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    taps = (PR.device_taps(26, 128, dev), PR.device_taps(26, 128, dev))
    out = PR.resize_bilinear(img, *taps).float()
    ref = PR.resize_bilinear_ref(img, *taps).float()
    if not torch.allclose(out, ref, rtol=3e-2, atol=3e-2):
        raise AssertionError("K3 bf16 differs from the plain version")
    log("[K3] 8x128x128x3 bf16 z=0.04: within 3e-2")
    return err


# --------------------------------------------------------------- phase 4

def phase_metro_solve(dev, stacked):
    import numpy as np
    import torch
    from repro_torch.core import check_solution, device_stack
    from repro_torch.core.greedy import (_pack_batch_solutions,
                                         solve_device_batch)
    dstack = device_stack(stacked, device=dev)
    results = {}
    for inner in ("kernel", "torch"):
        res = solve_device_batch(dstack, inner=inner)        # warm
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_device_batch(dstack, inner=inner)
            times.append((time.perf_counter() - t0) * 1e3)
        results[inner] = res
        log(f"[metro] inner={inner}: {stacked.batch_size} rows, "
            f"{int(res['admitted'].sum())} admitted, rounds={res['rounds']} "
            f"host syncs={res['syncs']} ms/solve={np.median(times):.2f} "
            f"(min {min(times):.2f})")
    k, t = results["kernel"], results["torch"]
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
    log(f"[metro] decisions equal across rounds; all {len(sols)} solutions "
        "valid; link budgets kept")
    return k


# --------------------------------------------------------------- phase 5

def make_engine(dev, inner):
    import numpy as np
    from repro_torch.core import CouplingSpec, scenarios
    from repro_torch.serving import MultiCellEngine, SliceRequest
    pools = scenarios.multi_cell_pools(N_CELLS, seed=1)
    domain = (np.arange(N_CELLS) * N_DOMAINS) // N_CELLS
    inc = np.zeros((N_CELLS, N_DOMAINS), bool)
    inc[np.arange(N_CELLS), domain] = True
    budgets = np.bincount(domain, minlength=N_DOMAINS) * BACKHAUL_PER_CELL
    eng = MultiCellEngine(pools, coupling=CouplingSpec(budgets, inc),
                          max_retries=3, device=dev)
    eng.sesm.inner = inner
    for c in range(N_CELLS):
        for i in range(STANDING):
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
    PK.ROUND_KERNEL.launches = 0
    PR.RESIZE_KERNEL.launches = 0
    recs, dec, ticks, wall = drive(eng)
    launches = {"pg_round": PK.ROUND_KERNEL.launches,
                "resize": PR.RESIZE_KERNEL.launches}
    sesm = eng.sesm
    log(f"[serve] {N_CELLS} cells, {HORIZON} steps: "
        f"{sum(r['admitted'] for r in recs)} admissions, "
        f"{sum(r['handovers'] for r in recs)} handovers; K1 launches "
        f"{launches['pg_round']}, K3 launches {launches['resize']}")
    log(f"[serve] re-slice ms/tick: median {np.median(ticks):.1f}, "
        f"all {[round(t, 1) for t in ticks]}; loop wall ms/step "
        f"{wall / HORIZON:.1f}")
    log(f"[serve] fresh_stacks={sesm.fresh_stacks} "
        f"session_rebuilds={sesm.session_rebuilds} "
        f"delta_rows={sesm.delta_rows} "
        f"Tmax={sesm._serve_session.max_tasks}")
    if launches["pg_round"] <= 0 or launches["resize"] <= 0:
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
    profile_tick(eng)
    return launches, sesm._serve_session.max_tasks, zs


def profile_tick(eng):
    """Where one steady re-slice tick of the main engine spends its time:
    wall time, device busy time (summed kernel time) and the top kernels,
    from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.reslice()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.reslice()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + _device_time(e)
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    log(f"[trace] steady re-slice tick: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %), "
        f"{len(kern)} kernel names")
    for name, us in top:
        log(f"[trace]   {us:9.1f} us  {name[:90]}")


# --------------------------------------------------------------- phase 6

def time_kernels(dev, tmax, zs, launches, k1_err, k3_err):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.pg import pg as PK
    from repro_torch.kernels.resize import resize as PR
    rng = np.random.default_rng(2)
    # K1 at the main path's shape: B = 256 cells, T = the session's bucket
    lat, words, rest = k1_inputs(rng, N_CELLS, tmax, 300, 2, dev)
    b, t, w = words.shape
    a, m = rest[1].shape
    k1 = dict(name="pg_round", route="cuda",
              source="src/repro_torch/kernels/csrc/pg_round.cu",
              replaces="src/repro/kernels/pg/pg.py:182",
              launches=launches["pg_round"], max_abs_err=k1_err)
    k1["ms"] = cuda_ms(lambda: PK.batch_round(words, *rest), iters=200)
    k1["plain_ms"] = cuda_ms(lambda: PK.batch_round_ref(lat, *rest))
    k1_bytes = b * t * w * 4 + b * t + a * m * 4 + 3 * b * m * 4 + b * 12
    # per lane: m subs, muls, 2 divs, 2 muls, 3 adds, 1 compare; + the
    # scan's compare per set bit (bounded by the lanes)
    k1_ops = b * a * (10 * m + 8)
    k1["bound_ms"] = max(k1_bytes / HBM_BYTES_PER_S,
                         k1_ops / F32_FLOP_PER_S) * 1e3
    k1["bound_by"] = "bytes" if k1_bytes / HBM_BYTES_PER_S \
        >= k1_ops / F32_FLOP_PER_S else "operations"
    k1["library_ms"] = None
    log(f"[time] K1 B={b} T={t} W={w} A={a}: kernel {k1['ms']*1e3:.1f} us "
        f"per call (device "
        f"{fmt_us(device_us(lambda: PK.batch_round(words, *rest), 'pg_round'))}"
        f"), plain {k1['plain_ms']*1e3:.1f} us, bound "
        f"{k1['bound_ms']*1e3:.3f} us ({k1['bound_by']})")

    # K3 at the main path's shape: a job batch of 5 frames of 128x128x3 at
    # the compression the engine admitted most often
    vals, counts = np.unique(np.round(zs, 6), return_counts=True)
    z = float(vals[counts.argmax()])
    img = torch.from_numpy(rng.standard_normal((5, 128, 128, 3)).astype(
        np.float32)).to(dev)
    ho, wo = PR.out_size_for_z(128, 128, z)
    th, tw = PR.device_taps(ho, 128, dev), PR.device_taps(wo, 128, dev)
    k3 = dict(name="resize", route="cuda",
              source="src/repro_torch/kernels/csrc/resize.cu",
              replaces="src/repro/kernels/resize/resize.py:40",
              launches=launches["resize"], max_abs_err=k3_err)
    k3["ms"] = cuda_ms(lambda: PR.resize_bilinear(img, th, tw), iters=200)
    k3["plain_ms"] = cuda_ms(lambda: PR.resize_bilinear_ref(img, th, tw))
    nchw = img.permute(0, 3, 1, 2)
    k3["library_ms"] = cuda_ms(lambda: F.interpolate(
        nchw, size=(ho, wo), mode="bilinear", align_corners=False),
        iters=200)
    # bytes: the input pixels the taps touch (rows x columns used), once
    rows, cols = (len(np.unique(idx.cpu().numpy()[wt.cpu().numpy() > 0]))
                  for idx, wt in (th, tw))
    k3_bytes = 5 * rows * cols * 3 * 4 + 5 * ho * wo * 3 * 4 \
        + 2 * (ho + wo) * 8
    k3_ops = 5 * ho * wo * 3 * 6
    k3["bound_ms"] = max(k3_bytes / HBM_BYTES_PER_S,
                         k3_ops / F32_FLOP_PER_S) * 1e3
    k3["bound_by"] = "bytes" if k3_bytes / HBM_BYTES_PER_S \
        >= k3_ops / F32_FLOP_PER_S else "operations"
    k3_dev = device_us(lambda: PR.resize_bilinear(img, th, tw), "resize")
    log(f"[time] K3 5x128x128x3 z={z:.4f} -> {ho}x{wo}: kernel "
        f"{k3['ms']*1e3:.1f} us per call (device {fmt_us(k3_dev)}), "
        f"plain {k3['plain_ms']*1e3:.1f} us, "
        f"F.interpolate {k3['library_ms']*1e3:.1f} us, bound "
        f"{k3['bound_ms']*1e3:.3f} us ({k3['bound_by']})")

    # the largest frames of phase 3, for the record
    big = torch.from_numpy(rng.standard_normal((8, 1024, 2048, 3)).astype(
        np.float32)).to(dev)
    bh, bw = PR.out_size_for_z(1024, 2048, 0.25)
    bt = (PR.device_taps(bh, 1024, dev), PR.device_taps(bw, 2048, dev))
    big_ms = cuda_ms(lambda: PR.resize_bilinear(big, *bt), iters=20)
    big_dev = device_us(lambda: PR.resize_bilinear(big, *bt), "resize", 10)
    lib_ms = cuda_ms(lambda: F.interpolate(
        big.permute(0, 3, 1, 2), size=(bh, bw), mode="bilinear",
        align_corners=False), iters=20)
    big_bytes = (8 * 1024 * 2048 * 3 + 8 * bh * bw * 3) * 4
    log(f"[time] K3 8x1024x2048x3 z=0.25: kernel {big_ms:.3f} ms "
        f"(device {fmt_us(big_dev)}), "
        f"F.interpolate {lib_ms:.3f} ms, full-input byte bound "
        f"{big_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    return [k1, k3]


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
    build_kernels()

    from repro_torch.core import next_pow2, scenarios, stack_instances
    t0 = time.perf_counter()
    insts, _ = scenarios.metro_diurnal_trace(N_CELLS, n_domains=N_DOMAINS)
    metro = stack_instances(
        insts, tmax=next_pow2(max(i.num_tasks for i in insts)))
    log(f"[metro] day batch: {metro.batch_size} rows, Tmax="
        f"{metro.max_tasks}, {int(metro.task_mask.sum())} tasks, built in "
        f"{time.perf_counter() - t0:.1f} s")

    k1_err = phase_k1(dev, metro)
    k3_err = phase_k3(dev)
    phase_metro_solve(dev, metro)
    launches, tmax, zs = phase_serving(dev)
    kernels = time_kernels(dev, tmax, zs, launches, k1_err, k3_err)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
