"""Port of ``src/repro/launch/dryrun.py``: one rank's counts of every (arch ×
shape × mesh) cell, with no card.

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices and reads XLA's memory and cost analyses and its
partitioned HLO. The port has no compiler to ask, so it runs the cell's
step itself as rank 0 of the production mesh would, on ``meta`` tensors
(shapes and dtypes, no storage), in a process whose default group is
``torch.distributed``'s ``fake`` backend at world 256 or 512 (its
collectives return at once), under ``launch/cost.py``'s counters:

1. builds the cell (``launch/specs.py``: spec for spec the reference's,
   ``--opt`` its optimized cell) and rank 0's arguments in the port's
   layout: its parameters in the compute layout
   (``distributed/sharding.py::compute_shardings``: dense tensor
   parallelism over ``model``; under ``--opt`` the MoE experts in their
   ZeRO-3 storage split over the data axes too), for a train cell its
   AdamW moments as the ZeRO layout's shards (``param_shardings(...,
   extra_batch_dim=True)``) and the step with ``n_microbatches``, its
   rows of the batch, for a decode cell its cache (its rows; every KV
   head for its block of the slots, ``seq_kv``);
2. runs one step (the train step, the prefill, or one decode step at the
   cache's last position) under ``cost.CostMode``: K4 and K4′ take their
   fake implementations, so attention is counted as the kernels compute
   it, not as the plain version's (T × T) scores;
3. derives the reference's three roofline terms from the counts and the
   H100's peaks (``launch/mesh.py::HW``) and writes a JSON record.

Why ``meta`` and not fake CUDA tensors: a ``cpu`` ``DeviceMesh`` over the
``fake`` backend takes fake CUDA tensors in its collectives, but a torch
built for the CPU aborts the process when autograd records a fake CUDA
tensor (``getDeviceGuardImpl``: no CUDA guard), which every train cell
needs; ``meta`` tensors record autograd on any build, so the count is the
same on this CPU and on the card's machine.

The record keeps the reference's keys where they have a counterpart:
``per_device`` (``dot_flops``, ``dot_bytes``, ``collective_bytes``,
``collective_counts``), ``roofline`` (``compute_s``, ``memory_s``,
``collective_s``, ``dominant``, ``bound_s``, ``model_flops``,
``useful_ratio``, ``tokens_per_step``), ``memory`` (``argument_bytes``,
``fits_hbm`` against the card's memory) and ``meta``. It replaces the
others, and names them under ``replaces``: ``trace_s`` for ``lower_s``
and ``compile_s``, ``memory.peak_bytes`` for the temporaries and aliases
of ``memory_analysis()``, ``roofline.counted_flops_total`` for
``hlo_flops_total``; ``cost_analysis_raw`` has none. A decode cell is
counted in the reference's layout of the cache, its sequence split over
``seq_kv``'s axes (``model``; ``data`` and ``model`` for ``long_500k``)
with every KV head on each rank, and ``meta["layout"]`` says so.

Usage (the CPU is enough):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k [--multipod] [--opt] [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from . import specs
from .cost import count
from .mesh import HW, make_production_mesh

__all__ = ["count_cell", "count_train_step", "main", "run_cell",
           "start_fake_group"]

LAYOUT = ("port: dense tensor parallelism over model (compute_shardings), "
          "batch rows over the data axes, the decode cache's sequence split "
          "over seq_kv's axes with every KV head a rank")
LAYOUT_OPT = LAYOUT + ("; optimized: Megatron-SP residual over model in "
                       "train cells, the MoE experts stored split over the "
                       "data axes (ZeRO-3) and gathered a layer at a time")


def start_fake_group(world: int, rank: int = 0) -> None:
    """Make ``torch.distributed``'s default group the ``fake`` backend at
    ``world`` ranks (its collectives return at once), unless it is one
    already; any other group is an error."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry run needs a fake group of {world} ranks, not "
                f"{dist.get_backend()} at {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _local(tree, shardings):
    from ..distributed.sharding import shard_of
    from ..tree import tree_map
    return tree_map(lambda t, sh: shard_of(t, sh).clone(), tree, shardings)


def _rows_bytes(batch: dict, n_data: int) -> int:
    return sum(v.numel() * v.element_size() // n_data
               for v in batch.values())


def count_cell(cell, mesh):
    """Rank ``mesh``'s local rank's counts of ``cell``'s step (``meta``
    tensors, under ``cost.CostMode``) → ``cost.StepCost``."""
    from ..configs import get_config
    from ..distributed.sharding import (batch_axes, compute_shardings,
                                        mesh_shape, param_shardings)
    from ..models import cache_specs
    from ..training.optimizer import _data_rows, opt_init
    from ..tree import tree_map
    cfg = get_config(cell.arch)
    opt = cell.meta["optimized"]
    sizes = mesh_shape(mesh)
    n_data = 1
    for a in batch_axes(mesh):
        n_data *= sizes[a]
    moe_impl = cell.meta["moe_impl"]
    p_specs = cell.args[0]
    osh = compute_shardings(p_specs, mesh, cfg, moe_impl, moe_fsdp=opt,
                            rules=cell.rules)
    params = _local(p_specs, osh)
    if cell.mode == "train":
        zsh = param_shardings(p_specs, mesh, cfg, cell.rules,
                              extra_batch_dim=True, moe_fsdp=opt)
        state = opt_init(params, zero_shardings=zsh, out_shardings=osh)
        batch = cell.args[2]
        _, cost = count(cell.fn, params, state, batch, track=(params, state),
                        ignore=(batch,),
                        extra_argument_bytes=_rows_bytes(batch, n_data))
        return cost
    if cell.mode == "prefill":
        rows = {k: v.clone() for k, v in _data_rows(cell.args[1],
                                                    mesh).items()}
        _, cost = count(cell.fn, params, rows, track=(params, rows))
        return cost
    tok = cell.args[2]
    b = tok.shape[0] // n_data if tok.shape[0] % n_data == 0 \
        else tok.shape[0]
    seq = cell.meta["seq"]
    dec_len = seq // 8 if cfg.is_encdec else seq
    local = cache_specs(cfg, b, dec_len, enc_len=seq if cfg.is_encdec else 0,
                        mesh=mesh, rules=cell.rules)
    cache = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), local)
    toks = torch.empty((b,), dtype=torch.int32, device="meta")
    _, cost = count(cell.fn, params, cache, toks, dec_len - 1,
                    track=(params, cache, toks))
    return cost


def count_train_step(cfg, mesh, batch: int, seq: int, *, opt=None,
                     rules=None, n_microbatches: int = 1):
    """This rank's counts of ``make_train_step(cfg, opt, mesh=mesh,
    n_microbatches=n_microbatches)`` (the compute layout, whole AdamW
    moments of the rank's shards, no ZeRO layout) on a ``(batch, seq)``
    token batch whole on every rank, under the axis ``rules`` (Megatron-SP
    with ``{"seq_sp": "model"}``): the steps ``chip_smoke.py``'s phases 21
    and 23 run on the card, and on a one-rank mesh phase 27's train_4k
    step (16 microbatches, as ``launch/specs.py::build_cell`` passes
    them), counted without it."""
    from ..distributed.sharding import compute_shardings
    from ..models import param_specs
    from ..training.optimizer import OptConfig, make_train_step, opt_init
    opt = opt or OptConfig(warmup_steps=1)
    params = _local(param_specs(cfg), compute_shardings(param_specs(cfg),
                                                        mesh, cfg))
    state = opt_init(params)
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    rows = {"tokens": tokens, "labels": tokens.clone()}
    step = make_train_step(cfg, opt, mesh=mesh, rules=rules,
                           n_microbatches=n_microbatches)
    _, cost = count(step, params, state, rows, track=(params, state, rows))
    return cost


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: str | None,
             optimized: bool = False) -> dict:
    """Reference ``run_cell`` (dryrun.py:36): rank 0's counts of the cell
    ``arch`` × ``shape`` on the production mesh, its roofline terms, and
    its record (written to ``out_dir`` as JSON when given)."""
    mesh_name = "multi" if multi_pod else "single"
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                    "optimized": optimized}
    t0 = time.time()
    start_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(device_type="cpu", multi_pod=multi_pod)
    n_dev = mesh.size()
    cell = specs.build_cell(arch, shape, mesh, optimized=optimized)
    if cell.skipped:
        record["skipped"] = cell.skipped
        print(f"[dryrun] SKIP {arch} × {shape} ({mesh_name}): {cell.skipped}")
        return _write(record, out_dir)
    try:
        cost = count_cell(cell, mesh)
        trace_s = time.time() - t0
        terms = {"compute_s": cost.flops / HW.PEAK_FLOPS_BF16,
                 "memory_s": cost.product_bytes / HW.HBM_BW,
                 "collective_s": cost.total_collective_bytes()
                 / HW.COLLECTIVE_BW}
        dominant = max(terms, key=terms.get)
        factor = 6 if cell.mode == "train" else 2
        model_flops = factor * cell.meta["active_params"] \
            * cell.tokens_per_step
        total = cost.flops * n_dev
        hbm = HW.HBM_BYTES
        record.update({
            "mode": cell.mode,
            "devices": n_dev,
            "card": HW.CARD,
            "trace_s": round(trace_s, 2),
            "memory": {
                "argument_bytes": cost.argument_bytes,
                "peak_bytes": cost.peak_bytes,
                "hbm_bytes": hbm,
                "fits_hbm": bool(cost.peak_bytes < hbm),
            },
            "per_device": {
                "dot_flops": cost.flops,
                "dot_bytes": cost.product_bytes,
                "collective_bytes": cost.collective_bytes,
                "collective_counts": cost.collective_counts,
            },
            "roofline": {
                **terms,
                "dominant": dominant,
                "bound_s": max(terms.values()),
                "model_flops": model_flops,
                "counted_flops_total": total,
                "useful_ratio": model_flops / total if total else 0.0,
                "tokens_per_step": cell.tokens_per_step,
            },
            "meta": dict(cell.meta,
                         layout=LAYOUT_OPT if optimized else LAYOUT),
            "replaces": {"lower_s": "trace_s", "compile_s": "trace_s",
                         "memory.temp_bytes": "memory.peak_bytes",
                         "memory.output_bytes": "memory.peak_bytes",
                         "memory.alias_bytes": "memory.peak_bytes",
                         "roofline.hlo_flops_total":
                             "roofline.counted_flops_total",
                         "cost_analysis_raw": None},
        })
        print(f"[dryrun] OK {arch} × {shape} ({mesh_name}) "
              f"trace={trace_s:.1f}s dominant={dominant} "
              f"compute={terms['compute_s'] * 1e3:.2f}ms "
              f"memory={terms['memory_s'] * 1e3:.2f}ms "
              f"collective={terms['collective_s'] * 1e3:.2f}ms "
              f"peak={cost.peak_bytes / 2**30:.2f}GiB "
              f"useful={record['roofline']['useful_ratio']:.2f}")
    except Exception as e:  # noqa: BLE001 — record per-cell failures
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {arch} × {shape} ({mesh_name}): "
              f"{record['error']}")
    return _write(record, out_dir)


def _write(record: dict, out_dir: str | None) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{record['arch']}__{record['shape']}__"
                     f"{record['mesh']}"
                     f"{'__opt' if record['optimized'] else ''}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=float)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(specs.SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's optimized cell: Megatron-SP in "
                         "train cells, ZeRO-3 of the MoE experts")
    args = ap.parse_args(argv)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multipod,
                   out_dir=args.out, optimized=args.opt)
    raise SystemExit(1 if "error" in rec else 0)


if __name__ == "__main__":
    main()
