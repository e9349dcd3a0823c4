"""Port of ``src/repro/training/train_loop.py``: the training loop with
checkpoint/restart, heartbeats and straggler tracking.

The loop is host-driven: draw the parameters from a seeded generator on the
device, restore the latest checkpoint if any (fault-tolerant restart), then
step the deterministic data pipeline from the restored step. Failure
injection exercises the restart path. Over a ``DeviceMesh`` every rank runs
the loop: it keeps its shards of the parameters (the compute layout) and
of the moments (the ZeRO layout, ``param_shardings(...,
extra_batch_dim=True)``), the step takes its rows of each batch, and each
rank saves and restores its own shards as host ``rank`` of the
checkpoint (the manifest format is the one-device loop's).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import DataConfig, TokenStream
from ..distributed.sharding import (compute_shardings, param_shardings,
                                    shard_of)
from ..kernels import resolve_device
from ..models import init_params, param_specs
from ..runtime.fault_tolerance import (HeartbeatMonitor, StepClock,
                                       StragglerMitigator)
from ..tree import tree_map
from .optimizer import OptConfig, make_train_step, opt_init

__all__ = ["TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = str(Path(tempfile.gettempdir()) / "repro_torch_ckpt")
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_microbatches: int = 1


def train(cfg, loop: TrainLoopConfig, *, mesh=None, moe_impl=None,
          device="cuda", opt: OptConfig | None = None,
          on_step: Callable[[int, dict], None] | None = None,
          inject_failure_at: int | None = None) -> dict:
    """Run (or resume) training of ``cfg`` on ``device`` (a CUDA card
    unless the caller asks for the CPU), or on every rank of the
    ``DeviceMesh`` ``mesh`` (on its device type, the rank's current CUDA
    device on a card; an MoE FFN in the form ``moe_impl``); returns the metrics history, the parameters (the rank's
    shards), the final loss and the flagged stragglers. The reference's
    loop semantics: the latest checkpoint restored (``[train] restored
    checkpoint at step N``), the data stepped from there, a heartbeat and a
    straggler record a step (``StepClock``), a save at every
    ``checkpoint_every``-th step under the name ``step + 1``, and a final
    blocking save."""
    if mesh is not None:
        device = "cpu" if mesh.device_type == "cpu" \
            else torch.device(mesh.device_type, torch.cuda.current_device())
    device = resolve_device(device)
    opt = opt or OptConfig(total_steps=loop.total_steps)
    gen = torch.Generator(device=device).manual_seed(loop.seed)
    params = init_params(gen, cfg, device)
    if mesh is None:
        opt_state = opt_init(params)
        step_fn = make_train_step(cfg, opt,
                                  n_microbatches=loop.n_microbatches)
        ckpt = Checkpointer(loop.checkpoint_dir)
    else:
        params, opt_state, step_fn = _mesh_state(cfg, opt, loop, params,
                                                 mesh, moe_impl)
        ckpt = Checkpointer(loop.checkpoint_dir, host_id=dist.get_rank(),
                            n_hosts=dist.get_world_size())
        ckpt.wait()
        dist.barrier()             # every rank's last save is on disk
    start_step = 0
    restored = ckpt.restore_latest({"params": params, "opt": opt_state})
    if restored is not None:
        start_step, state = restored
        params, opt_state = state["params"], state["opt"]
        print(f"[train] restored checkpoint at step {start_step}")

    data = TokenStream(DataConfig(
        global_batch=loop.global_batch, seq_len=loop.seq_len,
        vocab_size=cfg.vocab_size, seed=loop.seed))

    hb = HeartbeatMonitor(n_hosts=1)
    strag = StragglerMitigator(n_hosts=1)
    clock = StepClock(0, hb, strag)
    clock.step = start_step
    history = []
    for step in range(start_step, loop.total_steps):
        if inject_failure_at is not None and step == inject_failure_at:
            raise RuntimeError(f"injected failure at step {step}")
        with clock:
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            # float() reads each metric back: the step's device work is done
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
        history.append({"step": step, **metrics})
        if on_step:
            on_step(step, metrics)
        if step % loop.log_every == 0:
            print(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} gnorm {metrics['grad_norm']:.3f} "
                  f"({metrics['step_time_s']:.2f}s)")
        if step > 0 and step % loop.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    ckpt.save(loop.total_steps, {"params": params, "opt": opt_state},
              blocking=True)
    return {"history": history, "params": params,
            "final_loss": history[-1]["loss"] if history else None,
            "stragglers": strag.flagged}


def _mesh_state(cfg, opt, loop, params, mesh, moe_impl):
    """This rank's parameter shards (cut from the whole draw), its ZeRO
    moments and the mesh train step."""
    if cfg.is_moe and moe_impl is not None:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    specs = param_specs(cfg)
    osh = compute_shardings(specs, mesh, cfg, moe_impl)
    zsh = param_shardings(specs, mesh, cfg, extra_batch_dim=True)

    def local(t, sh):
        return shard_of(t, sh).clone() if any(sh.spec) else t
    params = tree_map(local, params, osh)
    opt_state = opt_init(params, zero_shardings=zsh, out_shardings=osh)
    step_fn = make_train_step(cfg, opt, mesh=mesh, moe_impl=moe_impl,
                              n_microbatches=loop.n_microbatches,
                              grad_shardings=zsh, param_out_shardings=osh)
    return params, opt_state, step_fn

