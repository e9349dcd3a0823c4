"""Port of ``src/repro/training/train_loop.py``: the training loop with
checkpoint/restart, heartbeats and straggler tracking.

The loop is host-driven: draw the parameters from a seeded generator on the
device, restore the latest checkpoint if any (fault-tolerant restart), then
step the deterministic data pipeline from the restored step. Failure
injection exercises the restart path. On one device: the reference's mesh
waits for the port's ``distributed/``.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import DataConfig, TokenStream
from ..kernels import resolve_device
from ..models import init_params
from ..runtime.fault_tolerance import (HeartbeatMonitor, StepClock,
                                       StragglerMitigator)
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


def train(cfg, loop: TrainLoopConfig, *, device="cuda",
          opt: OptConfig | None = None,
          on_step: Callable[[int, dict], None] | None = None,
          inject_failure_at: int | None = None) -> dict:
    """Run (or resume) training of ``cfg`` on ``device`` (a CUDA card
    unless the caller asks for the CPU); returns the metrics history, the
    parameters, the final loss and the flagged stragglers. The reference's
    loop semantics: the latest checkpoint restored (``[train] restored
    checkpoint at step N``), the data stepped from there, a heartbeat and a
    straggler record a step (``StepClock``), a save at every
    ``checkpoint_every``-th step under the name ``step + 1``, and a final
    blocking save."""
    device = resolve_device(device)
    opt = opt or OptConfig(total_steps=loop.total_steps)
    gen = torch.Generator(device=device).manual_seed(loop.seed)
    params = init_params(gen, cfg, device)
    opt_state = opt_init(params)

    ckpt = Checkpointer(loop.checkpoint_dir)
    start_step = 0
    restored = ckpt.restore_latest({"params": params, "opt": opt_state})
    if restored is not None:
        start_step, state = restored
        params, opt_state = state["params"], state["opt"]
        print(f"[train] restored checkpoint at step {start_step}")

    data = TokenStream(DataConfig(
        global_batch=loop.global_batch, seq_len=loop.seq_len,
        vocab_size=cfg.vocab_size, seed=loop.seed))
    step_fn = make_train_step(cfg, opt, n_microbatches=loop.n_microbatches)

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
