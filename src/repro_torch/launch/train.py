"""Port of ``src/repro/launch/train.py``: the train launcher, the
fault-tolerant loop on one device.

With ``--smoke`` it trains a reduced config of the chosen arch; on the
card (``--device cuda``, the default) or on the host (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 4
"""

from __future__ import annotations

import argparse

from ..configs import get_config, get_smoke_config
from ..training.train_loop import TrainLoopConfig, train

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=TrainLoopConfig.checkpoint_dir)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = TrainLoopConfig(total_steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq, checkpoint_dir=args.ckpt_dir)
    out = train(cfg, loop, device=args.device,
                inject_failure_at=args.inject_failure_at)
    print(f"[train] done; final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
