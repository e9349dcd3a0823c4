"""Port of ``examples/train_lm.py``: end-to-end driver, train a
~100M-param LM for a few hundred steps with checkpoint/restart fault
tolerance (deliverable (b)), and assert that the loss falls.

``--full-attention`` exists only in the port's driver: the config's
layers are all sliding-window ("local") layers, which take the banded
plain path in the reference and the port alike, so no kernel carries
them. The flag turns them into full-attention ("attn") layers with no
window, chatglm3-6b's kind, so that K4 and its gradient K4′ carry every
layer of the trained model.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--params-100m] [--full-attention]
Fast: PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 40   (tiny model)
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

from ..configs import get_smoke_config
from ..training import TrainLoopConfig, train


def config(params_100m: bool, full_attention: bool):
    """The driver's model: h2o-danube-3-4b's smoke config, or the
    reference's ~100M-param replacement of it, with every layer made a
    full-attention layer under ``full_attention``."""
    cfg = get_smoke_config("h2o-danube-3-4b")
    if params_100m:
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab_size=32000, window=256,
            chunk_q=128, chunk_k=128)
    if full_attention:
        cfg = dataclasses.replace(cfg, window=None, block_pattern=("attn",))
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--params-100m", action="store_true",
                    help="~100M-param config (slow on CPU; the 'real' run)")
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_train_lm"))
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--full-attention", action="store_true",
                    help="full-attention layers (K4 and K4′) in place of "
                         "the sliding-window ones")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config(args.params_100m, args.full_attention)
    n = cfg.param_count()
    print(f"[example] arch={cfg.name} params={n/1e6:.1f}M steps={args.steps}")

    loop = TrainLoopConfig(
        total_steps=args.steps, log_every=max(args.steps // 10, 1),
        checkpoint_every=max(args.steps // 3, 10),
        checkpoint_dir=args.ckpt_dir, global_batch=8,
        seq_len=256 if args.params_100m else 64)
    out = train(cfg, loop, device=args.device,
                inject_failure_at=args.inject_failure_at)
    first = out["history"][0]["loss"] if out["history"] else float("nan")
    print(f"[example] loss {first:.3f} -> {out['final_loss']:.3f} "
          f"(must decrease)")
    if not out["final_loss"] < first:
        raise AssertionError("training did not reduce the loss")
    return out


if __name__ == "__main__":
    main()
