"""Port of ``src/repro/launch/serve.py``: SEM-O-RAN admission + edge engine
with batched requests.

Runs the full control + data plane with a smoke-scale LM on the card
(``--device cuda``, the default) or on the host (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --ticks 1
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_smoke_config
from ..core import scenarios
from ..kernels import resolve_device
from ..models import init_params, prefill
from ..serving.engine import EdgeServingEngine
from ..serving.request import SliceRequest

__all__ = ["infer_fn", "main", "requests"]


def infer_fn(cfg):
    """The LM job's infer function: last-token logits of a prefill into a
    32-slot cache."""
    return lambda p, b: prefill(p, b, cfg, cache_len=32)[0]


def requests(arch: str) -> list[SliceRequest]:
    """The launcher's request mix: three vision streams and one LM service
    of model ``arch``."""
    return [
        SliceRequest("object-recognition", "yolox", "coco_bags",
                     max_latency_s=0.7, min_accuracy=0.30, jobs_per_sec=4),
        SliceRequest("object-recognition", "yolox", "coco_animals",
                     max_latency_s=0.7, min_accuracy=0.50, jobs_per_sec=4),
        SliceRequest("segmentation", "bisenetv2", "cityscapes_flat",
                     max_latency_s=0.7, min_accuracy=0.30, jobs_per_sec=4),
        SliceRequest("lm-serving", arch, "coco_person",
                     max_latency_s=0.7, min_accuracy=0.20, jobs_per_sec=2),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pool = scenarios.colosseum_pool()
    engine = EdgeServingEngine(pool, device=device)

    cfg = get_smoke_config(args.arch)
    params = init_params(torch.Generator(device).manual_seed(0), cfg, device)
    engine.register_model(args.arch, cfg, params, infer_fn(cfg))
    for req in requests(args.arch):
        engine.submit(req)

    decisions = engine.reslice()
    for d in decisions:
        print(f"[serve] {d.request.app_class:18s} admitted={d.admitted} "
              f"z={d.z:.2f} alloc={d.alloc} "
              f"E[lat]={d.expected_latency_s:.3f}s")
    for _ in range(args.ticks):
        engine.process(wall_dt=1.0)
    for rid, m in engine.metrics().items():
        p50 = "n/a" if m["no_data"] else f"{m['p50_latency_s']:.3f}s"
        print(f"[serve] task {rid} {m['app']:18s} jobs={m['jobs_done']} "
              f"p50={p50} deadline={m['deadline_s']}s "
              f"ok={m['meets_deadline']}")
    return engine


if __name__ == "__main__":
    main()
