"""Port of ``examples/slicing_demo.py``: semantic + flexible slicing
walk-through (paper Fig. 3 right / Fig. 7).

Shows the full O-RAN control flow: OSRs → SDLA curves → SESM slicing →
compression applied on real frames through K3, the resize kernel. The
re-slice is the engine's batched solve, K1 on the card.

Run: PYTHONPATH=src python -m repro_torch.examples.slicing_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..core import scenarios
from ..data import FrameStream
from ..kernels import resolve_device
from ..kernels.resize import ops as resize_ops
from ..serving import EdgeServingEngine, SliceRequest


def main(argv=None) -> EdgeServingEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    engine = EdgeServingEngine(scenarios.colosseum_pool(), device=device)

    # Step 1: the VNO submits three slice requests (Fig. 7's Bags/Animals/Flat)
    for app, acc in (("coco_bags", 0.30), ("coco_animals", 0.50),
                     ("cityscapes_flat", 0.30)):
        engine.submit(SliceRequest("object-recognition", "yolox", app,
                                   max_latency_s=0.7, min_accuracy=acc,
                                   jobs_per_sec=5.0))

    # Steps 2-6: SDLA curves + SESM slicing
    print("slicing decisions:")
    for d in engine.reslice():
        print(f"  {d.request.app_class:18s} admitted={d.admitted} "
              f"z={d.z:.2f} alloc={d.alloc} "
              f"E[lat]={d.expected_latency_s:.3f}s "
              f"E[acc]={d.expected_accuracy:.3f}")

    # data plane: the compression factor is real — frames are resized by z
    frames = FrameStream(128, 128).frames(0, 2)
    for rid, rt in engine.tasks.items():
        z = rt.decision.z
        out = resize_ops.compress_frames(torch.from_numpy(frames).to(device),
                                         z)
        ratio = out.shape[1] * out.shape[2] / (128 * 128)
        print(f"  task {rid}: frames {frames.shape[1:3]} -> "
              f"{tuple(out.shape[1:3])} (pixel ratio {ratio:.2f} ≈ z={z:.2f})")

    # run two seconds of traffic and report SLO compliance
    engine.process(wall_dt=1.0)
    engine.process(wall_dt=1.0)
    print("slice metrics:")
    for rid, m in engine.metrics().items():
        p50 = "n/a" if m["no_data"] else f"{m['p50_latency_s']:.3f}s"
        print(f"  {m['app']:18s} jobs={m['jobs_done']:3d} "
              f"p50={p50} deadline={m['deadline_s']}s "
              f"meets={m['meets_deadline']}")
    return engine


if __name__ == "__main__":
    main()
