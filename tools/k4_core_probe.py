"""The CUDA-core K4 and K4′ (``csrc/flash_attn.cu``, ``csrc/flash_attn_bwd.cu``)
timed at the shapes of PERF.md's float32 rows, for the port under
``--src`` (default: this checkout's ``src``), so that two trees can be
compared on one card in one call: run it once for each, in turns (parent,
change, change, parent).

Each shape is timed as ms a call with CUDA events around ``iters``
back-to-back calls, the shapes taken in turn, 5 times; the median, least
and largest of the 5 are printed. K4′ runs on the CUDA-core route
(``bwd_launch("cuda_cores", ...)``: float32, and chatglm3-6b's bf16 held
there) given the CUDA-core K4's log-sum-exp where that kernel writes one;
a tree whose CUDA-core K4 does not (before the LSE was written there)
recomputes it in its own first pass, which is that tree's float32 path.

With ``--train-lm N`` it then runs the tree's ``train_lm --params-100m
--full-attention`` for N steps (float32, B 8, T 256: K4 and K4′ on the
CUDA cores in every layer) and reports the median ms a step of steps 10
on, a host-bound wall that moves between runs: compare it only in turns.

Run on a machine with a card: ``python3 tools/k4_core_probe.py [--src
DIR] [--tag NAME] [--train-lm N]`` (about a minute, the two kernels'
build included). Prints one JSON line: the card, the tree, the times by
shape and, from a ``torch.profiler`` trace of 3 calls a shape, each
shape's device µs a call by kernel (K4′'s passes).
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, (B, Tq, Tk, Hq, Hkv, Dh, causal), dtype, K4 or K4′, calls a run)
SHAPES = (
    ("k4_chatglm3", (2, 2048, 2048, 32, 2, 128, True), "float32", "fwd", 5),
    ("k4_train_lm", (8, 256, 256, 12, 4, 64, True), "float32", "fwd", 100),
    ("k4_whisper_enc", (2, 1500, 1500, 6, 6, 64, False), "float32", "fwd",
     20),
    ("k4b_train_lm", (8, 256, 256, 12, 4, 64, True), "float32", "bwd", 50),
    ("k4b_chatglm3_bf16", (2, 2048, 2048, 32, 2, 128, True), "bfloat16",
     "bwd", 3),
    ("k4b_chatglm3", (2, 2048, 2048, 32, 2, 128, True), "float32", "bwd", 3),
    ("k4b_whisper_enc", (2, 1500, 1500, 6, 6, 64, False), "float32", "bwd",
     10),
)


def ms_a_call(fn, iters: int) -> float:
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


def calls(PA, rng):
    """name → (the call, calls a run) for every shape of ``SHAPES``."""
    out = {}
    for name, (b, tq, tk, hq, hkv, dh, causal), dtype, what, iters in SHAPES:
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to("cuda", dt) for s in (
                (b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh),
                (b, tq, hq, dh)))
        if what == "fwd":
            out[name] = (lambda q=q, k=k, v=v, c=causal: PA.launch(
                "cuda_cores", q, k, v, causal=c), iters)
            continue
        try:
            o, lse = PA.launch("cuda_cores", q, k, v, causal=causal,
                               with_lse=True)
        except ValueError:          # a tree whose CUDA-core K4 writes none
            o, lse = PA.launch("cuda_cores", q, k, v, causal=causal), None
        out[name] = (lambda q=q, k=k, v=v, o=o, d=dout, c=causal, l=lse:
                     PA.bwd_launch("cuda_cores", q, k, v, o, d, causal=c,
                                   lse=l), iters)
    return out


def device_us(fn) -> dict:
    """Device µs a call of each kernel ``fn`` launches, over 3 calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(r"(\w+_kernel)", e.key)
        if us and name:
            out[name[1]] = out.get(name[1], 0.0) + us / 3
    return out


def train_lm(steps: int) -> dict:
    """The tree's ``train_lm --params-100m --full-attention`` for ``steps``
    steps in a fresh checkpoint directory: median ms a step from step 10
    on, and the final loss."""
    import tempfile
    from repro_torch.examples import train_lm as example
    with tempfile.TemporaryDirectory() as ckpt:
        out = example.main(["--device", "cuda", "--params-100m",
                            "--full-attention", "--steps", str(steps),
                            "--ckpt-dir", ckpt])
    secs = [h["step_time_s"] for h in out["history"][10:]]
    return dict(steps=steps, ms_per_step=1e3 * statistics.median(secs),
                final_loss=out["final_loss"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train-lm", type=int, default=0, metavar="N",
                    help="then N steps of train_lm --full-attention")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_core_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.attn import attn as PA
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = calls(PA, np.random.default_rng(0))
    for fn, _ in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(args.reps):
        for name, (fn, iters) in fns.items():
            times[name].append(ms_a_call(fn, iters))
    passes = {name: device_us(fn) for name, (fn, _) in fns.items()}
    train = train_lm(args.train_lm) if args.train_lm else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "tag": args.tag, "src": os.path.abspath(args.src), "card": card,
        "torch": torch.__version__,
        "ms": {n: dict(median=statistics.median(t), min=min(t), max=max(t))
               for n, t in times.items()}, "device_us": passes,
        "train_lm": train}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
