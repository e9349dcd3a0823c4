"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The window is a closed loop with one caller: calls start until
``--seconds`` have passed, and the last one started is finished. With
``--trace 1`` the device is recorded over the window's first calls (the
cell file's ``trace_calls``) and the run reports the cell's per-layer
metrics; otherwise its end-to-end ones. Either way the window's answers
are then held against the reference, after the program's state is freed
and the memory peak read.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from . import loops, yardstick
from .devtrace import Recorder
from .spec import Spec
from .weights import flat, layout

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a metric's reader reads: the cell's configuration (``c``, the
    program's keys) and traffic, the window's calls ``(start, end,
    units)`` on the host's clock, the set-up time, and the device trace of
    a traced run (``trace``, else None)."""

    def __init__(self, cell, c, traffic, calls, setup_s, trace=None):
        self.cell, self.c, self.traffic = cell, c, traffic
        self.kind = traffic["kind"]
        self.calls, self.setup_s, self.trace = calls, setup_s, trace
        self.yard = yardstick

    @property
    def window_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0]

    @property
    def units(self) -> int:
        return sum(u for _, _, u in self.calls)

    def walls(self) -> list:
        """Each call's wall seconds, leaving out the traced calls where
        others ran."""
        skip = self.trace.calls if self.trace is not None else 0
        rest = self.calls[skip:] or self.calls
        return [e - s for s, e, _ in rest]

    def mean_wall(self) -> float:
        w = self.walls()
        return sum(w) / len(w)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_config(c: dict):
    """The program's ``ModelConfig`` of the configuration's ``port`` keys,
    its parameter tree held against the benchmark's layout."""
    from repro_torch.models import ModelConfig, param_specs
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c.items()})
    want = {p: ((c["n_layers"],) if p.startswith("scan.") else ())
            + tuple(s) for p, (s, _) in layout(c).items()}
    have = {p: tuple(t.shape) for p, t in flat(param_specs(cfg)).items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the program's parameter tree differs from the "
                         f"benchmark's: {diff}")
    return cfg


def window(loop, seconds: float, rec=None, traced: int = 0) -> list:
    calls, i = [], 0
    start = time.perf_counter()
    while True:
        if rec is not None and i < traced:
            with rec.span(f"{loop.kind} call"):
                t0 = time.perf_counter()
                n = loop.call(i)
                t1 = time.perf_counter()
            if i == traced - 1:
                rec.stop()
        else:
            t0 = time.perf_counter()
            n = loop.call(i)
            t1 = time.perf_counter()
        calls.append((t0, t1, n))
        i += 1
        if t1 - start >= seconds:
            return calls


def check(loop, limits: dict):
    """(correct, numbers): the window's answers against the reference;
    each number within its limit. A number whose limit the cell file
    gives as null is reported and not compared (it has no reading that
    separates the program from its control or faults); one the file
    does not name fails."""
    ans = loop.answers()
    loop.release()
    ref = loop.reference("f32", ans)
    nums = loop.compare(ans, ref)
    ok = all(k in limits and (limits[k] is None or (
        math.isfinite(v) and v <= limits[k])) for k, v in nums.items())
    return ok, nums


def main(argv=None, *, t0=None, root=None, device=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    spec = Spec(root)
    w = spec.workload(a.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < w["chips"]:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"portbench: {a.workload} needs {w['chips']} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    c = spec.config(w["config"])["port"]
    traffic = spec.traffic(w["traffic"])
    cell = spec.cell_file(a.workload)

    t_card = time.perf_counter()
    cfg = port_config(c)
    loop = loops.KINDS[traffic["kind"]](c, cfg, traffic, a.seed, dev)
    t_loop = time.perf_counter()
    loop.setup()
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: imports and the card "
          f"{t_card - t0:.3f} s, the program's configuration "
          f"{t_loop - t_card:.3f} s, the loop's set-up "
          f"{setup_s - (t_loop - t0):.3f} s", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)

    rec = Recorder() if a.trace else None
    calls = window(loop, a.seconds, rec, cell.get("trace_calls", 2))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    walls = [round(e - s, 4) for s, e, _ in calls]
    print(f"portbench: {len(calls)} calls, seconds each "
          f"{walls if len(walls) <= 24 else walls[:12] + ['...']}",
          file=sys.stderr)
    trace = rec.trace() if rec is not None else None

    try:
        correct, nums = check(loop, cell["limits"])
    except Exception:                      # the run's result says so
        traceback.print_exc()
        correct, nums = False, {}
    limits = cell["limits"]

    run = Run(a.workload, c, traffic, calls, setup_s, trace)
    metrics = {}
    for m in spec.metrics(a.workload, bool(a.trace)):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3

    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "count": w["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
           "metrics": metrics, "device": devinfo}
    if trace is not None:
        devinfo["busy_s"] = trace.busy_s()
        devinfo["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(),
                            "idle_gaps": trace.top_gaps()}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in nums.items()}
    for k, v in nums.items():
        print(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
