"""The readings the check's limits are set from, for one cell, on the card
at the cell's own size (not run by the benchmark's runs):

    python3 portbench/calibrate.py --workload NAME --seeds S1,S2,...
        [--control S1,S2,...] [--calls N] [--fault NAME] [--out FILE]

For each seed of ``--seeds`` the program runs the cell's set-up and
``--calls`` calls of its window (a prefill: the kept call; a decode: that
many steps of the first segment), and its answers are held against the
float32 reference: the program's readings. For each seed of
``--control`` the reference computed in the step below the
configuration's precision (fp8 products) stands in the program's place:
the control's readings. ``--fault`` plants one of the faults of
``tests/test_portbench_faults.py`` in the program first (its readings at
the cell's size). Each reading is a JSON line, on standard output and
appended to ``--out``.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), HERE]

import torch  # noqa: E402

from pbench import loops  # noqa: E402
from pbench.harness import forbidden_modules, port_config  # noqa: E402
from pbench.spec import Spec  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.fault:
        plant(a.fault)
    spec = Spec()
    w = spec.workload(a.workload)
    c = spec.config(w["config"])["port"]
    traffic = spec.traffic(w["traffic"])
    cfg = port_config(c)
    dev = torch.device("cuda:0")
    for seed in dict.fromkeys(a.seeds + a.control):
        t0 = time.perf_counter()
        loop = loops.KINDS[traffic["kind"]](c, cfg, traffic, seed, dev)
        loop.setup()
        for i in range(a.calls):
            loop.call(i)
        ans = loop.answers()
        loop.release()
        t1 = time.perf_counter()
        ref = loop.reference("f32", ans)
        t2 = time.perf_counter()
        extra = {}
        if "grad" in ref:
            g = sorted(ref["grad"].values())
            extra["units_left_out"] = sum(v < 1e-3 * g[len(g) // 2]
                                          for v in g)
        if seed in a.seeds:
            emit({"workload": a.workload, "seed": seed, "side": "program",
                  "calls": a.calls, "program_s": t1 - t0,
                  "reference_s": t2 - t1, **extra,
                  **loop.compare(ans, ref)}, a.out)
        fed = {"tokens": ans.get("tokens")}
        del ans
        if seed in a.control:
            low = loop.reference("fp8", fed)
            emit({"workload": a.workload, "seed": seed, "side": "control",
                  "precision": "fp8", **loop.compare(low, ref)}, a.out)
            del low
        del ref, loop
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"calibrate: loaded {bad}", file=sys.stderr)
        return 3
    return 0


def plant(fault: str) -> None:
    """Breaks the program's entry point as the fault tests do."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_portbench_faults as F
    from repro_torch import models
    from repro_torch.training import optimizer
    for mod, entry, make in ((models, "prefill", F.prefill_faults),
                             (models, "decode_step", F.decode_faults),
                             (optimizer, "make_train_step", F.train_faults)):
        faults = make(getattr(mod, entry))
        if fault in faults:
            setattr(mod, entry, faults[fault])


if __name__ == "__main__":
    sys.exit(main())
