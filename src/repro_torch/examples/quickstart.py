"""Port of ``examples/quickstart.py``: solve one SF-ESP instance and inspect
the slicing decisions. Each algorithm runs the port's device solve
(``backend="torch"``), whose single-instance rounds are K2's on the card.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import (build_instance, check_solution, run_algorithm,
                    scenarios, semantics)
from ..kernels import resolve_device

ALGORITHMS = ("sem-o-ran", "si-edge", "minres-sem", "flexres-n-sem",
              "highcomp", "highres")


def main(argv=None) -> dict:
    """Print the reference's table and decisions; → {algorithm: Solution}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)

    # The paper's numerical setup: 2 resource types (RBG, GPU), tasks spread
    # over the Tab. II applications, "med" accuracy / "high" latency bounds.
    pool = scenarios.numerical_pool(2)
    tasks = scenarios.numerical_tasks(20, acc="med", lat="high", seed=0)
    inst = build_instance(pool, tasks)

    print(f"{'algorithm':15s} {'allocated':>9s} {'satisfied':>9s} "
          f"{'objective':>10s}")
    sols = {}
    for name in ALGORITHMS:
        sol = run_algorithm(name, inst, backend="torch", device=device)
        rep = check_solution(inst, sol)
        if not rep["capacity_ok"]:
            raise AssertionError(f"{name} exceeds the capacity")
        print(f"{name:15s} {sol.num_allocated:9d} {sol.num_satisfied:9d} "
              f"{sol.objective:10.2f}")
        sols[name] = sol

    sol = sols["sem-o-ran"]
    print("\nSEM-O-RAN decisions (admitted tasks):")
    for i in np.nonzero(sol.admitted)[0][:8]:
        app = semantics.APPS[tasks.app_idx[i]].name
        print(f"  task {i:2d} {app:20s} z={sol.z[i]:.2f} "
              f"alloc={dict(zip(pool.names, sol.alloc[i]))}")
    return sols


if __name__ == "__main__":
    main()
