"""Port of ``src/repro/kernels/pg/ops.py``: the single-instance round's
inner step over K2's ``masked_argmax``.

The same contract as ``repro_torch.core.greedy._inner_torch``: the
per-allocation gradient (A·m work) and the capacity mask as plain torch
ops, K2 for the (T × A) masked reduction. The port's single solve runs the
whole round, this step included, in one launch of K2's round kernel
(``pg.py::bind_round``); its plain version ``pg.py::admission_round_ref``
follows this step.
"""

from __future__ import annotations

import torch

from . import pg as pg_kernel

__all__ = ["pg_argmax"]


def pg_argmax(grid, price, cap, occupied, remaining, lat_ok, alive, cost,
              *, flexible: bool = True):
    """Returns (G (T,), best_a (T,), has_feasible (T,)) for one round.

    ``grid`` (A, m), ``price``/``cap``/``occupied``/``remaining`` (m,) and
    ``cost`` (A,) are float32; ``lat_ok`` (T, A) and ``alive`` (T,) bool.
    The selection score is the primal gradient (flexible) or -cost (MinRes);
    the task priority G is always the gradient at the selected allocation.
    """
    from ...core.greedy import primal_gradient

    cap_ok = (grid <= remaining[None, :] + 1e-9).all(dim=1)          # (A,)
    pg = primal_gradient(grid, price, cap, occupied)                 # (A,)
    sel = pg if flexible else -cost
    g, best_a = pg_kernel.masked_argmax(sel, lat_ok, cap_ok, alive)
    best_a = best_a.long()
    has = g > float("-inf")
    G = torch.where(has, g if flexible else pg[best_a], float("-inf"))
    return G, best_a, has
