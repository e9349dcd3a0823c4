"""Per-rank counts of one step: the role of ``src/repro/launch/
hlo_analysis.py``, which reads XLA's partitioned HLO. Torch produces no
HLO, so the port counts the step as it runs on one rank's ``meta``
tensors (no storage, no card), under :class:`CostMode`, a
``TorchDispatchMode`` that sees every operator the step dispatches,
autograd's backward included:

* ``flops``: the matrix products' flops, by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, convolutions, ...) and K4's and
  K4′'s (``kernels/attn/attn.py`` registers them: every query against
  every key, as the reference's attention computes it, causal or not);
* ``product_bytes``: the products' operand and output bytes, the
  reference's ``dot_bytes``, a lower bound of the HBM traffic;
* ``collective_bytes`` and ``collective_counts`` by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``, ``broadcast``): the
  operand bytes of each ``c10d`` collective, as the reference counts its
  HLO collectives' operands;
* ``peak_bytes``: the largest sum, over the step, of the bytes of the
  storages alive at once — the arguments the caller :meth:`CostMode.track`
  s and every storage an operator makes, freed when the last tensor on it
  goes — plus, at K4′'s call, the scratch its kernel allocates. The
  counterpart of ``memory_analysis()``'s arguments plus temporaries.

The reference's loop-aware trip counts have no counterpart: the port's
layers and microbatches are Python loops, so each is counted as it runs.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["CostMode", "StepCost", "count"]

_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}
# the c10d operators' operand: the tensors each sends (the reference counts
# an HLO collective's operands)
_SENT = {"allgather_": 1, "_allgather_base_": 1,
         "allgather_into_tensor_coalesced_": 1, "allgather_coalesced_": 1,
         "reduce_scatter_": 1, "_reduce_scatter_base_": 1,
         "reduce_scatter_tensor_coalesced_": 1, "alltoall_": 1,
         "alltoall_base_": 1}
# products whose first argument is an added term, not a factor
_BIASED = ("addmm", "baddbmm", "addbmm", "addmv", "addr")


@dataclasses.dataclass
class StepCost:
    """One rank's counts of a step (see the module)."""

    flops: float = 0.0
    product_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0

    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts what the module describes while active; read :attr:`cost`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.cost = StepCost()
        self._live: dict[int, int] = {}
        self._ignored: set[int] = set()
        self._now = 0

    # --- storages ------------------------------------------------------
    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._ignored:
            return
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        weakref.finalize(st, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)

    def track(self, *trees) -> int:
        """Count the storages of ``trees``' tensors as arguments (alive
        from now until their last tensor goes); → their bytes."""
        before = self._now
        for t in _tensors(trees):
            self._hold(t)
        added = self._now - before
        self.cost.argument_bytes += added
        return added

    def ignore(self, *trees) -> None:
        """Leave the storages of ``trees``' tensors, and their views, out
        of the count (a global batch of which the rank reads its rows)."""
        self._ignored.update(t.untyped_storage()._cdata
                             for t in _tensors(trees))

    def add_argument_bytes(self, n: int) -> None:
        """Count ``n`` bytes of arguments held for the whole step that are
        not tensors of their own (a rank's rows of a batch it reads as a
        view of the global batch)."""
        self._now += n
        self.cost.argument_bytes += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)

    # --- operators -----------------------------------------------------
    def _product(self, func, args, kwargs, out) -> None:
        formula = self.flop_registry.get(func._overloadpacket)
        if formula is None:
            return
        self.cost.flops += formula(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        if func._overloadpacket.__name__ in _BIASED:
            ins = ins[1:3]
        elif len(ins) > 2 and func.namespace == "aten":
            ins = ins[:2]
        self.cost.product_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in _tensors(out))

    def _collective(self, func, args) -> None:
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is None:
            return
        sent = args[_SENT.get(name, 0)]
        n = sum(_nbytes(t) for t in _tensors(sent))
        self.cost.collective_bytes[kind] = \
            self.cost.collective_bytes.get(kind, 0.0) + n
        self.cost.collective_counts[kind] = \
            self.cost.collective_counts.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
        else:
            self._product(func, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        if func.namespace == "repro_torch":
            # the kernel's scratch lives beside its outputs during the call
            from ..kernels.attn import attn as A
            scratch = A.scratch_bytes(func._overloadpacket.__name__, *args)
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._now + scratch)
        return out


def count(fn, *args, track=(), ignore=(), extra_argument_bytes: int = 0,
          **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostMode` whose arguments
    are the storages of ``track`` and ``extra_argument_bytes`` more, the
    storages of ``ignore`` left out → (its result, the
    :class:`StepCost`)."""
    mode = CostMode()
    mode.track(*track)
    mode.ignore(*ignore)
    mode.add_argument_bytes(extra_argument_bytes)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.cost
