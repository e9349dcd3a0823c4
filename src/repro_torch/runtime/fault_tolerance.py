"""Port of ``src/repro/runtime/fault_tolerance.py`` (the port's own copy),
held against it value for value by ``tests/test_torch_core.py`` and
``tests/test_torch_train_loop.py``.

Fault tolerance for the serving plane and the trainer: heartbeats,
straggler detection, elastic re-meshing.

* :class:`HeartbeatMonitor` — cells (or hosts) stamp a heartbeat each tick
  (or step); one silent for `timeout_steps` is declared dead.
* :class:`StragglerMitigator` — per-tick duration EWMA; a tick slower than
  `threshold ×` the EWMA marks the cell a straggler.
* :class:`ElasticMesh` — given the surviving host set, the largest
  (data × model) mesh that preserves the model axis, and the new per-host
  batch (a plan: the port's mesh trainer, ``training/train_loop.py``,
  runs on the ``DeviceMesh`` its caller builds, and nothing re-meshes a
  running job).
* :class:`StepClock` — stamps each step's duration into both monitors.
"""

from __future__ import annotations

import dataclasses
import time

__all__ = ["ElasticMesh", "HeartbeatMonitor", "StepClock",
           "StragglerMitigator"]


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_steps: int = 3):
        self.n_hosts = n_hosts
        self.timeout = timeout_steps
        self.last_seen = {h: 0 for h in range(n_hosts)}
        self.step = 0

    def beat(self, host: int, step: int):
        self.last_seen[host] = step
        self.step = max(self.step, step)

    def revive(self, host: int):
        """Re-admit a recovered host: its silence window restarts NOW.

        A host declared dead keeps its stale ``last_seen`` forever, so without
        this hook it would re-enter :meth:`dead_hosts` on the very next check
        even after a clean restart (the serving engine's
        ``recover_cell`` calls this before the cell beats again)."""
        self.last_seen[host] = self.step

    def dead_hosts(self) -> list[int]:
        return [h for h, s in self.last_seen.items()
                if self.step - s >= self.timeout]

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [h for h in range(self.n_hosts) if h not in dead]


class StragglerMitigator:
    def __init__(self, n_hosts: int, threshold: float = 2.0,
                 ewma: float = 0.9):
        self.threshold = threshold
        self.ewma_coef = ewma
        self.ewma = {h: None for h in range(n_hosts)}
        self.flagged: dict[int, int] = {}

    def record(self, host: int, duration_s: float) -> bool:
        """Returns True if this host is now considered a straggler."""
        prev = self.ewma[host]
        if prev is None:
            self.ewma[host] = duration_s
            return False
        slow = duration_s > self.threshold * prev
        self.ewma[host] = self.ewma_coef * prev + (1 - self.ewma_coef) \
            * duration_s
        if slow:
            self.flagged[host] = self.flagged.get(host, 0) + 1
        return slow

    def chronic(self, min_flags: int = 3) -> list[int]:
        return [h for h, n in self.flagged.items() if n >= min_flags]

    def reset(self, host: int):
        """Forget a host's EWMA and flags (it was replaced/restarted)."""
        self.ewma[host] = None
        self.flagged.pop(host, None)


@dataclasses.dataclass
class ElasticMesh:
    """Largest viable (data × model) mesh over the surviving hosts."""

    model_degree: int            # fixed by the checkpoint's param sharding
    chips_per_host: int

    def plan(self, alive_hosts: int, global_batch: int) -> dict:
        chips = alive_hosts * self.chips_per_host
        data_degree = max(1, chips // self.model_degree)
        # data axis must divide the global batch — round down to a divisor
        while data_degree > 1 and global_batch % data_degree != 0:
            data_degree -= 1
        return {
            "mesh_shape": (data_degree, self.model_degree),
            "chips_used": data_degree * self.model_degree,
            "chips_idle": chips - data_degree * self.model_degree,
            "host_batch": global_batch // data_degree,
        }


class StepClock:
    """Context helper stamping per-step durations into the monitors."""

    def __init__(self, host: int, hb: HeartbeatMonitor,
                 strag: StragglerMitigator):
        self.host, self.hb, self.strag = host, hb, strag
        self.step = 0

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self.t0
        self.step += 1
        self.hb.beat(self.host, self.step)
        self.strag.record(self.host, dt)
        return False
