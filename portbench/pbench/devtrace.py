"""The device trace of a traced run: ``torch.profiler`` recording the
device's activity only (no host event of the program), over the first
calls of the window, read from the profiler's raw events (parsing them
into ``FunctionEvent`` s took minutes for a long trace). The harness's
own spans around its calls, stamped with the same wall clock the
profiler's events carry, name the idle gaps."""

from __future__ import annotations

import contextlib
import time

import torch

from . import yardstick as Y


class Trace:
    """Kernel intervals ``(name, start_ns, end_ns)`` of the traced calls,
    the spans ``(name, start_ns, end_ns)`` the harness opened around them,
    and the traced window [lo, hi] (the first span's start to the last
    span's end)."""

    def __init__(self, events: list, spans: list):
        self.spans = spans
        self.lo = min(s for _, s, _ in spans)
        self.hi = max(e for _, _, e in spans)
        first = min((s for _, s, _ in events), default=self.lo)
        last = max((e for _, _, e in events), default=self.hi)
        # events stamped on another clock than the spans' are moved so
        # that the first kernel starts with the first span
        shift = first - self.lo if first > self.hi or last < self.lo else 0
        self.events = [(n, s - shift, e - shift) for n, s, e in events]

    @property
    def calls(self) -> int:
        return len(self.spans)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return Y.union_seconds([(s, e) for _, s, e in self.events])

    def seconds(self, pick) -> float:
        """Device seconds in the kernels whose name ``pick`` accepts."""
        return sum(e - s for n, s, e in self.events if pick(n)) / 1e9

    def count(self, pick=lambda n: True) -> int:
        return sum(1 for n, _, _ in self.events if pick(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.events:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def top_gaps(self, k: int = 10) -> list:
        """The longest idle gaps of the window, each named by the
        harness's span open at its middle ("between calls" if none)."""
        gaps = Y.idle_gaps([(s, e) for _, s, e in self.events], self.lo,
                           self.hi)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) // 2
            name = next((n for n, a, b in self.spans if a <= mid <= b),
                        "between calls")
            out.append([name, (e - s) / 1e9])
        return out


class Recorder:
    """Records the device over the calls made inside :meth:`span` while
    active; :meth:`trace` gives the :class:`Trace` after :meth:`stop`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.spans: list = []
        self.prof.__enter__()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def trace(self) -> Trace:
        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        return Trace(events, self.spans)
