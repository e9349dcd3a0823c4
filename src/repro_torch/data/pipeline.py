"""Port of ``src/repro/data/pipeline.py``: the serving plane's frame source.

Only :class:`FrameStream` is ported (the vision jobs of the serving tick read
it); ``TokenStream`` waits for the LM stack. Frames are generated on the host
with numpy from ``(seed, step)`` exactly as in the reference, so equal seeds
give equal frames in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FrameStream"]


class FrameStream:
    """Synthetic camera frames for the serving/compression path."""

    def __init__(self, height: int = 128, width: int = 128, channels: int = 3,
                 seed: int = 0):
        self.h, self.w, self.c = height, width, channels
        self.seed = seed

    def frames(self, step: int, batch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        # smooth "scene" (low-frequency) + detail, so compression is visible
        base = rng.standard_normal((batch, 8, 8, self.c))
        up = np.kron(base, np.ones((1, self.h // 8, self.w // 8, 1)))
        detail = 0.1 * rng.standard_normal((batch, self.h, self.w, self.c))
        return (up + detail).astype(np.float32)
