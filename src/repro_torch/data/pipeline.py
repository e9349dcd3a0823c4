"""Port of ``src/repro/data/pipeline.py`` (the port's own numpy copy):
the trainer's token batches and the serving plane's frames.

Production shape: each host owns a disjoint shard of the global batch,
generation is a pure function of (seed, step, host), so a restarted job
resumes mid-stream with zero coordination — the checkpoint only needs the
step counter. Batches and frames are generated on the host with numpy
exactly as in the reference, so equal seeds give equal data in both
packages; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "FrameStream", "TokenStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenStream:
    """Deterministic LM token batches: batch(step) is pure in (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        # Zipf-ish marginal over the vocab, plus a copy task so tiny models
        # can visibly learn (loss decreases) in the examples.
        z = rng.zipf(1.3, size=(c.host_batch, c.seq_len))
        tokens = (z % (c.vocab_size - 2)).astype(np.int32) + 1
        half = c.seq_len // 2
        tokens[:, half:] = tokens[:, :c.seq_len - half]
        labels = np.concatenate(
            [tokens[:, 1:], np.full((c.host_batch, 1), -100, np.int32)],
            axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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
