"""Port of ``src/repro/data``: the serving plane's frame source."""

from .pipeline import FrameStream

__all__ = ["FrameStream"]
