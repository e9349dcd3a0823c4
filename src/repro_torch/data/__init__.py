"""Port of ``src/repro/data``: the trainer's token batches and the serving
plane's frame source."""

from .pipeline import DataConfig, FrameStream, TokenStream

__all__ = ["DataConfig", "FrameStream", "TokenStream"]
