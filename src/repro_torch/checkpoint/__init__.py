"""Port of ``src/repro/checkpoint``: the sharded numpy checkpointer."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
