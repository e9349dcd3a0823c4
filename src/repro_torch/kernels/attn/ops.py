"""Port of ``src/repro/kernels/attn/ops.py``: the flash-attention prefill
wrapper's public name."""

from .attn import flash_attention_fwd

__all__ = ["flash_attention_fwd"]
