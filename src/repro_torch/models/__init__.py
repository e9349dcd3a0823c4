"""Port of ``src/repro/models``: the model zoo's prefill for all ten
configs: ``"attn"``, ``"local"``, ``"rec"`` (RG-LRU) and ``"rwkv"`` blocks,
dense or MoE FFNs, and the encoder-decoder with cross-attention."""

from .common import ModelConfig, TensorSpec
from .model import cache_specs, init_cache, init_params, prefill

__all__ = ["ModelConfig", "TensorSpec", "cache_specs", "init_cache",
           "init_params", "prefill"]
