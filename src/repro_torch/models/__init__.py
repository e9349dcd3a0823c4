"""Port of ``src/repro/models``: the model zoo's dense attention stack for
prefill (``"attn"`` and ``"local"`` blocks with a dense FFN)."""

from .common import ModelConfig, TensorSpec
from .model import cache_specs, init_cache, init_params, prefill

__all__ = ["ModelConfig", "TensorSpec", "cache_specs", "init_cache",
           "init_params", "prefill"]
