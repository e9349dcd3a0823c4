"""Port of ``src/repro/models``: the model zoo's training forward (with its
backward), prefill and decode for all ten configs: ``"attn"``,
``"local"``, ``"rec"`` (RG-LRU) and ``"rwkv"`` blocks, dense or MoE FFNs,
and the encoder-decoder with cross-attention."""

from .common import ModelConfig, TensorSpec
from .model import (cache_specs, decode_step, forward_train, init_cache,
                    init_params, loss_fn, loss_sums, param_specs, prefill)

__all__ = ["ModelConfig", "TensorSpec", "cache_specs", "decode_step",
           "forward_train", "init_cache", "init_params", "loss_fn",
           "loss_sums", "param_specs", "prefill"]
