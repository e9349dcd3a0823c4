"""Port of ``src/repro/configs/rwkv6_1b6.py`` (pure data).

rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.

RWKV-6 "Finch" — data-dependent per-channel decay [arXiv:2404.05892].
O(1) recurrent state → long_500k runs (state, not KV cache).
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = True


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=7168, vocab_size=65536,
        block_pattern=("rwkv",), rwkv_head_dim=64,
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
