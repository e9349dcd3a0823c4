"""Port of ``src/repro/configs/chatglm3_6b.py`` (pure data).

chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024. 2d-RoPE: rotary applied to half the head dims
(rope_fraction=0.5) [arXiv:2406.12793]. Pure full attention → skip long_500k.
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = False


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
        d_ff=13696, vocab_size=65024,
        block_pattern=("attn",), rope_fraction=0.5, mlp_kind="swiglu",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
