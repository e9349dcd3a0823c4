"""Port of ``src/repro/configs/granite_34b.py`` (pure data).

granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch code model [arXiv:2405.04324]. Pure full attention → long_500k
shape is skipped (DESIGN.md §Arch-applicability).
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = False


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
        d_ff=24576, vocab_size=49152,
        block_pattern=("attn",), mlp_kind="swiglu",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
