"""Port of ``src/repro/configs/chameleon_34b.py`` (pure data).

chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536. Early-fusion VLM: VQ image tokens live in the unified vocab, so
the backbone consumes plain token ids (the VQ tokenizer frontend is a stub
per the assignment). qk-norm as in the public model [arXiv:2405.09818].
Pure full attention → skip long_500k."""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = False


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22016, vocab_size=65536,
        block_pattern=("attn",), qk_norm=True, mlp_kind="swiglu",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
