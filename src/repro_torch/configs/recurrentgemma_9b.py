"""Port of ``src/repro/configs/recurrentgemma_9b.py`` (pure data).

recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Griffin: RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]. Pattern (rec, rec, local) ×12 + (rec, rec) remainder.
Recurrent state + window cache → long_500k runs."""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = True


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
        d_ff=12288, vocab_size=256000,
        block_pattern=("rec", "rec", "local"), window=2048,
        d_rnn=4096, conv_width=4, mlp_kind="geglu", tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
