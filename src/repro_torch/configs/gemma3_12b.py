"""Port of ``src/repro/configs/gemma3_12b.py`` (pure data).

gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local:global attention pattern, 128k context [hf:google/gemma-3-*].
d_head=256 (gemma3 uses a decoupled head dim). Local window 1024.
The 5-local:1-global design is its sub-quadratic long-context mechanism →
long_500k runs (global layers SP-shard the KV over `data`).
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = True


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=15360, vocab_size=262144,
        block_pattern=("local",) * 5 + ("attn",), window=1024,
        mlp_kind="geglu", rope_theta=1_000_000.0, tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
