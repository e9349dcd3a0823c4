"""Port of ``src/repro/configs/qwen3_moe_235b.py`` (pure data).

qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) vocab=151936,
128 experts top-8, expert d_ff=1536, qk-norm [hf:Qwen/Qwen3-*].

MoE impl: "ep" — 128 experts shard 16-way (8 local experts/device) with
all_to_all dispatch. Full attention → skip long_500k.
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = False


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
        d_ff=1536, vocab_size=151936,
        block_pattern=("attn",), qk_norm=True, mlp_kind="swiglu",
        n_experts=128, top_k=8, d_expert=1536, moe_impl="ep",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
