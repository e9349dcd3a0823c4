"""Port of ``src/repro/configs/mixtral_8x7b.py`` (pure data).

mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) expert d_ff=14336
vocab=32000, 8 experts top-2, SWA window 4096 [arXiv:2401.04088].

MoE impl: "tp" — 8 experts cannot expert-shard a 16-way model axis, so the
expert FFN hidden dim is tensor-parallel with local sort dispatch
(DESIGN.md §4). SWA → long_500k runs.
"""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = True


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=32000,
        block_pattern=("local",), window=4096, mlp_kind="swiglu",
        n_experts=8, top_k=2, d_expert=14336, moe_impl="tp",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
