"""Port of ``src/repro/configs/h2o_danube3_4b.py`` (pure data).

h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000. llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. SWA → sub-quadratic → long_500k runs."""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = True


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
        d_ff=10240, vocab_size=32000,
        block_pattern=("local",), window=4096, mlp_kind="swiglu",
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
