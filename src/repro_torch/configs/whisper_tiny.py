"""Port of ``src/repro/configs/whisper_tiny.py`` (pure data).

whisper-tiny [audio]: enc-dec 4L+4L d_model=384 6H d_ff=1536 vocab=51865
[arXiv:2212.04356]. The conv audio frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, frames, d); a linear adapter projects them
into the encoder. RoPE replaces absolute positions (DESIGN.md §4).
Full attention, encoder-decoder → skip long_500k."""

from .base import ModelConfig, reduce_for_smoke

LONG_CONTEXT_OK = False


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
        d_ff=1536, vocab_size=51865,
        block_pattern=("attn",), mlp_kind="gelu",
        encoder_layers=4, frontend="stub_embeddings", tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(config())
