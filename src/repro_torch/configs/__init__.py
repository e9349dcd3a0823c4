"""Port of ``src/repro/configs/__init__.py`` (pure data).

One config module per assigned architecture (+ smoke variants)."""

from . import (chameleon_34b, chatglm3_6b, gemma3_12b, granite_34b,
               h2o_danube3_4b, mixtral_8x7b, qwen3_moe_235b,
               recurrentgemma_9b, rwkv6_1b6, whisper_tiny)

ARCHS = {
    "granite-34b": granite_34b,
    "gemma3-12b": gemma3_12b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "chatglm3-6b": chatglm3_6b,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "rwkv6-1.6b": rwkv6_1b6,
    "chameleon-34b": chameleon_34b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "whisper-tiny": whisper_tiny,
}


def get_config(name: str):
    return ARCHS[name].config()


def get_smoke_config(name: str):
    return ARCHS[name].smoke_config()


def long_context_ok(name: str) -> bool:
    return ARCHS[name].LONG_CONTEXT_OK
