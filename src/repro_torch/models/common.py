"""Port of ``src/repro/models/common.py``: a copy of ``ModelConfig``.

Model configuration shared by every architecture in the zoo.

One composable decoder/enc-dec stack covers all 10 assigned architectures; the
differences are expressed as data in :class:`ModelConfig`:

* ``block_pattern`` — the repeating unit of layer kinds, e.g.
  ``("attn",)`` (granite), ``("local",)*5 + ("global",)`` (gemma3),
  ``("rec", "rec", "attn_local")`` (recurrentgemma), ``("rwkv",)`` (rwkv6).
  Layers are stacked as pattern-repeats and scanned with ``lax.scan`` — this
  keeps the lowered HLO size O(pattern) instead of O(layers), which is what
  makes 88-94-layer dry-run compiles tractable.
* ``moe`` fields — Mixtral / Qwen3-MoE expert parallelism.
* ``encoder_layers > 0`` — whisper-style encoder-decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal

__all__ = ["ModelConfig", "ATTN_KINDS", "REC_KINDS", "TensorSpec"]

ATTN_KINDS = ("attn", "local")
REC_KINDS = ("rec", "rwkv")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not allocated yet (the port's counterpart
    of ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                       # 0 → d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 4096                    # sliding window for "local" kind
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0            # chatglm3: rotary on half the dims
    qk_norm: bool = False                 # chameleon / qwen3
    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    # --- MoE ---
    n_experts: int = 0                    # 0 → dense FFN
    top_k: int = 0
    d_expert: int = 0
    moe_impl: Literal["dense", "ep"] = "dense"
    moe_psum_late: bool = False   # TP-MoE: reduce after combine (§Perf)
    capacity_factor: float = 1.25
    # --- recurrent (RG-LRU / RWKV6) ---
    d_rnn: int = 0                        # RG-LRU recurrence width
    conv_width: int = 4                   # temporal conv in the rec block
    rwkv_head_dim: int = 64
    chunk_rec: int = 32                   # chunk size for linear recurrences
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_bidirectional: bool = True
    frontend: Literal["tokens", "stub_embeddings"] = "tokens"
    # --- numerics / misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing"   # "nothing" | "dots_no_batch"
    unroll_scan: bool = False     # fully unroll all scans (HLO-analysis oracle)
    logit_softcap: float = 0.0
    # attention chunking (flash-style streaming softmax in pure JAX)
    chunk_q: int = 512
    chunk_k: int = 512

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        assert self.n_layers >= len(self.block_pattern)

    # --- derived layer layout ------------------------------------------------
    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_repeats(self) -> int:
        """Full repetitions of block_pattern that are scanned."""
        return self.n_layers // self.pattern_len

    @property
    def remainder_kinds(self) -> tuple[str, ...]:
        """Trailing layers that don't fill a pattern repeat (applied unrolled).

        e.g. recurrentgemma: 38 layers = 12 × (rec, rec, attn_local) + (rec, rec).
        """
        r = self.n_layers - self.n_repeats * self.pattern_len
        return self.block_pattern[:r]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count N (used for 6·N·D roofline bookkeeping)."""
        d, dh = self.d_model, self.d_head
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * dh * n_q + 2 * d * dh * n_kv + dh * n_q * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_expert + d * self.n_experts
        else:
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            ffn = mult * d * self.d_ff
        rec = 0
        if "rec" in self.block_pattern:
            dr = self.d_rnn or d
            rec = 2 * d * dr + dr * d + 2 * dr + self.conv_width * dr
        per_layer = {
            "attn": attn + ffn, "local": attn + ffn, "global": attn + ffn,
            "rec": rec + ffn, "rwkv": 5 * d * d + 3 * d * self.d_ff,
        }
        total = sum(per_layer.get(k, attn + ffn)
                    for k in (self.block_pattern * self.n_repeats
                              + self.remainder_kinds))
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            total += self.encoder_layers * (attn + ffn) \
                + self.n_layers * (attn)          # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * self.d_model * self.d_expert
        moe_active = self.n_layers * self.top_k * 3 * self.d_model * self.d_expert
        return int(full - moe_all + moe_active)
