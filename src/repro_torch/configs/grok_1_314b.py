"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model 6144, 48 heads GQA kv=8, d_ff 32768, vocab 131072, MoE on
every layer (8 experts, top-2).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    kind="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    mlp="geglu",  # grok-1 experts are gated (3-matrix) FFNs — 2-matrix GELU
    # would give ~213B total; gated gives ~320B, matching the 314B card.
    num_experts=8,
    top_k=2,
    moe_every=1,
    moe_offset=0,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="grok-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        top_k=2,
    )
