"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 32B active
[arXiv:2501.kimi2 paper table].

61L, d_model 7168, 64 heads GQA kv=8, per-expert d_ff 2048, vocab 163840,
MoE with 384 experts top-8 on every layer (DeepSeek-V3-style fine-grained
experts).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    kind="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    mlp="swiglu",
    num_experts=384,
    top_k=8,
    moe_every=1,
    moe_offset=0,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="kimi-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        num_experts=4,
        top_k=2,
    )
