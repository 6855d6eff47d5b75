"""tinyllama-1.1b [dense] — Llama-2-architecture small model [arXiv:2401.02385].

22L, d_model 2048, 32 heads with GQA kv=4, d_ff 5632 (SwiGLU), vocab 32000,
RoPE, RMSNorm.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    kind="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    mlp="swiglu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="tinyllama-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=352,
        vocab_size=512,
    )
