"""qwen1.5-32b [dense] — Qwen1.5 family with QKV bias [hf:Qwen/Qwen1.5-0.5B].

64L, d_model 5120, 40 heads (GQA kv=40 — i.e. MHA), d_ff 27392 (SwiGLU),
vocab 152064, QKV projection bias.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    kind="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    mlp="swiglu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen1.5-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=344,
        vocab_size=512,
    )
