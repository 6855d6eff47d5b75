"""qwen3-14b [dense] — Qwen3 with qk_norm and GQA [hf:Qwen/Qwen3-8B].

40L, d_model 5120, 40 heads GQA kv=8, d_ff 17408 (SwiGLU), vocab 151936,
per-head RMSNorm on Q and K (qk_norm), no QKV bias.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    kind="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    mlp="swiglu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=352,
        vocab_size=512,
    )
