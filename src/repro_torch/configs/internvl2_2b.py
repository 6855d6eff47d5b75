"""internvl2-2b [vlm] — InternViT vision encoder + InternLM2 LM
[arXiv:2404.16821].

LM backbone: 24L, d_model 2048, 16 heads GQA kv=8, d_ff 8192 (SwiGLU),
vocab 92553. The InternViT encoder + MLP projector are STUBBED per the
brief: input_specs provides 256 precomputed patch embeddings (B, 256, 2048)
which the model prepends to the token sequence through a learned projector.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    kind="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    mlp="swiglu",
    frontend="vision_stub",
    num_patches=256,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        num_patches=16,
    )
