"""gemma-7b [dense] — GeGLU MLP, head_dim 256, tied embeddings
[arXiv:2403.08295]. (MQA is the 2b variant; 7b uses 16 heads MHA.)

28L, d_model 3072, 16 heads kv=16, head_dim 256 (16*256 = 4096 > d_model),
d_ff 24576 (GeGLU), vocab 256000, embeddings scaled by sqrt(d_model) and
tied with the output head.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    kind="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=256,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="gemma-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
    )
