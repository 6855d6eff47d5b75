"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave with MoE
[arXiv:2403.19887].

72L, d_model 8192, 64 heads GQA kv=8, d_ff 24576, vocab 65536; MoE with 16
experts top-2 on every other layer; attention on 1 of every 8 layers
(position 4 of the period, per the Jamba paper), Mamba elsewhere.
Pattern period = lcm(8, 2) = 8 -> 9 scanned repeats.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    kind="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    mlp="swiglu",
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="jamba-smoke",
        num_layers=8,  # one full pattern period
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        top_k=2,
    )
