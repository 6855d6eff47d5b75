"""rwkv6-3b [ssm] — RWKV-6 "Finch" with data-dependent decay
[arXiv:2404.05892].

32L, d_model 2560 (attention-free; 40 heads of size 64), channel-mix
d_ff 8960, vocab 65536. O(1)-state decode -> runs long_500k natively.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    kind="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # informational; mixer uses rwkv_head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    rwkv_head_size=64,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="rwkv6-smoke",
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        d_ff=448,
        vocab_size=512,
        rwkv_head_size=64,
    )
