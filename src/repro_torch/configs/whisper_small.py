"""whisper-small [audio] — encoder-decoder speech model [arXiv:2212.04356].

Decoder backbone: 12L, d_model 768, 12 heads (MHA), d_ff 3072 (GELU),
vocab 51865, LayerNorm, sinusoidal positions. 12-layer encoder consumes the
conv-frontend STUB's frame embeddings (B, 1500, 768) — the mel-spectrogram +
conv feature extractor is stubbed per the brief (input_specs provides frame
embeddings of the right shape).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    kind="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    mlp="gelu",
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_stub",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="whisper-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        encoder_layers=2,
        encoder_seq=60,
    )
