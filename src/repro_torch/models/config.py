"""Unified model configuration for the architecture zoo — counterpart of
``repro/models/config.py``, field for field.

One ``ModelConfig`` drives every family (dense / MoE / hybrid / SSM /
enc-dec / VLM): the layer stack is a repeating *pattern* of block kinds
(``block_pattern``), each block's params are stacked over pattern
repeats, and the forward loops over repeats. ``dtype`` is a
``torch.dtype`` (the reference's ``jnp.bfloat16`` default becomes
``torch.bfloat16``). ``remat`` and ``scan_unroll`` steer the reference's
``lax.scan``; the port keeps them so that configs compare field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    kind: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    head_dim: int | None = None  # default d_model // num_heads (gemma: 256)
    qkv_bias: bool = False  # qwen1.5
    qk_norm: bool = False  # qwen3
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    logit_softcap: float | None = None

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    router_aux_weight: float = 0.01  # load-balance loss weight
    moe_capacity_factor: float = 1.25  # per-expert slot headroom (GShard)

    # --- hybrid (Jamba): layer i is attention iff i % attn_every == attn_offset
    attn_every: int = 0  # 0 -> all layers are attention
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- RWKV6 ---------------------------------------------------------------
    rwkv_head_size: int = 64

    # --- encoder-decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500  # 30 s of mel frames after the conv stub

    # --- modality frontend stubs (vlm / audio) --------------------------------
    frontend: str | None = None  # "vision_stub" | "audio_stub"
    num_patches: int = 0  # vision tokens prepended to the text sequence

    # --- long-context variant -------------------------------------------------
    sliding_window: int | None = None  # set for the long_500k dense variant
    # int8 KV cache: K/V stored as int8 with per-slot/per-kv-head f32 scales
    kv_quant: bool = False

    dtype: Any = torch.bfloat16
    remat: str = "full"
    scan_unroll: bool = False

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def block_pattern(self) -> list[str]:
        """The repeating unit of the layer stack.

        Block kinds: 'attn' | 'mamba' | 'rwkv', suffixed '_moe' when the
        position uses a MoE MLP. len(pattern) divides num_layers; params for
        position p are stacked over num_layers/len(pattern) repeats.
        """
        if self.kind == "ssm":
            return ["rwkv"]
        period = 1
        if self.attn_every:
            period = max(period, self.attn_every)
        if self.num_experts and self.moe_every > 1:
            period = max(period, self.moe_every)
        if self.attn_every and self.num_experts and self.moe_every > 1:
            period = math.lcm(self.attn_every, self.moe_every)
        pattern = []
        for i in range(period):
            mixer = "attn"
            if self.attn_every and i % self.attn_every != self.attn_offset:
                mixer = "mamba"
            moe = bool(self.num_experts) and (i % max(self.moe_every, 1) == self.moe_offset)
            pattern.append(mixer + ("_moe" if moe else ""))
        return pattern

    @property
    def num_repeats(self) -> int:
        pat = len(self.block_pattern())
        if self.num_layers % pat:
            raise ValueError(f"num_layers {self.num_layers} is not a multiple of the pattern length {pat}")
        return self.num_layers // pat

    # --- parameter counting ----------------------------------------------------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) — active counts top_k experts."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        if self.qkv_bias:
            attn += q + 2 * kv
        n_in = 2 if self.mlp in ("swiglu", "geglu") else 1
        dense_mlp = d * f * n_in + f * d
        moe_mlp = self.num_experts * dense_mlp + d * self.num_experts
        active_mlp = self.top_k * dense_mlp + d * self.num_experts if self.num_experts else dense_mlp
        din, ds = self.d_inner, self.mamba_d_state
        mamba = d * 2 * din + din * self.mamba_d_conv + din * (2 * ds + 1) + din + din * d
        rwkv = 6 * d * d + 2 * d  # time-mix projections (r,k,v,g,w,o) approx
        total = active = 0
        for blk in self.block_pattern():
            mixer = blk.split("_")[0]
            mix_p = {"attn": attn, "mamba": mamba, "rwkv": rwkv}[mixer]
            mlp_p = moe_mlp if blk.endswith("_moe") else dense_mlp
            act_p = active_mlp if blk.endswith("_moe") else mlp_p
            total += mix_p + mlp_p + 2 * d
            active += mix_p + act_p + 2 * d
        total *= self.num_repeats
        active *= self.num_repeats
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += emb + d
        active += emb + d
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            total += enc
            active += enc
        return {"total": int(total), "active": int(active)}
