"""Shared transformer layers, dense subset — counterpart of
``repro/models/layers.py``: norms, RoPE, GQA attention (full sequence and
cached decode) and the dense MLPs.

Plain functions on tensors over the reference's params dicts (created by
the matching ``init_*`` from an explicit ``torch.Generator``, or bridged
from the reference). Cached decode differs from the reference in one way:
``attention_decode`` writes the new K/V into the cache tensors in place
(the reference returns updated copies), so a step moves one slot of the
cache, not all of it. The scores, the masked softmax and the PV product
of a decode step are K4 (``kernels/decode_attention.py``). Long-sequence
attention (``flash.py``, ``blockwise_sdpa``), the int8 KV cache and MoE
are not ported yet: they raise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as k4
from repro_torch.models.config import ModelConfig

#: what a caller reads when a part of the zoo is not ported yet.
NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1 item 18)"

# ------------------------------------------------------------------ norms ---


def init_rmsnorm(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device=None) -> dict:
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ------------------------------------------------------------------- RoPE ---


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) or (T,). The two halves of hd
    rotate against each other (split, not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention ---


def _winit(gen: torch.Generator, shape, dtype, device=None, scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights with std ``scale`` (default 1/sqrt(fan_in)), drawn in
    fp32 on the generator's device, then cast and moved."""
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    std = scale if scale is not None else (1.0 / np.sqrt(fan_in))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std
    return w.to(device=device, dtype=dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": _winit(gen, (d, q_out), cfg.dtype, device),
        "wk": _winit(gen, (d, kv_out), cfg.dtype, device),
        "wv": _winit(gen, (d, kv_out), cfg.dtype, device),
        "wo": _winit(gen, (q_out, d), cfg.dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((q_out,), dtype=cfg.dtype, device=device)
        p["bk"] = torch.zeros((kv_out,), dtype=cfg.dtype, device=device)
        p["bv"] = torch.zeros((kv_out,), dtype=cfg.dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, cfg.dtype, device)
        p["k_norm"] = init_rmsnorm(hd, cfg.dtype, device)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions, *, rope: bool = True):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.num_heads, hd)
    k = k.reshape(B, T, cfg.num_kv_heads, hd)
    v = v.reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd) by repeating each kv head."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def sdpa(q, k, v, *, causal: bool, sliding_window: Optional[int] = None,
         q_offset: int = 0) -> torch.Tensor:
    """Naive attention. q: (B, Tq, H, hd), k/v: (B, Tk, H, hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    tq, tk = q.shape[1], k.shape[1]
    qpos = torch.arange(tq, device=q.device) + q_offset
    kpos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if sliding_window is not None:
        mask &= kpos[None, :] > qpos[:, None] - sliding_window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# Threshold above which training/prefill attention switches to blockwise.
BLOCKWISE_THRESHOLD = 2048


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    rope: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill), the reference's
    short-sequence branch: T <= BLOCKWISE_THRESHOLD (or the census pass,
    ``scan_unroll``)."""
    if x.shape[1] > BLOCKWISE_THRESHOLD and not cfg.scan_unroll:
        raise ValueError(
            f"attention over {x.shape[1]} > {BLOCKWISE_THRESHOLD} tokens takes flash.py's "
            f"blockwise path, {NOT_PORTED}"
        )
    q, k, v = _project_qkv(p, x, cfg, positions, rope=rope)
    k = _repeat_kv(k, cfg.num_heads)
    v = _repeat_kv(v, cfg.num_heads)
    out = sdpa(q, k, v, causal=causal, sliding_window=cfg.sliding_window)
    B, T = x.shape[:2]
    return out.reshape(B, T, -1) @ p["wo"]


def attention_decode(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: int,
    *,
    rope: bool = True,
    pos_dev: Optional[torch.Tensor] = None,
):
    """One-token decode against a (B, S, KV, hd) cache.

    ``pos`` (a host int): current position; the new K/V are written at
    ``pos % S``, in place — plain append for full attention (S = max seq),
    ring-buffer overwrite for sliding-window caches (S = window), where
    every resident slot is valid once pos >= S. Then K4 attends to slots
    [0, min(pos, S - 1)] (the reference's mask): K4 takes ``pos_dev``, the
    same position as a (1,) int32 tensor on x's device, when it is given
    (K4 clamps it to S - 1 itself), else the host int. Returns (out,
    cache_k, cache_v), the caches the same tensors as given."""
    if cfg.kv_quant:
        raise ValueError(f"the int8 KV cache (kv_quant) is {NOT_PORTED}")
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, rope=rope)
    S = cache_k.shape[1]
    slot = pos % S
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    out = k4.decode_attention(q.to(cache_k.dtype), cache_k, cache_v, min(pos, S - 1) if pos_dev is None else pos_dev)
    out = out.to(x.dtype).reshape(B, 1, -1) @ p["wo"]
    return out, cache_k, cache_v


# ------------------------------------------------------------------- MLPs ---


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None, device=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": _winit(gen, (d, f), cfg.dtype, device),
            "w_up": _winit(gen, (d, f), cfg.dtype, device),
            "w_down": _winit(gen, (f, d), cfg.dtype, device),
        }
    return {
        "w_up": _winit(gen, (d, f), cfg.dtype, device),
        "b_up": torch.zeros((f,), dtype=cfg.dtype, device=device),
        "w_down": _winit(gen, (f, d), cfg.dtype, device),
        "b_down": torch.zeros((d,), dtype=cfg.dtype, device=device),
    }


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if cfg.mlp == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh") @ p["w_down"] + p["b_down"]
