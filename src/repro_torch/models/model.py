"""LM assembly for the architecture zoo, dense family — counterpart of
``repro/models/model.py``.

Embeddings -> a loop over repeats of the config's block pattern (the
reference's ``lax.scan``) -> final norm -> unembed. The params are the
reference's tree: ``{"embed", "final_norm", "blocks", ["unembed"]}`` with
``"blocks"`` a tuple (one entry per pattern position) of dicts whose
leaves are stacked over repeats, so weights cross between the packages
unchanged (``repro_torch.bridge``).

Entry points, as the reference's:
  forward(params, batch, cfg)                  -> (logits, aux) training/prefill
  init_cache(cfg, batch, max_seq)              -> decode cache tree
  decode_step(params, token, cache, pos, cfg)  -> (logits, cache)

``decode_step`` takes ``pos`` as a host int and updates ``cache`` in place
(the reference returns a new cache); every attention layer of a step is
one launch of K4 on the card. This slice runs the dense family (attention
mixers, dense MLPs, tied or untied embeddings, qkv bias, qk-norm, logit
softcap, sliding-window ring caches); MoE, Mamba, RWKV, enc-dec, the
vision stub and the int8 KV cache raise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a family or option this slice does not run."""
    unported = []
    if cfg.kind != "dense":
        unported.append(f"the {cfg.kind!r} family")
    if any(kind != "attn" for kind in cfg.block_pattern()):
        unported.append(f"blocks {sorted(set(cfg.block_pattern()))}")
    if cfg.frontend is not None:
        unported.append(f"the {cfg.frontend} frontend")
    if cfg.encoder_layers:
        unported.append("the encoder")
    if cfg.kv_quant:
        unported.append("the int8 KV cache")
    if unported:
        raise ValueError(f"{cfg.name}: {', '.join(unported)}: {L.NOT_PORTED}")


# ----------------------------------------------------------------- blocks ---


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, device),
        "mlp": L.init_mlp(gen, cfg, device=device),
    }


def _apply_mlp_part(bp: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    h = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
    out, aux = L.mlp(bp["mlp"], h, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _apply_block(
    bp: dict, kind: str, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + L.attention(bp["attn"], h, cfg, positions, causal=causal)
    return _apply_mlp_part(bp, x, cfg)


# ------------------------------------------------------------------- init ---


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None, device=None):
    """Params of ``cfg`` on ``device``: the reference's tree, shapes, dtypes
    and init scales (normal weights at 1/sqrt(fan_in), the embedding at
    0.02, unit norms, zero biases). Numbers are drawn in fp32 on the
    generator's device (a CUDA generator keeps a full-width init on the
    card); they differ from the reference's for the same seed."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    blocks = []
    for kind in cfg.block_pattern():
        layers = [_init_block(gen, kind, cfg, dev) for _ in range(cfg.num_repeats)]
        blocks.append(tree.map(lambda *leaves: torch.stack(leaves), *layers))
        del layers
    params: dict[str, Any] = {
        "embed": L._winit(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype, dev, scale=0.02),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
        "blocks": tuple(blocks),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L._winit(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype, dev)
    return params


# ---------------------------------------------------------------- forward ---


def _layer(stacked: dict, r: int) -> dict:
    """Repeat ``r``'s slice of a tree stacked over repeats (views)."""
    return tree.map(lambda a: a[r], stacked)


def _scan_blocks(params, cfg: ModelConfig, x, positions, causal: bool = True):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.num_repeats):
        for pi, kind in enumerate(cfg.block_pattern()):
            x, a = _apply_block(_layer(params["blocks"][pi], r), kind, x, cfg, positions, causal)
            aux = aux + a
    return x, aux


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def forward(params, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill forward over ``batch["tokens"]`` (B, T).
    Returns (logits (B, T, V), moe aux loss: 0 for the dense family)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _scan_blocks(params, cfg, x, positions, causal=True)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), aux


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ----------------------------------------------------------------- decode ---


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Decode cache tree, stacked over repeats per pattern position: for
    attention positions {"k", "v"} of (R, B, S, KV, hd) in ``cfg.dtype``,
    zero (S = sliding window if set, else max_seq)."""
    check_supported(cfg)
    dev = resolve_device(device)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.num_repeats, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return tuple(
        {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
         "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
        for _ in cfg.block_pattern()
    )


def _decode_block(bp, kind, x, state, pos: int, cfg: ModelConfig, pos_dev: torch.Tensor):
    h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
    out, _, _ = L.attention_decode(bp["attn"], h, cfg, state["k"], state["v"], pos, pos_dev=pos_dev)
    x, _ = _apply_mlp_part(bp, x + out, cfg)
    return x, state


def decode_step(params, token: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    """One decode step. token: (B, 1) int; pos: the current sequence
    position (a host int). Writes the step's K/V into ``cache`` in place.
    The position goes to every layer's K4 as one (1,) int32 tensor on the
    token's device, filled once a step (a fill, not a copy from the host).
    Returns (logits (B, 1, V), cache)."""
    check_supported(cfg)
    pos = int(pos)
    x = _embed(params, token, cfg)
    pos_dev = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for r in range(cfg.num_repeats):
        for pi, kind in enumerate(cfg.block_pattern()):
            x, _ = _decode_block(_layer(params["blocks"][pi], r), kind, x, _layer(cache[pi], r), pos, cfg, pos_dev)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), cache
