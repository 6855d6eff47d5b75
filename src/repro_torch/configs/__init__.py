"""Architecture registry: the 10 assigned configs — counterpart of
``repro/configs/__init__.py``.

``get(arch_id)`` -> full ModelConfig; ``get_smoke(arch_id)`` -> the reduced
same-family variant (<=2 repeats of the pattern, d_model<=512, <=4 experts)
used by the CPU tests. ``INPUT_SHAPES`` are the four assigned shapes. The
configs are data only: the port's model runs the dense family
(``models/model.py``) and raises for the others.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "tinyllama-1.1b",
    "qwen1.5-32b",
    "jamba-1.5-large-398b",
    "whisper-small",
    "kimi-k2-1t-a32b",
    "qwen3-14b",
    "internvl2-2b",
    "rwkv6-3b",
    "grok-1-314b",
    "gemma-7b",
]

# name -> (seq_len, global_batch, mode)
INPUT_SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")


def get(arch_id: str, **overrides):
    cfg = _module(arch_id).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(arch_id: str):
    return _module(arch_id).smoke()


def for_shape(arch_id: str, shape_name: str):
    """Config specialised for an input shape (long_500k switches dense
    archs to their sliding-window variant)."""
    cfg = get(arch_id)
    if shape_name == "long_500k" and cfg.kind in ("dense", "moe", "vlm", "encdec", "hybrid"):
        cfg = dataclasses.replace(cfg, sliding_window=8_192)
    return cfg
