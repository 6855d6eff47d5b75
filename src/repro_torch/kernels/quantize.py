"""Precision policy of the port: the fp32 subset of ``repro/kernels/quantize.py``.

The reference names three storage policies (fp32 | bf16 | int8w). The port
runs fp32 only so far: its bf16 and int8w kernels come with the quantize
slice of the port (ROADMAP Queue 1, item 11), and until then those names
raise a ``ValueError`` that says so. ``"auto"`` therefore resolves to
fp32 on every device here, where the reference picks bf16 (int8w for wide
models) on its accelerator.
"""

from __future__ import annotations

from typing import Any, Optional

#: the reference's storage policies, plus the sentinel the pipeline resolves.
PRECISIONS = ("fp32", "bf16", "int8w")
AUTO = "auto"

_ACT_BYTES = {"fp32": 4}
_WEIGHT_BYTES = {"fp32": 4}


def validate(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS} "
            f"(or {AUTO!r} where a resolver is available)"
        )
    if precision not in _ACT_BYTES:
        raise ValueError(
            f"precision {precision!r} is not ported yet: it comes with the "
            "quantize slice of the port (ROADMAP Queue 1, item 11); use 'fp32'"
        )
    return precision


def act_bytes(precision: str) -> int:
    """Bytes per activation element under ``precision``."""
    return _ACT_BYTES[validate(precision)]


def resolve_precision(name: Optional[str], model: Any = None) -> str:
    """Map None/"auto" to the port's default, fp32; validate explicit names."""
    if name is not None and name != AUTO:
        return validate(name)
    return "fp32"


def model_params_bytes(cfg: Any, precision: str = "fp32") -> int:
    """Analytic bytes of a MeshNet params tree: conv taps, biases and BN
    vectors, and the 1x1x1 head, at the policy's widths."""
    wb = _WEIGHT_BYTES[validate(precision)]
    k = cfg.kernel_size ** 3
    total = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        total += k * cin * cfg.channels * wb
        total += cfg.channels * 4
        if cfg.use_batchnorm:
            total += 4 * cfg.channels * 4
        cin = cfg.channels
    total += cfg.channels * cfg.num_classes * wb + cfg.num_classes * 4
    return total
