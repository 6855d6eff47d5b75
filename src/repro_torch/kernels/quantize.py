"""Precision policy of the port: counterpart of ``repro/kernels/quantize.py``.

Three storage policies, as the reference's:

  ``fp32``  — nothing is cast; the fp32 kernels (K1, K2) and the plain
              forward.
  ``bf16``  — conv and head weights and the activations are bfloat16;
              every conv accumulates in fp32 and rounds once per layer,
              at its output write (K1r, ``csrc/dilated_conv3d_lp.cu``;
              K2r, ``csrc/megakernel_lp.cu``, inside a segment too).
  ``int8w`` — per-output-channel symmetric int8 conv weights, their
              dequant scale folded into the fp32 epilogue
              (``fold_epilogue``), bf16 activations, fp32 accumulation;
              the conformed input is quantized to int8 with the fixed
              ``INPUT_SCALE``.

Every role has its byte width (``act_bytes``, ``weight_bytes``,
``input_bytes``, ``staging_bytes``), the reference's. Under int8w the
megakernel (K2r) also stages its inter-segment activations as int8, with
static per-channel scales (``staging_scales_from_bn``, or ``calibrate``
from a probe forward; ``quantize_staging`` is the rounding), and reads
the conformed input as int8 codes, ``INPUT_SCALE`` folded into its first
layer's epilogue. Without BatchNorm there is no bound to derive the
scales from, and the megakernel stages bf16.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does, and
each scale division divides by a tensor on the operand's device, so a
scalar divisor is never turned into a multiply by its reciprocal: the
int8 codes and scales are bit-equal to the reference's.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree

#: the three storage policies, plus the sentinel the pipeline resolves.
PRECISIONS = ("fp32", "bf16", "int8w")
AUTO = "auto"

#: fixed dequant scale of the int8-quantized conformed input volume
#: (conform gives [0, 1]; symmetric int8 over that range).
INPUT_SCALE = 1.0 / 127.0

#: sigma multiplier of the BatchNorm-derived int8 staging bound.
BN_BOUND_SIGMA = 6.0

_ACT_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8w": torch.bfloat16}
#: bytes per element by tensor role: ``act`` the activations and logits,
#: ``weight`` the conv taps, ``input`` the conformed volume, ``staging``
#: the megakernel's inter-segment arrays.
_ACT_BYTES = {"fp32": 4, "bf16": 2, "int8w": 2}
_WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8w": 1}
_INPUT_BYTES = {"fp32": 4, "bf16": 2, "int8w": 1}
_STAGING_BYTES = {"fp32": 4, "bf16": 2, "int8w": 1}


def validate(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS} "
            f"(or {AUTO!r} where a resolver is available)"
        )
    return precision


def act_dtype(precision: str) -> torch.dtype:
    """Activation compute and storage dtype (bf16 for both reduced policies)."""
    return _ACT_DTYPE[validate(precision)]


def act_bytes(precision: str) -> int:
    return _ACT_BYTES[validate(precision)]


def weight_bytes(precision: str) -> int:
    return _WEIGHT_BYTES[validate(precision)]


def input_bytes(precision: str) -> int:
    return _INPUT_BYTES[validate(precision)]


def staging_bytes(precision: str) -> int:
    return _STAGING_BYTES[validate(precision)]


def resolve_precision(name: Optional[str], model: Any = None) -> str:
    """Map None/"auto" to the port's default; validate explicit names.

    ``"auto"`` is fp32 on every device. The reference serves bf16 (int8w
    for models of 16 channels or more) on its TPU, where MeshNet's layers
    are bound by device-memory bytes and halving them is a speedup. On
    the H100, K1 runs fp32 on the CUDA cores' FMAs, and K1r (since its
    tensor-core redesign) runs bf16 on the tensor cores. Measured with
    chip_smoke.py phase 9d (NVIDIA H100 80GB HBM3, 700 W), one gwm_light
    forward at 256^3 under cuda_fused takes 10.09 ms at fp32 against 6.33
    and 6.30 ms at bf16 and 7.20 and 6.94 ms at int8w (K1r's nine
    launches 4.87 ms, K1's 9.02); the CUDA-core K1r before it took 13.10
    and 13.87 ms in the same call. Whether ``auto`` should take a reduced
    policy changes what users get (bf16's logits are 1.6e-2 from fp32's
    at 256^3, int8w's 4.7e-2), so it stays fp32 until that is decided.
    An explicit name always wins.
    """
    if name is not None and name != AUTO:
        return validate(name)
    return "fp32"


# ------------------------------------------------------------- weights ---


def _div(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` in fp32 as a true division, a scalar ``s`` taken as a
    tensor on x's device (a CPU scalar divisor may become a multiply by its
    reciprocal, which rounds differently), filled there rather than copied
    from the host, which would wait for the card."""
    if not isinstance(s, torch.Tensor):
        s = torch.full((), s, dtype=torch.float32, device=x.device)
    return torch.div(x, s)


def quantize_symmetric(w: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slice symmetric int8 quantization along ``axis``: ``(q, scale)``
    with ``q = round(w / scale)`` in [-127, 127] and ``scale = max|w| /
    127`` per slice of ``axis`` (conv weights: axis -1, the output
    channel); a zero slice gets scale 1, so its round trip is exact."""
    axis = axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    w = w.float()
    amax = torch.amax(w.abs(), dim=reduce_axes, keepdim=True)
    scale = torch.where(amax > 0, _div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(_div(w, scale)), -127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[axis])


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``quantize_symmetric``: float weights, error <= scale / 2."""
    shape = [1] * q.ndim
    shape[axis % q.ndim] = q.shape[axis]
    return q.float() * scale.reshape(shape)


def roundtrip_bound(scale: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |w - dequantize(quantize(w))|: half a step."""
    return scale / 2.0


def quantize_input(x: torch.Tensor) -> torch.Tensor:
    """A conformed ([0, 1]) volume -> int8 with the fixed ``INPUT_SCALE``."""
    return torch.clamp(torch.round(_div(x.float(), INPUT_SCALE)), -127, 127).to(torch.int8)


def cast_input(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The forward's input at the policy's activation dtype, as every
    reduced-precision forward of the reference casts it: under int8w the
    int8 grid of ``quantize_input`` times ``INPUT_SCALE``, the product
    rounded in bf16 (an int8 input is taken as already on that grid, at
    either policy); otherwise a cast."""
    adt = act_dtype(precision)
    if precision == "int8w" and x.dtype != torch.int8:
        x = quantize_input(x)
    if x.dtype == torch.int8:
        return x.to(adt) * torch.tensor(INPUT_SCALE, dtype=adt, device=x.device)
    return x.to(adt)


# ------------------------------------------------------- params trees ---


def is_prepared(params: Any, precision: str) -> bool:
    """Whether ``params`` already carry ``precision``'s storage dtypes, so
    ``prepare_params`` passes them through."""
    if validate(precision) == "fp32":
        return True
    w = params["layers"][0]["w"]
    if precision == "bf16":
        return w.dtype == torch.bfloat16
    return w.dtype == torch.int8


def prepare_params(params: Any, cfg: Any, precision: str) -> Any:
    """A MeshNet params tree in ``precision`` storage. bf16: conv and head
    weights become bfloat16 (biases and BN statistics stay fp32). int8w:
    each hidden layer's ``w`` becomes int8 with a per-output-channel
    ``wscale``; the 1x1x1 head is bf16. Idempotent."""
    if validate(precision) == "fp32" or is_prepared(params, precision):
        return params
    layers = []
    for layer in params["layers"]:
        new = dict(layer)
        if precision == "bf16":
            new["w"] = layer["w"].to(torch.bfloat16)
        else:
            new["w"], new["wscale"] = quantize_symmetric(layer["w"], axis=-1)
        layers.append(new)
    head = dict(params["head"])
    head["w"] = head["w"].to(torch.bfloat16)
    return {"layers": layers, "head": head}


def fold_epilogue(layer: dict, use_batchnorm: bool, eps: float = 1e-5):
    """``(bias, scale, offset)`` of a layer's fused epilogue
    ``relu((acc + bias) * scale + offset)``, the BatchNorm folded in. For
    an int8w layer the accumulator is in quantized-weight units, so the
    conv bias moves inside the affine: ``bias = 0``, ``scale = wscale *
    bn_scale``, ``offset = b * bn_scale + bn_offset``."""
    b = layer["b"].float()
    if use_batchnorm:
        bn_scale = layer["bn_scale"].float() * torch.rsqrt(layer["bn_var"].float() + eps)
        bn_offset = layer["bn_bias"].float() - layer["bn_mean"].float() * bn_scale
    else:
        bn_scale = torch.ones_like(b)
        bn_offset = torch.zeros_like(b)
    if "wscale" in layer:
        return torch.zeros_like(b), layer["wscale"] * bn_scale, b * bn_scale + bn_offset
    return b, bn_scale, bn_offset


def params_bytes(params: Any) -> int:
    """Bytes of a (possibly prepared) params tree."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree.leaves(params))


def model_params_bytes(cfg: Any, precision: str = "fp32") -> int:
    """Analytic ``params_bytes`` of a MeshNetConfig's tree: conv taps at the
    policy's weight width, the head bf16 under the reduced policies, fp32
    biases, BN vectors and dequant scales."""
    wb = weight_bytes(precision)
    hb = 4 if precision == "fp32" else 2
    k = cfg.kernel_size ** 3
    total = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        total += k * cin * cfg.channels * wb
        total += cfg.channels * 4
        if cfg.use_batchnorm:
            total += 4 * cfg.channels * 4
        if precision == "int8w":
            total += cfg.channels * 4
        cin = cfg.channels
    total += cfg.channels * cfg.num_classes * hb + cfg.num_classes * 4
    return total


# --------------------------------------------------- staging activation ---


def staging_scales_from_bn(params: Any, cfg: Any) -> Optional[list]:
    """One (C,) fp32 int8 staging scale per hidden layer from its BatchNorm
    statistics: post-BN activations are about N(bn_bias, bn_scale^2), so
    after the ReLU the bound is ``relu(bn_bias) + BN_BOUND_SIGMA *
    |bn_scale|``, and the scale is that bound over 127. None without
    BatchNorm (the megakernel then stages bf16)."""
    if not cfg.use_batchnorm:
        return None
    scales = []
    for layer in params["layers"]:
        bound = torch.relu(layer["bn_bias"].float()) + BN_BOUND_SIGMA * torch.abs(layer["bn_scale"].float())
        scales.append(_div(torch.clamp_min(bound, 1e-6), 127.0))
    return scales


def calibrate(params: Any, cfg: Any, x: torch.Tensor, margin: float = 1.25) -> list:
    """One (C,) fp32 staging scale per hidden layer from a probe forward:
    the fp32 plain forward (``meshnet.apply_layer``) on ``x``, each layer's
    per-channel largest magnitude times ``margin``, over 127."""
    from repro_torch.core import meshnet

    if x.ndim == 4:
        x = x[..., None]
    x = x.float()
    scales = []
    for i, d in enumerate(cfg.dilations):
        x, _ = meshnet.apply_layer(params["layers"][i], x, d, cfg)
        amax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)))
        scales.append(_div(torch.clamp_min(amax * margin, 1e-6), 127.0))
    return scales


def quantize_staging(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Activations -> int8 with a per-channel static scale: a true division,
    rounded half to even, saturated at +-127."""
    return torch.clamp(torch.round(torch.div(x.float(), scale)), -127, 127).to(torch.int8)


# ------------------------------------------------------------ reference ---


def conv_block_reduced(
    x: torch.Tensor, layer: dict, dilation: int, use_batchnorm: bool, *, z_same: bool = True
) -> torch.Tensor:
    """One reduced-precision MeshNet conv block, the plain version of K1r:
    the bf16 taps and bf16 or int8 weights widened to fp32 (exact), an
    fp32 'same' dilated conv, the fused fp32 epilogue of ``fold_epilogue``,
    one round to x's dtype (bf16) at the layer's output. ``z_same=False``
    drops the Z padding: the sharded slab schedule supplies Z context
    through the halo exchange (core/spatial_shard.py)."""
    from repro_torch.kernels import ref

    bias, scale, offset = fold_epilogue(layer, use_batchnorm)
    return ref.dilated_conv3d(
        x, layer["w"], bias, dilation=dilation, scale=scale, offset=offset, fuse_affine=True, z_same=z_same
    )


def head_reduced(x: torch.Tensor, head: dict) -> torch.Tensor:
    """The 1x1x1 head at a reduced policy: bf16 activations times the bf16
    weight, accumulated in fp32, the fp32 bias added, then one round to
    bf16 (a product of bf16 operands would round before the bias)."""
    w = head["w"][0, 0, 0].float()
    return (torch.matmul(x.float(), w) + head["b"].float()).to(torch.bfloat16)


def reference_apply(params: Any, x: torch.Tensor, cfg: Any, precision: str) -> torch.Tensor:
    """Precision-aware plain forward, the parity oracle the ``torch``
    executor serves at the reduced policies: weights prepared once,
    activations rounded to bf16 at each layer's output, every conv and the
    head accumulated in fp32; logits bf16."""
    from repro_torch.core import meshnet

    if validate(precision) == "fp32":
        return meshnet.apply(params, x, cfg)
    params = prepare_params(params, cfg, precision)
    if x.ndim == 4:
        x = x[..., None]
    x = cast_input(x, precision)
    for i, d in enumerate(cfg.dilations):
        x = conv_block_reduced(x, params["layers"][i], d, cfg.use_batchnorm)
    return head_reduced(x, params["head"])
