"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and, on the card, the version
``chip_smoke.py`` holds the kernel against. They repeat the kernel's
arithmetic in plain tensor code and are no yardstick of speed:
``dilated_conv3d`` for K1 and K5 and, on a bf16 input, K1r,
``megakernel_segment`` for K2 and, on a bf16 or int8 staging array, K2r,
and with ``z_bounds`` for K2z and K2r-z,
``dice_counts`` for K3, ``decode_attention`` for K4.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dilated_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    fuse_affine: bool = False,
    z_same: bool = True,
) -> torch.Tensor:
    """'Same'-padded k^3 dilated conv, channels-last, + bias (+ affine+ReLU).

    x: (B, D, H, W, Cin); w: (k, k, k, Cin, Cout); b: (Cout,). Computed as
    the sum over the k^3 taps of a shifted slice of the zero-padded input
    times that tap's (Cin, Cout) matrix, taps in (z, y, x) order with x
    fastest, accumulated in fp32. Output voxel p reads input p + t*d
    (correlation, as the reference's XLA conv). With ``fuse_affine``:
    ``relu((conv + b) * scale + offset)``, scale 1 and offset 0 when absent.

    Everything is computed in fp32 and the result is rounded once to x's
    dtype: for K1r (x bf16, w bf16 or int8) the taps and weights widen to
    fp32 exactly, and the one round to bf16 after the epilogue is
    ``quantize.conv_block_reduced``'s rounding point, the reference's.

    ``z_same=False`` drops the Z padding: the output is ``2 * pad`` shorter
    in Z, each voxel's Z context read from x (the sharded slab schedule's
    valid-Z conv, whose context comes from the halo exchange).
    """
    k = w.shape[0]
    pad = dilation * (k - 1) // 2
    zpad = pad if z_same else 0
    _, d, h, wd, _ = x.shape
    d = d + 2 * zpad - 2 * pad
    xp = F.pad(x.float(), (0, 0, pad, pad, pad, pad, zpad, zpad))
    wf = w.float()
    out = None
    for tz in range(k):
        for ty in range(k):
            for tx in range(k):
                sl = xp[
                    :,
                    tz * dilation : tz * dilation + d,
                    ty * dilation : ty * dilation + h,
                    tx * dilation : tx * dilation + wd,
                    :,
                ]
                term = torch.matmul(sl, wf[tz, ty, tx])
                out = term if out is None else out.add_(term)
    out = out + b.float()
    if fuse_affine:
        if scale is not None:
            out = out * scale.float()
        if offset is not None:
            out = out + offset.float()
        out = torch.relu(out)
    return out.to(x.dtype)


def z_interval(depth: int, z_bounds=None) -> tuple[int, int]:
    """The valid Z interval ``[lo, hi)`` of a volume ``depth`` deep: all of
    it, or its intersection with ``z_bounds = (z_lo, z_hi)`` (host ints),
    empty (``lo == hi``) when they do not overlap."""
    if z_bounds is None:
        return 0, depth
    lo = min(max(int(z_bounds[0]), 0), depth)
    return lo, max(min(int(z_bounds[1]), depth), lo)


def clip_band(rows: int, band=None) -> tuple[int, int]:
    """The output rows ``[lo, hi)`` of a segment whose tile-padded region
    is ``rows`` deep: all of them, or ``band`` (host ints) clipped to
    them."""
    if band is None:
        return 0, rows
    lo = min(max(int(band[0]), 0), rows)
    return lo, max(min(int(band[1]), rows), lo)


def megakernel_segment(
    x: torch.Tensor, pln, i: int, layers, head=None, deq=None, qscale=None, z_bounds=None, band=None
) -> torch.Tensor:
    """Segment ``i`` of a megakernel plan, the same staging arrays in and
    out as K2 and K2r (``kernels/megakernel.py::run_segment``), computed
    layer by layer over the whole volume instead of tile by tile.

    K2 masks every position outside the true volume to zero after each
    layer but the last, so per voxel its result is that of 'same'-padded
    layers over the volume; the last layer also covers the tile-padded
    region beyond it, reading zeros there. The output array's border is
    left unwritten, as K2 leaves it.

    A bf16 or int8 staging array is K2r's, with its rounding points: the
    taps widened to fp32 (an int8 code times ``deq`` when given, one fp32
    rounding), each layer summed and its epilogue applied in fp32, the
    output rounded to bf16 after every layer; the last layer's fp32 output
    quantised to int8 (``quantize_staging``'s arithmetic) when ``qscale``
    is given, else rounded to bf16, and the fused head summed in fp32 over
    the bf16 activations and its bf16 weights, its bias added, then one
    round to bf16.

    ``z_bounds`` (K2z, K2r-z) narrows the valid Z interval to its
    intersection with the volume's (``z_interval``): the input's rows and
    every layer's output rows but the last's outside it are selected to
    zero, as positions outside the volume are.

    ``band`` (``clip_band``; by default all of the tile-padded rows)
    computes only the output rows in ``[lo, hi)``, from the input rows
    within the segment's halo of them (valid-Z convs over that slab, the
    rows outside the volume and the valid interval zero); the other output
    rows are left unwritten and the other input rows are never read."""
    seg = pln.segments[i]
    h = seg.halo
    vol = pln.vol
    padded = pln.padded(seg)
    reduced = x.dtype != torch.float32
    lo, hi = z_interval(vol[0], z_bounds)
    b_lo, b_hi = clip_band(padded[0], band)
    # the band grown by the halo: its rows inside [lo, hi), zeros elsewhere
    r0, r1 = b_lo - h, b_hi + h
    act = torch.zeros((x.shape[0], r1 - r0) + tuple(vol[1:]) + (x.shape[-1],), dtype=x.dtype, device=x.device)
    a, c = max(r0, lo), min(r1, hi)
    if a < c:
        act[:, a - r0 : c - r0] = x[:, h + a : h + c, h : h + vol[1], h : h + vol[2], :]
    if reduced:
        act = act.float() if deq is None else act.float() * deq
    last = len(layers) - 1
    for li, ((w, b, scale, offset), d) in enumerate(zip(layers, seg.dilations)):
        if li == last:
            act = F.pad(act, (0, 0) + sum(((0, p - v) for p, v in zip(padded[:0:-1], vol[:0:-1])), ()))
            a, c = r0 + d, r1 - d
        else:  # only the output rows inside [lo, hi) are computed; the others are zeros
            a = min(max(r0 + d, lo), r1 - d)
            c = max(min(r1 - d, hi), a)
        out = dilated_conv3d(act[:, a - d - r0 : c + d - r0], w, b, dilation=d, scale=scale, offset=offset,
                             fuse_affine=True, z_same=False)
        if reduced and not (li == last and qscale is not None):
            out = out.to(torch.bfloat16).float()
        r0, r1 = r0 + d, r1 - d
        act = F.pad(out, (0, 0, 0, 0, 0, 0, a - r0, r1 - c))
    if reduced:
        if qscale is not None:
            act = torch.clamp(torch.round(torch.div(act, qscale)), -127, 127).to(torch.int8)
        elif head is not None:
            act = (torch.matmul(act, head[0].float()) + head[1]).to(torch.bfloat16)
        else:
            act = act.to(torch.bfloat16)
    elif head is not None:
        act = torch.matmul(act, head[0]) + head[1]
    o = pln.out_halo(i)
    out = torch.empty((x.shape[0],) + pln.out_dims(i) + (seg.cout,), dtype=act.dtype, device=x.device)
    out[:, o + b_lo : o + b_hi, o : o + padded[1], o : o + padded[2], :] = act
    return out


def dice_counts(pred: torch.Tensor, truth: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class (intersection, |pred_c|, |truth_c|) counts, (C, 3) int32,
    from per-class comparisons and sums; a label outside [0, C) matches no
    class (counterpart of ``repro/kernels/ref.py::dice_counts``)."""
    rows = []
    for c in range(num_classes):
        x = pred == c
        y = truth == c
        rows.append(torch.stack([(x & y).sum(), x.sum(), y.sum()]))
    return torch.stack(rows).to(torch.int32)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos) -> torch.Tensor:
    """Single-token GQA decode attention over a KV cache (counterpart of
    ``repro/kernels/ref.py::decode_attention``): q (B, 1, H, hd), k/v
    (B, S, KV, hd), attends to slots [0, pos]; the KV heads repeated to H,
    scores in fp32 over sqrt(hd), slots after ``pos`` masked with -1e30,
    softmax, the PV product in fp32; returns (B, 1, H, hd) in q's dtype.
    ``pos`` is a host int or a (1,) integer tensor on k's device, compared
    there (the reference kernel's operand)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    kk = torch.repeat_interleave(k, H // KV, dim=2).float()
    vv = torch.repeat_interleave(v, H // KV, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(hd)
    valid = torch.arange(k.shape[1], device=k.device) <= pos
    s = s.masked_fill(~valid[None, None, None], -1e30)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)
