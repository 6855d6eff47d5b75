"""Conform preprocessing — counterpart of ``repro/core/conform.py``.

Resample the raw T1 onto a cubic 1 mm grid (trilinear, edge-clamped),
then rescale intensities to [0, 1] by robust quantile clipping. Runs on
the volume's device.
"""

from __future__ import annotations

import torch


def _trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (D, H, W) at float coords (3, N) with edge clamping."""
    d, h, w = vol.shape
    cz, cy, cx = coords
    z0 = torch.clamp(torch.floor(cz).to(torch.int64), 0, d - 1)
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, w - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fz = torch.clamp(cz - z0, 0.0, 1.0)
    fy = torch.clamp(cy - y0, 0.0, 1.0)
    fx = torch.clamp(cx - x0, 0.0, 1.0)

    def at(zi, yi, xi):
        return vol[zi, yi, xi]

    c000, c001 = at(z0, y0, x0), at(z0, y0, x1)
    c010, c011 = at(z0, y1, x0), at(z0, y1, x1)
    c100, c101 = at(z1, y0, x0), at(z1, y0, x1)
    c110, c111 = at(z1, y1, x0), at(z1, y1, x1)
    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def resample(vol: torch.Tensor, out_shape: tuple[int, int, int], voxel_size=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Trilinearly resample ``vol`` onto an ``out_shape`` grid, 1 mm
    isotropic and centred on the source (``voxel_size`` is the source's,
    in mm). Coordinates are built in float32, as the reference does."""
    src = vol.to(torch.float32)
    sd, sh, sw = src.shape

    def axis(n, size, src_n):
        i = torch.arange(n, dtype=torch.float32, device=src.device)
        return (i - (n - 1) / 2.0) / size + (src_n - 1) / 2.0

    zz, yy, xx = torch.meshgrid(
        axis(out_shape[0], voxel_size[0], sd),
        axis(out_shape[1], voxel_size[1], sh),
        axis(out_shape[2], voxel_size[2], sw),
        indexing="ij",
    )
    coords = torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)])
    return _trilinear_sample(src, coords).reshape(out_shape)


def quantiles(x: torch.Tensor, qs) -> list[torch.Tensor]:
    """``jnp.quantile(x, q)`` for each q, linear interpolation, from one
    sort of ``x`` and for any size (``torch.quantile`` refuses inputs
    above 2**24 elements). Each position ``q * (n - 1)`` is computed in
    float32, as the reference computes it."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    out = []
    for q in qs:
        pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
        low = torch.floor(pos)
        high_w = (pos - low).to(flat.device)
        lo_v = flat[int(torch.clamp(low, 0, n - 1))]
        hi_v = flat[int(torch.clamp(torch.ceil(pos), 0, n - 1))]
        out.append(lo_v * (1 - high_w) + hi_v * high_w)
    return out


def rescale_intensity(vol: torch.Tensor, lo_q: float = 0.01, hi_q: float = 0.99) -> torch.Tensor:
    """Robust rescale to [0, 1] by quantile clipping; non-finite voxels
    become 0 first."""
    vol = torch.where(torch.isfinite(vol), vol, torch.zeros((), dtype=vol.dtype, device=vol.device))
    lo, hi = quantiles(vol, (lo_q, hi_q))
    out = (vol - lo) / torch.clamp(hi - lo, min=1e-6)
    return torch.clamp(out, 0.0, 1.0)


class DegenerateVolumeError(ValueError):
    """The input volume has no intensity dynamic range — all-zero, a
    constant fill, or nothing but non-finite voxels. The pipeline turns it
    into a failed record (``fail_type="degenerate_volume"``)."""

    def __init__(self, lo: float, hi: float):
        super().__init__(
            "degenerate input volume: finite intensity range "
            f"[{lo!r}, {hi!r}] has no dynamic range to conform"
        )
        self.lo = lo
        self.hi = hi


def conform(
    vol: torch.Tensor,
    out_shape: tuple[int, int, int] = (256, 256, 256),
    voxel_size=(1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Resample to the cubic isotropic grid, then rescale intensities.

    Raises ``DegenerateVolumeError`` for a constant / all-zero /
    all-non-finite 3-D volume before any resampling. Payloads that are not
    3-D are not intercepted: they fail in ``resample``."""
    vol = torch.as_tensor(vol, dtype=torch.float32)
    if vol.ndim == 3:
        finite = torch.where(torch.isfinite(vol), vol, torch.zeros((), device=vol.device))
        lo = float(finite.min())
        hi = float(finite.max())
        if not (hi - lo > 0.0):
            raise DegenerateVolumeError(lo, hi)
    if tuple(vol.shape) != tuple(out_shape):
        vol = resample(vol, tuple(out_shape), voxel_size)
    return rescale_intensity(vol)
