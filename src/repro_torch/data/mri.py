"""Synthetic structural MRI — counterpart of ``generate`` in ``repro/data/mri.py``.

Procedural "brains" whose gray/white-matter labels are known by
construction: an ellipsoidal head with a radial field deformed by
low-frequency noise defines nested shells (white matter inside gray
matter inside background), with dark ventricles in the white matter,
T1-like intensities, a smooth bias field and Gaussian noise. Random
numbers come from a ``torch.Generator``, drawn on the generator's own
device, and differ from the reference's, so the two agree in label
fractions, not in bits.

``DataLoader`` streams training batches of such pairs (counterpart of the
reference's ``DataLoader``), optionally cut to random sub-cubes and with
one-hot labels.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticMRIConfig:
    shape: tuple[int, int, int] = (64, 64, 64)
    noise_sigma: float = 0.04
    bias_field_strength: float = 0.15
    deform_strength: float = 0.12  # low-frequency radius deformation


def _smooth_noise(gen: torch.Generator, shape, device, cutoff: int = 6) -> torch.Tensor:
    """Low-frequency noise: a random coarse grid, trilinearly upsampled."""
    coarse_shape = tuple(max(2, s // cutoff) for s in shape)
    coarse = torch.randn(coarse_shape, generator=gen, device=gen.device).to(device)
    return F.interpolate(coarse[None, None], size=tuple(shape), mode="trilinear", align_corners=False)[0, 0]


def generate(
    generator: torch.Generator,
    cfg: SyntheticMRIConfig = SyntheticMRIConfig(),
    *,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One synthetic (T1 volume, labels) pair on ``device``: vol (D, H, W)
    float32 in [0, 1], labels (D, H, W) int32 in {0, 1, 2} (background,
    gray matter, white matter). A generator on that device keeps every
    step of it there."""
    dev = resolve_device(device)
    d, h, w = cfg.shape
    lin = [torch.linspace(-1, 1, n, device=dev) for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*lin, indexing="ij")
    # Random per-subject head axes (anisotropy +-15%).
    axes = (0.78 + 0.12 * torch.rand(3, generator=generator, device=generator.device)).tolist()
    r = torch.sqrt((zz / axes[0]) ** 2 + (yy / axes[1]) ** 2 + (xx / axes[2]) ** 2)
    r = r + cfg.deform_strength * _smooth_noise(generator, cfg.shape, dev)

    r_wm, r_gm = 0.55, 0.8
    wm = r < r_wm
    gm = (r >= r_wm) & (r < r_gm)

    # Ventricles: a small ellipsoid pair deep in WM relabelled background.
    vz = 0.12 * (float(torch.rand((), generator=generator, device=generator.device)) - 0.5)
    vent_r = torch.sqrt(((zz - vz) / 0.18) ** 2 + (yy / 0.28) ** 2 + (xx / 0.12) ** 2)
    vent = (vent_r < 1.0) & wm
    wm = wm & ~vent

    labels = torch.zeros(cfg.shape, dtype=torch.int32, device=dev)
    labels[gm] = 1
    labels[wm] = 2

    # T1-like intensities: WM bright, GM mid, CSF/vent dark, skull shell dim.
    vol = torch.zeros(cfg.shape, dtype=torch.float32, device=dev)
    vol[gm] = 0.45
    vol[wm] = 0.75
    vol[vent] = 0.12
    skull = (r >= r_gm) & (r < r_gm + 0.08)
    vol[skull] = 0.25

    bias = 1.0 + cfg.bias_field_strength * _smooth_noise(generator, cfg.shape, dev)
    noise = torch.randn(cfg.shape, generator=generator, device=generator.device).to(dev)
    vol = vol * bias + cfg.noise_sigma * noise
    return torch.clamp(vol, 0.0, 1.0), labels


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    """The paper's DataLoader (§III-A): batching and optional sub-volumes."""

    mri: SyntheticMRIConfig = SyntheticMRIConfig()
    batch_size: int = 2
    subvolumes: bool = False  # CubeDivider path
    cube: int = 32
    num_classes: int = 3
    one_hot: bool = False
    seed: int = 0


class DataLoader:
    """Streams (volume, labels) batches on ``device``: (B, D, H, W) float32
    volumes and (B, D, H, W) int32 labels, or (B, c, c, c) random sub-cubes
    with ``subvolumes``, labels (..., C) float32 with ``one_hot``.

    Mirrors the paper's DataLoaderClass: (1) load, (2) optional CubeDivider
    split, (3) reshape/one-hot prep, (4) batching. Every batch draws from
    one ``torch.Generator`` on ``device`` seeded from ``cfg.seed``, so a
    loader's stream is fixed by its config and device."""

    def __init__(self, cfg: DataLoaderConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        return self.batches()

    def batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        while True:
            vols, labs = zip(*(generate(gen, cfg.mri, device=self.device) for _ in range(cfg.batch_size)))
            vol = torch.stack(vols)
            lab = torch.stack(labs)
            if cfg.subvolumes:
                vol, lab = self._to_subvolumes(vol, lab, gen)
            if cfg.one_hot:
                lab = (lab[..., None] == torch.arange(cfg.num_classes, device=lab.device)).float()
            yield vol, lab

    def _to_subvolumes(self, vol: torch.Tensor, lab: torch.Tensor, gen: torch.Generator):
        """One random aligned c^3 sub-cube per sample (training-time patching)."""
        c = self.cfg.cube
        b, *spatial = vol.shape
        if any(n < c for n in spatial):
            raise ValueError(f"cube {c} does not fit the volume {tuple(spatial)}")
        corners = [
            torch.randint(0, n - c + 1, (b,), generator=gen, device=gen.device).tolist() for n in spatial
        ]
        cut_v, cut_l = [], []
        for i, (z, y, x) in enumerate(zip(*corners)):
            cut_v.append(vol[i, z : z + c, y : y + c, x : x + c])
            cut_l.append(lab[i, z : z + c, y : y + c, x : x + c])
        return torch.stack(cut_v), torch.stack(cut_l)
