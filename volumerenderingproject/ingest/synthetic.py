"""Synthetic analytic volumes — the reference's CPU-runnable test fixtures.

Replicates exactly (same shapes, same intensity formulas):
  * :func:`centered_sphere`      — BinaryLoader.cu:338-367 ``loadSphereToMem``:
    100³ grid, radius-50 sphere about the center, intensity = y/100·255.
  * :func:`corner_sphere`       — BinaryLoader.cu:369-398
    ``loadZEROCornerSphereToMem``: radius-100 sphere about the (0,0,0) corner,
    intensity = (r²-ratio)·255.
  * :func:`octant_sphere_colors` — myApp.cu:1363-1398 ``sphereTest`` octant
    coloring (returns RGBA per voxel; used by point-splat tests).

Plus a seeded stand-in for the brain scans the renderer is used on:
  * :func:`head_phantom` — an MRI-like head at any grid shape (MNI152-1mm's
    182x218x182 by default).

These are the fixtures for unit tests and gradient checks (SURVEY.md §4.1).
"""

from __future__ import annotations

import numpy as np

from .volume import Volume, make_volume


def centered_sphere(n: int = 100, cal_max: float = 255.0) -> Volume:
    """Sphere of radius n/2 about the grid center; intensity = y/n * 255."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    c = n / 2.0
    inside = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 <= (n / 2.0) ** 2
    vals = (y / float(n) * 255.0).astype(np.float32)
    data = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    return make_volume(data, cal_max=cal_max)


def corner_sphere(n: int = 100, cal_max: float = 255.0) -> Volume:
    """Sphere of radius n about (0,0,0); intensity = (r/R)^2 * 255."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    r2 = x**2 + y**2 + z**2
    inside = r2 <= float(n) ** 2
    vals = (r2 / float(n) ** 2 * 255.0).astype(np.float32)
    data = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    return make_volume(data, cal_max=cal_max)


def rgb_sphere(n: int = 64, cal_max: float = 255.0) -> Volume:
    """4-D multi-channel fixture standing in for the reference's missing
    ``RGB16_4D.nii`` (.MISSING_LARGE_BLOBS:2): a centered sphere whose three
    channels encode normalized x/y/z position * 255 inside the sphere."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    c = n / 2.0
    inside = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 <= (n / 2.0) ** 2
    chans = np.stack(
        [x / n * 255.0, y / n * 255.0, z / n * 255.0], axis=-1
    ).astype(np.float32)
    data = np.where(inside[..., None], chans, np.float32(0.0))
    return make_volume(data, cal_max=cal_max)


MNI_1MM = (182, 218, 182)  # MNI152 T1 1 mm template grid
AVG152 = (91, 109, 91)  # avg152T1 (2 mm) template grid


def head_phantom(dims=MNI_1MM, seed: int = 0, cal_max: float = 255.0
                 ) -> Volume:
    """Seeded head phantom: integer intensities 0-255 in an [X, Y, Z] grid.

    An ellipsoidal head fills ~70% of each axis.  From the outside in: a
    scalp layer (~150, the default TF's muscle band), a skull shell (~55,
    bone), and a brain interior (~112, brain) with darker fluid-filled
    ventricles (~20) near the centre; every tissue carries Gaussian noise.
    Outside the head the volume is exactly 0, so most of the grid is empty
    space, as in a skull-stripped or background-thresholded scan."""
    rng = np.random.default_rng(seed)
    axes = [(np.arange(d, dtype=np.float32) + 0.5) / d - 0.5 for d in dims]
    x, y, z = np.meshgrid(*axes, indexing="ij", sparse=True)
    r = np.sqrt((x / 0.36) ** 2 + (y / 0.40) ** 2 + (z / 0.35) ** 2)
    vent = np.sqrt(((x - 0.02) / 0.08) ** 2 + (y / 0.14) ** 2
                   + ((z + 0.03) / 0.06) ** 2)
    noise = rng.standard_normal(dims, dtype=np.float32)
    vals = np.zeros(dims, np.float32)
    vals = np.where(r < 1.0, 150.0 + 6.0 * noise, vals)   # scalp
    vals = np.where(r < 0.95, 55.0 + 14.0 * noise, vals)  # skull
    vals = np.where(r < 0.86, 112.0 + 7.0 * noise, vals)  # brain
    vals = np.where(vent < 1.0, 20.0 + 5.0 * noise, vals)  # ventricles
    data = np.clip(np.round(vals), 0.0, 255.0).astype(np.float32)
    return make_volume(data, cal_max=cal_max)


def octant_sphere_colors(
    dims=(100, 100, 100), background=(0.2, 0.2, 0.2)
) -> np.ndarray:
    """Octant-colored sphere RGBA grid (myApp.cu:1363-1398), shape [X,Y,Z,4]."""
    dx, dy, dz = dims
    coords = [np.arange(d, dtype=np.float64) for d in dims]
    x, y, z = np.meshgrid(*coords, indexing="ij")
    cx, cy, cz = dx / 2.0, dy / 2.0, dz / 2.0
    inside = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= (dx / 2.0) ** 2

    octant_colors = np.array(
        [
            # (x>cx, y>cy, z>cz) ordered as binary xyz
            [0.0, 0.0, 0.0, 1.0],  # 000
            [1.0, 1.0, 1.0, 1.0],  # 001
            [0.0, 1.0, 1.0, 1.0],  # 010
            [1.0, 0.0, 1.0, 1.0],  # 011
            [1.0, 1.0, 0.0, 1.0],  # 100
            [0.0, 0.0, 1.0, 1.0],  # 101
            [0.0, 1.0, 0.0, 1.0],  # 110
            [1.0, 0.0, 0.0, 1.0],  # 111
        ],
        dtype=np.float32,
    )
    idx = ((x > cx).astype(int) * 4 + (y > cy).astype(int) * 2 + (z > cz).astype(int))
    rgba = np.where(inside[..., None], octant_colors[idx], np.float32(0.0))
    # z boundary slabs get the background complement (myApp.cu:1394-1395)
    edge = (z == 0) | (z == dz - 1)
    bg = np.asarray(
        [1.0 - background[0], 1.0 - background[1], 1.0 - background[2], 1.0],
        np.float32,
    )
    rgba = np.where(edge[..., None], bg, rgba)
    return rgba.astype(np.float32)
