"""3-D convolution pre-filters — successor of Convolution.cpp.

The reference ships a standalone CPU 3-D convolution demo (C14,
Convolution.cpp:23-65: zero-padded 3x3x3 kernel with center 5.0 and face
weights 0.1, applied to a sphere volume) and a legacy 2-D version (C15,
OldConvolution.cpp).  Neither is wired into the render path; their purpose in
the new framework (SURVEY.md §2 C14) is pre-render filtering: smoothing and
gradient (normal) estimation for Phong shading (BASELINE.json config 4
"pre-render convolution gradient filter + shading").

``conv3d`` uses ``lax.conv_general_dilated``; the separable gradient and
smoothing stencils are shift-and-add (``_correlate1d``), which XLA fuses
into elementwise passes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_f32 = jnp.float32


def conv3d(volume: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Zero-padded SAME 3-D convolution of [X,Y,Z] with [kx,ky,kz].

    Matches the reference's zero-padding semantics
    (Convolution.cpp:85-110 ``instanciate_padded_data``).
    """
    v = volume[None, None].astype(_f32)  # NCDHW
    k = kernel[None, None].astype(_f32)  # OIDHW
    out = jax.lax.conv_general_dilated(
        v,
        k,
        window_strides=(1, 1, 1),
        padding="SAME",
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        # a GPU's default float32 conv may run in TF32 — enough to skew
        # gradient normals on the card only (the same class of bug as
        # utils/transforms._HI).  These are tiny stencils; full f32 is free.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]


def reference_kernel() -> jnp.ndarray:
    """The reference demo kernel: center 5.0, six faces 0.1, rest 0
    (Convolution.cpp:43-56)."""
    k = np.zeros((3, 3, 3), np.float32)
    k[1, 1, 1] = 5.0
    for d in range(3):
        for s in (0, 2):
            idx = [1, 1, 1]
            idx[d] = s
            k[tuple(idx)] = 0.1
    return jnp.asarray(k)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> jnp.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray((k / k.sum()).astype(np.float32))


def _correlate1d(volume: jnp.ndarray, k: jnp.ndarray,
                 axis: int) -> jnp.ndarray:
    """Zero-padded SAME 1-D cross-correlation along ``axis`` via
    shift-and-add — identical math to ``conv3d`` with a 1-D stencil but
    purely elementwise: k fused adds over the volume, with no
    single-channel convolution temporaries."""
    n = int(k.shape[0])
    r = n // 2
    v = volume.astype(_f32)
    length = v.shape[axis]
    out = jnp.zeros_like(v)
    for j in range(n):
        off = j - r  # out[i] += k[j] * v[i + off], zero outside
        sl = [slice(None)] * 3
        sl[axis] = slice(max(0, off), length + min(0, off))
        pad = [(0, 0)] * 3
        pad[axis] = (max(0, -off), max(0, off))
        out = out + k[j] * jnp.pad(v[tuple(sl)], pad)
    return out


def gaussian_smooth(volume: jnp.ndarray, sigma: float = 1.0) -> jnp.ndarray:
    """Separable Gaussian smoothing (three 1-D passes — O(3k) not O(k^3))."""
    k = gaussian_kernel1d(sigma)
    out = volume.astype(_f32)
    for axis in range(3):
        out = _correlate1d(out, k, axis)
    return out


def central_difference_gradient(volume: jnp.ndarray) -> jnp.ndarray:
    """Central-difference gradient field, shape [X,Y,Z,3].

    The density gradient is the surface normal estimate for Phong shading
    (ops/phong.py) — the working replacement for the reference's
    LightInteraction stub (C16, LightInteraction.cpp:5-80).
    Boundaries use one-sided differences via zero padding.
    """
    # cross-correlation (no kernel flip): out = 0.5*(x[i+1]-x[i-1])
    k = jnp.asarray([-0.5, 0.0, 0.5], _f32)
    grads = [_correlate1d(volume, k, axis) for axis in range(3)]
    return jnp.stack(grads, axis=-1)


def sobel_gradient(volume: jnp.ndarray) -> jnp.ndarray:
    """Sobel-smoothed gradient field [X,Y,Z,3] (smoother normals than
    central differences; separable 3x3x3)."""
    d = jnp.asarray([-0.5, 0.0, 0.5], _f32)
    s = jnp.asarray([1.0, 2.0, 1.0], _f32) / 4.0
    grads = []
    for axis in range(3):
        out = volume.astype(_f32)
        for ax2 in range(3):
            out = _correlate1d(out, d if ax2 == axis else s, ax2)
        grads.append(out)
    return jnp.stack(grads, axis=-1)


def gradient_field(
    volume: jnp.ndarray,
    gradient_filter: str = "central",
    presmooth_sigma: float = 0.0,
) -> jnp.ndarray:
    """Normal-estimation field for Phong shading [X,Y,Z,3], per the render
    config: optional Gaussian pre-smoothing (BASELINE config 4's
    "pre-render convolution gradient filter") then central-difference or
    Sobel gradients."""
    if presmooth_sigma > 0.0:
        volume = gaussian_smooth(volume, presmooth_sigma)
    if gradient_filter == "sobel":
        return sobel_gradient(volume)
    if gradient_filter == "central":
        return central_difference_gradient(volume)
    raise ValueError(f"unknown gradient_filter {gradient_filter!r}")
