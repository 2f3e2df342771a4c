"""Volume sampling ops with bit-careful reference parity.

Two samplers, both vectorized over arbitrary batch shapes of query points:

  * :func:`octree_nn_sample` — the *value* semantics of the reference's
    min/max array octree query (Octree.cu:158-183 / device mirror :286-311).
    Because the reference octree is complete (every leaf at depth d) and its
    leaves are filled by nearest-voxel lookup of the *centered* dataset
    (Octree.cu:85-108), the query's value is exactly: snap the point to the
    2^d dyadic grid, map the cell's lower corner to voxel space, truncate,
    fetch.  The octree only changes *speed* (empty-space skip when
    max==min), never output — see accel/pyramid.py for the skip structure.

    float32 parity notes (each step mirrors one C expression):
      - ``k = floor(p * 2^d)``: multiplying by a power of two is exact in
        f32, and the octree's dyadic node bounds are exact (corners are
        dyadic rationals built by exact halving, Octree.cu:131-156), so this
        floor reproduces the descent's inside tests (Octree.cu:257-268).
      - ``res = (k / 2^d) * L``: one f32 rounding, same as glm's
        scale-matrix multiply in updateNode (Octree.cu:85-88).
      - centered-range check on ``res`` then ``(int)((res + dim/2) - L/2)``
        truncation (Octree.cu:91-100); all the /2 constants are exact halves.
      - negative leaf values are clamped to 0 because the descent combines
        children with ``if (aux > res)`` starting from res = 0
        (Octree.cu:172-177).

  * :func:`trilinear_color_sample` — the a5/TEST kernel's color-space
    trilinear interpolation (kernel.cu:117-178): fetch the 8 corner voxels
    (offsets added in *float*, truncated per axis), classify EACH through the
    transfer function, then mix the RGBA colors y->x->z with
    ``difference = pos - trunc(pos)``.  The only out-of-range guard is
    ``flat_index < totaldim`` (kernel.cu:130 etc.) — indices wrap across
    rows exactly like the reference.  Outside the volume the sample takes
    TF(0)'s color (kernel.cu:117).

  * :func:`trilinear_intensity_sample` — smooth extension (no reference
    counterpart): interpolate intensities, zero-padded at the boundary.
    Fully differentiable w.r.t. the volume; used by the optimization path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_f32 = jnp.float32


@jax.custom_jvp
def div_exact(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """``x / y`` rounded to nearest, as IEEE f32 division gives it.

    Intensity normalization (``v / cal_max``) feeds interval compares,
    so a quotient one ulp off moves a voxel whose value sits on a TF bound
    into the neighbouring interval.  The reference divides exactly (nvcc's
    default ``-prec-div=true``) and so does XLA on the CPU, but XLA on a
    GPU lowers f32 division to an approximate divide (up to 2 ulp).  This
    takes that quotient and moves it, at most two ulps, to the correctly
    rounded one, deciding each step on the exact residual ``x - q*y``
    (exact for a ``y`` with at most 16 significant bits — any integer
    ``cal_max`` up to 65535 — and to a fraction of an ulp otherwise).
    The quotient of two floats is never exactly a rounding midpoint, so
    no tie rule is needed."""
    x = jnp.asarray(x, _f32)
    y = jnp.asarray(y, _f32)
    return _round_quotient(x, y, x / y)


def _round_quotient(x, y, q, steps: int = 2):
    """Move ``q`` (within ``steps`` ulps of x/y) to RN(x/y)."""
    for _ in range(steps):
        up = jnp.nextafter(q, jnp.asarray(jnp.inf, _f32))
        dn = jnp.nextafter(q, jnp.asarray(-jnp.inf, _f32))
        r = _residual(x, q, y)
        q = jnp.where(r > (up - q) * y * 0.5, up,
                      jnp.where(r < (dn - q) * y * 0.5, dn, q))
    return q


def _residual(x, q, y):
    """x - q*y without rounding: q is cut into three 8-bit pieces by its
    bit pattern, so each piece times a <=16-bit y is exact, and every
    partial difference is exact too (whether or not the compiler fuses a
    product into the subtraction)."""
    bits = jax.lax.bitcast_convert_type(q, jnp.int32)
    q1 = jax.lax.bitcast_convert_type(bits & jnp.int32(-(1 << 16)), _f32)
    q12 = jax.lax.bitcast_convert_type(bits & jnp.int32(-(1 << 8)), _f32)
    return ((x - q1 * y) - (q12 - q1) * y) - (q - q12) * y


@div_exact.defjvp
def _div_exact_jvp(primals, tangents):
    x, y = primals
    dx, dy = tangents
    q = div_exact(x, y)
    return q, dx / y - q * dy / y


def octree_nn_index(
    dims: Tuple[int, int, int],
    depth: int,
    p: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The a1 sampler's index computation: (flat_voxel_index, valid_mask).

    ``flat`` is clamped into range so it is always safe to gather with;
    ``valid`` is False outside the root cube [0,1)^3 or outside the centered
    dataset extent (in which case the sample value is defined to be 0).
    """
    d1, d2, d3 = dims
    L = float(max(dims))
    n = float(2**depth)
    dimv = jnp.asarray([d1, d2, d3], _f32)

    p = p.astype(_f32)
    inside_root = jnp.all((p >= 0.0) & (p < 1.0), axis=-1)

    k = jnp.floor(p * n)  # exact: *2^d only shifts the exponent
    res = (k / n) * jnp.asarray(L, _f32)  # one rounding, as in updateNode

    half_gap = jnp.asarray(L, _f32) / 2.0 - dimv / 2.0  # exact halves
    in_dataset = jnp.all((res >= half_gap) & (res < half_gap + dimv), axis=-1)

    t = (res + dimv / 2.0) - jnp.asarray(L, _f32) / 2.0
    ijk = jnp.trunc(t).astype(jnp.int32)
    flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
    flat = jnp.clip(flat, 0, d1 * d2 * d3 - 1)
    return flat, inside_root & in_dataset


def octree_nn_sample(
    volume_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    depth: int,
    p: jnp.ndarray,
) -> jnp.ndarray:
    """Sample at normalized unit-cube points ``p`` (..., 3) — a1 semantics.

    Args:
      volume_flat: [X*Y*Z] float32 (C-order, x-major: BinaryLoader.cu:234-238).
      dims: (X, Y, Z) static ints.
      depth: octree depth d = ceil(log2(longest_dimension)) (Octree.cu:40-41).
      p: query points in the octree's root cube [0,1)^3 (post-modelAux).

    Returns: intensities, shape p.shape[:-1]; 0 outside [0,1)^3 or outside the
    centered dataset extent; negatives clamped to 0 (see module docstring).
    """
    flat, valid = octree_nn_index(dims, depth, p)
    vals = jnp.take(volume_flat, flat, axis=0)
    vals = jnp.maximum(vals, 0.0)  # descent drops negatives (Octree.cu:172-177)
    return jnp.where(valid, vals, jnp.asarray(0.0, _f32))


def octree_nn_sample_slab(
    slab_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    depth: int,
    p: jnp.ndarray,
    x0: jnp.ndarray,
    slab_x: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Slab-sharded variant of :func:`octree_nn_sample` for x-block-sharded
    volumes (parallel/render_dist.py).

    Returns ``(value, owned)``: ``value`` is the a1 sample intensity when
    this device's slab [x0, x0+slab_x) owns the sample's (clamped) voxel x
    index, else 0; ``owned`` is that ownership mask.  Out-of-volume samples
    are assigned to the slab owning their x-clamped voxel so every sample is
    owned by exactly one device (the over identity must be applied once).
    """
    d1, d2, d3 = dims
    L = float(max(dims))
    n = float(2**depth)
    dimv = jnp.asarray([d1, d2, d3], _f32)

    p = p.astype(_f32)
    inside_root = jnp.all((p >= 0.0) & (p < 1.0), axis=-1)

    k = jnp.floor(p * n)
    res = (k / n) * jnp.asarray(L, _f32)
    half_gap = jnp.asarray(L, _f32) / 2.0 - dimv / 2.0
    in_dataset = jnp.all((res >= half_gap) & (res < half_gap + dimv), axis=-1)

    t = (res + dimv / 2.0) - jnp.asarray(L, _f32) / 2.0
    ijk = jnp.trunc(t).astype(jnp.int32)
    gx = jnp.clip(ijk[..., 0], 0, d1 - 1)
    owned = (gx >= x0) & (gx < x0 + slab_x)

    lx = jnp.clip(gx - x0, 0, slab_x - 1)
    flat = lx * (d2 * d3) + jnp.clip(ijk[..., 1], 0, d2 - 1) * d3 + jnp.clip(
        ijk[..., 2], 0, d3 - 1
    )
    vals = jnp.take(slab_flat, flat, axis=0)
    vals = jnp.maximum(vals, 0.0)
    vals = jnp.where(inside_root & in_dataset & owned, vals, jnp.asarray(0.0, _f32))
    return vals, owned


def slab_owner_x(pos_or_ijk_x: jnp.ndarray, d1: int) -> jnp.ndarray:
    """Clamped global voxel-x index that defines slab ownership: every
    sample (even out-of-volume ones) belongs to exactly one x-slab — the
    one containing its x-clamped voxel (see octree_nn_sample_slab)."""
    return jnp.clip(pos_or_ijk_x, 0, d1 - 1)


# Corner offsets in the a5 kernel's fetch order (kernel.cu:129-159):
# X1..X8 = (0,0,0),(0,0,1),(0,1,0),(0,1,1),(1,0,0),(1,0,1),(1,1,0),(1,1,1)
_A5_OFFSETS = (
    (0.0, 0.0, 0.0),
    (0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0),
    (0.0, 1.0, 1.0),
    (1.0, 0.0, 0.0),
    (1.0, 0.0, 1.0),
    (1.0, 1.0, 0.0),
    (1.0, 1.0, 1.0),
)


def corner_intensities(
    volume_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    pos: jnp.ndarray,
) -> jnp.ndarray:
    """The 8 corner intensities for a5 interpolation, shape (..., 8).

    Replicates the reference's per-corner index computation: offsets are
    added in float before per-axis truncation, and the only bound guard is
    ``flat < totaldim`` (kernel.cu:129-159).
    """
    d1, d2, d3 = dims
    total = d1 * d2 * d3
    pos = pos.astype(_f32)
    outs = []
    for off in _A5_OFFSETS:
        q = pos + jnp.asarray(off, _f32)
        ijk = jnp.trunc(q).astype(jnp.int32)
        flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
        ok = flat < total
        vals = jnp.take(volume_flat, jnp.clip(flat, 0, total - 1), axis=0)
        outs.append(jnp.where(ok, vals, jnp.asarray(0.0, _f32)))
    return jnp.stack(outs, axis=-1)


def trilinear_mix_colors(colors8: jnp.ndarray, frac: jnp.ndarray) -> jnp.ndarray:
    """Mix 8 corner RGBAs (..., 8, 4) with fractions (..., 3), y->x->z order
    (kernel.cu:161-175)."""
    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    fz = frac[..., 2:3]
    c = colors8
    cy1 = c[..., 0, :] * (1.0 - fy) + c[..., 2, :] * fy
    cy2 = c[..., 1, :] * (1.0 - fy) + c[..., 3, :] * fy
    cy3 = c[..., 4, :] * (1.0 - fy) + c[..., 6, :] * fy
    cy4 = c[..., 5, :] * (1.0 - fy) + c[..., 7, :] * fy
    cz1 = cy1 * (1.0 - fx) + cy3 * fx
    cz2 = cy2 * (1.0 - fx) + cy4 * fx
    return cz1 * (1.0 - fz) + cz2 * fz


def trilinear_color_sample(
    volume_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    pos: jnp.ndarray,
    classify_fn,
    cal_max: jnp.ndarray,
) -> jnp.ndarray:
    """a5/TEST sample color at voxel-space positions (..., 3) -> (..., 4)."""
    pos = pos.astype(_f32)
    dimv = jnp.asarray(dims, _f32)
    inside = jnp.all((pos >= 0.0) & (pos < dimv), axis=-1)

    intens = corner_intensities(volume_flat, dims, pos)  # (..., 8)
    colors8 = classify_fn(div_exact(intens, cal_max))  # (..., 8, 4)
    frac = pos - jnp.trunc(pos)  # `difference` kernel.cu:127
    mixed = trilinear_mix_colors(colors8, frac)

    outside_color = classify_fn(jnp.zeros_like(cal_max))  # TF(0) kernel.cu:117
    return jnp.where(inside[..., None], mixed, outside_color)


def trilinear_intensity_sample(
    volume: jnp.ndarray,
    pos: jnp.ndarray,
) -> jnp.ndarray:
    """Smooth-mode intensity sample at voxel-space positions (..., 3).

    Standard zero-padded trilinear interpolation of intensities; the
    differentiable counterpart of :func:`octree_nn_sample` (no reference
    equivalent — the reference only interpolates colors).
    """
    d1, d2, d3 = volume.shape[:3]
    pos = pos.astype(_f32)
    base = jnp.floor(pos)
    frac = pos - base
    basei = base.astype(jnp.int32)

    def fetch(ox, oy, oz):
        ix = basei[..., 0] + ox
        iy = basei[..., 1] + oy
        iz = basei[..., 2] + oz
        ok = (
            (ix >= 0) & (ix < d1) & (iy >= 0) & (iy < d2) & (iz >= 0) & (iz < d3)
        )
        flat = (
            jnp.clip(ix, 0, d1 - 1) * (d2 * d3)
            + jnp.clip(iy, 0, d2 - 1) * d3
            + jnp.clip(iz, 0, d3 - 1)
        )
        v = jnp.take(volume.reshape(d1 * d2 * d3, -1), flat, axis=0)
        return jnp.where(ok[..., None], v, jnp.asarray(0.0, _f32))

    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    fz = frac[..., 2:3]
    c000, c001 = fetch(0, 0, 0), fetch(0, 0, 1)
    c010, c011 = fetch(0, 1, 0), fetch(0, 1, 1)
    c100, c101 = fetch(1, 0, 0), fetch(1, 0, 1)
    c110, c111 = fetch(1, 1, 0), fetch(1, 1, 1)
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    return out.squeeze(-1) if out.shape[-1] == 1 else out


# ---------------------------------------------------------------------------
# Halo-extended x-slab samplers (volume-axis sharding with trilinear /
# gradient taps — SURVEY.md §2 "halo exchange"; parallel/render_dist.py
# exchanges one-voxel x-halos with lax.ppermute and passes the extended slab
# here).  All of these return ``(value_or_rgba, owned)`` where ``owned`` is
# the exactly-one-device ownership mask (slab_owner_x of the sample).
# ---------------------------------------------------------------------------


def corner_intensities_slab(
    slab_ext_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    pos: jnp.ndarray,
    x0: jnp.ndarray,
    slab_x: int,
    hw: int,
) -> jnp.ndarray:
    """The a5 corner fetch (see :func:`corner_intensities`) against an
    x-slab extended by ``hw`` halo planes on each side.

    Exactness: the reference's only guard is ``flat < totaldim``
    (kernel.cu:130), indices wrapping across rows.  For a sample owned by
    this slab (trunc x in [x0, x0+slab_x)), a corner's wrapped flat index
    lies in x rows [x0, x0+slab_x+2) — the +1 x offset plus compounded
    y-wrap (iy=d2 adds one full x row) and z-wrap — so ``hw >= 2``
    reproduces the global fetch bit-for-bit; non-owned samples may read
    clamped garbage — their result is discarded by the caller's ``owned``
    mask.
    """
    d1, d2, d3 = dims
    total = d1 * d2 * d3
    ext_total = (slab_x + 2 * hw) * d2 * d3
    base = (x0 - hw) * (d2 * d3)
    pos = pos.astype(_f32)
    outs = []
    for off in _A5_OFFSETS:
        q = pos + jnp.asarray(off, _f32)
        ijk = jnp.trunc(q).astype(jnp.int32)
        flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
        lflat = flat - base
        ok = (flat < total) & (lflat >= 0) & (lflat < ext_total)
        vals = jnp.take(slab_ext_flat, jnp.clip(lflat, 0, ext_total - 1),
                        axis=0)
        outs.append(jnp.where(ok, vals, jnp.asarray(0.0, _f32)))
    return jnp.stack(outs, axis=-1)


def trilinear_color_sample_slab(
    slab_ext_flat: jnp.ndarray,
    dims: Tuple[int, int, int],
    pos: jnp.ndarray,
    classify_fn,
    cal_max: jnp.ndarray,
    x0: jnp.ndarray,
    slab_x: int,
    hw: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Slab variant of :func:`trilinear_color_sample` -> (rgba, owned)."""
    d1 = dims[0]
    pos = pos.astype(_f32)
    dimv = jnp.asarray(dims, _f32)
    inside = jnp.all((pos >= 0.0) & (pos < dimv), axis=-1)
    gx = slab_owner_x(jnp.trunc(pos[..., 0]).astype(jnp.int32), d1)
    owned = (gx >= x0) & (gx < x0 + slab_x)

    intens = corner_intensities_slab(
        slab_ext_flat, dims, pos, x0, slab_x, hw)
    colors8 = classify_fn(div_exact(intens, cal_max))
    frac = pos - jnp.trunc(pos)
    mixed = trilinear_mix_colors(colors8, frac)
    outside_color = classify_fn(jnp.zeros_like(cal_max))
    rgba = jnp.where(inside[..., None], mixed, outside_color)
    return jnp.where(owned[..., None], rgba, jnp.zeros_like(rgba)), owned


def trilinear_intensity_sample_slab(
    slab_ext: jnp.ndarray,
    dims: Tuple[int, int, int],
    pos: jnp.ndarray,
    x0: jnp.ndarray,
    slab_x: int,
    hw: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Slab variant of :func:`trilinear_intensity_sample` -> (value, owned).

    Ownership is by the zero-padded interpolation's base voxel (floor),
    x-clamped; taps reach floor+1 so ``hw >= 1``.
    """
    d1, d2, d3 = dims
    pos = pos.astype(_f32)
    base = jnp.floor(pos)
    frac = pos - base
    basei = base.astype(jnp.int32)
    gx = slab_owner_x(basei[..., 0], d1)
    owned = (gx >= x0) & (gx < x0 + slab_x)
    ext_x = slab_x + 2 * hw
    flat2d = slab_ext.reshape(ext_x * d2 * d3, -1)

    def fetch(ox, oy, oz):
        ix = basei[..., 0] + ox
        iy = basei[..., 1] + oy
        iz = basei[..., 2] + oz
        ok = (
            (ix >= 0) & (ix < d1) & (iy >= 0) & (iy < d2)
            & (iz >= 0) & (iz < d3)
        )
        lx = ix - (x0 - hw)
        ok &= (lx >= 0) & (lx < ext_x)
        flat = (
            jnp.clip(lx, 0, ext_x - 1) * (d2 * d3)
            + jnp.clip(iy, 0, d2 - 1) * d3
            + jnp.clip(iz, 0, d3 - 1)
        )
        v = jnp.take(flat2d, flat, axis=0)
        return jnp.where(ok[..., None], v, jnp.asarray(0.0, _f32))

    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    fz = frac[..., 2:3]
    c000, c001 = fetch(0, 0, 0), fetch(0, 0, 1)
    c010, c011 = fetch(0, 1, 0), fetch(0, 1, 1)
    c100, c101 = fetch(1, 0, 0), fetch(1, 0, 1)
    c110, c111 = fetch(1, 1, 0), fetch(1, 1, 1)
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    out = out.squeeze(-1) if out.shape[-1] == 1 else out
    return jnp.where(owned, out, jnp.asarray(0.0, _f32)), owned


def octree_nn_index_slab(
    dims: Tuple[int, int, int],
    depth: int,
    p: jnp.ndarray,
    x0: jnp.ndarray,
    slab_x: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Slab-local a1 index computation: (local_flat, valid, owned).

    The index/ownership chain of :func:`octree_nn_sample_slab`, factored
    out for samplers that gather something other than the scalar intensity
    (multi-channel voxels, gradient fields).  ``local_flat`` is clamped
    into the slab and safe to gather with; ``valid`` is the usual
    in-root/in-dataset mask; ``owned`` the exactly-one-slab mask.
    """
    d1, d2, d3 = dims
    L = float(max(dims))
    n = float(2**depth)
    dimv = jnp.asarray([d1, d2, d3], _f32)

    p = p.astype(_f32)
    inside_root = jnp.all((p >= 0.0) & (p < 1.0), axis=-1)
    k = jnp.floor(p * n)
    res = (k / n) * jnp.asarray(L, _f32)
    half_gap = jnp.asarray(L, _f32) / 2.0 - dimv / 2.0
    in_dataset = jnp.all((res >= half_gap) & (res < half_gap + dimv), axis=-1)
    t = (res + dimv / 2.0) - jnp.asarray(L, _f32) / 2.0
    ijk = jnp.trunc(t).astype(jnp.int32)
    gx = jnp.clip(ijk[..., 0], 0, d1 - 1)
    owned = (gx >= x0) & (gx < x0 + slab_x)
    lx = jnp.clip(gx - x0, 0, slab_x - 1)
    flat = lx * (d2 * d3) + jnp.clip(ijk[..., 1], 0, d2 - 1) * d3 + jnp.clip(
        ijk[..., 2], 0, d3 - 1
    )
    return flat, inside_root & in_dataset, owned
