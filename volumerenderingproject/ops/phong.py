"""Volumetric lighting: Phong gradient shading + Henyey-Greenstein phase.

The reference *declares* a radiative-transfer API but every body is a stub
returning 0 (C16, LightInteraction.cpp:5-80); the only working piece is an
isotropic HG phase function with g = 0 (myApp.cu:1721-1728).  BASELINE.json
names "Phong/gradient lighting" as a first-class capability of the new
framework, so this module implements it for real:

  * Normals: the normalized density gradient (ops/conv3d gradient filters),
    sampled per ray sample.
  * Phong: ambient + diffuse + specular against a directional light,
    applied to the classified sample color before compositing.
  * HG phase: the full Henyey-Greenstein distribution with per-material g
    (the reference stores g on Material but never uses it; Material.h:14-23).

Everything is differentiable — light parameters join the optimizable set.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

_f32 = jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Light:
    """Directional light + Phong coefficients."""

    direction: jnp.ndarray  # [3], world space, need not be normalized
    color: jnp.ndarray  # [3]
    ambient: jnp.ndarray  # scalar
    diffuse: jnp.ndarray  # scalar
    specular: jnp.ndarray  # scalar
    shininess: jnp.ndarray  # scalar


def default_light() -> Light:
    return Light(
        direction=jnp.asarray([0.5, 1.0, 0.75], _f32),
        color=jnp.asarray([1.0, 1.0, 1.0], _f32),
        ambient=jnp.asarray(0.35, _f32),
        diffuse=jnp.asarray(0.55, _f32),
        specular=jnp.asarray(0.25, _f32),
        shininess=jnp.asarray(16.0, _f32),
    )


N_LIGHT_PARAMS = 10  # direction 3 + color 3 + ambient/diffuse/specular/shininess


def light_to_vec(light: Light) -> jnp.ndarray:
    """Flatten a Light into a [10] f32 vector (the optimizable parameter
    set named by BASELINE.json's north star: "gradients w.r.t. ...
    lighting").  Inverse of :func:`light_from_vec`."""
    return jnp.concatenate([
        jnp.asarray(light.direction, _f32).reshape(3),
        jnp.asarray(light.color, _f32).reshape(3),
        jnp.asarray(light.ambient, _f32).reshape(1),
        jnp.asarray(light.diffuse, _f32).reshape(1),
        jnp.asarray(light.specular, _f32).reshape(1),
        jnp.asarray(light.shininess, _f32).reshape(1),
    ])


def light_from_vec(v: jnp.ndarray) -> Light:
    return Light(
        direction=v[0:3],
        color=v[3:6],
        ambient=v[6],
        diffuse=v[7],
        specular=v[8],
        shininess=v[9],
    )


def safe_pow(base: jnp.ndarray, exponent) -> jnp.ndarray:
    """``base ** exponent`` for base >= 0 with a NaN-free derivative w.r.t.
    a *traced* exponent: d/d exp = pow * log(base) is NaN at base == 0
    (0 * -inf), which poisons light-shininess gradients.  Clamps the base
    away from 0 inside the pow and zeroes the result where base == 0 —
    value-identical for base outside (0, 1e-6)."""
    b = jnp.maximum(base, 1e-6)
    return jnp.where(base > 0.0, b**exponent, 0.0)


def random_directions(key, n: int) -> jnp.ndarray:
    """n uniformly distributed unit vectors [n, 3] (the vectorized
    counterpart of the reference's rejection-sampled getRandomDirection /
    initialize_random_directions, myApp.cu:1693-1710) — used for stochastic
    scattering directions with the HG phase function."""
    import jax

    v = jax.random.normal(key, (n, 3), _f32)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def henyey_greenstein(cos_theta: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """HG phase function p(cos θ; g) = (1-g²) / (4π (1+g²-2g cosθ)^{3/2}).

    g = 0 reduces to the isotropic 1/4π — exactly the reference's
    Henyey_Greenstein_Phaze_Function (myApp.cu:1721-1728).
    """
    g = jnp.asarray(g, _f32)
    denom = 1.0 + g * g - 2.0 * g * jnp.asarray(cos_theta, _f32)
    return (1.0 - g * g) / (4.0 * jnp.pi * jnp.maximum(denom, 1e-8) ** 1.5)


def light_transmittance_grid_slab(
    alpha_slab: jnp.ndarray,
    light_dir,
    *,
    axis_name: str = "volume",
) -> jnp.ndarray:
    """Volume-sharded :func:`light_transmittance_grid`: ``alpha_slab`` is
    this device's x-slab [m, Y, Z] of an x-block-sharded alpha grid (one
    slab per device on the shard_map axis ``axis_name``); returns the
    slab's portion of the full-volume transmittance grid, numerically
    identical to the replicated sweep (the same per-plane operations in
    the same order, stitched across devices with ``lax.ppermute``).

    Two communication patterns, chosen by the light's dominant axis
    (the sweep is a prefix along the light axis):

      * dominant axis == x (the sharded axis): the sweep is a sequential
        pipeline across slabs — each stage every device runs its local
        m-plane scan and forwards its boundary carry [Y, Z] to the next
        slab in visit order (n_vol ppermutes total; compute cost n_vol x
        the local scan, i.e. one full-volume sweep per device).
      * dominant axis == y/z: planes span [X(sharded), .]; the shear's
        x-component couples adjacent x rows, so each scan step exchanges
        ONE boundary row [1, C] with each x-neighbor (2 ppermutes/plane)
        and resamples from the halo-extended carry.

    ``light_dir`` must be CONCRETE (not a tracer): the branch is chosen
    in Python because the two patterns have different collective
    structures.  Traced directions (light-direction fits on a volume
    mesh) fall back to the rays/samples axes — diff/fit.py never routes
    scattering through slabs."""
    import numpy as _np

    if isinstance(light_dir, jax.core.Tracer):
        raise NotImplementedError(
            "volume-sharded scattering needs a concrete light direction; "
            "use rays/samples axes to fit light params under scattering")
    u = _np.asarray(jax.device_get(light_dir), _np.float32)
    u = u / max(float(_np.linalg.norm(u)), 1e-8)
    axis = int(_np.argmax(_np.abs(u)))
    sign = 1.0 if u[axis] >= 0 else -1.0
    n = jax.lax.axis_size(axis_name)
    vi = jax.lax.axis_index(axis_name)
    m = alpha_slab.shape[0]

    uj = jnp.asarray(u, _f32)

    def att_of(a, dl):
        return jnp.power(jnp.maximum(1.0 - a, 1e-9), dl)

    # all shear constants stay float32 — the replicated sweep computes
    # them in f32 from the traced direction, so f64 here would break the
    # numerically-identical claim
    inv32 = _np.float32(1.0) / _np.maximum(
        _np.abs(u[axis]), _np.float32(1e-6))

    if axis == 0:
        # ---- x-dominant: sequential slab pipeline ----------------------
        a = alpha_slab  # [m, Y, Z]
        inv = inv32
        db = u[1] * inv
        dc = u[2] * inv
        nb, nc = a.shape[1], a.shape[2]
        att = att_of(a, jnp.asarray(inv, _f32))

        ib = _np.floor(db + _np.arange(nb, dtype=_np.float32))
        ic = _np.floor(dc + _np.arange(nc, dtype=_np.float32))
        fb = jnp.asarray((db + _np.arange(nb, dtype=_np.float32)) - ib)
        fc = jnp.asarray((dc + _np.arange(nc, dtype=_np.float32)) - ic)
        ib = jnp.asarray(ib.astype(_np.int32))
        ic = jnp.asarray(ic.astype(_np.int32))

        def resample(g):
            def tap(iy, iz):
                ok = ((iy >= 0) & (iy < nb))[:, None] & (
                    (iz >= 0) & (iz < nc))[None, :]
                v = g[jnp.clip(iy, 0, nb - 1)][:, jnp.clip(iz, 0, nc - 1)]
                return jnp.where(ok, v, 1.0)

            w00 = (1 - fb)[:, None] * (1 - fc)[None, :]
            w01 = (1 - fb)[:, None] * fc[None, :]
            w10 = fb[:, None] * (1 - fc)[None, :]
            w11 = fb[:, None] * fc[None, :]
            return (w00 * tap(ib, ic) + w01 * tap(ib, ic + 1)
                    + w10 * tap(ib + 1, ic) + w11 * tap(ib + 1, ic + 1))

        def local_sweep(g_in):
            def step(g_prev, k):
                idx = jnp.where(sign > 0, m - 1 - k, k)
                t_k = resample(g_prev)
                g_k = t_k * jax.lax.dynamic_index_in_dim(
                    att, idx, 0, keepdims=False)
                return g_k, t_k

            g_out, t_planes = jax.lax.scan(
                step, g_in, jnp.arange(m, dtype=jnp.int32))
            t = jnp.where(sign > 0, t_planes[::-1], t_planes)
            return t, g_out

        # visit order: sign>0 sweeps from high x down => slab n-1 first,
        # carry flows to lower slabs; sign<0 the reverse
        if sign > 0:
            pairs = [(i, i - 1) for i in range(1, n)]
            my_stage = (n - 1) - vi
        else:
            pairs = [(i, i + 1) for i in range(n - 1)]
            my_stage = vi

        def stage(s, carry):
            # invariant: entering stage s, the device with my_stage == s
            # holds the TRUE incoming carry (stage 0: the init ones;
            # stage s: received from its upstream slab at stage s-1).
            # Other devices sweep garbage harmlessly — their t is either
            # already kept or will be overwritten on their turn.
            g, t_acc = carry
            t_planes, g_out = local_sweep(g)
            t_acc = jnp.where(my_stage == s, t_planes, t_acc)
            g = jax.lax.ppermute(g_out, axis_name, pairs)
            return g, t_acc

        ones_bc = jnp.ones(a.shape[1:], _f32)
        _, t = jax.lax.fori_loop(
            0, n, stage, (ones_bc, jnp.ones_like(a)))
        return t

    # ---- y/z-dominant: halo-exchange scan ------------------------------
    perm = (1, 0, 2) if axis == 1 else (2, 0, 1)
    a = jnp.transpose(alpha_slab, perm)  # [A, m, C]; B = x is sharded
    na, _, nc = a.shape
    inv = inv32
    db = u[perm[1]] * inv  # x-shear: couples adjacent slabs
    dc = u[perm[2]] * inv
    att = att_of(a, jnp.asarray(inv, _f32))

    x0 = vi * m
    jloc = _np.arange(m, dtype=_np.float32)
    lb = _np.floor(db + jloc)  # local tap row (may be -1 / m: the halo)
    fb = jnp.asarray((db + jloc) - lb)
    lb = jnp.asarray(lb.astype(_np.int32))
    ic = _np.floor(dc + _np.arange(nc, dtype=_np.float32))
    fc = jnp.asarray((dc + _np.arange(nc, dtype=_np.float32)) - ic)
    ic = jnp.asarray(ic.astype(_np.int32))
    nb_global = n * m
    left_pairs = [(i, i + 1) for i in range(n - 1)]
    right_pairs = [(i, i - 1) for i in range(1, n)]

    def resample_halo(g):
        # halo rows: global x0-1 (left) and x0+m (right) of the carry
        left = jax.lax.ppermute(g[-1:], axis_name, left_pairs)
        right = jax.lax.ppermute(g[:1], axis_name, right_pairs)
        ext = jnp.concatenate([left, g, right], axis=0)  # [m+2, C]

        def tap(row_l, iz):
            gy = x0 + row_l  # global x row of the tap
            ok = ((gy >= 0) & (gy < nb_global))[:, None] & (
                (iz >= 0) & (iz < nc))[None, :]
            v = ext[jnp.clip(row_l + 1, 0, m + 1)][
                :, jnp.clip(iz, 0, nc - 1)]
            return jnp.where(ok, v, 1.0)

        w00 = (1 - fb)[:, None] * (1 - fc)[None, :]
        w01 = (1 - fb)[:, None] * fc[None, :]
        w10 = fb[:, None] * (1 - fc)[None, :]
        w11 = fb[:, None] * fc[None, :]
        return (w00 * tap(lb, ic) + w01 * tap(lb, ic + 1)
                + w10 * tap(lb + 1, ic) + w11 * tap(lb + 1, ic + 1))

    def step(g_prev, k):
        idx = jnp.where(sign > 0, na - 1 - k, k)
        t_k = resample_halo(g_prev)
        g_k = t_k * jax.lax.dynamic_index_in_dim(
            att, idx, 0, keepdims=False)
        return g_k, t_k

    ones = jnp.ones((m, nc), _f32)
    _, t_planes = jax.lax.scan(
        step, ones, jnp.arange(na, dtype=jnp.int32))
    t = jnp.where(sign > 0, t_planes[::-1], t_planes)
    inv_perm = _np.argsort(perm)
    return jnp.transpose(t, inv_perm)


def light_transmittance_grid(
    alpha: jnp.ndarray, light_dir: jnp.ndarray
) -> jnp.ndarray:
    """Per-voxel transmittance toward a directional light, [X, Y, Z] f32.

    ``T(v) = prod (1 - alpha)^dl`` along the segment from voxel v to the
    volume boundary in the ``light_dir`` direction (the direction TOWARD
    the light) — the working realization of the reference's stubbed
    ``optical_depth``/``extinction`` API (LightInteraction.h:10-35,
    LightInteraction.cpp:5-80: Riemann sums over bodies returning 0).

    Vectorized evaluation: a sheared plane sweep (the half-angle-slicing
    idea) along the light's dominant axis — one `lax.scan` whose carry is
    the previous plane's accumulated transmittance, resampled bilinearly
    by the constant shear offset, instead of a per-voxel ray march.  Cost
    O(volume), fully differentiable (including w.r.t. ``light_dir``).
    The six (axis, sign) sweep variants are selected with `lax.switch`,
    so a traced light direction stays jittable.

    Approximation: the path is discretized one plane at a time with path
    length 1/|u_axis| voxels per plane and bilinear resampling of the
    running product between planes (exact for axis-aligned lights).
    """
    u = light_dir / jnp.maximum(jnp.linalg.norm(light_dir), 1e-8)
    axis = jnp.argmax(jnp.abs(u))

    def sweep(perm):
        """Sweep along axes ``perm[0]``; returns T for +sign (light on the
        high side of that axis) via a closure, parameterized by sign."""

        def run(sign):
            a = jnp.transpose(alpha, perm)  # [A, B, C], sweep over A
            ub = u[perm[1]]
            uc = u[perm[2]]
            # upstream (toward the light) of plane k is the adjacent plane
            # on the light side, offset by the shear (db, dc) = u_perp/|u_a|
            # (independent of the axis sign: the step is u / |u_a|)
            inv = 1.0 / jnp.maximum(jnp.abs(u[perm[0]]), 1e-6)
            db = ub * inv
            dc = uc * inv
            dl = inv  # path length through one plane, voxel units
            na, nb, nc = a.shape
            att = jnp.power(jnp.maximum(1.0 - a, 1e-9), dl)

            ib = jnp.floor(db + jnp.arange(nb, dtype=_f32))
            ic = jnp.floor(dc + jnp.arange(nc, dtype=_f32))
            fb = (db + jnp.arange(nb, dtype=_f32)) - ib
            fc = (dc + jnp.arange(nc, dtype=_f32)) - ic
            ib = ib.astype(jnp.int32)
            ic = ic.astype(jnp.int32)

            def resample(g):
                # bilinear sample of g at (ib + fb, ic + fc); out of
                # bounds reads 1 (full transmittance beyond the volume)
                def tap(iy, iz):
                    ok = ((iy >= 0) & (iy < nb))[:, None] & (
                        (iz >= 0) & (iz < nc))[None, :]
                    v = g[jnp.clip(iy, 0, nb - 1)][:, jnp.clip(iz, 0, nc - 1)]
                    return jnp.where(ok, v, 1.0)

                w00 = (1 - fb)[:, None] * (1 - fc)[None, :]
                w01 = (1 - fb)[:, None] * fc[None, :]
                w10 = fb[:, None] * (1 - fc)[None, :]
                w11 = fb[:, None] * fc[None, :]
                return (w00 * tap(ib, ic) + w01 * tap(ib, ic + 1)
                        + w10 * tap(ib + 1, ic) + w11 * tap(ib + 1, ic + 1))

            def step(g_prev, k):
                # k indexes the ORIGINAL axis; sign<0 flips traversal
                idx = jnp.where(sign > 0, na - 1 - k, k)
                t_k = resample(g_prev)
                g_k = t_k * jax.lax.dynamic_index_in_dim(
                    att, idx, 0, keepdims=False)
                return g_k, t_k

            ones = jnp.ones((nb, nc), _f32)
            _, t_planes = jax.lax.scan(
                step, ones, jnp.arange(na, dtype=jnp.int32))
            # t_planes[j] is plane visited j-th; map back to axis order
            t = jnp.where(sign > 0, t_planes[::-1], t_planes)
            inv_perm = np.argsort(perm)
            return jnp.transpose(t, inv_perm)

        return run

    perms = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]
    branches = []
    for perm in perms:
        for sign in (1.0, -1.0):
            branches.append(
                (lambda p, s: (lambda: sweep(p)(jnp.asarray(s, _f32))))(
                    tuple(perm), sign))
    # branch index: 2*axis + (u_axis < 0)
    neg = jnp.take(u, axis) < 0
    idx = axis * 2 + neg.astype(jnp.int32)
    return jax.lax.switch(idx, branches)


def phong_shade(
    rgb: jnp.ndarray,
    normal: jnp.ndarray,
    view_dir: jnp.ndarray,
    light: Light,
    grad_mag: jnp.ndarray | None = None,
    grad_threshold: float = 1e-3,
) -> jnp.ndarray:
    """Shade sample colors [..., 3] with normals [..., 3].

    ``view_dir`` points from the sample toward the camera ([..., 3] or [3]).
    Where the gradient magnitude is below ``grad_threshold`` (homogeneous
    media have no meaningful surface normal), shading falls back to the
    unshaded color.
    """
    l = light.direction / jnp.linalg.norm(light.direction)
    n = normal
    n_norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(n_norm, 1e-8)

    ndotl = jnp.abs(jnp.sum(n * l, axis=-1, keepdims=True))
    # Blinn-Phong half vector
    v = view_dir / jnp.maximum(
        jnp.linalg.norm(view_dir, axis=-1, keepdims=True), 1e-8
    )
    h = l + v
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
    ndoth = jnp.abs(jnp.sum(n * h, axis=-1, keepdims=True))

    shaded = (
        light.ambient * rgb
        + light.diffuse * ndotl * rgb * light.color
        + light.specular * safe_pow(ndoth, light.shininess) * light.color
    )
    mag = n_norm if grad_mag is None else grad_mag[..., None]
    w = jnp.clip(mag / grad_threshold, 0.0, 1.0)
    return w * shaded + (1.0 - w) * rgb
