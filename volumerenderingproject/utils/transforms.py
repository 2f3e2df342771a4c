"""Homogeneous 4x4 transform helpers (jnp, float32).

Replacement for the glm subset used by the reference
(/root/reference, GLM_FORCE_CUDA via kernel.h:4).  Matrices are stored in the
*mathematical* convention: ``apply(M, p) == (M @ [p, 1])[:3]`` — equivalent to
glm's column-major ``M * vec4(p, 1)``.

``translate``/``scale``/``rotate`` mirror glm call semantics: they *right*
multiply (``glm::translate(m, v) == m * T``), so a chain
``m = translate(m, a); m = scale(m, s)`` applies the scale first, matching
e.g. kernel.cu:1177-1192 (modelCam) and BinaryLoader.cu:247-269
(toVolumeSpace).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "identity",
    "translate",
    "scale",
    "rotate",
    "translation",
    "scaling",
    "rotation",
    "look_at",
    "ortho",
    "perspective",
    "inverse",
    "matmul",
    "apply",
    "apply_dir",
    "normalize",
    "cross",
]

_f32 = jnp.float32

# On an NVIDIA GPU a float32 matmul/dot at DEFAULT precision may run in
# TF32 (10-bit mantissa, ~3 decimal digits) — enough error in transformed
# sample positions to flip voxel truncations and visibly corrupt a5
# renders on the card, which CPU tests never see.  Every matrix product in
# this module is tiny (4x4 or Nx3 by 3x3), so full float32 precision is
# effectively free.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HI)


def matmul(a, b) -> jnp.ndarray:
    """Full-f32-precision matmul for transform chains (see _HI note)."""
    return _mm(jnp.asarray(a, _f32), jnp.asarray(b, _f32)).astype(_f32)


def _as_vec3(v) -> jnp.ndarray:
    return jnp.asarray(v, dtype=_f32).reshape(3)


def identity() -> jnp.ndarray:
    return jnp.eye(4, dtype=_f32)


def translation(v) -> jnp.ndarray:
    """Pure translation matrix (glm translation part of glm::translate(I, v))."""
    v = _as_vec3(v)
    m = jnp.eye(4, dtype=_f32)
    return m.at[:3, 3].set(v)


def scaling(v) -> jnp.ndarray:
    """Pure (anisotropic) scaling matrix."""
    v = _as_vec3(v)
    m = jnp.eye(4, dtype=_f32)
    return m.at[0, 0].set(v[0]).at[1, 1].set(v[1]).at[2, 2].set(v[2])


def rotation(angle_rad, axis) -> jnp.ndarray:
    """Rotation about ``axis`` by ``angle_rad`` (glm::rotate semantics).

    Axis is normalized internally, matching glm.
    """
    axis = normalize(_as_vec3(axis))
    c = jnp.cos(jnp.asarray(angle_rad, _f32))
    s = jnp.sin(jnp.asarray(angle_rad, _f32))
    t = 1.0 - c
    x, y, z = axis[0], axis[1], axis[2]
    r = jnp.stack(
        [
            jnp.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y]),
            jnp.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x]),
            jnp.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c]),
        ]
    ).astype(_f32)
    m = jnp.eye(4, dtype=_f32)
    return m.at[:3, :3].set(r)


def translate(m, v) -> jnp.ndarray:
    """``glm::translate(m, v) == m @ translation(v)``."""
    return _mm(jnp.asarray(m, _f32), translation(v)).astype(_f32)


def scale(m, v) -> jnp.ndarray:
    """``glm::scale(m, v) == m @ scaling(v)``."""
    return _mm(jnp.asarray(m, _f32), scaling(v)).astype(_f32)


def rotate(m, angle_rad, axis) -> jnp.ndarray:
    """``glm::rotate(m, angle, axis) == m @ rotation(angle, axis)``."""
    return _mm(jnp.asarray(m, _f32), rotation(angle_rad, axis)).astype(_f32)


def normalize(v) -> jnp.ndarray:
    """glm::normalize — v * inversesqrt(dot(v, v)); no zero guard, like glm."""
    v = jnp.asarray(v, _f32)
    return v * jax_rsqrt(jnp.sum(v * v, axis=-1, keepdims=v.ndim > 1))


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(jnp.asarray(x, _f32))


def cross(a, b) -> jnp.ndarray:
    a = jnp.asarray(a, _f32)
    b = jnp.asarray(b, _f32)
    return jnp.cross(a, b).astype(_f32)


def look_at(eye, center, up) -> jnp.ndarray:
    """glm::lookAt (right-handed): view matrix looking from eye at center."""
    eye = _as_vec3(eye)
    f = normalize(_as_vec3(center) - eye)
    s = normalize(cross(f, _as_vec3(up)))
    u = cross(s, f)
    m = jnp.stack(
        [
            jnp.concatenate([s, -jnp.dot(s, eye, precision=_HI)[None]]),
            jnp.concatenate([u, -jnp.dot(u, eye, precision=_HI)[None]]),
            jnp.concatenate([-f, jnp.dot(f, eye, precision=_HI)[None]]),
            jnp.asarray([0.0, 0.0, 0.0, 1.0], _f32),
        ]
    )
    return m.astype(_f32)


def ortho(left, right, bottom, top, znear, zfar) -> jnp.ndarray:
    """glm::ortho — orthographic projection (myApp.cu:182)."""
    left, right, bottom, top, znear, zfar = (
        jnp.asarray(x, _f32) for x in (left, right, bottom, top, znear, zfar)
    )
    m = jnp.zeros((4, 4), _f32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(-2.0 / (zfar - znear))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-(zfar + znear) / (zfar - znear))
    m = m.at[3, 3].set(1.0)
    return m


def perspective(fovy_rad, aspect, znear, zfar) -> jnp.ndarray:
    """glm::perspective (right-handed, [-1, 1] clip)."""
    fovy_rad = jnp.asarray(fovy_rad, _f32)
    t = jnp.tan(fovy_rad / 2.0)
    m = jnp.zeros((4, 4), _f32)
    m = m.at[0, 0].set(1.0 / (jnp.asarray(aspect, _f32) * t))
    m = m.at[1, 1].set(1.0 / t)
    m = m.at[2, 2].set(-(zfar + znear) / (zfar - znear))
    m = m.at[2, 3].set(-(2.0 * zfar * znear) / (zfar - znear))
    m = m.at[3, 2].set(-1.0)
    return m


def inverse(m) -> jnp.ndarray:
    """General 4x4 inverse (glm::inverse, kernel.cu:1198)."""
    with jax.default_matmul_precision("float32"):
        return jnp.linalg.inv(jnp.asarray(m, _f32)).astype(_f32)


def apply(m, p) -> jnp.ndarray:
    """Apply homogeneous transform to point(s): ``(M @ [p, 1])[:3]``.

    ``p`` may be shape (3,) or (..., 3).
    """
    m = jnp.asarray(m, _f32)
    p = jnp.asarray(p, _f32)
    # explicit mul-adds: stays on the VPU in full f32 (see _HI note)
    r = m[:3, :3]
    out = (p[..., 0:1] * r[:, 0] + p[..., 1:2] * r[:, 1]
           + p[..., 2:3] * r[:, 2] + m[:3, 3])
    return out.astype(_f32)


def apply_dir(m, d) -> jnp.ndarray:
    """Apply only the linear part (w=0) to direction(s)."""
    m = jnp.asarray(m, _f32)
    d = jnp.asarray(d, _f32)
    r = m[:3, :3]
    return (d[..., 0:1] * r[:, 0] + d[..., 1:2] * r[:, 1]
            + d[..., 2:3] * r[:, 2]).astype(_f32)
