"""POINT / a0 mode: voxel point-cloud splatting, as a software rasterizer.

The reference draws one GL_POINT per voxel (myApp.cu:955-981) with
  model      = translate(I, (-0.5,-0.5,-0.5))            (myApp.cu:170-171)
  view       = lookAt(cameraPos, origin, cameraUp)       (myApp.cu:960)
  projection = ortho(-1, 1, -1, 1, -1.5, 1.5)            (myApp.cu:182)
vertex positions are the longest-dimension-centered voxel coords
((x + L/2 - dim/2)/L, prepareVolumeColors myApp.cu:1302-1304), colors come
from the transfer function, and the fragment shader discards alpha == 0
(3.3.point_shader.fs:6-8).  Depth test is LESS with alpha blending in voxel
draw order.

This implementation resolves visibility with a depth buffer via
``segment_min`` (nearest surviving voxel per pixel, ties broken by lowest
voxel index — i.e. first drawn, which is what GL_LESS keeps), then blends the
winner over the background.  Deviation from GL: occluded-but-drawn-later
translucent fragments do not accumulate (the reference's draw-order blending
artifact); for the brain TF whose visible materials have alpha 0.3-0.7 this
matches the dominant visual.  Documented as an approximation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..ops import sampling
from ..utils import transforms as T
from ..utils.config import RenderConfig

_f32 = jnp.float32


def voxel_positions(volume: Volume) -> jnp.ndarray:
    """Longest-dimension-centered normalized voxel coords [N, 3]
    (prepareVolumeColors myApp.cu:1302-1304)."""
    d1, d2, d3 = volume.dims
    L = float(volume.longest_dimension)
    x = jax.lax.broadcasted_iota(_f32, (d1, d2, d3), 0)
    y = jax.lax.broadcasted_iota(_f32, (d1, d2, d3), 1)
    z = jax.lax.broadcasted_iota(_f32, (d1, d2, d3), 2)
    dims = volume.dims
    px = ((x + L / 2.0) - dims[0] / 2.0) / L
    py = ((y + L / 2.0) - dims[1] / 2.0) / L
    pz = ((z + L / 2.0) - dims[2] / 2.0) / L
    return jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)


def render_points(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    exact: bool = False,
    rgba: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rasterize the voxel cloud -> [W, H, 4] image.

    ``exact=True`` uses the native C++ rasterizer with the reference's GL
    semantics bit-for-bit (draw-order blending + depth writes); the default
    JAX path approximates with nearest-voxel-wins (see module docstring)
    and runs on device.  ``rgba`` overrides the per-voxel colors [N, 4]
    (the debug colorers in models/debug_colors.py, replacing the
    reference's prepareVolumeColors colorTest switch, myApp.cu:1296-1312).
    """
    if exact:
        return _render_points_exact(volume, tf, camera, config)
    w, h = config.width, config.height
    n_pix = w * h

    pos = voxel_positions(volume)
    vol_flat = volume.data.reshape(-1)
    if rgba is None:
        rgba = tf.classify(
            sampling.div_exact(vol_flat, volume.cal_max))  # [N, 4]

    mvp = (
        T.matmul(T.matmul(T.ortho(-1.0, 1.0, -1.0, 1.0, -1.5, 1.5),
        camera.look_at_origin_view()),
        T.translation((-0.5, -0.5, -0.5)))
    )
    ndc = T.apply(mvp, pos)  # ortho: w stays 1

    px = jnp.floor((ndc[..., 0] + 1.0) * 0.5 * w).astype(jnp.int32)
    py = jnp.floor((ndc[..., 1] + 1.0) * 0.5 * h).astype(jnp.int32)
    z = ndc[..., 2]
    valid = (
        (px >= 0)
        & (px < w)
        & (py >= 0)
        & (py < h)
        & (z >= -1.0)
        & (z <= 1.0)
        & (rgba[..., 3] > 0.0)  # shader discard (3.3.point_shader.fs:6-8)
    )
    # GL window y is up; image y indexes from the top row like the ray caster
    pix = px * h + (h - 1 - py)
    pix = jnp.where(valid, pix, n_pix)  # sentinel bucket for culled voxels

    zmin = jax.ops.segment_min(
        jnp.where(valid, z, jnp.inf), pix, num_segments=n_pix + 1
    )
    is_front = valid & (z == zmin[pix])
    n_vox = pos.shape[0]
    vox_idx = jnp.arange(n_vox, dtype=jnp.int32)
    idx_min = jax.ops.segment_min(
        jnp.where(is_front, vox_idx, n_vox), pix, num_segments=n_pix + 1
    )
    winner = is_front & (vox_idx == idx_min[pix])

    flat_rgba = jax.ops.segment_sum(
        jnp.where(winner[:, None], rgba, 0.0), pix, num_segments=n_pix + 1
    )[:n_pix]
    bg = jnp.asarray(config.background, _f32)
    a = flat_rgba[..., 3:4]
    rgb = bg[:3] * (1.0 - a) + flat_rgba[..., :3] * a
    img = jnp.concatenate([rgb, jnp.ones_like(a)], axis=-1)
    return img.reshape(w, h, 4)


def _render_points_exact(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
) -> jnp.ndarray:
    """Native-rasterizer path: exact GL draw-order blending + depth writes."""
    import numpy as np

    from .. import native

    if not native.available():
        raise RuntimeError(
            "exact point splatting needs the native library "
            "(python -m volumerenderingproject.native.build)"
        )
    pos = voxel_positions(volume)
    vol_flat = (
        volume.data if volume.channels == 1 else volume.data[..., 0]
    ).reshape(-1)
    rgba = tf.classify(sampling.div_exact(vol_flat, volume.cal_max))
    mvp = (
        T.matmul(T.matmul(T.ortho(-1.0, 1.0, -1.0, 1.0, -1.5, 1.5),
        camera.look_at_origin_view()),
        T.translation((-0.5, -0.5, -0.5)))
    )
    ndc = T.apply(mvp, pos)
    img = native.point_rasterize(
        np.asarray(ndc),
        np.asarray(rgba),
        config.width,
        config.height,
        np.asarray(config.background, np.float32),
    )
    return jnp.asarray(img)


def render_points_depth(
    volume: Volume,
    camera: Camera,
    config: RenderConfig,
) -> jnp.ndarray:
    """Depth-buffer visualization of the voxel cloud -> [W, H, 4].

    The counterpart of the reference's z-buffer shader
    (3.3.zbuffershader.fs:1-16: FragColor = vec3(gl_FragCoord.z), i.e. the
    raw window-space depth of whatever wins the depth test; no alpha
    discard).  Window depth for the ortho pipeline is (ndc_z + 1) / 2;
    pixels no voxel covers keep the GL clear depth 1.0.
    """
    w, h = config.width, config.height
    n_pix = w * h

    pos = voxel_positions(volume)
    mvp = (
        T.matmul(T.matmul(T.ortho(-1.0, 1.0, -1.0, 1.0, -1.5, 1.5),
        camera.look_at_origin_view()),
        T.translation((-0.5, -0.5, -0.5)))
    )
    ndc = T.apply(mvp, pos)

    px = jnp.floor((ndc[..., 0] + 1.0) * 0.5 * w).astype(jnp.int32)
    py = jnp.floor((ndc[..., 1] + 1.0) * 0.5 * h).astype(jnp.int32)
    z = ndc[..., 2]
    valid = (
        (px >= 0) & (px < w) & (py >= 0) & (py < h)
        & (z >= -1.0) & (z <= 1.0)
    )
    pix = px * h + (h - 1 - py)
    pix = jnp.where(valid, pix, n_pix)
    zmin = jax.ops.segment_min(
        jnp.where(valid, z, jnp.inf), pix, num_segments=n_pix + 1
    )[:n_pix]
    depth = jnp.where(jnp.isfinite(zmin), (zmin + 1.0) * 0.5, 1.0)
    d = depth[:, None]
    img = jnp.concatenate([d, d, d, jnp.ones_like(d)], axis=-1)
    return img.reshape(w, h, 4)


def render_depth_vrc(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
) -> jnp.ndarray:
    """Ray-cast depth map -> [W, H, 4] grayscale (framework extension: the
    zbuffer idea applied to the volume renderer).  Depth per pixel is the
    opacity-weighted expected sample depth E[t] along the ray, normalized
    by the viewplane distance; fully transparent rays read 1.0."""
    from ..models import raycast
    from ..ops import composite as comp

    origins = raycast.ray_origins(camera, config)
    dirs = raycast.primary_ray_dirs(camera, config)
    ds = jnp.asarray(config.sample_distance, _f32)
    clip = jnp.asarray(config.front_clip, _f32)
    vol_flat = (
        volume.data if volume.channels == 1 else volume.data[..., 0]
    ).reshape(-1)

    from ..ops import sampling

    def step(carry, i):
        c, t = carry  # c = weighted depth sum, t = transmittance
        ti = i * ds + clip
        p = (origins + ti * dirs) + jnp.asarray(0.5, _f32)
        v = sampling.octree_nn_sample(
            vol_flat, volume.dims, volume.octree_depth, p)
        a = tf.classify(
            sampling.div_exact(v, jnp.trunc(volume.cal_max)))[..., 3:4]
        c = c + t * a * ti
        t = t * (1.0 - a)
        return (c, t), None

    steps = jnp.arange(config.samples_per_ray, dtype=_f32)
    shape = (config.width, config.height)
    (c, t), _ = jax.lax.scan(
        step, (jnp.zeros(shape + (1,), _f32), jnp.ones(shape + (1,), _f32)),
        steps)
    vp = jnp.asarray(config.viewplane_distance, _f32)
    depth = jnp.clip((c + t * vp) / vp, 0.0, 1.0)
    return jnp.concatenate(
        [depth, depth, depth, jnp.ones_like(depth)], axis=-1)
