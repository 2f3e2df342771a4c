"""The flagship renderer: differentiable volume ray-casting.

Functional form: ``render(volume, tf, camera, config) -> image [W, H, 4]``,
image indexed ``[pixel_x, pixel_y]`` like the reference's column-major screen
buffer (pixel id = x*SCR_HEIGHT + y, kernel.cu:25,199).

Replicates the two CUDA ray-cast pipelines:

  * VRC / a1 (kernel.cu:40-70 calculateSampleColor + 194-225 blend):
    per sample, world position -> modelAux (+0.5, kernel.cu:1046-1063) ->
    octree nearest-neighbor sample -> /cal_max -> transfer function ->
    back-to-front over-blend seeded at the background.
  * TEST / a5 (kernel.cu:72-187 getColorFromNF): camera-grid positions
    through modelCam -> inverseView -> toVolumeTransform (kernel.cu:1177-1222),
    color-space trilinear sampling, same blend.

Design notes (vs the CUDA 3-kernel + 3.92 GB sample buffer):
  * The march is a ``lax.scan`` over the sample axis — O(W*H) live memory
    instead of the reference's materialized W*H*spr*16B buffer
    (kernel.cu:1036-1043).  ``mode="reference"`` scans back-to-front with the
    reference's exact accumulation order; ``mode="fast"`` scans front-to-back
    in transmittance form (identical math, reordered rounding) and is the
    order the fused GPU march (ops/gpu_march.py) reproduces.
  * Each scan step is vectorized over all rays, with a single flat gather
    into the volume; ray setup is closed-form.
  * ``remat=True`` wraps the per-step sampling in ``jax.checkpoint`` so the
    backward pass recomputes samples instead of storing spr residual planes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils import transforms as T
from ..utils.config import Algorithm, Interp, RenderConfig
from ..ops import composite as comp
from ..ops import gpu_march, sampling

_f32 = jnp.float32


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------


def pixel_grid(
    config: RenderConfig,
    x_offset: jnp.ndarray | int = 0,
    local_width: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pixel index grids X, Y of shape [w_local, H] (float32).

    ``x_offset``/``local_width`` support ray-sharded rendering: a device
    owning columns [x_offset, x_offset + local_width) builds its local grid
    with *global* pixel indices so sample positions are unchanged.
    """
    w = config.width if local_width is None else local_width
    x = jax.lax.broadcasted_iota(_f32, (w, config.height), 0)
    x = x + jnp.asarray(x_offset, _f32)
    y = jax.lax.broadcasted_iota(_f32, (w, config.height), 1)
    return x, y


def primary_ray_dirs(
    camera: Camera,
    config: RenderConfig,
    x_offset: jnp.ndarray | int = 0,
    local_width: int | None = None,
) -> jnp.ndarray:
    """Per-pixel ray directions [w_local, H, 3] (rayDirectionKernel
    kernel.cu:20-38).

    Ortho: cameraFront for every pixel.  Conic: normalize(top_left
    + x*(w/W)*right + y*(h/H)*(-up) - cameraPos); note `+right` and the
    ortho-formula top_left, replicated on purpose (see scene/camera.py).
    """
    w_local = config.width if local_width is None else local_width
    if not config.conic:
        return jnp.broadcast_to(
            camera.front, (w_local, config.height, 3)
        ).astype(_f32)
    xt, yt = _screen_terms(camera, config, x_offset, local_width)
    top_left = camera.top_left
    if config.conic_corrected:
        # the intended conic corner (utils.h:63-65, commented out upstream)
        top_left = top_left + jnp.asarray(
            config.viewplane_distance, _f32
        ) * camera.front
    return T.normalize(top_left + xt + yt - camera.position)


def ray_origins(
    camera: Camera,
    config: RenderConfig,
    x_offset: jnp.ndarray | int = 0,
    local_width: int | None = None,
) -> jnp.ndarray:
    """Per-pixel ray origins [w_local, H, 3].

    Ortho: the pixel's point on the screen plane, built with the CUDA
    kernel's exact add order ``(top_left + xterm) + yterm``
    (kernel.cu:56-58).  Conic: cameraPos (kernel.cu:54).
    """
    w_local = config.width if local_width is None else local_width
    if config.conic:
        return jnp.broadcast_to(
            camera.position, (w_local, config.height, 3)
        ).astype(_f32)
    xt, yt = _screen_terms(camera, config, x_offset, local_width)
    return (camera.top_left + xt) + yt


def _screen_terms(camera, config, x_offset, local_width):
    """The pixel's offsets along the screen, ``(x*w/W)*right`` and
    ``(y*h/H)*(-up)`` (kernel.cu:56-58), with the divisions rounded as the
    reference's are on every backend (ops/sampling.div_exact)."""
    x, y = pixel_grid(config, x_offset, local_width)
    w = jnp.asarray(config.real_screen_width, _f32)
    h = jnp.asarray(config.real_screen_height, _f32)
    xt = sampling.div_exact(x * w, config.width)[..., None] * camera.right
    yt = sampling.div_exact(y * h, config.height)[..., None] * (-camera.up)
    return xt, yt


# ---------------------------------------------------------------------------
# Per-sample color functions
# ---------------------------------------------------------------------------


def _vrc_sample_rgba(
    positions: jnp.ndarray,
    volume: Volume,
    tf: TransferFunction,
    config: RenderConfig,
    shading=None,
    lut=None,
    scatter=None,
) -> jnp.ndarray:
    """a1 per-sample classify: modelAux(+0.5) -> octree NN -> TF [-> Phong].

    ``shading``, when set, is a (grad_flat [X*Y*Z, 3], light, view_dir)
    triple: the sample's density gradient becomes the Phong normal
    (the working upgrade of the reference's LightInteraction stub, C16).
    ``lut``, when set, is a precompiled [N, 4] dense TF table used instead
    of the interval scan (config.tf_lut).
    ``scatter``, when set, is a (tl_flat [X*Y*Z], light, ray_dirs) triple
    for single-scattering (config.scattering): adds HG-phase-weighted
    in-scattered light, see :func:`_apply_scattering`.
    """
    p = positions + jnp.asarray(0.5, _f32)  # modelAux kernel.cu:1050
    if volume.channels > 1:
        rgba = _vrc_sample_rgba_multichannel(p, volume, tf, config)
        flat = valid = None
    else:
        vol_flat = volume.data.reshape(-1)
        if config.interp is Interp.TRILINEAR:
            # smooth differentiable extension: trilinear intensities +
            # smooth TF
            vox = _to_volume_space(p, volume)
            v = sampling.trilinear_intensity_sample(volume.data, vox)
            rgba = tf.classify_smooth(v / volume.cal_max, config.tf_sharpness)
            flat = valid = None
        elif config.interp is Interp.TRILINEAR_COLOR:
            # a5-style color-space trilinear sampling on the a1 ray grid
            vox = _to_volume_space(p, volume)
            rgba = sampling.trilinear_color_sample(
                vol_flat, volume.dims, vox, tf.classify, volume.cal_max
            )
            flat = valid = None
        else:
            flat, valid = sampling.octree_nn_index(
                volume.dims, volume.octree_depth, p
            )
            v = jnp.maximum(jnp.take(vol_flat, flat, axis=0), 0.0)
            v = jnp.where(valid, v, jnp.asarray(0.0, _f32))
            # the a1 kernel receives cal_max as an *int* parameter
            # (kernel.cu:42 `int max_intensity`, truncating the header
            # double) while the a5 path uses the float header value
            v_norm = sampling.div_exact(v, jnp.trunc(volume.cal_max))
            if lut is not None:
                n = lut.shape[0]
                idx = jnp.clip(
                    jnp.round(v_norm * (n - 1)).astype(jnp.int32), 0, n - 1
                )
                rgba = jnp.take(lut, idx, axis=0)
            else:
                rgba = tf.classify(v_norm)

    if shading is not None:
        from ..ops import phong

        grad_flat, light, view_dir = shading
        if flat is None:
            flat, valid = sampling.octree_nn_index(
                volume.dims, volume.octree_depth, p
            )
        normal = jnp.take(grad_flat, flat, axis=0)
        normal = jnp.where(valid[..., None], normal, 0.0)
        shaded = phong.phong_shade(rgba[..., :3], normal, view_dir, light)
        rgba = jnp.concatenate([shaded, rgba[..., 3:4]], axis=-1)

    if scatter is not None:
        if flat is None:
            flat, valid = sampling.octree_nn_index(
                volume.dims, volume.octree_depth, p
            )
        vol_flat = volume.data.reshape(-1)
        v = jnp.maximum(jnp.take(vol_flat, flat, axis=0), 0.0)
        v = jnp.where(valid, v, jnp.asarray(0.0, _f32))
        rgba = _apply_scattering(
            rgba, tf, config, scatter, flat, valid,
            sampling.div_exact(v, jnp.trunc(volume.cal_max)))

    if config.density_scale != 1.0:
        a = rgba[..., 3:4] * jnp.asarray(config.density_scale, _f32)
        rgba = jnp.concatenate([rgba[..., :3], jnp.clip(a, 0.0, 1.0)], axis=-1)
    return rgba


def _apply_scattering(rgba, tf, config, scatter, flat, valid, v_norm):
    """Add single-scattered radiance to sample colors (config.scattering).

    Per sample: ``rgb += strength * p_HG(cos t; g_material) * T_light(v) *
    light.color`` — the working realization of the reference's stubbed
    ``inscattering``/``scattering_probability`` (LightInteraction.h:10-35)
    with the per-material HG g finally consumed by a render path
    (Material.h:14-23 stores it but nothing reads it upstream).
    ``T_light`` is the per-voxel light transmittance
    (ops/phong.light_transmittance_grid); ``cos t`` is between the photon's
    incoming propagation (-light_dir) and the outgoing direction toward the
    camera (-ray_dir), which equals dot(ray_dir, light_dir)."""
    from ..ops import phong

    tl_flat, light, ray_dirs = scatter
    tl = jnp.where(valid, jnp.take(tl_flat, flat, axis=0), 0.0)
    gk = jnp.take(tf.hg_g, tf.classify_index(v_norm), axis=0)
    ldir = light.direction / jnp.maximum(
        jnp.linalg.norm(light.direction), 1e-8)
    cos_t = jnp.sum(ray_dirs * ldir, axis=-1)
    ph = phong.henyey_greenstein(cos_t, gk)
    add = (
        jnp.asarray(config.scattering_strength, _f32)
        * (ph * tl)[..., None]
        * light.color
    )
    return jnp.concatenate([rgba[..., :3] + add, rgba[..., 3:4]], axis=-1)


def _make_scatter(volume, tf, config, light, ray_dirs):
    """Build the per-call scattering inputs: the light-transmittance grid
    (flattened) + light + unit ray directions.  Single-channel only (the
    multichannel sampler has no per-voxel material)."""
    from ..ops import phong

    if volume.channels != 1:
        raise NotImplementedError(
            "config.scattering supports single-channel volumes")
    if light is None:
        light = phong.default_light()
    alpha = tf.classify(sampling.div_exact(
        jnp.maximum(volume.data, 0.0), jnp.trunc(volume.cal_max)))[..., 3]
    alpha = jnp.clip(alpha * jnp.asarray(config.density_scale, _f32), 0.0, 1.0)
    tgrid = phong.light_transmittance_grid(alpha, light.direction)
    return (tgrid.reshape(-1), light, ray_dirs)


def _vrc_sample_rgba_multichannel(
    p: jnp.ndarray,
    volume: Volume,
    tf: TransferFunction,
    config: RenderConfig,
) -> jnp.ndarray:
    """4-D multi-channel sampling (the RGB16_4D-style datasets named in
    BASELINE.json; the reference has no 4-D render path — semantics defined
    here): sample every channel at the a1 voxel, take RGB directly from the
    first three channels (scaled by cal_max; single surplus channels
    broadcast to gray), and take alpha from the transfer function evaluated
    on the channel mean — so TF editing still controls opacity."""
    c = volume.channels
    flat, valid = sampling.octree_nn_index(
        volume.dims, volume.octree_depth, p
    )
    chans = volume.data.reshape(-1, c)
    v = jnp.take(chans, flat, axis=0)  # [..., C]
    v = jnp.maximum(v, 0.0)
    v = jnp.where(valid[..., None], v, 0.0)
    norm = sampling.div_exact(v, volume.cal_max)
    if c >= 3:
        rgb = norm[..., :3]
    else:
        rgb = jnp.repeat(norm[..., :1], 3, axis=-1)
    mean = jnp.mean(norm, axis=-1)
    alpha = tf.classify(mean)[..., 3:4]
    # density_scale is applied by the shared block in _vrc_sample_rgba
    return jnp.concatenate([rgb, alpha], axis=-1)


def _to_volume_space(p: jnp.ndarray, volume: Volume) -> jnp.ndarray:
    """NiftiFile::toVolumeSpace (BinaryLoader.cu:247-269) minus the +0.5
    (callers pass post-modelAux points): scale by L, center the dataset."""
    L = jnp.asarray(float(volume.longest_dimension), _f32)
    dimv = jnp.asarray(volume.dims, _f32)
    return p * L + (dimv / 2.0 - L / 2.0)


def _a5_positions(
    x: jnp.ndarray, y: jnp.ndarray, i: jnp.ndarray, camera: Camera,
    volume: Volume, config: RenderConfig
) -> jnp.ndarray:
    """a5 sample positions in voxel space, applying the three stage matrices
    sequentially like the kernel (kernel.cu:100-115)."""
    model_cam = T.scale(
        T.translate(
            T.identity(),
            (-config.real_screen_width / 2.0, -config.real_screen_height / 2.0, 0.0),
        ),
        (
            config.real_screen_width / config.width,
            config.real_screen_height / config.height,
            -config.viewplane_distance / config.samples_per_ray,
        ),
    )  # kernel.cu:1177-1192
    inverse_view = T.inverse(camera.look_at_origin_view())  # kernel.cu:1197-1198
    L = float(volume.longest_dimension)
    to_volume = T.matmul(
        T.matmul(
            T.translation(
                (
                    volume.dims[0] / 2.0 - L / 2.0,
                    volume.dims[1] / 2.0 - L / 2.0,
                    volume.dims[2] / 2.0 - L / 2.0,
                )
            ),
            T.scaling((L, L, L)),
        ),
        T.translation((0.5, 0.5, 0.5)),
    )  # kernel.cu:1203-1217

    grid = jnp.stack(
        [x, y, jnp.broadcast_to(i, x.shape).astype(_f32)], axis=-1
    )
    pos = T.apply(model_cam, grid)
    pos = T.apply(inverse_view, pos)
    pos = T.apply(to_volume, pos)
    return pos


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------


def _march(
    sample_rgba_fn,
    config: RenderConfig,
    mode: str,
    remat: bool,
    shape: Tuple[int, int] | None = None,
    s_start: jnp.ndarray | int = 0,
    s_count: int | None = None,
) -> jnp.ndarray:
    """Scan the sample axis; ``sample_rgba_fn(i_f32) -> [*shape, 4]``.

    ``mode="segment"`` marches only samples [s_start, s_start + s_count)
    front-to-back and returns the raw (C, T) pair — the associative unit for
    sample-axis sharding (ops/composite.py segment_compose).
    """
    shape = shape or (config.width, config.height)
    spr = config.samples_per_ray if s_count is None else s_count
    bg = jnp.asarray(config.background, _f32)
    if remat:
        sample_rgba_fn = jax.checkpoint(sample_rgba_fn)
    steps = jnp.arange(spr, dtype=_f32) + jnp.asarray(s_start, _f32)

    if mode == "reference":
        acc0 = jnp.broadcast_to(bg[:3], shape + (3,))

        def step(acc, i):
            return comp.over_step_btf(acc, sample_rgba_fn(i)), None

        acc, _ = jax.lax.scan(step, acc0, steps, reverse=True)
        alpha = jnp.ones(acc.shape[:-1] + (1,), _f32)
        return jnp.concatenate([acc, alpha], axis=-1)

    if mode in ("fast", "segment"):
        seg0 = comp.segment_identity(shape)

        def step(seg, i):
            return comp.segment_update(seg, sample_rgba_fn(i)), None

        seg, _ = jax.lax.scan(step, seg0, steps)
        if mode == "segment":
            return seg
        return comp.segment_finalize(seg, bg)

    raise ValueError(f"unknown mode {mode!r}")


def render_vrc(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    mode: str = "fast",
    remat: bool = True,
    light=None,
) -> jnp.ndarray:
    """a1/VRC render -> [W, H, 4] (alpha all 1).

    With ``config.lighting`` (or an explicit ``light``), samples are
    Phong-shaded using central-difference density-gradient normals
    (BASELINE.json config 2; no working reference counterpart — C16 is a
    stub).  The gradient field is computed once per call, outside the march.
    """
    origins = ray_origins(camera, config)
    dirs = primary_ray_dirs(camera, config)
    ds = jnp.asarray(config.sample_distance, _f32)
    clip = jnp.asarray(config.front_clip, _f32)

    shading = None
    if config.lighting or (light is not None and not config.scattering):
        from ..ops import conv3d, phong

        if light is None:
            light = phong.default_light()
        data = volume.data if volume.channels == 1 else volume.data[..., 0]
        grad = conv3d.gradient_field(
            data, config.gradient_filter, config.presmooth_sigma)
        shading = (grad.reshape(-1, 3), light, -dirs)
    lut = tf.to_lut(config.tf_lut) if config.tf_lut else None
    scatter = (
        _make_scatter(volume, tf, config, light, dirs)
        if config.scattering else None
    )

    def sample_rgba(i):
        t = i * ds + clip  # kernel.cu:54,59
        pos = origins + t * dirs
        return _vrc_sample_rgba(pos, volume, tf, config, shading, lut,
                                scatter)

    return _march(sample_rgba, config, mode, remat)


def render_vrc_segment(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    x_offset: jnp.ndarray | int = 0,
    local_width: int | None = None,
    s_start: jnp.ndarray | int = 0,
    s_count: int | None = None,
    remat: bool = True,
    light=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shardable a1 work unit: columns [x_offset, x_offset+local_width) x
    samples [s_start, s_start+s_count) -> front-to-back (C, T) segment.

    Used by parallel/render_dist.py under shard_map: the rays axis needs no
    communication; sample-axis segments compose with
    ops/composite.segment_compose (the over operator is associative in
    (C, T) form — SURVEY.md §5 long-context analog).  ``light`` overrides
    the default light (sharded light-parameter fits, diff/fit.py).
    """
    w_local = config.width if local_width is None else local_width
    origins = ray_origins(camera, config, x_offset, w_local)
    dirs = primary_ray_dirs(camera, config, x_offset, w_local)
    ds = jnp.asarray(config.sample_distance, _f32)
    clip = jnp.asarray(config.front_clip, _f32)

    shading = None
    if config.lighting or (light is not None and not config.scattering):
        from ..ops import conv3d, phong

        if light is None:
            light = phong.default_light()
        data = volume.data if volume.channels == 1 else volume.data[..., 0]
        grad = conv3d.gradient_field(
            data, config.gradient_filter, config.presmooth_sigma)
        shading = (grad.reshape(-1, 3), light, -dirs)
    lut = tf.to_lut(config.tf_lut) if config.tf_lut else None
    scatter = (
        _make_scatter(volume, tf, config, light, dirs)
        if config.scattering else None
    )

    def sample_rgba(i):
        t = i * ds + clip
        pos = origins + t * dirs
        return _vrc_sample_rgba(pos, volume, tf, config, shading, lut,
                                scatter)

    return _march(
        sample_rgba,
        config,
        "segment",
        remat,
        shape=(w_local, config.height),
        s_start=s_start,
        s_count=s_count,
    )


def render_test(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    mode: str = "fast",
    remat: bool = True,
    light=None,
) -> jnp.ndarray:
    """a5/TEST render -> [W, H, 4].

    ``config.lighting`` Phong-shades samples like the a1 path (BASELINE
    config 2 names lighting for both a1/a5 modes); normals are the
    density gradient at the sample's containing voxel, the view direction
    is the camera front (the a5 grid marches along it, kernel.cu:1190).
    """
    x, y = pixel_grid(config)
    sample_rgba = _a5_sample_fn(volume, tf, camera, config, x, y, light)
    return _march(sample_rgba, config, mode, remat)


def _a5_sample_fn(volume, tf, camera, config, x, y, light):
    """Build the a5 per-step sampler (shared by full and segment renders)."""
    vol_flat = volume.data.reshape(-1)
    lit = config.lighting or (light is not None and not config.scattering)
    if lit:
        from ..ops import conv3d, phong

        if light is None:
            light = phong.default_light()
        data = volume.data if volume.channels == 1 else volume.data[..., 0]
        grad_flat = conv3d.gradient_field(
            data, config.gradient_filter, config.presmooth_sigma
        ).reshape(-1, 3)
        view_dir = -camera.front
    # a5 marches along camera.front for every ray (kernel.cu:1190)
    scatter = (
        _make_scatter(volume, tf, config, light, camera.front)
        if config.scattering else None
    )

    def sample_rgba(i):
        pos = _a5_positions(x, y, i, camera, volume, config)
        rgba = sampling.trilinear_color_sample(
            vol_flat, volume.dims, pos, tf.classify, volume.cal_max
        )
        if not lit and scatter is None:
            return rgba

        d1, d2, d3 = volume.dims
        dimv = jnp.asarray(volume.dims, _f32)
        inside = jnp.all((pos >= 0.0) & (pos < dimv), axis=-1)
        ijk = jnp.trunc(pos).astype(jnp.int32)
        flat = (
            jnp.clip(ijk[..., 0], 0, d1 - 1) * (d2 * d3)
            + jnp.clip(ijk[..., 1], 0, d2 - 1) * d3
            + jnp.clip(ijk[..., 2], 0, d3 - 1)
        )
        if lit:
            from ..ops import phong as _phong

            normal = jnp.take(grad_flat, flat, axis=0)
            normal = jnp.where(inside[..., None], normal, 0.0)
            shaded = _phong.phong_shade(
                rgba[..., :3], normal, view_dir, light)
            rgba = jnp.concatenate([shaded, rgba[..., 3:4]], axis=-1)
        if scatter is not None:
            v = jnp.maximum(jnp.take(vol_flat, flat, axis=0), 0.0)
            v = jnp.where(inside, v, 0.0)
            rgba = _apply_scattering(
                rgba, tf, config, scatter, flat, inside,
                sampling.div_exact(v, volume.cal_max))
        return rgba

    return sample_rgba


def render_test_segment(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    x_offset: jnp.ndarray | int = 0,
    local_width: int | None = None,
    s_start: jnp.ndarray | int = 0,
    s_count: int | None = None,
    remat: bool = True,
    light=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shardable a5 work unit (cf. render_vrc_segment): columns x samples
    tile -> (C, T) segment.  The a5 grid is indexed by global pixel
    coordinates, so the local grid carries the x offset."""
    w_local = config.width if local_width is None else local_width
    x, y = pixel_grid(config, x_offset, w_local)
    sample_rgba = _a5_sample_fn(volume, tf, camera, config, x, y, light)
    return _march(
        sample_rgba,
        config,
        "segment",
        remat,
        shape=(w_local, config.height),
        s_start=s_start,
        s_count=s_count,
    )


def render(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    mode: str = "fast",
    remat: bool = True,
) -> jnp.ndarray:
    """Dispatch on config.algorithm (renderLoop myApp.cu:875-1056).

    On a GPU backend, unlit single-channel a1/VRC renders in ``"fast"``
    mode run the fused march (ops/gpu_march.py, predicate
    ``gpu_march.eligible``); ``config.early_termination`` sets its
    epsilon (0 = equal to the scan up to float rounding).  Everything else
    runs the XLA scan.  ``mode="xla"`` always runs the XLA scan
    (otherwise identical to ``"fast"``).
    """
    if config.algorithm is Algorithm.POINT:
        from . import point_splat

        return point_splat.render_points(volume, tf, camera, config)
    if mode == "xla":
        mode = "fast"
    elif gpu_march.eligible(volume, config, mode=mode):
        return gpu_march.render_vrc(volume, tf, camera, config)
    if config.algorithm is Algorithm.TEST:
        return render_test(volume, tf, camera, config, mode=mode, remat=remat)
    return render_vrc(volume, tf, camera, config, mode=mode, remat=remat)


@functools.partial(jax.jit, static_argnames=("config", "mode", "remat"))
def render_jit(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    mode: str = "fast",
    remat: bool = True,
) -> jnp.ndarray:
    return render(volume, tf, camera, config, mode=mode, remat=remat)
