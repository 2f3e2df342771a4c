"""Multi-device rendering with shard_map: ray DP + sample SP + volume slabs.

Design (SURVEY.md §2 parallelism mandate, §5 long-context analog):

  * ``rays`` axis: the pixel grid's x (column) dimension is block-sharded;
    forward needs zero communication (the reference's embarrassingly
    parallel pixel loop, kernel.cu:40-70, mapped onto devices instead of
    CUDA blocks).  Gradients all-reduce over this axis in backward — XLA
    inserts the psum when differentiating through shard_map.
  * ``samples`` axis: the sample (spr) axis is split into contiguous
    segments; each device folds its segment into a (C, T) pair and the
    pairs compose front-to-back with the associative over operator
    (ops/composite.segment_compose) after an all_gather along the axis —
    the renderer's exact analog of blockwise/ring attention.
  * ``volume`` axis: the voxel grid's x extent is block-sharded (volume
    slabs).  Every device marches all its rays' samples but classifies only
    samples landing in its slab (others are the over-identity, alpha = 0).
    Because an orthographic ray's x coordinate is monotone in t, each
    slab's samples form one contiguous run along the ray, so per-slab
    (C, T) pairs compose exactly in slab order — front-to-back order given
    by sign(front.x).  (Conic cameras whose rays disagree on sign(dir.x)
    are not supported on this axis.)

All three compose: mesh ("rays", "samples", "volume").
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, Interp, RenderConfig
from ..models import raycast
from ..ops import composite as comp
from ..ops import gpu_march, sampling

_f32 = jnp.float32


def _fold_segments_front_to_back(segs_c, segs_t, reverse_pred):
    """Fold [K, ...] gathered segments with segment_compose; ``reverse_pred``
    (traced bool) flips the fold order (used for slab visibility order)."""
    k = segs_c.shape[0]
    seg = comp.segment_identity(segs_c.shape[1:-1])

    def body(i, seg):
        idx = jnp.where(reverse_pred, k - 1 - i, i)
        nxt = (
            jax.lax.dynamic_index_in_dim(segs_c, idx, 0, keepdims=False),
            jax.lax.dynamic_index_in_dim(segs_t, idx, 0, keepdims=False),
        )
        return comp.segment_compose(seg, nxt)

    return jax.lax.fori_loop(0, k, body, seg)


def render_vrc_sharded(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    *,
    remat: bool = True,
    light=None,
) -> jnp.ndarray:
    """Distributed a1/VRC render over a ("rays", "samples", "volume") mesh.

    The volume's data is expected replicated unless the mesh's "volume"
    axis is > 1, in which case data is x-slab-sharded by shard_map's
    in_spec.  Returns the full [W, H, 4] image (columns sharded over
    "rays" in the output sharding).

    Each device's work unit on the rays/samples axes runs the fused GPU
    march (ops/gpu_march.render_vrc_segment) when ``gpu_march.eligible``
    holds, and the XLA scan segments otherwise.  Both are differentiable:
    the fused march's backward is the scan segment's VJP, and XLA inserts
    the gradient all-reduce when transposing shard_map.
    """
    n_rays = mesh.shape["rays"]
    n_samp = mesh.shape["samples"]
    n_vol = mesh.shape["volume"]
    if config.width % n_rays:
        raise ValueError(f"width {config.width} % rays axis {n_rays} != 0")
    if config.samples_per_ray % n_samp:
        raise ValueError(
            f"spr {config.samples_per_ray} % samples axis {n_samp} != 0"
        )
    if volume.dims[0] % n_vol:
        raise ValueError(f"dim x {volume.dims[0]} % volume axis {n_vol} != 0")
    if n_vol > 1 and volume.channels > 1 and (
        config.algorithm is not Algorithm.VRC
        or config.interp is not Interp.NEAREST
    ):
        raise NotImplementedError(
            "volume-axis sharding of multi-channel volumes supports the "
            "nearest-neighbor a1 path (the only multi-channel sampler)"
        )
    # conic + volume axis: rays can disagree on sign(dir.x), so the slab
    # fold is evaluated in BOTH orders and selected per ray (see
    # tile_fn's compose block) — x(t) is monotone per ray, so per-slab
    # sample runs stay contiguous and the per-ray order is exact.
    if n_vol > 1 and config.scattering and (
        config.interp is not Interp.NEAREST or volume.channels != 1
    ):
        raise NotImplementedError(
            "volume-sharded scattering is the single-channel a1 NN path "
            "(the sharded light-transmittance sweep, ops/phong."
            "light_transmittance_grid_slab); use rays/samples axes"
        )
    w_local = config.width // n_rays
    s_local = config.samples_per_ray // n_samp
    slab_x = volume.dims[0] // n_vol if n_vol > 1 else None

    use_kernel = (n_vol == 1 and light is None
                  and gpu_march.eligible(volume, config))

    def tile_fn(vol_data, cal_max, tf_, cam, lgt):
        ri = jax.lax.axis_index("rays")
        si = jax.lax.axis_index("samples")
        if n_vol == 1:
            vol_local = Volume(
                data=vol_data,
                cal_max=cal_max,
                cal_min=volume.cal_min,
                pixdim=volume.pixdim,
                dims=volume.dims,
                channels=volume.channels,
            )
            if use_kernel:
                seg = gpu_march.render_vrc_segment(
                    vol_local, tf_, cam, config,
                    x_offset=ri * w_local,
                    local_width=w_local,
                    s_start=si * s_local,
                    s_count=s_local,
                )
            else:
                segment_fn = (
                    raycast.render_test_segment
                    if config.algorithm is Algorithm.TEST
                    else raycast.render_vrc_segment
                )
                seg = segment_fn(
                    vol_local,
                    tf_,
                    cam,
                    config,
                    x_offset=ri * w_local,
                    local_width=w_local,
                    s_start=si * s_local,
                    s_count=s_local,
                    remat=remat,
                    light=lgt,
                )
        else:
            seg = _render_segment_volume_slab(
                vol_data,
                cal_max,
                tf_,
                cam,
                config,
                x_offset=ri * w_local,
                local_width=w_local,
                s_start=si * s_local,
                s_count=s_local,
                dims=volume.dims,
                depth=volume.octree_depth,
                remat=remat,
                light=lgt,
                light_host=light,
            )
        if n_vol > 1:
            # compose slabs in visibility order: front.x >= 0 means rays
            # move toward +x, so slab 0 is nearest the camera.
            segs_c = jax.lax.all_gather(seg[0], "volume")
            segs_t = jax.lax.all_gather(seg[1], "volume")
            if config.conic and config.algorithm is not Algorithm.TEST:
                # conic rays can disagree on sign(dir.x): fold both
                # orders (K compose steps each — cheap) and select per
                # ray.  dir.x == 0 rays live in one slab, so either
                # order is exact for them.  a5 (TEST) is excluded: its
                # march ignores config.conic — every ray steps along the
                # shared camera-front affine (kernel.cu:1177-1222), so
                # the cam.front[0] fold below matches its actual
                # traversal direction even for conic configs.
                ri2 = jax.lax.axis_index("rays")
                dirs = raycast.primary_ray_dirs(
                    cam, config, ri2 * w_local, w_local)
                asc = _fold_segments_front_to_back(
                    segs_c, segs_t, jnp.asarray(False))
                desc = _fold_segments_front_to_back(
                    segs_c, segs_t, jnp.asarray(True))
                neg = (dirs[..., 0] < 0.0)[..., None]
                seg = (jnp.where(neg, desc[0], asc[0]),
                       jnp.where(neg, desc[1], asc[1]))
            else:
                seg = _fold_segments_front_to_back(
                    segs_c, segs_t, reverse_pred=cam.front[0] < 0
                )

        # compose sample segments front-to-back (device si=0 is nearest)
        segs_c = jax.lax.all_gather(seg[0], "samples")
        segs_t = jax.lax.all_gather(seg[1], "samples")
        seg = _fold_segments_front_to_back(
            segs_c, segs_t, reverse_pred=jnp.asarray(False)
        )
        return comp.segment_finalize(seg, jnp.asarray(config.background, _f32))

    vol_spec = P("volume") if n_vol > 1 else P()
    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(vol_spec, P(), P(), P(), P()),
        out_specs=P("rays"),
        check_vma=False,
    )
    return fn(volume.data, volume.cal_max, tf, camera, light)


def _with_x_halo(slab: jnp.ndarray, hw: int, axis_name: str = "volume"
                 ) -> jnp.ndarray:
    """Extend an x-slab with ``hw`` halo planes from each x neighbor via
    ``lax.ppermute`` (SURVEY.md §2 "halo exchange for trilinear/gradient
    taps").  Edge devices receive zeros — matching the renderer's
    out-of-volume semantics (zero-padded gradients, guarded corner taps).

    When the slab is narrower than the halo (tiny test meshes), falls back
    to an all_gather + dynamic window — same result, more communication."""
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        z = jnp.zeros((hw,) + slab.shape[1:], slab.dtype)
        return jnp.concatenate([z, slab, z], axis=0)
    slab_x = slab.shape[0]
    if slab_x < hw:
        full = jax.lax.all_gather(slab, axis_name, tiled=True)
        z = jnp.zeros((hw,) + slab.shape[1:], slab.dtype)
        padded = jnp.concatenate([z, full, z], axis=0)
        vi = jax.lax.axis_index(axis_name)
        return jax.lax.dynamic_slice_in_dim(
            padded, vi * slab_x, slab_x + 2 * hw, axis=0
        )
    # left halo = my left neighbor's last hw planes (unreceived -> zeros)
    left = jax.lax.ppermute(
        slab[-hw:], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    right = jax.lax.ppermute(
        slab[:hw], axis_name, [(i, i - 1) for i in range(1, n)]
    )
    return jnp.concatenate([left, slab, right], axis=0)


def _slab_halo_width(config: RenderConfig) -> int:
    """x-halo width for slab work units: hw = 2 baseline (the
    a5/trilinear flat-wrap corner reach, kernel.cu:130) widened to the
    Gaussian radius + 1 under presmoothing so owned voxels' smoothed
    gradients see the replicated neighborhood."""
    hw = 2
    if config.presmooth_sigma > 0.0:
        hw = max(hw, 1 + max(1, int(3.0 * config.presmooth_sigma + 0.5)))
    return hw


def _slab_gradient_from_ext(ext: jnp.ndarray, config: RenderConfig,
                            hw: int, x0, d1: int) -> jnp.ndarray:
    """Gradient normals [slab+2hw, Y, Z, 3] on a halo-extended x-slab,
    matching the replicated pipeline exactly: under presmoothing the
    smoothed field is zero-masked outside the global [0, d1) x range
    before the gradient pass (the replicated gradient reads the
    smoothed volume ZERO-padded at the boundary; smoothing leaks
    nonzero values into the halo otherwise).  Shared by the XLA slab
    segments and the diff slab segments' (M, S) bake so the two cannot
    drift."""
    from ..ops import conv3d

    if config.presmooth_sigma > 0.0:
        sm = conv3d.gaussian_smooth(ext, config.presmooth_sigma)
        gx = jnp.arange(-hw, ext.shape[0] - hw) + x0
        sm = jnp.where(((gx >= 0) & (gx < d1))[:, None, None], sm, 0.0)
        if config.gradient_filter == "sobel":
            return conv3d.sobel_gradient(sm)
        return conv3d.central_difference_gradient(sm)
    return conv3d.gradient_field(ext, config.gradient_filter, 0.0)


def _render_segment_volume_slab(
    vol_slab: jnp.ndarray,
    cal_max: jnp.ndarray,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    *,
    x_offset,
    local_width: int,
    s_start,
    s_count: int,
    dims: Tuple[int, int, int],
    depth: int,
    remat: bool,
    light=None,
    light_host=None,
):
    """March a ray/sample tile against one x-slab of the volume.

    Samples whose owning voxel lies outside this slab classify as the over
    identity (each sample is owned by exactly one slab, so the composed
    segments equal the replicated render).  Trilinear taps, a5 corner
    fetches, and gradient-normal lighting reach across slab boundaries
    through a one-voxel x-halo exchanged with lax.ppermute."""
    vi = jax.lax.axis_index("volume")
    slab_x = vol_slab.shape[0]
    x0 = vi * slab_x
    slab3d = vol_slab if vol_slab.ndim == 3 else vol_slab[..., 0]
    d1, d2, d3 = dims

    a5 = config.algorithm is Algorithm.TEST
    shade_on = config.lighting or (light is not None
                                   and not config.scattering)
    need_halo = (
        a5 or shade_on or config.interp is not Interp.NEAREST
    )
    hw = _slab_halo_width(config) if shade_on else 2
    ext = _with_x_halo(slab3d, hw) if need_halo else None
    ext_flat = ext.reshape(-1) if need_halo else None

    shading = None
    if shade_on:
        from ..ops import phong

        # gradient on the extended slab: owned voxels see the same
        # neighborhood as the replicated volume (zero halos at the
        # edges match conv3d's zero padding; presmooth masking inside
        # the shared helper)
        grad_ext = _slab_gradient_from_ext(
            ext, config, hw, x0, d1).reshape(-1, 3)
        shading = (grad_ext,
                   light if light is not None else phong.default_light())

    scatter = None
    if config.scattering:
        # single-scattering on a volume slab: the
        # light-transmittance sweep runs SHARDED — per-slab partials
        # stitched with ppermute (ops/phong.light_transmittance_grid_slab
        # — a prefix along the light axis, the renderer's (C, T) trick
        # applied to the light rays); shading then reads the slab-local
        # grid exactly like the replicated path reads the full one.
        from ..ops import phong

        if config.interp is not Interp.NEAREST or vol_slab.ndim == 4:
            raise NotImplementedError(
                "volume-sharded scattering is the single-channel a1 NN "
                "path; use rays/samples axes otherwise")
        lg = light if light is not None else phong.default_light()
        # the sweep's collective pattern is chosen by the light's
        # dominant axis, which must be known at trace time; ``light``
        # arrives traced through shard_map, so the CONCRETE direction is
        # threaded via the closure (``light_host`` — equal by
        # construction; None means the default light)
        dir_host = (light_host.direction if light_host is not None
                    else phong.default_light().direction)
        alpha_g = tf.classify(
            sampling.div_exact(jnp.maximum(slab3d, 0.0),
                               jnp.trunc(cal_max)))[..., 3]
        alpha_g = jnp.clip(
            alpha_g * jnp.asarray(config.density_scale, _f32), 0.0, 1.0)
        tgrid = phong.light_transmittance_grid_slab(
            alpha_g, dir_host, axis_name="volume")
        scatter = (tgrid.reshape(-1), lg)

    origins = raycast.ray_origins(camera, config, x_offset, local_width)
    dirs = raycast.primary_ray_dirs(camera, config, x_offset, local_width)
    ds = jnp.asarray(config.sample_distance, _f32)
    clipf = jnp.asarray(config.front_clip, _f32)
    slab_flat = slab3d.reshape(-1)
    ext_base = (x0 - hw) * (d2 * d3)
    ext_total_rows = slab_x + 2 * hw

    def _ext_index(flat_global, valid):
        """Global flat voxel index -> extended-slab flat index (+validity)."""
        lflat = flat_global - ext_base
        ok = valid & (lflat >= 0) & (lflat < ext_total_rows * d2 * d3)
        return jnp.clip(lflat, 0, ext_total_rows * d2 * d3 - 1), ok

    def _shade(rgba, flat_global, valid, view_dir):
        from ..ops import phong as _phong

        grad_ext, light = shading
        lflat, ok = _ext_index(flat_global, valid)
        normal = jnp.take(grad_ext, lflat, axis=0)
        normal = jnp.where(ok[..., None], normal, 0.0)
        shaded = _phong.phong_shade(rgba[..., :3], normal, view_dir, light)
        return jnp.concatenate([shaded, rgba[..., 3:4]], axis=-1)

    if a5:
        x, y = raycast.pixel_grid(config, x_offset, local_width)

        def sample_rgba(i):
            pos = raycast._a5_positions(x, y, i, camera, _VolDims(dims), config)
            rgba, owned = sampling.trilinear_color_sample_slab(
                ext_flat, dims, pos, tf.classify, cal_max, x0, slab_x, hw
            )
            if shading is not None:
                ijk = jnp.trunc(pos).astype(jnp.int32)
                inside = jnp.all(
                    (pos >= 0.0) & (pos < jnp.asarray(dims, _f32)), axis=-1
                )
                flat = (
                    jnp.clip(ijk[..., 0], 0, d1 - 1) * (d2 * d3)
                    + jnp.clip(ijk[..., 1], 0, d2 - 1) * d3
                    + jnp.clip(ijk[..., 2], 0, d3 - 1)
                )
                rgba = _shade(rgba, flat, inside & owned, -camera.front)
                rgba = jnp.where(owned[..., None], rgba, 0.0)
            return rgba

    else:

        def sample_rgba(i):
            t = i * ds + clipf
            pos = origins + t * dirs
            p = pos + jnp.asarray(0.5, _f32)
            if config.interp is Interp.TRILINEAR:
                vox = raycast._to_volume_space(p, _VolDims(dims))
                v, owned = sampling.trilinear_intensity_sample_slab(
                    ext, dims, vox, x0, slab_x, hw
                )
                rgba = tf.classify_smooth(
                    v / cal_max, config.tf_sharpness
                )
                rgba = jnp.where(owned[..., None], rgba, 0.0)
                flat, valid = sampling.octree_nn_index(dims, depth, p)
            elif config.interp is Interp.TRILINEAR_COLOR:
                vox = raycast._to_volume_space(p, _VolDims(dims))
                rgba, owned = sampling.trilinear_color_sample_slab(
                    ext_flat, dims, vox, tf.classify, cal_max, x0, slab_x, hw
                )
                flat, valid = sampling.octree_nn_index(dims, depth, p)
            elif vol_slab.ndim == 4:
                # multi-channel a1 (raycast._vrc_sample_rgba_multichannel
                # semantics, slab ownership applied once per sample)
                nchan = vol_slab.shape[3]
                chans = vol_slab.reshape(-1, nchan)
                lflat, valid, owned = sampling.octree_nn_index_slab(
                    dims, depth, p, x0, slab_x
                )
                v = jnp.take(chans, lflat, axis=0)
                v = jnp.maximum(v, 0.0)
                v = jnp.where((valid & owned)[..., None], v, 0.0)
                norm = sampling.div_exact(v, cal_max)
                if nchan >= 3:
                    rgb = norm[..., :3]
                else:
                    rgb = jnp.repeat(norm[..., :1], 3, axis=-1)
                mean = jnp.mean(norm, axis=-1)
                alpha = tf.classify(mean)[..., 3:4]
                rgba = jnp.concatenate([rgb, alpha], axis=-1)
                flat, valid = sampling.octree_nn_index(dims, depth, p)
            else:
                v, owned = sampling.octree_nn_sample_slab(
                    slab_flat, dims, depth, p, x0, slab_x
                )
                # int-truncated cal_max: kernel.cu:42 `int max_intensity`
                rgba = tf.classify(
                    sampling.div_exact(v, jnp.trunc(cal_max)))
                flat, valid = sampling.octree_nn_index(dims, depth, p)
            if shading is not None:
                rgba = _shade(rgba, flat, valid & owned, -dirs)
            if scatter is not None:
                # mirror raycast._apply_scattering (classify -> shade ->
                # scatter -> density order), with the slab-local T grid
                from ..ops import phong as _ph

                tl_flat, lg2 = scatter
                lflat_s, valid_s, owned_s = sampling.octree_nn_index_slab(
                    dims, depth, p, x0, slab_x)
                tl = jnp.where(valid_s & owned_s,
                               jnp.take(tl_flat, lflat_s, axis=0), 0.0)
                vn_s = sampling.div_exact(v, jnp.trunc(cal_max))
                gk = jnp.take(tf.hg_g, tf.classify_index(vn_s), axis=0)
                ldir = lg2.direction / jnp.maximum(
                    jnp.linalg.norm(lg2.direction), 1e-8)
                cos_t = jnp.sum(dirs * ldir, axis=-1)
                ph = _ph.henyey_greenstein(cos_t, gk)
                add = (jnp.asarray(config.scattering_strength, _f32)
                       * (ph * tl)[..., None] * lg2.color)
                rgba = jnp.concatenate(
                    [rgba[..., :3] + add, rgba[..., 3:4]], axis=-1)
            if config.density_scale != 1.0:
                a = jnp.clip(
                    rgba[..., 3:4] * jnp.asarray(config.density_scale, _f32),
                    0.0,
                    1.0,
                )
                rgba = jnp.concatenate([rgba[..., :3], a], axis=-1)
            # identity (all-zero rgba) for samples another slab owns
            return jnp.where(owned[..., None], rgba, jnp.zeros_like(rgba))

    return raycast._march(
        sample_rgba,
        config,
        "segment",
        remat,
        shape=(local_width, config.height),
        s_start=s_start,
        s_count=s_count,
    )


class _VolDims:
    """Minimal duck-typed stand-in for Volume where only dims-derived
    geometry is consumed (raycast._to_volume_space / _a5_positions)."""

    def __init__(self, dims: Tuple[int, int, int]):
        self.dims = dims

    @property
    def longest_dimension(self) -> int:
        return max(self.dims)


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "remat"))
def render_vrc_sharded_jit(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    remat: bool = True,
    light=None,
) -> jnp.ndarray:
    return render_vrc_sharded(
        volume, tf, camera, config, mesh, remat=remat, light=light)
