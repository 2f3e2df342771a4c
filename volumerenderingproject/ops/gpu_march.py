"""Fused a1/VRC ray march for NVIDIA GPUs (Pallas, Triton route).

One kernel does what the reference splits into three (ray setup ->
per-sample classify -> composite, kernel.cu:20-225): each program takes a
block of ``block_rays`` rays and marches them front to back in registers,
so no W*H*spr sample buffer and no (C, T) carry round trip through device
memory per sample.  The XLA ``lax.scan`` march (models/raycast._march)
reads and writes the whole carry once per sample and never skips work.

Layout.  The volume stays f32 and flat in device memory.  It is
normalized once per call in XLA (``max(v, 0) / trunc(cal_max)`` through
ops/sampling.div_exact, the a1 value semantics of
models/raycast._vrc_sample_rgba), so the kernel holds no division; each
sample gathers one voxel.  Brain volumes at template scale (3.6 MB avg152, 28.9 MB MNI-1mm)
sit in the H100's 50 MB L2.  Ray origins and directions come from
models/raycast.ray_origins / primary_ray_dirs, so ortho and conic rays
are the XLA path's rays bit for bit.

Work skipping, all exact (a skipped sample provably has alpha = 0):

  * Box clip: each block intersects its rays with the dataset box and
    marches only the chunks between the first entry and the last exit.
  * Occupancy: an 8^3-brick bitmap of "some voxel has alpha > 0 under
    this TF", dilated by one brick and built in XLA per call.  A chunk of
    ``S`` samples spans less than one brick per axis (``S`` is chosen so),
    so one lookup at each ray's chunk midpoint bounds all its samples; a
    chunk no live ray needs is skipped by the whole block.
  * Early termination: a ray whose transmittance is <= ``eps``
    (``config.early_termination``) takes no more samples, and the block
    exits once every ray has.  The error is bounded by eps * max colour;
    eps = 0 only drops rays with T == 0 exactly.

When TF(0).alpha > 0, out-of-volume samples are visible, so the box clip
and the occupancy skip turn themselves off (the ``alpha0`` guard).

The float operations mirror models/raycast + ops/sampling expression by
expression, and classification is interval compares or a LUT gather (no
matrix product, so TF32 cannot enter), so eps = 0 matches
``render(mode="xla")``.  The gradient is the XLA scan's: a
``jax.custom_vjp`` whose backward is the VJP of
``raycast.render_vrc_segment``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, Interp, RenderConfig
from . import sampling

_f32 = jnp.float32
_i32 = jnp.int32

BRICK = 8  # occupancy brick edge (voxels)
# rays per program and warps per program, swept on an H100 at 700^2 x 500
# spr (PERF.md)
BLOCK_RAYS = 128
NUM_WARPS = 4


def eligible(volume: Volume, config: RenderConfig, *, mode: str = "fast",
             light=None) -> bool:
    """True when the fused GPU march implements this render exactly: a1
    nearest-neighbour sampling of a single-channel volume, unlit, in the
    front-to-back ("fast") order, on a GPU backend.  Everything else runs
    the XLA scan."""
    return (
        jax.default_backend() == "gpu"
        and mode == "fast"
        and config.algorithm is Algorithm.VRC
        and volume.channels == 1
        and config.interp is Interp.NEAREST
        and not config.lighting
        and not config.scattering
        and light is None
    )


def chunk_samples(config: RenderConfig, dims: Tuple[int, int, int]) -> int:
    """Samples per chunk: the largest power of two <= 16 for which every
    sample's voxel lies within one brick of the chunk midpoint on each axis
    (half the chunk's span, plus < 2 voxels of index snap, under 8) — the
    condition that makes the dilated-occupancy midpoint test conservative."""
    span = config.sample_distance * max(dims)  # voxels per sample, at most
    s = 16
    while s > 1 and (s - 1) * span > 2 * (BRICK - 2.5):
        s //= 2
    return s


def _voxel_alpha(vn: jnp.ndarray, tf: TransferFunction, config: RenderConfig,
                 lut: jnp.ndarray | None) -> jnp.ndarray:
    """Per-value alpha exactly as the a1 classify gives it (last matching
    interval, interval 0 when none matches; or the LUT entry), times the
    density scale."""
    if lut is not None:
        n = lut.shape[0]
        idx = jnp.clip(jnp.round(vn * (n - 1)).astype(_i32), 0, n - 1)
        a = jnp.take(lut[:, 3], idx, axis=0)
    else:
        a = jnp.broadcast_to(tf.colors[0, 3], vn.shape)
        for k in range(tf.num_intervals):
            m = (vn >= tf.lower[k]) & (vn <= tf.upper[k])
            a = jnp.where(m, tf.colors[k, 3], a)
    if config.density_scale != 1.0:
        a = jnp.clip(a * jnp.asarray(config.density_scale, _f32), 0.0, 1.0)
    return a


def brick_occupancy(vn: jnp.ndarray, alpha_fn) -> jnp.ndarray:
    """Dilated brick occupancy, [nbx+2, nby+2, nbz+2] i32.

    Entry (bx+1, by+1, bz+1) is 1 when any voxel of bricks bx-1..bx+1 x
    by-1..by+1 x bz-1..bz+1 has alpha > 0; the one-brick border covers
    points just outside the grid."""
    occ = (alpha_fn(vn) > 0.0).astype(_i32)
    pads = [(0, -(-d // BRICK) * BRICK - d) for d in vn.shape]
    occ = jnp.pad(occ, pads)
    nb = tuple(-(-d // BRICK) for d in vn.shape)
    occ = occ.reshape(nb[0], BRICK, nb[1], BRICK, nb[2], BRICK).max((1, 3, 5))
    occ = jnp.pad(occ, 1)
    return jax.lax.reduce_window(occ, 0, jax.lax.max, (3, 3, 3), (1, 1, 1),
                                 "SAME")


def prepare(volume: Volume, tf: TransferFunction, config: RenderConfig,
            lut: jnp.ndarray | None = None):
    """The per-call XLA pass before the kernel -> (normalized volume,
    dilated brick occupancy, TF(0) alpha)."""
    vn = sampling.div_exact(jnp.maximum(volume.data, 0.0),
                            jnp.trunc(volume.cal_max))
    occ = brick_occupancy(vn, lambda v: _voxel_alpha(v, tf, config, lut))
    alpha0 = _voxel_alpha(jnp.zeros((), _f32), tf, config, lut)
    return vn, occ, alpha0


def _round_half_even(x):
    """jnp.round for 0 <= x < 2**22 (exact there), in ops Triton lowers."""
    r = jnp.floor(x + 0.5)
    tie = (r - x) == 0.5
    odd = (r - 2.0 * jnp.floor(r * 0.5)) == 1.0
    return jnp.where(tie & odd, r - 1.0, r)


def _march_kernel(dyn_ref, tfp_ref, occ_ref, vol_ref, lut_ref,
                  ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                  cr_ref, cg_ref, cb_ref, t_ref, *,
                  dims, depth, num_intervals, lut_n, nb, n_rays, block_rays,
                  steps, s_count, ds, clip, eps, density_scale, skip):
    d1, d2, d3 = dims
    L = np.float32(max(dims))
    n = np.float32(2 ** depth)
    inv_n = np.float32(1.0 / 2 ** depth)  # exact: a power of two
    hg = [np.float32(L / 2) - np.float32(d / 2) for d in dims]
    hg_hi = [np.float32(hg[c] + np.float32(dims[c])) for c in range(3)]
    halfd = [np.float32(d / 2) for d in dims]
    halfL = np.float32(L / 2)
    ds = np.float32(ds)
    clip = np.float32(clip)
    eps = np.float32(max(eps, 0.0))
    nchunks = -(-s_count // steps)
    ntot = d1 * d2 * d3

    alpha0_pos = dyn_ref[0] > 0.0
    s_start = dyn_ref[1].astype(_i32)
    K = num_intervals
    lower = [tfp_ref[k] for k in range(K)]
    upper = [tfp_ref[K + k] for k in range(K)]
    colors = [[tfp_ref[2 * K + 4 * k + c] for c in range(4)]
              for k in range(K)]

    ray = pl.program_id(0) * block_rays + jax.lax.iota(_i32, block_rays)
    live = ray < n_rays
    o = [ox_ref[...], oy_ref[...], oz_ref[...]]
    d = [dx_ref[...], dy_ref[...], dz_ref[...]]
    zeros = jnp.zeros((block_rays,), _f32)

    # ---- block sample range from the rays' dataset-box intersections ----
    # (conservative by one sample on each side; the box is in pos space)
    big = np.float32(1e30)
    t_lo = jnp.full((block_rays,), -big, _f32)
    t_hi = jnp.full((block_rays,), big, _f32)
    for c in range(3):
        lo_c = np.float32(max(0.0, hg[c] / L) - 0.5)
        hi_c = np.float32(min(1.0, hg_hi[c] / L + 1.0 / n) - 0.5)
        safe = jnp.abs(d[c]) > 1e-12
        dv = jnp.where(safe, d[c], 1.0)
        ta = (lo_c - o[c]) / dv
        tb = (hi_c - o[c]) / dv
        inside = (o[c] >= lo_c) & (o[c] <= hi_c)
        t_lo = jnp.maximum(t_lo, jnp.where(
            safe, jnp.minimum(ta, tb), jnp.where(inside, -big, big)))
        t_hi = jnp.minimum(t_hi, jnp.where(
            safe, jnp.maximum(ta, tb), jnp.where(inside, big, -big)))
    hit = live & (t_hi >= t_lo)
    t_enter = jnp.min(jnp.where(hit, t_lo, big))
    t_exit = jnp.max(jnp.where(hit, t_hi, -big))
    lim = np.float32(s_count + steps)
    s_start_f = s_start.astype(_f32)
    i_lo = jnp.clip(jnp.floor((t_enter - clip) / ds) - 1.0 - s_start_f,
                    0.0, lim).astype(_i32)
    i_hi = jnp.clip(jnp.ceil((t_exit - clip) / ds) + 1.0 - s_start_f,
                    -1.0, lim).astype(_i32)
    chunk_lo = jnp.where(alpha0_pos, 0, jnp.minimum(i_lo // steps, nchunks))
    chunk_hi = jnp.where(alpha0_pos, nchunks,
                         jnp.clip(i_hi // steps + 1, 0, nchunks))

    def classify(v):
        if lut_n:
            idx = jnp.clip(_round_half_even(v * np.float32(lut_n - 1)),
                           0.0, np.float32(lut_n - 1)).astype(_i32)
            rgba = [plgpu.load(lut_ref.at[idx * 4 + c]) for c in range(4)]
        else:
            rgba = [jnp.full((block_rays,), colors[0][c], _f32)
                    for c in range(4)]
            for k in range(K):
                m = (v >= lower[k]) & (v <= upper[k])
                rgba = [jnp.where(m, colors[k][c], rgba[c]) for c in range(4)]
        if density_scale != 1.0:
            rgba[3] = jnp.clip(rgba[3] * np.float32(density_scale), 0.0, 1.0)
        return rgba

    def march_chunk(ci, cr, cg, cb, t):
        for k in range(steps):
            i_loc = ci * steps + k
            active = live & (t > eps)
            if s_count % steps:
                active = active & (i_loc < s_count)
            # the a1 sample chain of models/raycast + ops/sampling
            i_f = (s_start + i_loc).astype(_f32)
            ti = i_f * ds + clip
            p = [(o[c] + ti * d[c]) + np.float32(0.5) for c in range(3)]
            valid = active
            res = []
            for c in range(3):
                valid = valid & (p[c] >= 0.0) & (p[c] < 1.0)
                r = (jnp.floor(p[c] * n) * inv_n) * L
                valid = valid & (r >= hg[c]) & (r < hg_hi[c])
                res.append(r)
            ijk = [((res[c] + halfd[c]) - halfL).astype(_i32)
                   for c in range(3)]
            flat = jnp.clip(ijk[0] * (d2 * d3) + ijk[1] * d3 + ijk[2],
                            0, ntot - 1)
            v = plgpu.load(vol_ref.at[flat], mask=valid, other=0.0)
            r_, g_, b_, a_ = classify(v)
            ta = t * a_
            cr = jnp.where(active, cr + ta * r_, cr)
            cg = jnp.where(active, cg + ta * g_, cg)
            cb = jnp.where(active, cb + ta * b_, cb)
            t = jnp.where(active, t * (1.0 - a_), t)
        return cr, cg, cb, t

    def chunk_needed(ci, t):
        """Some live ray's chunk midpoint lies in a dilated occupied brick."""
        i_mid = (s_start + ci * steps).astype(_f32) + np.float32(
            (steps - 1) / 2)
        tm = i_mid * ds + clip
        b = []
        for c in range(3):
            q = ((o[c] + tm * d[c]) + np.float32(0.5)) * L + (halfd[c] - halfL)
            bc = jnp.clip(jnp.floor(q * np.float32(1.0 / BRICK)), -1.0,
                          np.float32(nb[c] - 2)).astype(_i32) + 1
            b.append(bc)
        idx = (b[0] * nb[1] + b[1]) * nb[2] + b[2]
        need = live & (t > eps)
        occ = plgpu.load(occ_ref.at[idx], mask=need, other=0)
        return jnp.max(occ) > 0

    def cond(carry):
        ci, _, _, _, t = carry
        return (ci < chunk_hi) & (jnp.max(jnp.where(live, t, 0.0)) > eps)

    def body(carry):
        ci, cr, cg, cb, t = carry
        if skip:
            work = alpha0_pos | chunk_needed(ci, t)
            cr, cg, cb, t = jax.lax.cond(
                work, lambda: march_chunk(ci, cr, cg, cb, t),
                lambda: (cr, cg, cb, t))
        else:
            cr, cg, cb, t = march_chunk(ci, cr, cg, cb, t)
        return ci + 1, cr, cg, cb, t

    carry = (chunk_lo, zeros, zeros, zeros, zeros + 1.0)
    _, cr, cg, cb, t = jax.lax.while_loop(cond, body, carry)
    cr_ref[...] = cr
    cg_ref[...] = cg
    cb_ref[...] = cb
    t_ref[...] = t


def _forward(volume, tf, camera, x_offset, s_start, static):
    from ..models import raycast

    config, local_width, s_count, block_rays, num_warps, interpret = static
    w = local_width
    h = config.height
    n_rays = w * h
    npad = -(-n_rays // block_rays) * block_rays
    lut = tf.to_lut(config.tf_lut) if config.tf_lut else None
    vn, occ, alpha0 = prepare(volume, tf, config, lut)
    dyn = jnp.stack([alpha0, jnp.asarray(s_start, _f32)])
    tfp = jnp.concatenate([tf.lower, tf.upper, tf.colors.reshape(-1)])
    lut_flat = lut.reshape(-1) if lut is not None else jnp.zeros((4,), _f32)

    origins = raycast.ray_origins(camera, config, x_offset, w)
    dirs = raycast.primary_ray_dirs(camera, config, x_offset, w)
    rays = [a.reshape(-1) for a in (*jnp.moveaxis(origins, -1, 0),
                                    *jnp.moveaxis(dirs, -1, 0))]
    rays = [jnp.pad(a, (0, npad - n_rays)) for a in rays]

    kernel = functools.partial(
        _march_kernel,
        dims=volume.dims,
        depth=volume.octree_depth,
        num_intervals=tf.num_intervals,
        lut_n=int(config.tf_lut),
        nb=occ.shape,
        n_rays=n_rays,
        block_rays=block_rays,
        steps=chunk_samples(config, volume.dims),
        s_count=s_count,
        ds=config.sample_distance,
        clip=config.front_clip,
        eps=config.early_termination,
        density_scale=float(config.density_scale),
        skip=bool(config.empty_space_skipping),
    )
    whole = pl.BlockSpec()
    per_ray = pl.BlockSpec((block_rays,), lambda i: (i,))
    out = pl.pallas_call(
        kernel,
        grid=(npad // block_rays,),
        in_specs=[whole] * 5 + [per_ray] * 6,
        out_specs=[per_ray] * 4,
        out_shape=[jax.ShapeDtypeStruct((npad,), _f32)] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="a1_march",
    )(dyn, tfp, occ.reshape(-1), vn.reshape(-1), lut_flat, *rays)
    cr, cg, cb, t = (a[:n_rays].reshape(w, h) for a in out)
    return jnp.stack([cr, cg, cb], axis=-1), t[..., None]


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _segment(volume, tf, camera, x_offset, s_start, static):
    return _forward(volume, tf, camera, x_offset, s_start, static)


def _segment_fwd(volume, tf, camera, x_offset, s_start, static):
    out = _forward(volume, tf, camera, x_offset, s_start, static)
    return out, (volume, tf, camera, x_offset, s_start)


def _segment_bwd(static, res, ct):
    from ..models import raycast

    volume, tf, camera, x_offset, s_start = res
    config, local_width, s_count = static[:3]

    def scan(volume, tf, camera):
        return raycast.render_vrc_segment(
            volume, tf, camera, config, x_offset=x_offset,
            local_width=local_width, s_start=s_start, s_count=s_count)

    _, vjp = jax.vjp(scan, volume, tf, camera)
    return (*vjp(ct), None, None)


_segment.defvjp(_segment_fwd, _segment_bwd)


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
    block_rays: int = BLOCK_RAYS,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Columns [x_offset, x_offset + local_width) x samples [s_start,
    s_start + s_count) -> front-to-back (C [w, H, 3], T [w, H, 1]): the
    fused form of ``raycast.render_vrc_segment``, shard_map-friendly
    (offsets may be traced, shapes are static)."""
    if block_rays & (block_rays - 1):
        raise ValueError(f"block_rays {block_rays} must be a power of two")
    static = (
        config,
        config.width if local_width is None else local_width,
        config.samples_per_ray if s_count is None else s_count,
        block_rays,
        num_warps,
        interpret,
    )
    return _segment(volume, tf, camera, jnp.asarray(x_offset, _i32),
                    jnp.asarray(s_start, _i32), static)


def render_vrc(
    volume: Volume,
    tf: TransferFunction,
    camera: Camera,
    config: RenderConfig,
    **kw,
) -> jnp.ndarray:
    """a1/VRC render -> [W, H, 4] through the fused march; equal to
    ``raycast.render_vrc(..., mode="fast")`` up to ``config.early_termination``
    times the largest colour."""
    from . import composite

    seg = render_vrc_segment(volume, tf, camera, config, **kw)
    return composite.segment_finalize(seg, config.background)
