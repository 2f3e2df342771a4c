"""Single-scattering mode (config.scattering) — VERDICT round-2 item 6.

Realizes the reference's declared-but-stubbed radiative-transfer API
(optical_depth / inscattering / extinction / scattering_probability,
LightInteraction.h:10-35, LightInteraction.cpp:5-80 all return 0) and puts
the per-material Henyey-Greenstein g (Material.h:14-23, stored but never
read upstream) into an actual render path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.models.raycast import render, render_vrc
from volumerenderingproject.ops import phong
from volumerenderingproject.utils.config import Algorithm


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    vol = make_volume(
        rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32))
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = RenderConfig(width=12, height=10, samples_per_ray=20)
    return vol, tf, cam, cfg


def test_transmittance_grid_axis_aligned_analytic():
    """One absorbing plane: voxels behind it (w.r.t. the light) see
    T = (1 - alpha); voxels in front see T = 1 — for all six axis
    directions."""
    for axis in range(3):
        shape = [3, 3, 3]
        shape[axis] = 4
        alpha = jnp.zeros(shape)
        idx = [slice(None)] * 3
        idx[axis] = 1
        alpha = alpha.at[tuple(idx)].set(0.5)
        for sign in (1.0, -1.0):
            d = np.zeros(3, np.float32)
            d[axis] = sign
            t = np.asarray(
                phong.light_transmittance_grid(alpha, jnp.asarray(d)))
            behind = [slice(None)] * 3
            front = [slice(None)] * 3
            if sign > 0:  # light on the high side: voxel 0 is shadowed
                behind[axis] = slice(0, 1)
                front[axis] = slice(2, None)
            else:
                behind[axis] = slice(2, None)
                front[axis] = slice(0, 1)
            np.testing.assert_allclose(t[tuple(behind)], 0.5, atol=1e-6)
            np.testing.assert_allclose(t[tuple(front)], 1.0, atol=1e-6)


def test_transmittance_grid_oblique_bounds():
    """Oblique light: T stays in (0, 1], monotone along the light path."""
    rng = np.random.default_rng(0)
    alpha = jnp.asarray(rng.uniform(0.0, 0.6, (8, 8, 8)), jnp.float32)
    t = np.asarray(phong.light_transmittance_grid(
        alpha, jnp.asarray([0.7, 0.5, 0.3], jnp.float32)))
    assert (t > 0.0).all() and (t <= 1.0 + 1e-6).all()
    # the plane nearest the light (max x here) is unshadowed-est
    assert t[7].mean() >= t[0].mean()


def test_scatter_changes_image_and_oracle(scene):
    """a1 scattering render == manual oracle recomputation: the scattered
    term added to each sample's rgb is strength * HG(cos t; g) * T_light *
    light.color at the sample's voxel."""
    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(scattering=True, scattering_strength=2.0)
    light = phong.default_light()

    base = np.asarray(render_vrc(vol, tf, cam, cfg, mode="fast"))
    got = np.asarray(render_vrc(vol, tf, cam, cfg_s, mode="fast",
                                light=light))
    assert np.abs(got - base).max() > 1e-4

    # oracle: re-march with an explicitly-scattered sample function
    from volumerenderingproject.models import raycast
    from volumerenderingproject.ops import sampling

    origins = raycast.ray_origins(cam, cfg_s)
    dirs = raycast.primary_ray_dirs(cam, cfg_s)
    alpha = tf.classify(
        jnp.maximum(vol.data, 0.0) / jnp.trunc(vol.cal_max))[..., 3]
    tgrid = phong.light_transmittance_grid(alpha, light.direction)
    tl_flat = tgrid.reshape(-1)
    ldir = light.direction / jnp.linalg.norm(light.direction)
    cos_t = jnp.sum(dirs * ldir, axis=-1)

    def sample_rgba(i):
        t = i * jnp.float32(cfg_s.sample_distance)
        p = origins + t * dirs + 0.5
        flat, valid = sampling.octree_nn_index(
            vol.dims, vol.octree_depth, p)
        v = jnp.maximum(jnp.take(vol.data.reshape(-1), flat, axis=0), 0.0)
        v = jnp.where(valid, v, 0.0)
        vn = v / jnp.trunc(vol.cal_max)
        rgba = tf.classify(vn)
        gk = jnp.take(tf.hg_g, tf.classify_index(vn), axis=0)
        tl = jnp.where(valid, jnp.take(tl_flat, flat, axis=0), 0.0)
        ph = phong.henyey_greenstein(cos_t, gk)
        add = 2.0 * (ph * tl)[..., None] * light.color
        return jnp.concatenate([rgba[..., :3] + add, rgba[..., 3:4]], -1)

    want = np.asarray(raycast._march(sample_rgba, cfg_s, "fast", True))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_scatter_hg_g_changes_result(scene):
    """A nonzero per-material HG g changes the image (forward-scattering
    anisotropy) — the g field is finally consumed."""
    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(scattering=True)
    iso = np.asarray(render_vrc(vol, tf, cam, cfg_s, mode="fast"))
    tf_g = dataclasses.replace(
        tf, hg_g=jnp.full_like(tf.hg_g, 0.8))
    aniso = np.asarray(render_vrc(vol, tf_g, cam, cfg_s, mode="fast"))
    assert np.abs(iso - aniso).max() > 1e-4


def test_scatter_a5_and_dispatch(scene):
    """render() dispatch honors scattering for both algorithms (the XLA
    scan serves it on every backend)."""
    vol, tf, cam, cfg = scene
    for alg in (Algorithm.VRC, Algorithm.TEST):
        cfg_s = cfg.replace(scattering=True, algorithm=alg)
        img = np.asarray(render(vol, tf, cam, cfg_s))
        img0 = np.asarray(render(vol, tf, cam, cfg.replace(algorithm=alg)))
        assert np.isfinite(img).all()
        assert np.abs(img - img0).max() > 1e-5


def test_scatter_differentiable_light(scene):
    """Scattering is differentiable w.r.t. the light direction/color
    (the optimizable-light mandate extends to the scattering path)."""
    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(scattering=True)

    def loss(lvec):
        img = render_vrc(vol, tf, cam, cfg_s, mode="fast",
                         light=phong.light_from_vec(lvec))
        return jnp.mean(img[..., :3] ** 2)

    g = np.asarray(jax.grad(loss)(phong.light_to_vec(
        phong.default_light())))
    assert np.isfinite(g).all()
    assert np.abs(g[:6]).max() > 0.0  # direction + color reach the image


def test_scatter_sharded_matches_single(scene):
    """Scattering through shard_map (rays x samples mesh) == single-device."""
    from jax.sharding import Mesh

    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded,
    )

    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(width=16, scattering=True)
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    single = np.asarray(render_vrc(vol, tf, cam, cfg_s, mode="fast"))
    sharded = np.asarray(
        render_vrc_sharded(vol, tf, cam, cfg_s, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-5)

    # volume axis is rejected (the sweep needs the full volume)
    vol8 = make_volume(np.zeros((8, 8, 8), np.float32))
    devs3 = np.array(jax.devices()[:2]).reshape(1, 1, 2)
    mesh3 = Mesh(devs3, ("rays", "samples", "volume"))
    with pytest.raises(NotImplementedError):
        render_vrc_sharded(vol8, tf, cam, cfg_s, mesh3)


@pytest.fixture
def gpu_spy(monkeypatch):
    """A GPU backend whose fused-march calls are recorded (and run in
    interpret mode)."""
    from volumerenderingproject.ops import gpu_march

    calls = []
    seg = gpu_march.render_vrc_segment

    def spy(*a, **k):
        calls.append(1)
        return seg(*a, interpret=True, **k)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", spy)
    return calls


@pytest.mark.parametrize("kw", [{}, {"lighting": True}, {"tf_lut": 64},
                                {"algorithm": Algorithm.TEST}], ids=str)
def test_scatter_stays_on_scan(scene, gpu_spy, kw):
    """The fused GPU march has no scattering term: on a GPU backend
    render() keeps scattering renders on the XLA scan."""
    from volumerenderingproject.models.raycast import render_test

    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(scattering=True, scattering_strength=1.5, **kw)
    scan = render_test if cfg_s.algorithm is Algorithm.TEST else render_vrc
    want = np.asarray(scan(vol, tf, cam, cfg_s, mode="fast"))
    got = np.asarray(render(vol, tf, cam, cfg_s))
    np.testing.assert_array_equal(got, want)
    assert gpu_spy == []


def test_scatter_segments_sharded_stay_on_scan(scene, gpu_spy):
    """Scattering on a rays x samples mesh under a GPU backend: scan
    segments, equal to the single-device render."""
    from jax.sharding import Mesh

    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded,
    )

    vol, tf, cam, cfg = scene
    cfg_s = cfg.replace(width=16, scattering=True)
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    single = np.asarray(render_vrc(vol, tf, cam, cfg_s, mode="fast"))
    sharded = np.asarray(render_vrc_sharded(vol, tf, cam, cfg_s, mesh))
    np.testing.assert_allclose(sharded, single, atol=2e-5)
    assert gpu_spy == []
