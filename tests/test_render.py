import numpy as np
import jax
import jax.numpy as jnp
import pytest

from volumerenderingproject import (
    Algorithm,
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
    render_jit,
    render_test,
    render_vrc,
)

from reference_impl import py_render_vrc, py_render_test


def _tiny_setup(rng, dims=(6, 8, 7)):
    vol_np = rng.uniform(0.0, 255.0, size=dims).astype(np.float32)
    volume = make_volume(vol_np, cal_max=255.0)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=9, height=7, samples_per_ray=25)
    return vol_np, volume, tf, cam, cfg


def _cam_dict(cam):
    return {
        "position": np.asarray(cam.position, np.float32),
        "front": np.asarray(cam.front, np.float32),
        "right": np.asarray(cam.right, np.float32),
        "up": np.asarray(cam.up, np.float32),
        "top_left": np.asarray(cam.top_left, np.float32),
    }


def _cfg_dict(cfg):
    return {
        "width": cfg.width,
        "height": cfg.height,
        "spr": cfg.samples_per_ray,
        "sample_distance": cfg.sample_distance,
        "front_clip": cfg.front_clip,
        "real_screen_width": cfg.real_screen_width,
        "real_screen_height": cfg.real_screen_height,
        "viewplane_distance": cfg.viewplane_distance,
        "background": cfg.background,
        "conic": cfg.conic,
    }


def _intervals(tf):
    return [
        (float(lo), float(hi), np.asarray(c, np.float32))
        for lo, hi, c in zip(
            np.asarray(tf.lower), np.asarray(tf.upper), np.asarray(tf.colors)
        )
    ]


def test_vrc_matches_loop_reference_ortho(rng):
    vol_np, volume, tf, cam, cfg = _tiny_setup(rng)
    want = py_render_vrc(vol_np, _intervals(tf), 255.0, _cam_dict(cam), _cfg_dict(cfg))
    got = np.asarray(render_vrc(volume, tf, cam, cfg, mode="reference"))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_vrc_matches_loop_reference_conic(rng):
    vol_np, volume, tf, cam, _ = _tiny_setup(rng)
    cfg = RenderConfig(
        width=8, height=6, samples_per_ray=20, conic=True, conic_corrected=False
    )
    want = py_render_vrc(vol_np, _intervals(tf), 255.0, _cam_dict(cam), _cfg_dict(cfg))
    got = np.asarray(render_vrc(volume, tf, cam, cfg, mode="reference"))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_fast_mode_matches_reference_mode(rng):
    _, volume, tf, cam, cfg = _tiny_setup(rng)
    ref = np.asarray(render_vrc(volume, tf, cam, cfg, mode="reference"))
    fast = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    np.testing.assert_allclose(fast, ref, atol=1e-5)


def test_test_mode_matches_loop_reference(rng):
    vol_np, volume, tf, cam, _ = _tiny_setup(rng)
    cfg = RenderConfig(
        width=7, height=7, samples_per_ray=15, algorithm=Algorithm.TEST
    )
    want = py_render_test(vol_np, _intervals(tf), 255.0, _cam_dict(cam), _cfg_dict(cfg))
    got = np.asarray(render_test(volume, tf, cam, cfg, mode="reference"))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_render_jit_compiles_and_matches(rng):
    _, volume, tf, cam, cfg = _tiny_setup(rng)
    eager = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    jitted = np.asarray(render_jit(volume, tf, cam, cfg))
    np.testing.assert_allclose(jitted, eager, atol=1e-6)


def test_background_only_when_empty(rng):
    volume = make_volume(np.zeros((4, 4, 4), np.float32))
    tf = default_transfer_function()
    cam = Camera.initial()
    cfg = RenderConfig(width=4, height=4, samples_per_ray=10)
    img = np.asarray(render_vrc(volume, tf, cam, cfg))
    np.testing.assert_allclose(img[..., :3], 0.2, atol=1e-6)
    np.testing.assert_allclose(img[..., 3], 1.0)


def test_gradients_flow_to_tf_colors(rng):
    _, volume, tf, cam, cfg = _tiny_setup(rng)

    def loss(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        img = render_vrc(volume, tf2, cam, cfg, mode="fast")
        return jnp.mean(img[..., :3] ** 2)

    g = np.asarray(jax.grad(loss)(tf.colors))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_gradients_flow_to_volume_trilinear(rng):
    from volumerenderingproject.utils.config import Interp

    vol_np, volume, tf, cam, cfg = _tiny_setup(rng)
    cfg = cfg.replace(interp=Interp.TRILINEAR, samples_per_ray=10)

    def loss(data):
        v2 = volume.with_data(data)
        img = render_vrc(v2, tf, cam, cfg, mode="fast")
        return jnp.mean(img[..., :3])

    g = np.asarray(jax.grad(loss)(volume.data))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_point_splat_runs(rng):
    vol_np, volume, tf, cam, _ = _tiny_setup(rng)
    cfg = RenderConfig(width=16, height=16, algorithm=Algorithm.POINT)
    from volumerenderingproject.models.point_splat import render_points

    img = np.asarray(render_points(volume, tf, cam, cfg))
    assert img.shape == (16, 16, 4)
    assert np.isfinite(img).all()
    # something was splatted (not all background)
    assert (np.abs(img[..., :3] - 0.2) > 1e-3).any()


def test_avg152_small_render(avg152_path, rng):
    from volumerenderingproject import load_nifti, reset_preset

    volume = load_nifti(avg152_path)
    tf = default_transfer_function()
    cam = reset_preset()
    cfg = RenderConfig(width=24, height=24, samples_per_ray=60)
    img = np.asarray(render_vrc(volume, tf, cam, cfg))
    assert np.isfinite(img).all()
    # brain visible: some pixels depart from background
    assert (np.abs(img[..., :3] - 0.2) > 0.05).any()
