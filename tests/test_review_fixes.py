"""Tests pinning the fixes from the round-1 code review."""

import numpy as np
import jax.numpy as jnp
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.scene.transfer_function import (
    TransferFunction,
    from_text,
    to_text,
)
from volumerenderingproject.utils.config import Interp


def _scene(rng, cal_max=255.0):
    vol_np = rng.uniform(0.0, 255.0, size=(8, 8, 7)).astype(np.float32)
    volume = make_volume(vol_np, cal_max=cal_max)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=8, height=6, samples_per_ray=16)
    return vol_np, volume, tf, cam, cfg


def test_tf_text_roundtrips_fitted_colors():
    tf = default_transfer_function()
    fitted = TransferFunction(
        tf.lower, tf.upper, tf.colors + 0.123, tf.hg_g.at[1].set(0.5)
    )
    tf2 = from_text(to_text(fitted))
    np.testing.assert_allclose(np.asarray(tf2.colors), np.asarray(fitted.colors), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tf2.hg_g), np.asarray(fitted.hg_g), rtol=1e-6)


def test_a1_truncates_cal_max_like_reference(rng):
    """kernel.cu:42 passes cal_max as int; a dataset with cal_max=254.7
    must normalize by 254, not 254.7 — matching the loop oracle."""
    from reference_impl import py_render_vrc

    vol_np, volume, tf, cam, cfg = _scene(rng, cal_max=254.7)
    camd = {
        k: np.asarray(getattr(cam, k), np.float32)
        for k in ("position", "front", "right", "up", "top_left")
    }
    cfgd = {
        "width": cfg.width, "height": cfg.height, "spr": cfg.samples_per_ray,
        "sample_distance": cfg.sample_distance, "front_clip": cfg.front_clip,
        "real_screen_width": cfg.real_screen_width,
        "real_screen_height": cfg.real_screen_height,
        "viewplane_distance": cfg.viewplane_distance,
        "background": cfg.background, "conic": cfg.conic,
    }
    ivals = [
        (float(lo), float(hi), np.asarray(c, np.float32))
        for lo, hi, c in zip(
            np.asarray(tf.lower), np.asarray(tf.upper), np.asarray(tf.colors)
        )
    ]
    want = py_render_vrc(vol_np, ivals, 254.7, camd, cfgd)
    got = np.asarray(render_vrc(volume, tf, cam, cfg, mode="reference"))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_trilinear_color_interp_differs_from_nearest(rng):
    _, volume, tf, cam, cfg = _scene(rng)
    nn = np.asarray(render_vrc(volume, tf, cam, cfg))
    tc = np.asarray(render_vrc(volume, tf, cam, cfg.replace(interp=Interp.TRILINEAR_COLOR)))
    assert np.isfinite(tc).all()
    assert np.abs(tc - nn).max() > 1e-3  # actually interpolates now


def test_multichannel_lighting_shades():
    volume = synthetic.rgb_sphere(16)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=10, height=10, samples_per_ray=16)
    unlit = np.asarray(render_vrc(volume, tf, cam, cfg))
    lit = np.asarray(render_vrc(volume, tf, cam, cfg.replace(lighting=True)))
    assert np.abs(lit - unlit).max() > 1e-3


def test_sharded_lighting_matches_single(rng):
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import render_vrc_sharded

    _, volume, tf, cam, cfg = _scene(rng)
    cfg = cfg.replace(lighting=True)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    single = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    sharded = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_density_matches_single(rng):
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import render_vrc_sharded

    _, volume, tf, cam, cfg = _scene(rng)
    cfg = cfg.replace(density_scale=0.5)
    for mesh in (make_mesh(rays=4, samples=2, volume=1), make_mesh(rays=2, samples=1, volume=4)):
        single = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
        sharded = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
        np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_fit_trains_density(rng):
    import optax

    from volumerenderingproject.diff.fit import FitParams, make_train_step
    from volumerenderingproject.parallel.mesh import make_mesh

    _, volume, tf, cam, cfg = _scene(rng)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    target = jnp.zeros((cfg.width, cfg.height, 4), jnp.float32)
    params = FitParams.init(tf)
    opt = optax.sgd(1e-2)
    step = make_train_step(tf, cfg, opt, mesh=mesh)
    p2, _, _ = step(params, opt.init(params), volume, cam, target)
    # density gradient must flow in the sharded path
    assert float(jnp.abs(p2.density_scale - params.density_scale)) > 0


def test_cli_point_with_mesh_errors():
    from volumerenderingproject.harness import cli

    with pytest.raises(SystemExit):
        cli.main(
            ["render", "--data", "sphere", "--width", "8", "--height", "8",
             "--algorithm", "point", "--mesh", "rays=1"]
        )


def test_volume_axis_lighting_matches(rng):
    """Round 1 rejected lighting on the volume axis; round 2's halo
    exchange supports it — assert correctness instead."""
    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import render_vrc_sharded

    _, volume, tf, cam, cfg = _scene(rng)
    cfg_lit = cfg.replace(lighting=True)
    mesh = make_mesh(rays=1, samples=1, volume=2)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_lit, mesh))
    want = np.asarray(render_vrc(volume, tf, cam, cfg_lit, mode="fast"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_a5_lighting_differs_and_sharded_matches(rng):
    from volumerenderingproject.models.raycast import render_test
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import render_vrc_sharded
    from volumerenderingproject.utils.config import Algorithm

    _, volume, tf, cam, cfg = _scene(rng)
    cfg5 = cfg.replace(algorithm=Algorithm.TEST)
    unlit = np.asarray(render_test(volume, tf, cam, cfg5))
    lit_cfg = cfg5.replace(lighting=True)
    lit = np.asarray(render_test(volume, tf, cam, lit_cfg))
    assert np.isfinite(lit).all()
    assert np.abs(lit - unlit).max() > 1e-3
    mesh = make_mesh(rays=4, samples=2, volume=1)
    sharded = np.asarray(render_vrc_sharded(volume, tf, cam, lit_cfg, mesh))
    np.testing.assert_allclose(sharded, lit, atol=1e-5)


def test_tf_lut_render_matches_scan_on_grid_data(rng):
    """With intensities landing exactly on LUT grid points, the LUT render
    equals the scan render; generic data is close."""
    _, volume, tf, cam, cfg = _scene(rng)
    scan = np.asarray(render_vrc(volume, tf, cam, cfg))
    lut = np.asarray(render_vrc(volume, tf, cam, cfg.replace(tf_lut=4096)))
    # 4096-entry LUT resolves the default table's 1/255-spaced bounds well;
    # only samples within half a bin of a bound can differ
    close = np.isclose(lut, scan, atol=1e-6).all(-1)
    assert close.mean() > 0.95


def test_fit_checkpoint_resume_exact(rng, tmp_path):
    """Crash recovery: a fit interrupted at step 4 and resumed from its
    checkpoint (params + optimizer state) must land exactly where the
    uninterrupted 8-step run lands."""
    from volumerenderingproject.diff.fit import fit_transfer_function

    _, volume, tf, cam, cfg = _scene(rng)
    target = np.zeros((cfg.width, cfg.height, 4), np.float32)
    ckdir = str(tmp_path / "ck")

    straight, _ = fit_transfer_function(
        volume, cam, target, tf, cfg, steps=8, learning_rate=1e-2)

    # "crash" after 4 steps (checkpoint every 2)
    fit_transfer_function(
        volume, cam, target, tf, cfg, steps=4, learning_rate=1e-2,
        checkpoint_dir=ckdir, checkpoint_every=2)
    resumed, losses = fit_transfer_function(
        volume, cam, target, tf, cfg, steps=8, learning_rate=1e-2,
        checkpoint_dir=ckdir, checkpoint_every=2, resume=True)
    assert len(losses) == 4  # continued from step 4
    np.testing.assert_allclose(
        np.asarray(resumed.tf_colors), np.asarray(straight.tf_colors),
        atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(resumed.density_scale),
        np.asarray(straight.density_scale), atol=1e-6)
