import numpy as np
import jax
import jax.numpy as jnp

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.scene import camera as cam_mod
from volumerenderingproject.scene import voxel_colors
from volumerenderingproject.ops import phong


def test_finite_difference_gradient_tf_colors(rng):
    """BASELINE.json: 'pixel-grad allclose vs ref' — autodiff gradients of
    the render w.r.t. TF colors must match central finite differences."""
    vol_np = rng.uniform(0.0, 255.0, size=(6, 6, 6)).astype(np.float32)
    volume = make_volume(vol_np)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=5, height=5, samples_per_ray=12)

    def loss(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        img = render_vrc(volume, tf2, cam, cfg, mode="fast")
        return jnp.sum(img[..., :3] ** 2)

    g = np.asarray(jax.grad(loss)(tf.colors))
    eps = 1e-3
    colors = np.asarray(tf.colors)
    for k, c in [(1, 0), (1, 3), (3, 1), (3, 3), (2, 2)]:
        dp = colors.copy()
        dp[k, c] += eps
        dm = colors.copy()
        dm[k, c] -= eps
        fd = (float(loss(jnp.asarray(dp))) - float(loss(jnp.asarray(dm)))) / (
            2 * eps
        )
        assert abs(fd - g[k, c]) < 2e-2 * max(1.0, abs(fd)), (k, c, fd, g[k, c])


def test_finite_difference_gradient_density(rng):
    from volumerenderingproject.diff.fit import FitParams, render_loss

    vol_np = rng.uniform(0.0, 255.0, size=(6, 6, 6)).astype(np.float32)
    volume = make_volume(vol_np)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=5, height=5, samples_per_ray=10)
    target = jnp.zeros((5, 5, 4), jnp.float32)

    def loss(ds):
        p = FitParams(tf_colors=tf.colors, density_scale=ds)
        return render_loss(p, tf, volume, cam, target, cfg)

    g = float(jax.grad(loss)(jnp.asarray(0.8, jnp.float32)))
    eps = 1e-3
    fd = (float(loss(jnp.asarray(0.8 + eps))) - float(loss(jnp.asarray(0.8 - eps)))) / (2 * eps)
    assert abs(fd - g) < 2e-2 * max(1.0, abs(fd))


def test_voxel_color_schemes():
    volume = synthetic.centered_sphere(16)
    tf = default_transfer_function()
    c1 = np.asarray(voxel_colors.tf_colors(volume, tf))
    assert c1.shape == (16, 16, 16, 4)
    # bands (niftiColorTest): intensity 0.45 -> (0.8, 0.8, 0.4, 1)
    v2 = make_volume(np.full((2, 2, 2), 0.45 * 255.0, np.float32))
    c2 = np.asarray(voxel_colors.intensity_bands(v2))
    np.testing.assert_allclose(c2[0, 0, 0], [0.8, 0.8, 0.4, 1.0], rtol=1e-6)
    # niftiColorTest2: z==0 plane wins (cyan)
    c3 = np.asarray(voxel_colors.intensity_green(volume))
    np.testing.assert_allclose(c3[5, 5, 0], [0.0, 1.0, 1.0, 1.0])
    np.testing.assert_allclose(c3[0, 5, 5], [1.0, 0.0, 1.0, 1.0])


def test_camera_preset_roundtrip(tmp_path):
    cam = cam_mod.reset_preset()
    p = tmp_path / "cam.json"
    cam_mod.save_preset(cam, str(p))
    cam2 = cam_mod.load_preset(str(p))
    for k in ("position", "front", "right", "up", "top_left"):
        np.testing.assert_allclose(
            np.asarray(getattr(cam, k)), np.asarray(getattr(cam2, k))
        )


def test_random_directions_unit():
    dirs = np.asarray(phong.random_directions(jax.random.PRNGKey(0), 500))
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=-1), 1.0, rtol=1e-5)
    # roughly isotropic: mean close to zero
    assert np.abs(dirs.mean(axis=0)).max() < 0.15


def test_camera_orbit_stays_looking_at_origin():
    cam = Camera.initial(position=(0.0, 0.0, 1.0))
    for _ in range(5):
        cam = cam.orbit(yaw_rad=0.3, pitch_rad=0.1)
        # front always points at the origin (processInput myApp.cu:1107)
        want = -np.asarray(cam.position)
        want = want / np.linalg.norm(want)
        np.testing.assert_allclose(np.asarray(cam.front), want, atol=1e-5)
        # radius preserved by pure rotation
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(cam.position)), 1.0, atol=1e-5
        )
