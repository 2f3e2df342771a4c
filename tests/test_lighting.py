import numpy as np
import jax.numpy as jnp

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.ops import conv3d, phong


def test_reference_kernel_shape_and_values():
    k = np.asarray(conv3d.reference_kernel())
    assert k[1, 1, 1] == 5.0
    assert k[0, 1, 1] == k[2, 1, 1] == k[1, 0, 1] == np.float32(0.1)
    assert abs(k.sum() - (5.0 + 6 * 0.1)) < 1e-5


def test_conv3d_matches_numpy(rng):
    vol = rng.uniform(0, 1, size=(6, 7, 8)).astype(np.float32)
    k = np.asarray(conv3d.reference_kernel())
    got = np.asarray(conv3d.conv3d(jnp.asarray(vol), jnp.asarray(k)))
    # brute force zero-padded convolution (cross-correlation — XLA conv
    # doesn't flip the kernel; the reference kernel is symmetric anyway)
    pad = np.pad(vol, 1)
    want = np.zeros_like(vol)
    for i in range(6):
        for j in range(7):
            for l in range(8):
                want[i, j, l] = np.sum(pad[i : i + 3, j : j + 3, l : l + 3] * k)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gaussian_smooth_preserves_mean(rng):
    vol = rng.uniform(0, 1, size=(16, 16, 16)).astype(np.float32)
    out = np.asarray(conv3d.gaussian_smooth(jnp.asarray(vol), sigma=1.0))
    # interior mean approximately preserved; variance reduced
    assert abs(out[4:-4].mean() - vol[4:-4].mean()) < 0.05
    assert out[4:-4].std() < vol[4:-4].std()


def test_gradient_points_along_ramp():
    vol = np.tile(
        np.arange(16, dtype=np.float32)[:, None, None], (1, 16, 16)
    )  # ramp along x
    g = np.asarray(conv3d.central_difference_gradient(jnp.asarray(vol)))
    assert g.shape == (16, 16, 16, 3)
    np.testing.assert_allclose(g[4:-4, 4:-4, 4:-4, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(g[4:-4, 4:-4, 4:-4, 1:], 0.0, atol=1e-5)
    gs = np.asarray(conv3d.sobel_gradient(jnp.asarray(vol)))
    np.testing.assert_allclose(gs[4:-4, 4:-4, 4:-4, 0], 1.0, atol=1e-5)


def test_hg_phase_isotropic_at_g0():
    c = jnp.linspace(-1, 1, 11)
    p = np.asarray(phong.henyey_greenstein(c, 0.0))
    np.testing.assert_allclose(p, 1.0 / (4 * np.pi), rtol=1e-6)


def test_hg_phase_forward_peaked():
    p_fwd = float(phong.henyey_greenstein(jnp.float32(1.0), 0.8))
    p_bwd = float(phong.henyey_greenstein(jnp.float32(-1.0), 0.8))
    assert p_fwd > 10 * p_bwd
    # normalization: integral over sphere = 1
    mu = np.linspace(-1, 1, 20001)
    vals = np.asarray(phong.henyey_greenstein(jnp.asarray(mu), 0.5))
    integral = 2 * np.pi * np.trapezoid(vals, mu)
    assert abs(integral - 1.0) < 1e-3


def test_phong_shade_flat_region_unchanged():
    rgb = jnp.ones((4, 3)) * 0.5
    normal = jnp.zeros((4, 3))  # no gradient -> unshaded
    view = jnp.asarray([0.0, 0.0, 1.0])
    out = np.asarray(phong.phong_shade(rgb, normal, view, phong.default_light()))
    np.testing.assert_allclose(out, 0.5, atol=1e-6)


def test_lit_render_differs_from_unlit_and_is_finite():
    volume = synthetic.centered_sphere(32)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=12, height=12, samples_per_ray=30)
    unlit = np.asarray(render_vrc(volume, tf, cam, cfg))
    lit = np.asarray(render_vrc(volume, tf, cam, cfg.replace(lighting=True)))
    assert np.isfinite(lit).all()
    assert np.abs(lit - unlit).max() > 1e-3
    # background pixels unaffected by lighting
    bg_mask = np.all(np.abs(unlit[..., :3] - 0.2) < 1e-6, axis=-1)
    if bg_mask.any():
        np.testing.assert_allclose(lit[bg_mask], unlit[bg_mask], atol=1e-6)


def test_lit_render_gradients_flow():
    import jax

    volume = synthetic.centered_sphere(16)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=6, height=6, samples_per_ray=10, lighting=True)

    def loss(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        return jnp.mean(render_vrc(volume, tf2, cam, cfg)[..., :3])

    g = np.asarray(jax.grad(loss)(tf.colors))
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_gradient_filter_and_presmooth():
    """BASELINE config 4: pre-render convolution gradient filter + shading.
    Sobel and pre-smoothed normals change the lit image; sharded renders
    match single-device for both."""
    import numpy as np

    from volumerenderingproject import (
        Camera,
        RenderConfig,
        default_transfer_function,
        make_volume,
    )
    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded,
    )

    rng = np.random.default_rng(9)
    volume = make_volume(
        rng.uniform(0, 255, size=(10, 9, 8)).astype(np.float32))
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    base = RenderConfig(width=12, height=10, samples_per_ray=20,
                        lighting=True)
    central = np.asarray(render_vrc(volume, tf, cam, base))
    sobel_cfg = base.replace(gradient_filter="sobel")
    sobel = np.asarray(render_vrc(volume, tf, cam, sobel_cfg))
    smooth_cfg = base.replace(presmooth_sigma=1.0)
    smooth = np.asarray(render_vrc(volume, tf, cam, smooth_cfg))
    assert np.abs(sobel - central).max() > 1e-4
    assert np.abs(smooth - central).max() > 1e-4

    mesh = make_mesh(rays=2, samples=2, volume=1)
    for cfg_i, want in ((sobel_cfg, sobel), (smooth_cfg, smooth)):
        got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_i, mesh))
        np.testing.assert_allclose(got, want, atol=1e-5)
    # sobel AND presmooth normals work on volume slabs: the halo widens
    # to the Gaussian radius + 1 for presmooth (round-4 exclusion lift;
    # full parity sweep lives in test_parallel.py::test_presmooth_volume_slab)
    mesh_v = make_mesh(rays=1, samples=1, volume=2)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, sobel_cfg, mesh_v))
    np.testing.assert_allclose(got, sobel, atol=1e-5)
    got_s = np.asarray(render_vrc_sharded(volume, tf, cam, smooth_cfg, mesh_v))
    np.testing.assert_allclose(got_s, smooth, atol=1e-5)
