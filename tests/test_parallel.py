import numpy as np
import jax
import jax.numpy as jnp
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.parallel.mesh import make_mesh
from volumerenderingproject.parallel.render_dist import render_vrc_sharded


@pytest.fixture(scope="module")
def scene(rng=None):
    rng = np.random.default_rng(7)
    vol_np = rng.uniform(0.0, 255.0, size=(8, 10, 9)).astype(np.float32)
    volume = make_volume(vol_np)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.4, 0.3, 0.9))
    cfg = RenderConfig(width=16, height=6, samples_per_ray=24)
    return volume, tf, cam, cfg


def _single(volume, tf, cam, cfg):
    return np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))


def test_rays_axis_matches_single(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=8, samples=1, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg), atol=1e-6)


def test_samples_axis_matches_single(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=2, samples=4, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg), atol=1e-5)


def test_volume_axis_matches_single(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=2, samples=1, volume=4)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg), atol=1e-5)


def test_volume_axis_negative_front_x(scene):
    volume, tf, cam, cfg = scene
    cam2 = Camera.initial(position=(-0.6, 0.2, 0.7))  # front.x > 0... mirrored
    assert float(cam2.front[0]) > 0
    cam3 = Camera.initial(position=(0.6, 0.2, 0.7))
    assert float(cam3.front[0]) < 0
    mesh = make_mesh(rays=1, samples=1, volume=8)
    for cam_i in (cam2, cam3):
        got = np.asarray(render_vrc_sharded(volume, tf, cam_i, cfg, mesh))
        np.testing.assert_allclose(
            got, _single(volume, tf, cam_i, cfg), atol=1e-5
        )


def test_full_3d_mesh(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=2, samples=2, volume=2)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg), atol=1e-5)


def test_sharded_gradients_match_single(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=2, samples=2, volume=1)
    target = jnp.zeros((cfg.width, cfg.height, 4), jnp.float32)

    def loss_single(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        img = render_vrc(volume, tf2, cam, cfg, mode="fast")
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    def loss_sharded(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        img = render_vrc_sharded(volume, tf2, cam, cfg, mesh)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    g1 = np.asarray(jax.grad(loss_single)(tf.colors))
    g2 = np.asarray(jax.grad(loss_sharded)(tf.colors))
    assert np.abs(g1).sum() > 0
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-7)


def test_mesh_validation(scene):
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=8, samples=1, volume=1)
    bad_cfg = cfg.replace(width=16, height=5)
    bad_cfg = bad_cfg.replace(width=15)  # not divisible by 8
    with pytest.raises(ValueError):
        render_vrc_sharded(volume, tf, cam, bad_cfg, mesh)


def test_a5_sharded_matches_single(scene):
    from volumerenderingproject.models.raycast import render_test
    from volumerenderingproject.utils.config import Algorithm

    volume, tf, cam, cfg = scene
    cfg5 = cfg.replace(algorithm=Algorithm.TEST)
    mesh = make_mesh(rays=4, samples=2, volume=1)
    single = np.asarray(render_test(volume, tf, cam, cfg5, mode="fast"))
    sharded = np.asarray(render_vrc_sharded(volume, tf, cam, cfg5, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_conic_volume_sharding_matches_single(scene):
    """Conic + volume axis: the slab fold runs in
    both orders and selects per ray by sign(dir.x) (rays on either side
    of the camera axis disagree on the slab visit order)."""
    volume, tf, _, cfg = scene
    mesh = make_mesh(rays=1, samples=1, volume=8)
    cfg_c = cfg.replace(conic=True)
    # near-perpendicular cameras: the conic fan straddles sign(dir.x)
    for pos in ((0.05, 0.3, 1.2), (0.3, 0.2, 1.1)):
        cam = Camera.initial(position=pos)
        want = _single(volume, tf, cam, cfg_c)
        got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_c, mesh))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(pos))
        # the fan genuinely disagrees on sign(dir.x) in the first case
    from volumerenderingproject.models.raycast import primary_ray_dirs

    dirs = primary_ray_dirs(Camera.initial(position=(0.05, 0.3, 1.2)),
                            cfg_c)
    signs = np.sign(np.asarray(dirs[..., 0]))
    assert (signs > 0).any() and (signs < 0).any()


def test_config_validation():
    from volumerenderingproject.utils.config import RenderConfig

    with pytest.raises(ValueError):
        RenderConfig(width=0)
    with pytest.raises(ValueError):
        RenderConfig(samples_per_ray=-1)
    with pytest.raises(ValueError):
        RenderConfig(front_clip=5.0)


@pytest.fixture
def fused(monkeypatch):
    """Route eligible work units to the fused GPU march, run in interpret
    mode on the CPU mesh; returns the list of kernel calls."""
    from volumerenderingproject.ops import gpu_march

    calls = []
    seg = gpu_march.render_vrc_segment

    def spy(*a, **k):
        calls.append(k.get("s_start"))
        return seg(*a, interpret=True, **k)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", spy)
    return calls


@pytest.mark.parametrize("axes", [(8, 1, 1), (2, 4, 1), (2, 1, 4), (2, 2, 2)],
                         ids=str)
def test_pallas_segments_all_axes(scene, fused, axes):
    """The fused march under shard_map (interpret mode) matches the
    single-device scan on every mesh-axis combination; volume-axis meshes
    keep the scan's slab work units."""
    volume, tf, cam, cfg = scene
    want = _single(volume, tf, cam, cfg)
    mesh = make_mesh(rays=axes[0], samples=axes[1], volume=axes[2])
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert bool(fused) == (axes[2] == 1)


@pytest.mark.parametrize("kw", [dict(lighting=True), dict(tf_lut=64),
                                dict(lighting=True, tf_lut=64)], ids=str)
def test_pallas_segments_lit_and_lut(scene, fused, kw):
    """LUT classify runs on the fused segments, lighting on the scan
    segments; both match the single-device scan on a rays x samples mesh."""
    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(**kw)
    want = _single(volume, tf, cam, cfg2)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg2, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert bool(fused) == (not cfg2.lighting)


def test_pallas_auto_falls_back_when_ineligible(scene, fused):
    """Lighting is outside the fused march's semantics: the work units
    must be the XLA scan segments (and still match the single render)."""
    volume, tf, cam, cfg = scene
    cfg_lit = cfg.replace(lighting=True)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_lit, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg_lit),
                               atol=1e-5)
    assert fused == []


def test_volume_axis_halo_trilinear_color(scene):
    """Volume-axis slabs with a one-voxel halo must reproduce the a1
    trilinear-color interp exactly (taps cross slab boundaries)."""
    from volumerenderingproject.utils.config import Interp

    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(interp=Interp.TRILINEAR_COLOR)
    want = np.asarray(render_vrc(volume, tf, cam, cfg2, mode="fast"))
    mesh = make_mesh(rays=1, samples=1, volume=4)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg2, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_axis_halo_trilinear_smooth(scene):
    from volumerenderingproject.utils.config import Interp

    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(interp=Interp.TRILINEAR)
    want = np.asarray(render_vrc(volume, tf, cam, cfg2, mode="fast"))
    mesh = make_mesh(rays=2, samples=1, volume=2)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg2, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_axis_halo_lighting(scene):
    """Gradient-normal Phong shading on slabs: central differences read
    through the exchanged halo."""
    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(lighting=True)
    want = np.asarray(render_vrc(volume, tf, cam, cfg2, mode="fast"))
    mesh = make_mesh(rays=1, samples=2, volume=4)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg2, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_axis_a5(scene):
    """a5/TEST sharding over volume slabs (corner fetches through the halo,
    incl. the reference's flat-index wrap semantics)."""
    from volumerenderingproject.models.raycast import render_test
    from volumerenderingproject.utils.config import Algorithm

    volume, tf, cam, cfg = scene
    cfg5 = cfg.replace(algorithm=Algorithm.TEST)
    want = np.asarray(render_test(volume, tf, cam, cfg5, mode="fast"))
    mesh = make_mesh(rays=2, samples=1, volume=2)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg5, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    cfg5l = cfg5.replace(lighting=True)
    want = np.asarray(render_test(volume, tf, cam, cfg5l, mode="fast"))
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg5l, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_segments_conic_rays_samples(scene, fused):
    """Conic cameras shard over rays/samples through the fused march."""
    volume, tf, cam, cfg = scene
    cfg_c = cfg.replace(conic=True)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_c, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg_c),
                               atol=1e-5)
    assert len(fused) == 1


@pytest.mark.parametrize("axes", [(1, 1, 2), (2, 2, 2)], ids=str)
def test_multichannel_slab_matches_single(scene, axes):
    """Volume-sharded 4-D multichannel (nearest-neighbour, no halo)."""
    _, tf, cam, cfg = scene
    rng = np.random.default_rng(11)
    volume = make_volume(
        rng.uniform(0.0, 255.0, size=(8, 10, 9, 3)).astype(np.float32))
    mesh = make_mesh(rays=axes[0], samples=axes[1], volume=axes[2])
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _single(volume, tf, cam, cfg), atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"lighting": True}], ids=str)
def test_a5_rays_samples_matches_single(scene, kw):
    from volumerenderingproject.models.raycast import render_test
    from volumerenderingproject.utils.config import Algorithm

    volume, tf, cam, cfg = scene
    cfg5 = cfg.replace(algorithm=Algorithm.TEST, **kw)
    want = np.asarray(render_test(volume, tf, cam, cfg5, mode="fast"))
    mesh = make_mesh(rays=2, samples=2, volume=1)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg5, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_sharded_scattering_matches_single(scene):
    """Scattering on a volume-slab mesh: the sharded
    light-transmittance sweep (phong.light_transmittance_grid_slab)
    stitches per-slab partials with ppermute — parity vs the replicated
    render across all three sweep branches (dominant axis x / y / z,
    both signs, nonzero x-shear)."""
    import dataclasses

    from volumerenderingproject.ops import phong

    volume, tf, cam, cfg = scene
    cfg_s = cfg.replace(scattering=True)
    mesh = make_mesh(rays=1, samples=1, volume=4)
    for ldir in ((0.5, 1.0, 0.75),    # y-dominant, x-shear (default)
                 (1.0, 0.3, -0.2),    # x-dominant, +x
                 (-1.0, 0.1, 0.4),    # x-dominant, -x
                 (0.4, -0.3, -1.0),   # z-dominant, -z, x-shear
                 (0.0, 1.0, 0.2)):    # y-dominant, zero x-shear
        light = dataclasses.replace(
            phong.default_light(),
            direction=jnp.asarray(ldir, jnp.float32))
        want = np.asarray(render_vrc(
            volume, tf, cam, cfg_s, mode="fast", light=light))
        got = np.asarray(render_vrc_sharded(
            volume, tf, cam, cfg_s, mesh, light=light))
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(ldir))


def test_sharded_sweep_matches_replicated_grid():
    """light_transmittance_grid_slab == light_transmittance_grid on the
    slab, directly (the op-level parity behind the render test)."""
    from functools import partial

    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from volumerenderingproject.ops import phong

    rng = np.random.default_rng(5)
    alpha = jnp.asarray(
        rng.uniform(0, 0.9, size=(16, 10, 9)).astype(np.float32))
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("volume",))
    for ldir in ((1.0, 0.4, 0.1), (-0.2, -1.0, 0.3), (0.3, 0.2, 1.0)):
        d = jnp.asarray(ldir, jnp.float32)
        want = np.asarray(phong.light_transmittance_grid(alpha, d))

        fn = shard_map(
            partial(phong.light_transmittance_grid_slab,
                    light_dir=np.asarray(ldir, np.float32)),
            mesh=mesh, in_specs=P("volume"), out_specs=P("volume"),
            check_vma=False)
        got = np.asarray(fn(alpha))
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=str(ldir))


def test_volume_axis_presmooth_lighting(scene):
    """Presmoothed gradient shading on a volume-slab mesh — the
    x-halo widens to the Gaussian radius + 1 so smoothed normals match
    the replicated render exactly."""
    volume, tf, cam, cfg = scene
    cfg_p = cfg.replace(lighting=True, presmooth_sigma=1.2,
                        gradient_filter="sobel")
    mesh = make_mesh(rays=1, samples=1, volume=4)
    want = _single(volume, tf, cam, cfg_p)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg_p, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
