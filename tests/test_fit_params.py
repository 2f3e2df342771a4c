"""Lighting + TF-bound parameter gradients.

BASELINE.json's north star names gradients w.r.t. transfer-function
parameters, density, AND lighting.  These tests cover:

  * light-parameter gradients through the XLA Phong scan against
    central finite differences,
  * a fit that recovers a perturbed light (ambient/direction) and
    perturbed TF interval bounds (smooth mode),
  * sharded (mesh) light/bound gradients matching single-device.
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
from volumerenderingproject.diff.fit import (
    FitParams,
    fit_transfer_function,
    render_loss,
)
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.ops import phong
from volumerenderingproject.utils.config import Interp


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    vol_np = rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32)
    volume = make_volume(vol_np)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = RenderConfig(width=18, height=13, samples_per_ray=30)
    target = jnp.asarray(
        rng.uniform(0.0, 1.0, size=(18, 13, 4)).astype(np.float32))
    return volume, tf, cam, cfg, target


def _loss_of(img, target):
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


def test_light_vec_roundtrip():
    lg = phong.default_light()
    v = phong.light_to_vec(lg)
    assert v.shape == (phong.N_LIGHT_PARAMS,)
    lg2 = phong.light_from_vec(v)
    for f in ("direction", "color", "ambient", "diffuse", "specular",
              "shininess"):
        np.testing.assert_allclose(
            np.asarray(getattr(lg, f)), np.asarray(getattr(lg2, f)))


@pytest.mark.parametrize("i", range(phong.N_LIGHT_PARAMS))
def test_light_grads_match_finite_differences(scene, i):
    """dL/d(light param i) through the XLA Phong scan equals a central
    finite difference of the loss (float64-free: a step of 1e-2 on a
    smooth loss)."""
    volume, tf, cam, cfg, target = scene

    @jax.jit
    def loss(lvec):
        img = render_vrc(volume, tf, cam, cfg, mode="fast",
                         light=phong.light_from_vec(lvec))
        return _loss_of(img, target)

    lvec = phong.light_to_vec(phong.default_light())
    g = float(jax.jit(jax.grad(loss))(lvec)[i])
    h = 1e-2
    e = jnp.zeros_like(lvec).at[i].set(h)
    fd = (float(loss(lvec + e)) - float(loss(lvec - e))) / (2 * h)
    assert abs(g - fd) <= 2e-2 * abs(fd) + 2e-5, (g, fd)


def test_render_loss_routes_light_and_bounds(scene):
    """render_loss exposes nonzero light gradients and, in smooth mode,
    nonzero bound gradients through FitParams."""
    volume, tf, cam, cfg, target = scene
    params = FitParams.init(tf, light=phong.default_light())
    g = jax.grad(render_loss)(params, tf, volume, cam, target, cfg)
    assert float(jnp.abs(g.light.ambient)) > 0.0
    assert g.tf_lower is None and g.tf_upper is None

    cfg_s = dataclasses.replace(cfg, interp=Interp.TRILINEAR)
    params_b = FitParams.init(tf, fit_bounds=True)
    g_b = jax.grad(render_loss)(params_b, tf, volume, cam, target, cfg_s)
    assert float(jnp.max(jnp.abs(g_b.tf_lower))) > 0.0
    assert float(jnp.max(jnp.abs(g_b.tf_upper))) > 0.0


def test_fit_recovers_perturbed_light(scene):
    """A fit from a perturbed light converges toward the target render's
    light (ambient + direction recovery through the XLA scan path)."""
    volume, tf, cam, cfg, _ = scene
    true_light = phong.default_light()
    target = render_vrc(volume, tf, cam, cfg, mode="fast",
                        light=true_light)

    start = dataclasses.replace(
        true_light,
        ambient=jnp.asarray(0.7, jnp.float32),
        diffuse=jnp.asarray(0.2, jnp.float32),
    )
    params, losses = fit_transfer_function(
        volume, cam, target, tf, cfg, steps=150, learning_rate=2e-2,
        light=start)
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    # ambient moved toward the true value
    a0 = abs(0.7 - float(true_light.ambient))
    a1 = abs(float(params.light.ambient) - float(true_light.ambient))
    assert a1 < 0.5 * a0, (a1, a0)


def test_fit_recovers_perturbed_bounds(scene):
    """Smooth-mode fit recovers perturbed TF interval bounds (the
    differentiable upgrade of the reference's static interval table,
    TransferFunction.cu:19-23)."""
    volume, tf, cam, cfg, _ = scene
    cfg_s = dataclasses.replace(
        cfg, interp=Interp.TRILINEAR, tf_sharpness=40.0)
    target = render_vrc(volume, tf, cam, cfg_s, mode="fast")

    tf_pert = dataclasses.replace(
        tf,
        lower=tf.lower + jnp.asarray([0.0, 0.06, -0.05, 0.04], jnp.float32),
        upper=tf.upper + jnp.asarray([0.0, -0.06, 0.05, -0.04], jnp.float32),
    )
    params, losses = fit_transfer_function(
        volume, cam, target, tf_pert, cfg_s, steps=80, learning_rate=5e-3,
        fit_bounds=True)
    assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])
    err0 = float(jnp.mean(jnp.abs(tf_pert.lower - tf.lower)))
    err1 = float(jnp.mean(jnp.abs(params.tf_lower - tf.lower)))
    assert err1 < err0, (err1, err0)


def test_sharded_light_grads_match_single_device(scene):
    """Light/bound/color gradients through the mesh (shard_map + psum)
    equal the single-device XLA gradients."""
    from jax.sharding import Mesh

    volume, tf, cam, cfg, target = scene
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    cfg2 = dataclasses.replace(cfg, width=16, samples_per_ray=30)
    target2 = target[:16]
    params = FitParams.init(tf, light=phong.default_light())

    g_single = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg2)
    g_mesh = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg2, mesh)
    np.testing.assert_allclose(
        np.asarray(g_mesh.tf_colors), np.asarray(g_single.tf_colors),
        rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(phong.light_to_vec(g_mesh.light)),
        np.asarray(phong.light_to_vec(g_single.light)),
        rtol=2e-4, atol=1e-6)

    # smooth-mode interval-bound gradients shard identically too
    cfg_s = dataclasses.replace(cfg2, interp=Interp.TRILINEAR,
                                tf_sharpness=40.0)
    params_b = FitParams.init(tf, fit_bounds=True)
    gb_single = jax.grad(render_loss)(
        params_b, tf, volume, cam, target2, cfg_s)
    gb_mesh = jax.grad(render_loss)(
        params_b, tf, volume, cam, target2, cfg_s, mesh)
    for name in ("tf_lower", "tf_upper"):
        np.testing.assert_allclose(
            np.asarray(getattr(gb_mesh, name)),
            np.asarray(getattr(gb_single, name)),
            rtol=2e-4, atol=1e-6, err_msg=name)


def test_checkpoint_roundtrip_new_fields(tmp_path, scene):
    """save/load_checkpoint round-trips the new optional fields."""
    from volumerenderingproject.diff.fit import (
        load_checkpoint,
        save_checkpoint,
    )

    _, tf, _, _, _ = scene
    params = FitParams.init(
        tf, fit_bounds=True, light=phong.default_light())
    save_checkpoint(str(tmp_path), 3, params)
    back = load_checkpoint(str(tmp_path), 3)
    np.testing.assert_allclose(
        np.asarray(back.tf_lower), np.asarray(params.tf_lower))
    np.testing.assert_allclose(
        np.asarray(phong.light_to_vec(back.light)),
        np.asarray(phong.light_to_vec(params.light)))


def test_a5_fit_routes_to_a5_forward(scene):
    """A fit with config.algorithm = TEST optimizes the a5 forward model
    (the round-3 routing fix: fits previously always rendered a1)."""
    from volumerenderingproject.models.raycast import render_test
    from volumerenderingproject.utils.config import Algorithm

    volume, tf, cam, cfg, _ = scene
    cfg5 = dataclasses.replace(cfg, algorithm=Algorithm.TEST)
    # target rendered with perturbed colors; fit must converge toward it
    tf_true = dataclasses.replace(
        tf, colors=jnp.clip(tf.colors + 0.12, 0.0, 1.0))
    target = render_test(volume, tf_true, cam, cfg5, mode="fast")
    params, losses = fit_transfer_function(
        volume, cam, target, tf, cfg5, steps=40, learning_rate=2e-2)
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])
    # and the loss is measured against the a5 render, not a1
    img_fit = render_test(
        volume, dataclasses.replace(tf, colors=params.tf_colors),
        cam, cfg5, mode="fast")
    err_fit = float(jnp.mean((img_fit[..., :3] - target[..., :3]) ** 2))
    assert abs(err_fit - losses[-1]) < max(5e-3, 0.5 * losses[-1])


def test_mesh_kernel_fit_grads_match_single(scene, monkeypatch):
    """The mesh x kernel fit path: render_loss over a rays x samples mesh
    — density folded into the TF alpha column, traced colours + density —
    differentiated through the fused march's segments (interpret mode;
    on a GPU backend render_vrc_sharded takes them automatically) matches
    the single-device gradients."""
    import functools

    from jax.sharding import Mesh

    from volumerenderingproject.ops import gpu_march

    volume, tf, cam, cfg, target = scene
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    cfg2 = dataclasses.replace(cfg, width=16, samples_per_ray=30)
    target2 = target[:16]
    params = FitParams.init(tf)
    gs = jax.grad(render_loss)(params, tf, volume, cam, target2, cfg2)

    calls = []
    seg = gpu_march.render_vrc_segment

    def spy(*a, **k):
        calls.append(1)
        return seg(*a, interpret=True, **k)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", spy)
    gm = jax.grad(render_loss)(params, tf, volume, cam, target2, cfg2, mesh)
    assert calls
    np.testing.assert_allclose(np.asarray(gm.tf_colors),
                               np.asarray(gs.tf_colors), rtol=2e-4, atol=1e-6)
    assert abs(float(gs.density_scale)) > 0.0
    np.testing.assert_allclose(float(gm.density_scale),
                               float(gs.density_scale), rtol=2e-4)


def test_a5_mesh_fit_grads_match_single(scene):
    """a5 fits over a mesh: render_loss with a
    TEST-algorithm config + mesh produces the same color/density grads
    as the single-device path (the XLA a5 scan segments)."""
    from jax.sharding import Mesh

    from volumerenderingproject.utils.config import Algorithm

    volume, tf, cam, cfg, target = scene
    devs = np.array(jax.devices()[:4]).reshape(2, 2, 1)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    cfg5 = dataclasses.replace(cfg, width=16, samples_per_ray=30,
                               algorithm=Algorithm.TEST)
    target2 = target[:16]
    params = FitParams.init(tf)

    g_single = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg5)
    g_mesh = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg5, mesh)
    assert float(jnp.abs(g_single.tf_colors).sum()) > 0
    np.testing.assert_allclose(
        np.asarray(g_mesh.tf_colors), np.asarray(g_single.tf_colors),
        rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g_mesh.density_scale),
        np.asarray(g_single.density_scale), rtol=2e-4, atol=1e-6)


def test_volume_mesh_fit_grads_match_single(scene):
    """Volume-axis mesh fits: render_loss over a ("rays", "samples",
    "volume") mesh with volume > 1 matches the single-device gradients
    (the XLA slab scan segments)."""
    from jax.sharding import Mesh

    from volumerenderingproject import make_volume

    _, tf, cam, cfg, target = scene
    rng = np.random.default_rng(5)
    volume = make_volume(  # even x so the axis divides it
        rng.uniform(0, 255, size=(8, 11, 10)).astype(np.float32))
    devs = np.array(jax.devices()[:4]).reshape(2, 1, 2)
    mesh = Mesh(devs, ("rays", "samples", "volume"))
    cfg2 = dataclasses.replace(cfg, width=16, samples_per_ray=30)
    target2 = target[:16]
    params = FitParams.init(tf)

    g_single = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg2)
    g_mesh = jax.grad(render_loss)(
        params, tf, volume, cam, target2, cfg2, mesh)
    np.testing.assert_allclose(
        np.asarray(g_mesh.tf_colors), np.asarray(g_single.tf_colors),
        rtol=2e-4, atol=1e-6)
