"""Gradients through render_vrc_sharded equal the single-device scan's, on
every mesh axis: the fused GPU march's segments (interpret mode, custom_vjp
whose backward is the scan segment's VJP) on rays/samples meshes, the XLA
slab segments on volume meshes, lit (with light parameters) and a5."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumerenderingproject import Camera, RenderConfig, make_volume
from volumerenderingproject import default_transfer_function
from volumerenderingproject.models.raycast import render_test, render_vrc
from volumerenderingproject.ops import gpu_march, phong
from volumerenderingproject.parallel.mesh import make_mesh
from volumerenderingproject.parallel.render_dist import render_vrc_sharded
from volumerenderingproject.utils.config import Algorithm


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    vol_np = rng.uniform(0.0, 255.0, size=(8, 10, 9)).astype(np.float32)
    volume = make_volume(vol_np)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.4, 0.3, 0.9))
    cfg = RenderConfig(width=16, height=6, samples_per_ray=24)
    return volume, tf, cam, cfg


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", functools.partial(
        gpu_march.render_vrc_segment, interpret=True))


def _color_grads(volume, tf, cam, cfg, mesh=None):
    target = jnp.zeros((cfg.width, cfg.height, 3), jnp.float32)
    render = render_test if cfg.algorithm is Algorithm.TEST else render_vrc

    def loss(colors):
        tf2 = dataclasses.replace(tf, colors=colors)
        if mesh is None:
            img = render(volume, tf2, cam, cfg, mode="fast")
        else:
            img = render_vrc_sharded(volume, tf2, cam, cfg, mesh)
        return jnp.mean((img[..., :3] - target) ** 2)

    return np.asarray(jax.grad(loss)(tf.colors))


@pytest.mark.parametrize("axes", [(2, 2, 1), (4, 1, 1), (1, 4, 1)], ids=str)
def test_diff_segments_grads_match_single(scene, fused, axes):
    """Fused-march work units: forward and TF-colour gradients."""
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=axes[0], samples=axes[1], volume=axes[2])
    want = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    g1 = _color_grads(volume, tf, cam, cfg)
    assert np.abs(g1).sum() > 0
    np.testing.assert_allclose(_color_grads(volume, tf, cam, cfg, mesh), g1,
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("axes", [(1, 1, 4), (2, 1, 2), (1, 2, 2)], ids=str)
def test_diff_segments_volume_slab(scene, fused, axes):
    """Volume-slab work units (the XLA scan's) under the same loss."""
    volume, tf, cam, cfg = scene
    mesh = make_mesh(rays=axes[0], samples=axes[1], volume=axes[2])
    np.testing.assert_allclose(
        _color_grads(volume, tf, cam, cfg, mesh),
        _color_grads(volume, tf, cam, cfg), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("extra", [{}, {"gradient_filter": "sobel"},
                                   {"presmooth_sigma": 1.0}], ids=str)
def test_diff_segments_volume_slab_lit(scene, extra):
    """Lit slab segments: gradient normals through the exchanged x-halo
    give the replicated lit gradients for central, Sobel and presmoothed
    normals."""
    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(lighting=True, **extra)
    mesh = make_mesh(rays=1, samples=1, volume=4)
    np.testing.assert_allclose(
        _color_grads(volume, tf, cam, cfg2, mesh),
        _color_grads(volume, tf, cam, cfg2), rtol=1e-4, atol=1e-6)


def test_diff_segments_lit_light_grads(scene):
    """TF-colour and light-parameter gradients through lit scan segments
    on a rays x samples mesh match the single-device scan."""
    volume, tf, cam, cfg = scene
    cfg2 = cfg.replace(lighting=True)
    mesh = make_mesh(rays=2, samples=2, volume=1)
    target = jnp.zeros((cfg.width, cfg.height, 3), jnp.float32)
    lvec = phong.light_to_vec(phong.default_light())

    def loss(colors, lv, sharded):
        tf2 = dataclasses.replace(tf, colors=colors)
        lgt = phong.light_from_vec(lv)
        if sharded:
            img = render_vrc_sharded(volume, tf2, cam, cfg2, mesh, light=lgt)
        else:
            img = render_vrc(volume, tf2, cam, cfg2, mode="fast", light=lgt)
        return jnp.mean((img[..., :3] - target) ** 2)

    gc1, gl1 = jax.grad(loss, argnums=(0, 1))(tf.colors, lvec, False)
    gc2, gl2 = jax.grad(loss, argnums=(0, 1))(tf.colors, lvec, True)
    assert np.abs(np.asarray(gl1)).sum() > 0
    np.testing.assert_allclose(np.asarray(gc2), np.asarray(gc1),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gl2), np.asarray(gl1),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("axes", [(2, 2, 1), (1, 4, 1), (2, 1, 2)], ids=str)
def test_diff_segments_a5(scene, axes):
    volume, tf, cam, cfg = scene
    cfg5 = cfg.replace(algorithm=Algorithm.TEST)
    mesh = make_mesh(rays=axes[0], samples=axes[1], volume=axes[2])
    g1 = _color_grads(volume, tf, cam, cfg5)
    assert np.abs(g1).sum() > 0
    np.testing.assert_allclose(_color_grads(volume, tf, cam, cfg5, mesh), g1,
                               rtol=1e-4, atol=1e-7)
