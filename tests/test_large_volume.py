"""MNI152-1mm-scale coverage (BASELINE config 3): the real file is absent
from the reference checkout (.MISSING_LARGE_BLOBS:1), so a synthetic volume
with the same geometry (182x218x182, longest dim 218 -> octree depth 8)
exercises the same code paths."""

import numpy as np
import jax.numpy as jnp
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.accel import pyramid
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.ops import sampling


@pytest.fixture(scope="module")
def mni_like():
    rng = np.random.default_rng(42)
    dims = (182, 218, 182)
    coords = [np.arange(d, dtype=np.float32) for d in dims]
    x, y, z = np.meshgrid(*coords, indexing="ij")
    c = [d / 2.0 for d in dims]
    r2 = (
        ((x - c[0]) / 80.0) ** 2
        + ((y - c[1]) / 100.0) ** 2
        + ((z - c[2]) / 80.0) ** 2
    )
    head = (r2 <= 1.0).astype(np.float32)
    data = head * (60.0 + 150.0 * np.exp(-r2 * 2.0)).astype(np.float32)
    return make_volume(data, cal_max=255.0)


def test_depth8_geometry(mni_like):
    assert mni_like.longest_dimension == 218
    assert mni_like.octree_depth == 8  # Octree.cu:40-41: 2^8 = 256 >= 218


def test_depth8_sampler_matches_direct(mni_like):
    """At depth 8 the dyadic grid (256) is coarser than needed but the
    closed form must still hit the right voxels."""
    data = np.asarray(mni_like.data)
    pts = np.random.default_rng(0).uniform(0.05, 0.95, (200, 3)).astype(np.float32)
    vals = np.asarray(
        sampling.octree_nn_sample(
            jnp.asarray(data.reshape(-1)), mni_like.dims, 8, jnp.asarray(pts)
        )
    )
    # spot-verify against manual computation for a few points
    L, n = 218.0, 256.0
    for p, v in list(zip(pts, vals))[:20]:
        k = np.floor(p.astype(np.float32) * np.float32(n))
        res = (k / np.float32(n)) * np.float32(L)
        dims = np.asarray(mni_like.dims, np.float32)
        ok = np.all(
            (res >= L / 2 - dims / 2) & (res < L / 2 + dims / 2)
        )
        if not ok:
            assert v == 0.0
            continue
        idx = np.trunc((res + dims / 2) - np.float32(L / 2)).astype(int)
        assert v == max(data[tuple(idx)], 0.0)


def test_render_large_volume(mni_like):
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=12, height=12, samples_per_ray=40)
    img = np.asarray(render_vrc(mni_like, tf, cam, cfg))
    assert np.isfinite(img).all()
    assert (np.abs(img[..., :3] - 0.2) > 0.05).any()


def test_pyramid_depth8(mni_like):
    pyr = pyramid.build_pyramid(mni_like)
    assert pyr.depth == 8
    assert pyr.levels_min[0].shape == (256, 256, 256)
    assert float(pyr.root_max()) == float(np.asarray(mni_like.data).max())
    frac = float(pyramid.occupancy_fraction(pyr, 3))
    assert 0 < frac < 1.0


def test_pallas_packed_handles_mni_scale(mni_like):
    """The fused GPU march (Pallas, Triton route) takes the 182x218x182
    grid with the volume flat in device memory — no z-lane or on-chip
    residency limit — and matches the scan."""
    from volumerenderingproject.ops import gpu_march

    tf = default_transfer_function()
    cam = Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = RenderConfig(width=8, height=8, samples_per_ray=12)
    want = np.asarray(render_vrc(mni_like, tf, cam, cfg, mode="fast"))
    got = np.asarray(
        gpu_march.render_vrc(mni_like, tf, cam, cfg, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_diff_pallas_accepts_mni_scale(mni_like):
    """jax.grad through the fused march at MNI-1mm scale equals jax.grad
    through the scan (the custom_vjp's backward is the scan's VJP)."""
    import dataclasses

    import jax

    from volumerenderingproject.ops import gpu_march

    tf = default_transfer_function()
    cam = Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = RenderConfig(width=8, height=8, samples_per_ray=12)

    def loss(colors, fused):
        tf2 = dataclasses.replace(tf, colors=colors)
        if fused:
            img = gpu_march.render_vrc(mni_like, tf2, cam, cfg,
                                       interpret=True)
        else:
            img = render_vrc(mni_like, tf2, cam, cfg, mode="fast")
        return jnp.mean(img[..., :3] ** 2)

    g1 = np.asarray(jax.grad(loss)(tf.colors, True))
    g2 = np.asarray(jax.grad(loss)(tf.colors, False))
    assert np.abs(g2).sum() > 0
    np.testing.assert_allclose(g1, g2, rtol=1e-6, atol=1e-9)
