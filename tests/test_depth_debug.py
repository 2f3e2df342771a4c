"""Depth visualizers (zbuffer shader analog) + debug voxel colorers."""

import numpy as np
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
)
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models import debug_colors, point_splat


@pytest.fixture(scope="module")
def scene():
    volume = synthetic.centered_sphere(24)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=24, height=24, samples_per_ray=24)
    return volume, tf, cam, cfg


def test_point_depth_map(scene):
    """Nearest-voxel window depth per pixel; uncovered pixels read the GL
    clear depth 1.0 (3.3.zbuffershader.fs semantics)."""
    volume, tf, cam, cfg = scene
    img = np.asarray(point_splat.render_points_depth(volume, cam, cfg))
    assert img.shape == (24, 24, 4)
    # grayscale
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    np.testing.assert_array_equal(img[..., 0], img[..., 2])
    d = img[..., 0]
    assert (d == 1.0).any()  # background pixels at clear depth
    covered = d < 1.0
    assert covered.any()
    assert (d[covered] >= 0.0).all() and (d[covered] < 1.0).all()
    # the sphere's nearest face must be nearer than its silhouette edge
    assert d[covered].min() < d[covered].max()


def test_vrc_depth_map(scene):
    volume, tf, cam, cfg = scene
    img = np.asarray(
        point_splat.render_depth_vrc(volume, tf, cam, cfg))
    d = img[..., 0]
    assert np.isfinite(d).all()
    assert (d <= 1.0).all() and (d >= 0.0).all()
    assert d.min() < 1.0  # something was hit


def test_debug_colorers_match_reference_semantics(scene):
    volume, tf, cam, cfg = scene

    rgba = np.asarray(debug_colors.nifti_color_test(volume))
    v = (np.asarray(volume.data).reshape(-1)
         / np.float32(volume.cal_max)).astype(np.float32)
    # spot-check one band: [0.3, 0.4) -> blue
    m = (v >= 0.3) & (v < 0.4)
    if m.any():
        np.testing.assert_array_equal(
            rgba[m],
            np.tile(np.float32([0.0, 0.0, 0.8, 1.0]), (m.sum(), 1)))
    # below 0.1: transparent black
    m0 = v < 0.1
    assert (rgba[m0] == 0).all()

    rgba2 = np.asarray(debug_colors.nifti_color_test2(volume))
    d1, d2, d3 = volume.dims
    x = np.arange(d1 * d2 * d3) // (d2 * d3)
    # x == 0 plane is magenta, overriding intensity (but y/z planes can
    # override it afterwards, reference if-order) — check a voxel with
    # x == 0, y != 0, z != 0
    sel = (x == 0) & (np.arange(d1 * d2 * d3) % (d2 * d3) >= d3 + 1) \
        & (np.arange(d1 * d2 * d3) % d3 != 0)
    assert sel.any()
    np.testing.assert_array_equal(
        rgba2[sel], np.tile([1.0, 0.0, 1.0, 1.0], (sel.sum(), 1)))

    rgba3 = np.asarray(debug_colors.sphere_octants(volume))
    assert rgba3.shape == (volume.totaldim, 4)
    # end caps are inverted background
    zc = np.arange(d1 * d2 * d3) % d3
    caps = (zc == 0) | (zc == d3 - 1)
    np.testing.assert_allclose(
        rgba3[caps], np.tile([0.8, 0.8, 0.8, 1.0], (caps.sum(), 1)))

    # colorers plug into the splatter
    img = np.asarray(
        point_splat.render_points(volume, tf, cam, cfg, rgba=rgba3))
    assert img.shape == (24, 24, 4)
