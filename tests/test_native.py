import numpy as np
import pytest

from volumerenderingproject import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        try:
            from volumerenderingproject.native.build import build

            build(verbose=False)
        except Exception as e:  # toolchain missing — fallbacks cover users
            pytest.skip(f"native build unavailable: {e}")
    assert native.available()


def test_native_header_matches_python(avg152_path):
    from volumerenderingproject.ingest.nifti import parse_header

    with open(avg152_path, "rb") as f:
        py = parse_header(f.read(1024))
    nat = native.nifti_header(avg152_path)
    assert nat["sizeof_hdr"] == py.sizeof_hdr
    assert nat["datatype"] == py.datatype
    assert tuple(nat["dim"]) == py.dim
    assert nat["vox_offset"] == py.vox_offset
    assert nat["cal_max"] == py.cal_max


def test_native_volume_matches_python(avg152_path):
    from volumerenderingproject.ingest import load_nifti

    v_py = load_nifti(avg152_path, backend="python")
    v_nat = load_nifti(avg152_path, backend="native")
    assert v_nat.dims == v_py.dims
    np.testing.assert_array_equal(np.asarray(v_nat.data), np.asarray(v_py.data))


def test_native_leaf_grid_matches_jax(rng):
    import jax.numpy as jnp

    from volumerenderingproject import make_volume
    from volumerenderingproject.accel import pyramid

    vol = rng.uniform(0, 255, size=(5, 7, 6)).astype(np.float32)
    volume = make_volume(vol)
    want = np.asarray(pyramid.leaf_grid(volume))
    got = native.leaf_grid(vol, volume.octree_depth)
    np.testing.assert_array_equal(got, want)


def test_native_pyramid_matches_jax(rng):
    from volumerenderingproject import make_volume
    from volumerenderingproject.accel import pyramid

    vol = rng.uniform(0, 255, size=(8, 8, 8)).astype(np.float32)
    volume = make_volume(vol)
    pyr = pyramid.build_pyramid(volume)
    mins, maxs = native.build_pyramid(vol, volume.octree_depth)
    assert len(mins) == len(pyr.levels_min)
    for a, b in zip(mins, pyr.levels_min):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(maxs, pyr.levels_max):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_native_conv3d_matches_jax(rng):
    import jax.numpy as jnp

    from volumerenderingproject.ops import conv3d as jconv

    vol = rng.uniform(0, 1, size=(6, 7, 8)).astype(np.float32)
    k = np.asarray(jconv.reference_kernel())
    want = np.asarray(jconv.conv3d(jnp.asarray(vol), jnp.asarray(k)))
    got = native.conv3d(vol, k)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_native_nifti1_and_bigendian(tmp_path):
    import struct

    dims = (4, 5, 6)
    data = np.arange(np.prod(dims), dtype=">i2").reshape(dims)  # big-endian int16
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, *dims, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)  # int16
    struct.pack_into(">h", hdr, 72, 16)
    struct.pack_into(">f", hdr, 108, 352.0)
    p = tmp_path / "be.nii"
    with open(p, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(data.tobytes())
    hdr_nat, flat = native.nifti_read(str(p))
    assert hdr_nat["swapped"] is True
    np.testing.assert_array_equal(
        flat.reshape(dims), data.astype(np.float32)
    )


def test_point_rasterize_draw_order_blending():
    """Two translucent points on the same pixel: the first drawn passes the
    depth test and blends over background; a later, *nearer* point blends on
    top (GL_LESS passes), while a later, farther point is rejected."""
    bg = np.asarray([0.2, 0.2, 0.2, 1.0], np.float32)
    # point A at depth 0.5, point B nearer (0.0), point C farther (0.9)
    ndc = np.asarray(
        [[0.0, 0.0, 0.0], [0.0, 0.0, -0.5], [0.0, 0.0, 0.8]], np.float32
    )
    rgba = np.asarray(
        [[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, 0.5]], np.float32
    )
    img = native.point_rasterize(ndc, rgba, 4, 4, bg)
    px = img[2, 1]  # ndc(0,0) -> window (2,2) -> image row 4-1-2=1
    # A over bg: 0.5*red + 0.5*bg; then B (nearer) over that
    after_a = 0.5 * rgba[0, :3] + 0.5 * bg[:3]
    want = 0.5 * rgba[1, :3] + 0.5 * after_a
    np.testing.assert_allclose(px[:3], want, rtol=1e-6)


def test_point_rasterize_matches_jax_approx_on_sphere():
    from volumerenderingproject import (
        Camera,
        RenderConfig,
        default_transfer_function,
    )
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.models.point_splat import render_points

    volume = synthetic.centered_sphere(24)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=24, height=24)
    exact = np.asarray(render_points(volume, tf, cam, cfg, exact=True))
    approx = np.asarray(render_points(volume, tf, cam, cfg))
    assert np.isfinite(exact).all()
    # the approximation should agree on most pixels (single-layer regions)
    close = np.isclose(exact[..., :3], approx[..., :3], atol=0.2).all(-1)
    assert close.mean() > 0.7
