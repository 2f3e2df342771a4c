"""Render-to-texture quad display (utils/texture.py)."""

import numpy as np

from volumerenderingproject.utils import texture


def test_identity_resample():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (16, 12, 4)).astype(np.float32)
    out = np.asarray(texture.texture_quad_display(img, 16, 12))
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_upscale_interpolates():
    img = np.zeros((2, 2, 3), np.float32)
    img[1, :, :] = 1.0  # right column white
    out = np.asarray(texture.texture_quad_display(img, 8, 8))
    # monotone ramp along x, constant along y
    assert (np.diff(out[:, 0, 0]) >= -1e-6).all()
    np.testing.assert_allclose(out[:, 0], out[:, -1], atol=1e-6)
    # clamp-to-edge: corners equal the source corners
    np.testing.assert_allclose(out[0, 0], img[0, 0], atol=1e-6)
    np.testing.assert_allclose(out[-1, -1], img[1, 1], atol=1e-6)


def test_downscale_averages():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    out = np.asarray(texture.texture_quad_display(img, 8, 8))
    assert out.shape == (8, 8, 3)
    assert abs(out.mean() - img.mean()) < 0.05


def test_stub_blue_parity():
    out = np.asarray(texture.stub_blue(4, 4))
    np.testing.assert_array_equal(out[..., 2], 1.0)
    np.testing.assert_array_equal(out[..., 0], 0.0)


def test_cli_window_flag(tmp_path):
    import sys

    from volumerenderingproject.harness.cli import main
    from volumerenderingproject.utils.imageio import load_png

    out = str(tmp_path / "win.png")
    argv = sys.argv
    sys.argv = ["cli", "render", "--data", "sphere", "--width", "16",
                "--height", "16", "--spr", "8", "--window", "32x32",
                "--out", out]
    try:
        main()
    finally:
        sys.argv = argv
    assert load_png(out).shape == (32, 32, 3)
