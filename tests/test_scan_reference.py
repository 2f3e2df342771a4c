"""The XLA scan against the per-sample loop reference (tests/
reference_impl.py) on the geometries the fused kernels used to be tested
on: non-square images, long z columns, spheres, the a5 flat-index wrap,
and the head phantom.  The scan is the renderer every path falls back to, and
the reference the fused GPU march is held to."""

import numpy as np
import pytest

from volumerenderingproject import (
    Algorithm,
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
    render_test,
    render_vrc,
)
from volumerenderingproject.ingest import synthetic

from reference_impl import py_render_test, py_render_vrc
from test_render import _cam_dict, _cfg_dict, _intervals


def _volume(name):
    rng = np.random.default_rng(17)
    if name == "random":
        return rng.uniform(0.0, 255.0, (10, 12, 11)).astype(np.float32)
    if name == "sphere":
        return np.asarray(synthetic.centered_sphere(24).data)
    if name == "long_z":  # z the longest axis, as in sagittal stacks
        return rng.uniform(0.0, 255.0, (6, 7, 30)).astype(np.float32)
    if name == "phantom":
        return np.asarray(synthetic.head_phantom((12, 14, 12), seed=5).data)
    if name == "wrap":
        # the a5 z+1 tap of (2, 2, 5) wraps to (2, 3, 0) (kernel.cu:129-159)
        vol = np.zeros((6, 6, 6), np.float32)
        vol[2, 3, 0] = 150.0
        vol[2, 2, 5] = 150.0
        return vol
    raise KeyError(name)


CASES = {
    "a1_random_nonsquare": ("random", Algorithm.VRC, (13, 7, 20)),
    "a1_sphere": ("sphere", Algorithm.VRC, (11, 9, 24)),
    "a1_long_z": ("long_z", Algorithm.VRC, (9, 8, 30)),
    "a1_phantom": ("phantom", Algorithm.VRC, (10, 10, 24)),
    "a5_random_nonsquare": ("random", Algorithm.TEST, (11, 7, 16)),
    "a5_sphere": ("sphere", Algorithm.TEST, (9, 9, 14)),
    "a5_long_z": ("long_z", Algorithm.TEST, (8, 7, 16)),
    "a5_wrap_quirk": ("wrap", Algorithm.TEST, (12, 12, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_matches_loop_reference(name):
    vname, alg, (w, h, spr) = CASES[name]
    vol_np = _volume(vname)
    volume = make_volume(vol_np, cal_max=255.0)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = RenderConfig(width=w, height=h, samples_per_ray=spr,
                       algorithm=alg)
    args = (vol_np, _intervals(tf), 255.0, _cam_dict(cam), _cfg_dict(cfg))
    if alg is Algorithm.TEST:
        want = py_render_test(*args)
        got = np.asarray(render_test(volume, tf, cam, cfg, mode="fast"))
    else:
        want = py_render_vrc(*args)
        got = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert np.abs(want[..., :3] - 0.2).max() > 0.02  # not background only
