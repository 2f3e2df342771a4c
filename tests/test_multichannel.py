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
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models.raycast import render_vrc
from volumerenderingproject.parallel.mesh import make_mesh
from volumerenderingproject.parallel.render_dist import render_vrc_sharded


def _scene():
    volume = synthetic.rgb_sphere(16)
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=16, height=12, samples_per_ray=20)
    return volume, tf, cam, cfg


def test_rgb_sphere_fixture():
    volume = synthetic.rgb_sphere(16)
    assert volume.channels == 3
    assert volume.dims == (16, 16, 16)
    data = np.asarray(volume.data)
    # channel values encode position at the center voxel
    np.testing.assert_allclose(
        data[8, 8, 8], [8 / 16 * 255] * 3, rtol=1e-6
    )
    assert (data[0, 0, 0] == 0).all()


def test_multichannel_render_runs_and_colors():
    volume, tf, cam, cfg = _scene()
    img = np.asarray(render_vrc(volume, tf, cam, cfg))
    assert np.isfinite(img).all()
    fg = np.abs(img[..., :3] - 0.2).max(axis=-1) > 0.05
    assert fg.any()
    # channels differ (colorful render, not grayscale)
    fg_px = img[fg]
    assert np.abs(fg_px[:, 0] - fg_px[:, 1]).max() > 0.01


def test_multichannel_sharded_matches_single():
    volume, tf, cam, cfg = _scene()
    mesh = make_mesh(rays=4, samples=2, volume=1)
    single = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    sharded = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_multichannel_volume_axis_matches():
    """Round 1 rejected this; round 2 shards multi-channel a1 over x-slabs
    (exactly-one-owner per sample).  Non-a1 multi-channel modes still
    reject (no multi-channel sampler exists for them)."""
    import pytest

    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.utils.config import Interp

    volume, tf, cam, cfg = _scene()
    mesh = make_mesh(rays=2, samples=1, volume=4)
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg, mesh))
    want = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(NotImplementedError):
        render_vrc_sharded(
            volume, tf, cam, cfg.replace(interp=Interp.TRILINEAR_COLOR),
            mesh)


def test_multichannel_gradients_flow():
    import jax

    volume, tf, cam, cfg = _scene()

    def loss(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        return jnp.mean(render_vrc(volume, tf2, cam, cfg)[..., :3])

    g = np.asarray(jax.grad(loss)(tf.colors))
    assert np.isfinite(g).all()
    # only alphas influence a multichannel render (rgb comes from data)
    assert np.abs(g[:, 3]).sum() > 0


def test_4d_nifti_roundtrip(tmp_path):
    import struct

    from volumerenderingproject.ingest import load_nifti

    dims = (4, 5, 6, 3)
    data = np.arange(np.prod(dims), dtype=np.float32)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 4, *dims, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<f", hdr, 108, 352.0)
    p = tmp_path / "t4.nii"
    with open(p, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(data.tobytes())
    vol = load_nifti(p, backend="python")
    assert vol.dims == (4, 5, 6)
    assert vol.channels == 3
    # channel-major file order -> [X,Y,Z,C]
    arr = np.asarray(vol.data)
    np.testing.assert_array_equal(
        arr[..., 0], data.reshape(3, 4, 5, 6)[0]
    )


def test_multichannel_volume_axis_sharding():
    """Round 2: multi-channel volumes shard over x-slabs too (round 1
    rejected the volume axis for channels > 1)."""
    import jax.numpy as jnp

    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded,
    )

    rng = np.random.default_rng(13)
    vol = make_volume(
        rng.uniform(0, 255, size=(8, 6, 5, 3)).astype(np.float32))
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.4, 0.3, 0.9))
    cfg = RenderConfig(width=8, height=6, samples_per_ray=16)
    want = np.asarray(render_vrc(vol, tf, cam, cfg, mode="fast"))
    for axes in (dict(rays=2, samples=1, volume=4),
                 dict(rays=1, samples=2, volume=2)):
        mesh = make_mesh(**axes)
        got = np.asarray(render_vrc_sharded(vol, tf, cam, cfg, mesh))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(axes))


def _mc_volumes():
    rng = np.random.default_rng(9)
    vols = {3: synthetic.rgb_sphere(16)}
    for c in (2, 4):
        vols[c] = make_volume(
            rng.uniform(0, 255, (10, 11, 9, c)).astype(np.float32))
    return vols


def _np_multichannel_render(volume, tf, cam, cfg):
    """Numpy front-to-back march of the multichannel semantics: rgb from
    the first three channels (channel 0 as grey for C < 3), alpha from
    the TF of the channel mean, on the a1 sampler's voxel indices."""
    from volumerenderingproject.models import raycast
    from volumerenderingproject.ops import sampling

    data = np.asarray(volume.data).reshape(-1, volume.channels)
    origins = np.asarray(raycast.ray_origins(cam, cfg))
    dirs = np.asarray(raycast.primary_ray_dirs(cam, cfg))
    c = np.zeros(origins.shape, np.float32)
    t = np.ones(origins.shape[:-1] + (1,), np.float32)
    for i in range(cfg.samples_per_ray):
        pos = origins + np.float32(i * cfg.sample_distance) * dirs
        flat, valid = sampling.octree_nn_index(
            volume.dims, volume.octree_depth, jnp.asarray(pos + 0.5))
        v = data[np.asarray(flat)] * np.asarray(valid)[..., None]
        norm = np.maximum(v, 0.0) / 255.0
        rgb = norm[..., :3] if volume.channels >= 3 else np.repeat(
            norm[..., :1], 3, -1)
        a = np.asarray(tf.classify(jnp.asarray(norm.mean(-1))))[..., 3:4]
        c = c + t * a * rgb
        t = t * (1.0 - a)
    return c + t * np.float32(cfg.background[:3])


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_multichannel_semantics(channels, monkeypatch):
    """The scan's multichannel render equals a numpy march of the
    semantics, and a GPU backend keeps multichannel volumes on the scan."""
    from volumerenderingproject.models.raycast import render
    from volumerenderingproject.ops import gpu_march

    volume = _mc_volumes()[channels]
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.3, 0.4, 0.9))
    cfg = RenderConfig(width=16, height=12, samples_per_ray=20)
    got = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    want = _np_multichannel_render(volume, tf, cam, cfg)
    np.testing.assert_allclose(got[..., :3], want, atol=2e-5)
    assert np.abs(want - 0.2).max() > 0.05  # the volume is in view
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not gpu_march.eligible(volume, cfg)
    np.testing.assert_array_equal(np.asarray(render(volume, tf, cam, cfg)),
                                  got)


@pytest.mark.parametrize("axes", [dict(rays=4, samples=1, volume=1),
                                  dict(rays=2, samples=2, volume=1)], ids=str)
def test_multichannel_segments_sharded(axes):
    """Multichannel work units under shard_map (rays/samples axes) match
    the single-device render."""
    volume, tf, cam, cfg = _scene()
    want = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    got = np.asarray(render_vrc_sharded(volume, tf, cam, cfg,
                                        make_mesh(**axes)))
    np.testing.assert_allclose(got, want, atol=1e-5)
