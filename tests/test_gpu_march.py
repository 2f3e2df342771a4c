"""The fused GPU a1 march (ops/gpu_march.py) in Pallas interpret mode,
against the XLA scan it replaces on the card.

The kernel is the Triton route's; ``interpret=True`` runs the same kernel
body on the CPU.  The scan is ``raycast.render_vrc(mode="fast")``, whose
float order the kernel mirrors, so eps = 0 agrees to rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumerenderingproject import (
    Camera,
    RenderConfig,
    default_transfer_function,
    make_volume,
    reset_preset,
)
from volumerenderingproject.ingest import synthetic
from volumerenderingproject.models import raycast
from volumerenderingproject.ops import gpu_march

PHANTOM = (23, 27, 23)  # the MNI-1mm grid cut 8x per axis


@pytest.fixture(scope="module")
def phantom():
    return synthetic.head_phantom(PHANTOM, seed=3)


def _tf_alpha0():
    """Interval 0 (the fallback, and every out-of-volume sample) visible."""
    tf = default_transfer_function()
    return dataclasses.replace(tf, colors=tf.colors.at[0, 3].set(0.05))


def _march(volume, tf, cam, cfg, **kw):
    return np.asarray(gpu_march.render_vrc(volume, tf, cam, cfg,
                                           interpret=True, **kw))


def _scan(volume, tf, cam, cfg):
    return np.asarray(raycast.render_vrc(volume, tf, cam, cfg, mode="fast"))


BASE = RenderConfig(width=24, height=20, samples_per_ray=64)

CASES = {
    "ortho": (BASE, {}),
    "conic": (BASE.replace(conic=True), {}),
    "eps": (BASE.replace(early_termination=1e-3), {}),
    "conic_eps": (BASE.replace(conic=True, early_termination=1e-3), {}),
    "lut64": (BASE.replace(tf_lut=64), {}),
    "lut300": (BASE.replace(tf_lut=300), {}),
    "density": (BASE.replace(density_scale=0.6), {}),
    "odd_width_padding": (BASE.replace(width=37, height=29),
                          {"block_rays": 64}),
    "block32": (BASE, {"block_rays": 32}),
    "front_clip": (BASE.replace(front_clip=0.3), {}),
    "no_skipping": (BASE.replace(empty_space_skipping=False), {}),
    "chunk_of_one": (BASE.replace(samples_per_ray=5), {}),
    "ragged_chunks": (BASE.replace(samples_per_ray=61), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_march_matches_scan(phantom, name):
    cfg, kw = CASES[name]
    tf = default_transfer_function()
    cam = reset_preset()
    got = _march(phantom, tf, cam, cfg, **kw)
    want = _scan(phantom, tf, cam, cfg)
    assert got.shape == (cfg.width, cfg.height, 4)
    # eps bounds the early-termination error by eps * max(colour, bg)
    tol = 2e-5 + cfg.early_termination
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.abs(want[..., :3] - 0.2).max() > 0.1  # the head is in view


@pytest.mark.parametrize("conic", [False, True])
def test_alpha0_guard(phantom, conic):
    """TF(0).alpha > 0 makes out-of-volume samples visible: the box clip
    and the occupancy skip must turn themselves off."""
    tf = _tf_alpha0()
    cfg = BASE.replace(conic=conic)
    got = _march(phantom, tf, reset_preset(), cfg)
    want = _scan(phantom, tf, reset_preset(), cfg)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pos", [(0.4, 0.3, 0.9), (-0.9, 0.2, -0.3)])
def test_sphere_scene(pos):
    volume = synthetic.centered_sphere(32)
    tf = default_transfer_function()
    cam = Camera.initial(position=pos)
    cfg = RenderConfig(width=20, height=16, samples_per_ray=48)
    np.testing.assert_allclose(_march(volume, tf, cam, cfg),
                               _scan(volume, tf, cam, cfg), atol=2e-5,
                               rtol=0)


def test_occupancy_skip_is_exact(phantom):
    """Skipping drops only samples of alpha 0: skip on == skip off."""
    tf = default_transfer_function()
    cfg = BASE.replace(samples_per_ray=96)
    on = _march(phantom, tf, reset_preset(), cfg)
    off = _march(phantom, tf, reset_preset(),
                 cfg.replace(empty_space_skipping=False))
    np.testing.assert_array_equal(on, off)


def test_occupancy_skip_engages(phantom, monkeypatch):
    """With every brick reported empty, every chunk is skipped and the
    image is the background: the skip path runs."""
    monkeypatch.setattr(gpu_march, "brick_occupancy",
                        lambda vn, alpha_fn: jnp.zeros(
                            tuple(-(-d // 8) + 2 for d in vn.shape),
                            jnp.int32))
    cfg = BASE
    img = _march(phantom, default_transfer_function(), reset_preset(), cfg)
    np.testing.assert_array_equal(
        img, np.broadcast_to(np.float32(cfg.background), img.shape))


SEGMENTS = {
    "full": (0, None, 0, None),
    "columns": (8, 8, 0, None),
    "samples": (0, None, 20, 17),
    "both": (16, 8, 40, 24),
}


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segment_matches_scan_segment(phantom, name):
    """The (C, T) work unit of the rays/samples mesh axes."""
    x_off, lw, s0, sc = SEGMENTS[name]
    tf = default_transfer_function()
    cam = reset_preset()
    kw = dict(x_offset=x_off, local_width=lw, s_start=s0, s_count=sc)
    c1, t1 = gpu_march.render_vrc_segment(phantom, tf, cam, BASE,
                                          interpret=True, **kw)
    c2, t2 = raycast.render_vrc_segment(phantom, tf, cam, BASE, **kw)
    w = BASE.width if lw is None else lw
    assert c1.shape == (w, BASE.height, 3) and t1.shape == (w, BASE.height, 1)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=2e-5)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=2e-5)


@pytest.mark.parametrize("wrt", ["colors", "density", "volume"])
def test_gradient_is_the_scans(phantom, wrt):
    """jax.grad through the fused march (custom_vjp) equals jax.grad
    through the XLA scan."""
    tf = default_transfer_function()
    cam = reset_preset()
    cfg = BASE.replace(width=16, height=12, samples_per_ray=40)
    target = jnp.zeros((cfg.width, cfg.height, 3), jnp.float32)

    def loss(x, fused):
        vol, tf2 = phantom, tf
        if wrt == "colors":
            tf2 = dataclasses.replace(tf, colors=x)
        elif wrt == "density":
            tf2 = dataclasses.replace(tf, colors=tf.colors.at[:, 3].mul(x))
        else:
            vol = phantom.with_data(x)
        if fused:
            img = gpu_march.render_vrc(vol, tf2, cam, cfg, interpret=True)
        else:
            img = raycast.render_vrc(vol, tf2, cam, cfg, mode="fast")
        return jnp.mean((img[..., :3] - target) ** 2)

    x0 = {"colors": tf.colors, "density": jnp.float32(0.9),
          "volume": phantom.data}[wrt]
    g_fused = np.asarray(jax.grad(loss)(x0, True))
    g_scan = np.asarray(jax.grad(loss)(x0, False))
    if wrt != "volume":  # NN sampling: zero volume gradient a.e.
        assert np.abs(g_scan).sum() > 0
    np.testing.assert_allclose(g_fused, g_scan, rtol=1e-6, atol=1e-9)


def test_render_dispatch_routes_to_march(phantom, monkeypatch):
    """On a GPU backend render() takes the fused march; mode="xla" and
    lit renders keep the scan."""
    calls = []
    seg = gpu_march.render_vrc_segment

    def spy(*a, **k):
        calls.append(1)
        return seg(*a, interpret=True, **k)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", spy)
    tf, cam, cfg = default_transfer_function(), reset_preset(), BASE
    got = np.asarray(raycast.render(phantom, tf, cam, cfg))
    assert calls == [1]
    np.testing.assert_allclose(got, _scan(phantom, tf, cam, cfg), atol=2e-5)
    raycast.render(phantom, tf, cam, cfg, mode="xla")
    raycast.render(phantom, tf, cam, cfg.replace(lighting=True))
    assert calls == [1]


def _eligible_cases():
    from volumerenderingproject.utils.config import Algorithm, Interp

    base = RenderConfig(width=8, height=8, samples_per_ray=8)
    return {
        "a1": (base, {}, True),
        "a1_lut": (base.replace(tf_lut=256), {}, True),
        "a1_conic": (base.replace(conic=True), {}, True),
        "a1_eps": (base.replace(early_termination=1e-3), {}, True),
        "reference_order": (base, {"mode": "reference"}, False),
        "lighting": (base.replace(lighting=True), {}, False),
        "scattering": (base.replace(scattering=True), {}, False),
        "a5": (base.replace(algorithm=Algorithm.TEST), {}, False),
        "point": (base.replace(algorithm=Algorithm.POINT), {}, False),
        "trilinear": (base.replace(interp=Interp.TRILINEAR), {}, False),
        "trilinear_color": (base.replace(interp=Interp.TRILINEAR_COLOR), {},
                            False),
        "explicit_light": (base, {"light": object()}, False),
        "multichannel": (base, {"channels": 3}, False),
    }


@pytest.mark.parametrize("name", sorted(_eligible_cases()))
def test_eligible_predicate(monkeypatch, name):
    cfg, kw, want = _eligible_cases()[name]
    shape = (4, 4, 4, kw.pop("channels")) if "channels" in kw else (4, 4, 4)
    vol = make_volume(np.zeros(shape, np.float32))
    assert not gpu_march.eligible(vol, cfg, **kw)  # the CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert gpu_march.eligible(vol, cfg, **kw) is want


@pytest.mark.parametrize("cfg", [
    BASE, BASE.replace(tf_lut=256, conic=True),
    BASE.replace(density_scale=0.5, early_termination=1e-3),
], ids=["plain", "lut_conic", "density_eps"])
def test_lowers_through_triton(phantom, cfg):
    """The kernel lowers to Triton IR for CUDA without a card (the PTX
    compile happens on the GPU)."""
    from jax import export

    fn = jax.jit(lambda v, t, c: gpu_march.render_vrc(v, t, c, cfg))
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(phantom, default_transfer_function(), reset_preset())
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.parametrize("spr,dims", [
    (500, (182, 218, 182)), (250, (182, 218, 182)), (500, (91, 109, 91)),
    (64, (23, 27, 23)), (5, (23, 27, 23)), (2000, (512, 512, 512)),
])
def test_chunk_samples_bound(spr, dims):
    """A chunk spans at most 11 voxels, so every sample's voxel lies
    within one brick of the chunk midpoint's brick."""
    cfg = RenderConfig(samples_per_ray=spr)
    s = gpu_march.chunk_samples(cfg, dims)
    assert s >= 1 and s & (s - 1) == 0 and s <= 16
    assert s == 1 or (s - 1) * cfg.sample_distance * max(dims) <= 11.0


def test_brick_occupancy_is_dilated():
    rng = np.random.default_rng(0)
    vn = (rng.uniform(size=(20, 13, 9)) > 0.995).astype(np.float32)
    occ = np.asarray(gpu_march.brick_occupancy(jnp.asarray(vn),
                                               lambda v: v))
    nb = [-(-d // 8) for d in vn.shape]
    assert occ.shape == tuple(n + 2 for n in nb)
    raw = np.zeros(nb, bool)
    for i, j, k in zip(*np.nonzero(vn)):
        raw[i // 8, j // 8, k // 8] = True
    want = np.zeros([n + 2 for n in nb], bool)
    for i, j, k in zip(*np.nonzero(raw)):
        want[i:i + 3, j:j + 3, k:k + 3] = True
    np.testing.assert_array_equal(occ.astype(bool), want)


def test_round_half_even_matches_jnp_round():
    x = jnp.asarray(np.concatenate([
        np.arange(0, 600, dtype=np.float32) * 0.5,
        np.random.default_rng(1).uniform(0, 4095, 1000).astype(np.float32),
    ]))
    np.testing.assert_array_equal(np.asarray(gpu_march._round_half_even(x)),
                                  np.asarray(jnp.round(x)))


def test_rejects_non_power_of_two_block(phantom):
    with pytest.raises(ValueError):
        gpu_march.render_vrc_segment(phantom, default_transfer_function(),
                                     reset_preset(), BASE, block_rays=96,
                                     interpret=True)


def test_sharded_march_matches_single(phantom, monkeypatch):
    """The fused march as the rays/samples work unit under shard_map."""
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import render_vrc_sharded

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(gpu_march, "render_vrc_segment", functools.partial(
        gpu_march.render_vrc_segment, interpret=True))
    tf, cam, cfg = default_transfer_function(), reset_preset(), BASE
    mesh = make_mesh(rays=2, samples=2, volume=1,
                     devices=jax.devices()[:4])
    got = np.asarray(render_vrc_sharded(phantom, tf, cam, cfg, mesh))
    np.testing.assert_allclose(got, _scan(phantom, tf, cam, cfg), atol=2e-5)
