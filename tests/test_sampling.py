import numpy as np
import jax.numpy as jnp
import pytest

from volumerenderingproject.ops import sampling

from reference_impl import PyOctree


def _random_volume(rng, dims):
    return rng.uniform(0.0, 255.0, size=dims).astype(np.float32)


def test_octree_nn_matches_octree_query(rng):
    dims = (5, 7, 6)  # non-cubic, L=7, depth 3
    vol = _random_volume(rng, dims)
    octree = PyOctree(vol)
    assert octree.depth == 3

    pts = rng.uniform(-0.2, 1.2, size=(500, 3)).astype(np.float32)
    want = np.array([octree.get_intensity(p) for p in pts], np.float32)
    got = np.asarray(
        sampling.octree_nn_sample(
            jnp.asarray(vol.reshape(-1)), dims, octree.depth, jnp.asarray(pts)
        )
    )
    np.testing.assert_array_equal(got, want)


def test_octree_nn_dyadic_boundaries(rng):
    """Query exactly on leaf boundaries (dyadic points) — the half-open
    node intervals must resolve identically."""
    dims = (8, 8, 8)
    vol = _random_volume(rng, dims)
    octree = PyOctree(vol)
    grid = np.linspace(0.0, 1.0, 2**octree.depth + 1, dtype=np.float32)
    xs, ys, zs = np.meshgrid(grid[:4], grid[:4], grid[:4], indexing="ij")
    pts = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    want = np.array([octree.get_intensity(p) for p in pts], np.float32)
    got = np.asarray(
        sampling.octree_nn_sample(
            jnp.asarray(vol.reshape(-1)), dims, octree.depth, jnp.asarray(pts)
        )
    )
    np.testing.assert_array_equal(got, want)


def test_octree_nn_negative_values_clamped(rng):
    dims = (4, 4, 4)
    vol = -np.abs(_random_volume(rng, dims)) - 1.0  # all negative
    octree = PyOctree(vol)
    pts = rng.uniform(0.0, 1.0, size=(100, 3)).astype(np.float32)
    want = np.array([octree.get_intensity(p) for p in pts], np.float32)
    got = np.asarray(
        sampling.octree_nn_sample(
            jnp.asarray(vol.reshape(-1)), dims, octree.depth, jnp.asarray(pts)
        )
    )
    np.testing.assert_array_equal(got, want)
    assert (want == 0.0).all()  # the descent drops negatives


def test_octree_nn_outside_root_is_zero(rng):
    dims = (5, 5, 5)
    vol = _random_volume(rng, dims) + 1.0
    pts = np.array(
        [[-0.01, 0.5, 0.5], [1.0, 0.5, 0.5], [0.5, 0.5, 1.2]], np.float32
    )
    got = np.asarray(
        sampling.octree_nn_sample(jnp.asarray(vol.reshape(-1)), dims, 3, jnp.asarray(pts))
    )
    np.testing.assert_array_equal(got, 0.0)


def test_trilinear_intensity_midpoint(rng):
    dims = (4, 4, 4)
    vol = _random_volume(rng, dims)
    p = jnp.asarray([[1.5, 1.5, 1.5]], jnp.float32)
    got = float(sampling.trilinear_intensity_sample(jnp.asarray(vol), p)[0])
    want = vol[1:3, 1:3, 1:3].mean()
    assert abs(got - want) < 1e-3


def test_trilinear_intensity_on_grid(rng):
    dims = (5, 6, 7)
    vol = _random_volume(rng, dims)
    pts = jnp.asarray([[2.0, 3.0, 4.0], [0.0, 0.0, 0.0]], jnp.float32)
    got = np.asarray(sampling.trilinear_intensity_sample(jnp.asarray(vol), pts))
    np.testing.assert_allclose(got, [vol[2, 3, 4], vol[0, 0, 0]], rtol=1e-6)


def test_corner_intensities_wrap_semantics(rng):
    # the reference only guards flat < totaldim: an x overflow wraps into
    # the next row instead of clamping (kernel.cu:129-159). Verify we do too.
    dims = (3, 3, 3)
    vol = _random_volume(rng, dims)
    pos = jnp.asarray([[0.5, 0.5, 2.5]], jnp.float32)  # z+1 -> 3, wraps
    out = np.asarray(
        sampling.corner_intensities(jnp.asarray(vol.reshape(-1)), dims, pos)
    )[0]
    # offset (0,0,1): z=3 -> flat = 0*9 + 0*3 + 3 = vol[0,1,0]
    assert out[1] == vol[0, 1, 0]


def _division_cases():
    rng = np.random.default_rng(3)
    ints = np.arange(1, 256, dtype=np.float32)  # integer MRI values
    return {
        "integers/255": (ints, np.float32(255.0)),
        "integers/4095": (ints * 16.0, np.float32(4095.0)),
        "random/700": (rng.uniform(0, 1400, 4096).astype(np.float32),
                       np.float32(700.0)),
        "random/65535": (rng.uniform(0, 70000, 4096).astype(np.float32),
                         np.float32(65535.0)),
        "negative/255": (-ints, np.float32(255.0)),
    }


@pytest.mark.parametrize("name", sorted(_division_cases()))
@pytest.mark.parametrize("off", [-2, -1, 0, 1, 2])
def test_div_exact_rounds_like_ieee(name, off):
    """div_exact moves a quotient up to two ulps off (as a GPU's
    approximate f32 divide gives it) to the IEEE-rounded one."""
    from volumerenderingproject.ops.sampling import _round_quotient, div_exact

    x, y = _division_cases()[name]
    want = x / y  # numpy f32 division is IEEE round-to-nearest
    q = want.copy()
    for _ in range(abs(off)):
        q = np.nextafter(q, np.float32(np.inf if off > 0 else -np.inf))
    got = np.asarray(_round_quotient(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(q)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(div_exact(x, y)), want)


def test_div_exact_gradient():
    import jax

    from volumerenderingproject.ops.sampling import div_exact

    gx, gy = jax.grad(lambda a, b: div_exact(a, b), argnums=(0, 1))(
        jnp.float32(3.0), jnp.float32(4.0))
    assert float(gx) == pytest.approx(0.25)
    assert float(gy) == pytest.approx(-3.0 / 16.0)
