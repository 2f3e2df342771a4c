import numpy as np
import jax.numpy as jnp

from volumerenderingproject import make_volume
from volumerenderingproject.accel import pyramid
from volumerenderingproject.ops import sampling

from reference_impl import PyOctree


def test_leaf_grid_matches_pointwise_sampler(rng):
    dims = (5, 7, 6)
    vol_np = rng.uniform(0.0, 255.0, size=dims).astype(np.float32)
    volume = make_volume(vol_np)
    leaf = np.asarray(pyramid.leaf_grid(volume))
    n = 2**volume.octree_depth
    assert leaf.shape == (n, n, n)
    # sample at each cell's lower corner == leaf value
    grid = (np.arange(n, dtype=np.float32)) / n
    xs, ys, zs = np.meshgrid(grid, grid, grid, indexing="ij")
    pts = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    vals = np.asarray(
        sampling.octree_nn_sample(
            jnp.asarray(vol_np.reshape(-1)),
            dims,
            volume.octree_depth,
            jnp.asarray(pts),
        )
    ).reshape(n, n, n)
    np.testing.assert_array_equal(leaf, vals)


def test_pyramid_root_matches_octree(rng):
    dims = (5, 7, 6)
    vol_np = rng.uniform(0.0, 255.0, size=dims).astype(np.float32)
    volume = make_volume(vol_np)
    pyr = pyramid.build_pyramid(volume)
    octree = PyOctree(vol_np)
    assert float(pyr.root_max()) == octree.node_max[0]
    # NB: octree interior minima are pinned to 0 (Octree.cu:133); the
    # pyramid computes the true min, which can only be >= the octree's.
    assert float(pyr.root_min()) >= octree.node_min[0]


def test_pyramid_levels_consistent(rng):
    vol_np = rng.uniform(0.0, 255.0, size=(8, 8, 8)).astype(np.float32)
    vol_np[:4] = 0.0  # empty half
    volume = make_volume(vol_np)
    pyr = pyramid.build_pyramid(volume)
    assert pyr.depth == 3
    for l in range(pyr.depth):
        lo = np.asarray(pyr.levels_min[l])
        hi = np.asarray(pyr.levels_max[l])
        assert (lo <= hi).all()
        # parent bounds contain children
        plo = np.asarray(pyr.levels_min[l + 1])
        phi = np.asarray(pyr.levels_max[l + 1])
        for a in range(2):
            for b in range(2):
                for c in range(2):
                    assert (plo <= lo[a::2, b::2, c::2]).all()
                    assert (phi >= hi[a::2, b::2, c::2]).all()


def test_occupancy_flags_empty_space(rng):
    vol_np = np.zeros((8, 8, 8), np.float32)
    vol_np[6, 6, 6] = 100.0
    volume = make_volume(vol_np)
    pyr = pyramid.build_pyramid(volume)
    occ0 = np.asarray(pyr.occupancy(0))
    assert not occ0.any()  # leaves are single values: max == min everywhere
    occ1 = np.asarray(pyr.occupancy(1))
    assert occ1.sum() == 1  # only the cell containing the bright voxel
    frac = float(pyramid.occupancy_fraction(pyr, 1))
    assert 0 < frac < 0.1


def test_trace_query_matches_sampler(rng):
    from volumerenderingproject import make_volume

    dims = (5, 7, 6)
    vol_np = rng.uniform(0.0, 255.0, size=dims).astype(np.float32)
    vol_np[:2] = 0.0
    volume = make_volume(vol_np)
    pyr = pyramid.build_pyramid(volume)
    lines = []
    for p in [(0.6, 0.5, 0.5), (0.05, 0.1, 0.1), (-0.5, 0.5, 0.5)]:
        v = pyramid.trace_query(pyr, p, out=lines.append)
        want = float(
            sampling.octree_nn_sample(
                jnp.asarray(vol_np.reshape(-1)),
                dims,
                volume.octree_depth,
                jnp.asarray([p], jnp.float32),
            )[0]
        )
        assert v == want, (p, v, want)
    text = "\n".join(lines)
    assert "level 0" in text and ("early stop" in text or "reached leaf" in text)
    assert "outside the root cube" in text
