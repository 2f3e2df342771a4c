"""Min/max mipmap pyramid — the array-form octree equivalent.

The reference builds a complete pointer-free array octree over [0,1)^3 with
min/max per node for empty-space skipping (Octree.cu:30-156; 36 B/node,
~86 MB for avg152, minutes-scale recursive host build).  Because that octree
is *complete*, it is information-equivalent to a mipmap stack: level 0 holds
the leaf values (the centered nearest-voxel fill of the 2^d grid,
Octree.cu:85-108), and level l is 2x min/max pooling of level l-1.  Built
with XLA reduce-window in milliseconds on device, O(volume) memory
(SURVEY.md §7.4).

The query value semantics live in ops/sampling.octree_nn_sample (the octree
never changes output, only speed); this module supplies the *skip* structure:
``occupancy(level)`` says which macro-cells are homogeneous (max == min —
which, per the reference's pinned-to-zero interior minima, fires exactly on
all-zero regions).  The fused GPU march skips by its own per-TF brick
bitmap (ops/gpu_march.brick_occupancy), not by this pyramid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..ingest.volume import Volume

_f32 = jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MinMaxPyramid:
    """Per-level min/max grids over the 2^depth root cube.

    levels_min/levels_max: tuple of [n_l, n_l, n_l] arrays, level 0 finest
    (n_0 = 2^depth), last level 1x1x1 (the octree root, Octree.cu:52).
    """

    levels_min: Tuple[jnp.ndarray, ...]
    levels_max: Tuple[jnp.ndarray, ...]

    @property
    def depth(self) -> int:
        return len(self.levels_min) - 1

    def root_min(self) -> jnp.ndarray:
        return self.levels_min[-1].reshape(())

    def root_max(self) -> jnp.ndarray:
        return self.levels_max[-1].reshape(())

    def occupancy(self, level: int) -> jnp.ndarray:
        """Boolean grid at ``level``: True where the macro-cell may contain
        non-skippable content (max != min) — the early-stop complement
        (Octree.cu:168)."""
        return self.levels_max[level] != self.levels_min[level]


def leaf_grid(volume: Volume) -> jnp.ndarray:
    """Level-0 leaf values: the centered nearest-voxel fill of the 2^d cube
    (Octree.cu:85-108), as an [n, n, n] array, n = 2^depth.

    Cell k holds volume[trunc((k/n*L + dim/2) - L/2)] when the mapped point
    is inside the centered extent, else 0 — identical to what
    ops/sampling.octree_nn_sample computes pointwise.
    """
    d = volume.octree_depth
    n = 2**d
    L = float(volume.longest_dimension)
    dims = volume.dims
    dimv = jnp.asarray(dims, _f32)

    k = jnp.arange(n, dtype=_f32)
    res = (k / float(n)) * jnp.asarray(L, _f32)  # same rounding as updateNode
    idx = []
    ok = []
    for ax in range(3):
        half_gap = jnp.asarray(L, _f32) / 2.0 - dimv[ax] / 2.0
        ok.append((res >= half_gap) & (res < half_gap + dimv[ax]))
        t = (res + dimv[ax] / 2.0) - jnp.asarray(L, _f32) / 2.0
        idx.append(jnp.clip(jnp.trunc(t).astype(jnp.int32), 0, dims[ax] - 1))

    data = volume.data if volume.channels == 1 else volume.data[..., 0]
    grid = data[jnp.ix_(idx[0], idx[1], idx[2])]
    mask = (
        ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    )
    grid = jnp.where(mask, grid, 0.0)
    # the octree descent drops negative leaf values (Octree.cu:172-177)
    return jnp.maximum(grid, 0.0)


def _pool2(x: jnp.ndarray, op) -> jnp.ndarray:
    return jax.lax.reduce_window(
        x,
        init_value=op["init"],
        computation=op["fn"],
        window_dimensions=(2, 2, 2),
        window_strides=(2, 2, 2),
        padding="VALID",
    )


@functools.partial(jax.jit, static_argnames=())
def _build_levels(leaf: jnp.ndarray):
    mins: List[jnp.ndarray] = [leaf]
    maxs: List[jnp.ndarray] = [leaf]
    while mins[-1].shape[0] > 1:
        mins.append(
            _pool2(mins[-1], {"init": jnp.inf, "fn": jax.lax.min})
        )
        maxs.append(
            _pool2(maxs[-1], {"init": -jnp.inf, "fn": jax.lax.max})
        )
    return tuple(mins), tuple(maxs)


def build_pyramid(volume: Volume) -> MinMaxPyramid:
    """Build the full min/max pyramid on device (octree build replacement)."""
    leaf = leaf_grid(volume)
    mins, maxs = _build_levels(leaf)
    return MinMaxPyramid(levels_min=mins, levels_max=maxs)


def occupancy_fraction(pyr: MinMaxPyramid, level: int) -> jnp.ndarray:
    """Fraction of level-``level`` macro-cells that cannot be skipped."""
    occ = pyr.occupancy(level)
    return jnp.mean(occ.astype(_f32))


def trace_query(pyr: MinMaxPyramid, point, out=print) -> float:
    """Print the octree-descent path for a probe point — the debugging
    equivalent of searchPointGetIntensityPrinted (Octree.cu:186-250,
    invoked from the commented block myApp.cu:849-855).

    Walks from the root down the pyramid levels toward the leaf containing
    ``point``, printing each node's bounds and min/max and stopping early
    where the reference's max==min check would (here: where the cell is
    homogeneous).  Returns the leaf value (or the homogeneous value).
    """
    import numpy as np

    p = np.asarray(point, np.float32)
    if not ((p >= 0.0).all() and (p < 1.0).all()):
        out(f"point {p.tolist()} outside the root cube [0,1)^3 -> 0.0")
        return 0.0
    depth = pyr.depth
    for level in range(depth, -1, -1):
        n_l = 2 ** (depth - level)
        cell = np.minimum((p * n_l).astype(np.int64), n_l - 1)
        lo = np.asarray(pyr.levels_min[level])[tuple(cell)]
        hi = np.asarray(pyr.levels_max[level])[tuple(cell)]
        size = 1.0 / n_l
        out(
            f"level {depth - level} cell {cell.tolist()} "
            f"corner {(cell * size).tolist()} size {size:g} "
            f"min {float(lo):g} max {float(hi):g}"
        )
        if lo == hi:
            if level == 0:
                out("reached leaf")
            else:
                out("early stop (homogeneous)")
            return float(hi)
    return float(hi)
