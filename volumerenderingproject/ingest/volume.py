"""The ``Volume`` pytree — the framework's in-memory volume representation.

Equivalent of the reference's ``NiftiFile`` (BinaryLoader.h:16-50):
the raw float volume plus the handful of header-derived quantities the render
pipeline actually consumes (dims, cal_max, longest_dimension, totaldim).

The voxel array is kept in C-order ``[X, Y, Z]`` (optionally ``[X, Y, Z, C]``
for 4-D multi-channel data) so that the reference's flat index
``x*dim2*dim3 + y*dim3 + z`` (BinaryLoader.cu:234-238) is exactly
``data.reshape(-1)[flat]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Volume:
    """A scalar (or multi-channel) volume plus render-relevant metadata.

    Attributes:
      data: float32 voxel intensities, shape [X, Y, Z] or [X, Y, Z, C].
      cal_max: display-intensity normalizer (nifti ``cal_max``;
        classification uses ``intensity / cal_max``, kernel.cu:64).
      cal_min: display-intensity floor (unused by the reference pipeline,
        kept for completeness).
      pixdim: grid spacing per axis (mm), shape [3].
      dims: static (X, Y, Z) ints — the nifti ``dim[1..3]``.
      channels: static channel count (1 for 3-D volumes).
    """

    data: jnp.ndarray
    cal_max: jnp.ndarray
    cal_min: jnp.ndarray
    pixdim: jnp.ndarray
    dims: Tuple[int, int, int] = dataclasses.field(metadata=dict(static=True))
    channels: int = dataclasses.field(metadata=dict(static=True), default=1)

    @property
    def longest_dimension(self) -> int:
        """max(dim[1..3]) — BinaryLoader.cu:33-36."""
        return max(self.dims)

    @property
    def totaldim(self) -> int:
        """Product of spatial dims — BinaryLoader.cu:409-415 (3-D volumes)."""
        return int(np.prod(self.dims))

    @property
    def octree_depth(self) -> int:
        """Smallest d with 2**d >= longest_dimension — Octree.cu:40-41."""
        d = 0
        while 2**d < self.longest_dimension:
            d += 1
        return d

    def with_data(self, data: jnp.ndarray) -> "Volume":
        return dataclasses.replace(self, data=data)


def make_volume(
    data,
    cal_max: float = 255.0,
    cal_min: float = 0.0,
    pixdim=(1.0, 1.0, 1.0),
) -> Volume:
    """Build a Volume from an [X, Y, Z] (or [X, Y, Z, C]) array."""
    arr = jnp.asarray(data, jnp.float32)
    if arr.ndim == 3:
        dims = tuple(int(s) for s in arr.shape)
        channels = 1
    elif arr.ndim == 4:
        dims = tuple(int(s) for s in arr.shape[:3])
        channels = int(arr.shape[3])
    else:
        raise ValueError(f"volume must be 3-D or 4-D, got shape {arr.shape}")
    return Volume(
        data=arr,
        cal_max=jnp.asarray(cal_max, jnp.float32),
        cal_min=jnp.asarray(cal_min, jnp.float32),
        pixdim=jnp.asarray(pixdim, jnp.float32),
        dims=dims,  # type: ignore[arg-type]
        channels=channels,
    )
