"""Device mesh helpers.

The reference is strictly single-GPU (cudaSetDevice(0), kernel.cu:885; no
NCCL/MPI — SURVEY.md §2 parallelism inventory).  This framework
introduces multi-device execution as a first-class axis set:

  * ``rays``    — data parallelism over image columns (embarrassingly
                  parallel; no communication in forward).
  * ``samples`` — sequence parallelism over the sample axis (the renderer's
                  long-context analog; segments compose associatively).
  * ``volume``  — model parallelism over x-slabs of the voxel grid (for
                  volumes too large to replicate; composition in slab
                  visibility order).

Multi-host: call :func:`initialize_distributed` first (wraps
jax.distributed.initialize); XLA then runs collectives through NCCL, over
NVLink within a host and the network across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    rays: Optional[int] = None,
    samples: int = 1,
    volume: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("rays", "samples", "volume") mesh over the given devices.

    ``rays`` defaults to however many devices remain after samples*volume.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if rays is None:
        if n % (samples * volume):
            raise ValueError(f"{n} devices not divisible by {samples*volume}")
        rays = n // (samples * volume)
    want = rays * samples * volume
    if want > n:
        raise ValueError(f"mesh needs {want} devices, have {n}")
    arr = np.array(devs[:want]).reshape(rays, samples, volume)
    return Mesh(arr, axis_names=("rays", "samples", "volume"))


def initialize_distributed(**kwargs) -> None:
    """Multi-host init (jax.distributed.initialize passthrough)."""
    jax.distributed.initialize(**kwargs)
