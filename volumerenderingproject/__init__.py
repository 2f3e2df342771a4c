"""volumerenderingproject — a differentiable volume renderer for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
CUDA/OpenGL MRI ray caster RodrigoGomesSantos/VolumeRenderingProject:
NIfTI-1/2 ingest, min/max-octree-equivalent acceleration, piecewise-constant
transfer-function classification, nearest-neighbor and trilinear ray casting,
alpha compositing, Phong gradient lighting, convolution pre-filters — plus
what the reference lacks: autodiff through the renderer, multi-device
sharding (rays + sample-axis), checkpointing, and a benchmark/CLI harness.
"""

from .ingest.volume import Volume, make_volume
from .ingest.nifti import load_nifti
from .scene.camera import Camera, default_camera, reset_preset
from .scene.transfer_function import (
    TransferFunction,
    default_transfer_function,
)
from .utils.config import Algorithm, Interp, RenderConfig
from .models.raycast import render, render_jit, render_vrc, render_test

__version__ = "0.1.0"
