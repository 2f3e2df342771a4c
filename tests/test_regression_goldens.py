"""Regression goldens: renders committed by this framework (goldens/),
generated deterministically on CPU at the saved preset camera.  Unlike the
reference's goldens (unknown camera), these pin our own output exactly —
any refactor that shifts a pixel shows up here.

PNG quantization is 8-bit, so comparisons allow 1/255 + rounding slack.
"""

import os

import numpy as np
import pytest

from volumerenderingproject import (
    RenderConfig,
    default_transfer_function,
    reset_preset,
)
from volumerenderingproject.utils.config import Algorithm
from volumerenderingproject.utils import imageio

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens")

CFG = RenderConfig(width=100, height=100, samples_per_ray=100)


def _check(img, name, algorithm):
    golden = imageio.load_png(os.path.join(GOLDEN_DIR, name))
    ours = imageio.to_uint8(imageio.to_display(img[..., :3], algorithm)).astype(np.float32) / 255.0
    diff = np.abs(ours - golden)
    assert diff.max() <= (1.5 / 255.0), f"{name}: max diff {diff.max()}"


@pytest.fixture(scope="module")
def avg152(avg152_path):
    from volumerenderingproject import load_nifti

    return load_nifti(avg152_path)


def test_a1_regression(avg152):
    from volumerenderingproject.models.raycast import render_vrc

    img = np.asarray(
        render_vrc(avg152, default_transfer_function(), reset_preset(), CFG, mode="reference")
    )
    _check(img, "avg152_100x100_a1_spr100.png", Algorithm.VRC)


def test_a5_regression(avg152):
    from volumerenderingproject.models.raycast import render_test

    img = np.asarray(
        render_test(
            avg152,
            default_transfer_function(),
            reset_preset(),
            CFG.replace(algorithm=Algorithm.TEST),
            mode="reference",
        )
    )
    _check(img, "avg152_100x100_a5_spr100.png", Algorithm.TEST)


def test_a0_regression(avg152):
    from volumerenderingproject.models.point_splat import render_points

    img = np.asarray(
        render_points(
            avg152,
            default_transfer_function(),
            reset_preset(),
            CFG.replace(algorithm=Algorithm.POINT),
        )
    )
    _check(img, "avg152_100x100_a0.png", Algorithm.VRC)


def test_lit_regression(avg152):
    from volumerenderingproject.models.raycast import render_vrc

    img = np.asarray(
        render_vrc(
            avg152,
            default_transfer_function(),
            reset_preset(),
            CFG.replace(lighting=True),
            mode="fast",
        )
    )
    _check(img, "avg152_100x100_a1_lit.png", Algorithm.VRC)


def test_sphere_regression():
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.models.raycast import render_vrc

    img = np.asarray(
        render_vrc(
            synthetic.centered_sphere(),
            default_transfer_function(),
            reset_preset(),
            CFG,
            mode="reference",
        )
    )
    _check(img, "sphere_100x100_a1_spr100.png", Algorithm.VRC)


def test_scattering_regression(avg152):
    """Single-scattering mode pinned golden (round-3 feature)."""
    from volumerenderingproject.models.raycast import render_vrc

    img = np.asarray(
        render_vrc(
            avg152,
            default_transfer_function(),
            reset_preset(),
            CFG.replace(scattering=True, scattering_strength=1.5),
            mode="fast",
        )
    )
    _check(img, "avg152_100x100_a1_scatter.png", Algorithm.VRC)
