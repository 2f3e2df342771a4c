"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set env vars before the first jax import (SURVEY.md §4: multi-host
tests on a fake backend so DP/psum logic runs without a pod).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# pin the CPU platform in JAX's config as well, before any backend is
# initialized, so tests run on the virtual 8-device CPU mesh
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def avg152_path():
    p = os.path.join(REFERENCE_DIR, "avg152T1_LR_nifti2.nii")
    if not os.path.exists(p):
        pytest.skip("avg152 dataset not available")
    return p


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
