"""Test config: an 8-device virtual CPU platform, so sharding tests
exercise real multi-device paths on any host (SURVEY §7 Phase 3
validation strategy), with JAX's persistent compilation cache off.

Tests marked ``gpu`` (tests/test_gpu_accuracy.py) need an NVIDIA GPU:
each decides inside a fixture whether one is present and skips without
one.  On a machine with a card:

    python -m pytest tests/test_gpu_accuracy.py -m gpu -q
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DAT = "/root/reference/dat"


@pytest.fixture(scope="session")
def dat_dir():
    if not os.path.isdir(REFERENCE_DAT):
        pytest.skip("reference dat/ not available")
    return REFERENCE_DAT


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_room_cloud(rng, n=4000, size=1000.0):
    """Synthetic 'room': points on the walls of a box — well-constrained
    geometry for registration tests (same spirit as the reference's
    icosphere fixtures, testing/data/icosphere/)."""
    n_face = n // 6
    pts = []
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, size=(n_face, 3))
            p[:, axis] = side
            pts.append(p)
    return np.concatenate(pts, axis=0)
