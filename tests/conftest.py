"""Test environment.

By default the tests run on the CPU with 8 virtual devices, so sharding
tests run anywhere (JAX simulates multi-device topologies via
--xla_force_host_platform_device_count on the CPU platform). Tests
marked `gpu` need the card: run them in one process with
`JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/`; each
checks for the card in the `gpu_device` fixture and skips without it.
"""

import os

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

from computeraytracer.scene import presets, scene_from_dict  # noqa: E402
from computeraytracer.utils import compile_cache  # noqa: E402

# the suite is dominated by XLA compiles of grad-of-scan programs; the
# persistent cache makes re-runs (and xdist workers hitting the same
# shapes) near-instant
compile_cache.enable()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run the gpu-marked tests on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def simple_scene():
    scene, meta = scene_from_dict(presets.simple_scene(64, 64))
    return scene


@pytest.fixture(scope="session")
def cornell_scene():
    scene, meta = scene_from_dict(presets.cornell_box(64, 64))
    return scene
