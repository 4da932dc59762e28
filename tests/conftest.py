"""Test configuration: force an 8-virtual-device CPU platform.

Must run before jax is imported anywhere: tests exercise multi-device
sharding paths on a virtual CPU mesh (SURVEY §4 implication).  The
platform is set through ``jax.config`` as well as the environment, so a
JAX already configured for another platform by the caller's environment
still runs the tests on the CPU.  Tests that need a GPU carry the
``gpu`` marker and skip here (see the ``gpu`` fixture); ``python
chip_smoke.py`` runs them on the card.
"""

import os

# chip_smoke.py runs the gpu-marked tests in its own process, on the
# device it already holds, and sets this to keep the platform as it is
NATIVE = os.environ.get("SSME_TESTS_NATIVE") == "1"

if not NATIVE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not NATIVE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from ssme_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU.  Decided when the test
    runs, never at import, so every pytest-xdist worker collects the
    same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel compiles only for one")
    return jax.devices()[0]
