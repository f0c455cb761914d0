"""Test config: the CPU backend with 8 virtual devices (for mesh/collective
tests without several cards) and float64 enabled (float64-on-CPU plays the
oracle role that MPFR-1000 plays in the reference tests, SURVEY.md §4).

``JAX_PLATFORMS``, where it is set, picks the backend instead (the GPU-marked
tests run on the card with ``JAX_PLATFORMS=cuda``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax
import pytest

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from ddp_jax.utils.compile_cache import setup_compile_cache

# the arm/solver test programs are compile-heavy (jacfwd over RNEA +
# while_loop solvers); cached, a full-suite rerun drops from minutes of XLA
# compile time to seconds
setup_compile_cache(min_compile_time_s=0.5)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
