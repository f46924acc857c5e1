"""Test configuration: force an 8-device CPU mesh + fp64.

The analogue of the reference CI running `mpirun --oversubscribe -np N`
on one VM (.github/workflows/makefile-test.yml:59): shards are the unit
of "node".  Must run before any JAX backend is initialised.

``chip_smoke.py`` runs the ``gpu``-marked tests inside its own process
on the card; it sets ``DL_ESM_TESTS_ON_DEVICE=1`` so this file leaves
the already-initialised GPU backend alone.
"""
import os

import pytest

ON_DEVICE = os.environ.get("DL_ESM_TESTS_ON_DEVICE") == "1"
if not ON_DEVICE:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: XLA:CPU re-compiles are a large share of
# the suite's wall-clock; CPU entries live in a per-host subdirectory.
from dl_esm_inf_tpu.utils import compilation_cache  # noqa: E402

compilation_cache.enable()


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test runs on; skips where there is none
    (decided here, at run time, never while modules are collected)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on "
                    "the card")
    return dev
