"""Test configuration.

The CPU backend gets 8 virtual devices, so the sharding tests build real
meshes without accelerators (``--xla_force_host_platform_device_count``
has to be set before jax starts). The platform is the caller's choice:
the CPU test run sets ``JAX_PLATFORMS=cpu``; ``chip_smoke.py`` runs the
tests marked ``gpu`` on the card in its own process.

The persistent compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
says, else in ``<checkout>/.jax_cache``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

from optrace_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
