"""Test configuration: run on CPU with a virtual 8-device mesh.

Multi-device correctness is tested the idiomatic JAX way — faking an 8-device
topology on CPU with --xla_force_host_platform_device_count (SURVEY §4's
recommendation).  Tests marked `gpu` form the chip tier: they skip on the CPU
(from the `gpu_backend` fixture) and run on a GPU machine with

    CNF_GPU_TESTS=1 python -m pytest tests/ -m gpu -n 0

Heavy gradient/FD checks are slow-marked; run everything with `-m ""`.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

# CNF_GPU_TESTS=1 leaves the real backend in place for the gpu-marked chip
# tier; everything else runs on the virtual CPU mesh.
if os.environ.get("CNF_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

from continuousnf_tpu.utils import enable_compile_cache

# XLA compiles dominate suite wall time; the xdist workers and repeat runs
# share them through the persistent cache.
enable_compile_cache()

import pytest


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is the GPU (the chip tier)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run with CNF_GPU_TESTS=1 on a GPU machine)")


def pytest_configure(config):
    # GPU runs must not fan out xdist workers: each JAX process reserves
    # most of the card's memory when it starts, so a second one fails.
    # Fail fast instead of relying on the user remembering `-n 0` (the
    # pyproject addopts default is `-n 2`).
    if os.environ.get("CNF_GPU_TESTS") == "1":
        n = getattr(config.option, "numprocesses", None)
        if n not in (None, 0):
            raise pytest.UsageError(
                "CNF_GPU_TESTS=1 requires a single process: pass -n 0 "
                "(xdist workers would share the one GPU)"
            )
