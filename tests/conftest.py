"""Test configuration: CPU-only JAX with 8 virtual devices and float64.

Multi-chip sharding tests run on a simulated 8-device CPU mesh (the
substitute for a fake distributed backend, SURVEY.md section 4); float64
matches the reference's NumPy numerics for parity tests.  Tests that need
the GPU carry the `gpu` marker and skip here; `pytest -m gpu` runs them on
a machine with a card (the `gpu_device` fixture decides, at run time).
"""

import gc
import os

import pytest


def pytest_configure(config):
    """Pin JAX to the CPU (8 virtual devices) unless the run selects the
    GPU tests with `-m gpu`; runs before any test module imports JAX."""
    if config.option.markexpr.strip() != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
    import jax

    if config.option.markexpr.strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # Persistent compile cache: warm reruns of the suite deserialize
    # instead of recompiling.  Set GNN_TEST_CACHE=0 to force cold compiles.
    if os.environ.get("GNN_TEST_CACHE") != "0":
        from gnn_track_finding.utils import platform
        platform.enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none (decided when
    the test runs, never while modules are collected)."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU; run with `pytest -m gpu` on the card")


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Release compiled executables between test modules.

    A full-suite run used to die deterministically around the 70th test
    with SIGSEGV/SIGABRT inside XLA:CPU executable loading
    (compilation_cache.get_executable_and_time with the persistent cache
    on, backend_compile_and_load with it off) while every test passed
    solo: the suite accumulates hundreds of live jitted executables and
    the 8-virtual-device x64 pipeline programs are large, so loading yet
    another executable's JIT code eventually crashes the process
    (position-dependent, not content-dependent).  Dropping the jit caches
    at module boundaries keeps the live-code footprint bounded; the
    persistent cache makes the cross-module recompiles cheap
    (deserialization instead of compilation).  See CLAUDE.md
    "Machine gotchas".
    """
    yield
    import jax
    jax.clear_caches()
    gc.collect()
