"""Test configuration: CPU backend with 8 virtual devices (multi-chip
sharding simulation) and float64 enabled (the reference solver is f64;
SURVEY.md section 4 test-strategy mapping).

The suite runs on the CPU unless JAX_PLATFORMS says otherwise. Tests that
need a GPU are marked `gpu` and take the `gpu` fixture, which skips them
where there is no card; on a machine with one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_enable_x64", True)

# NO persistent compilation cache on CPU: XLA:CPU cache entries embed AOT
# machine code and deserializing them can SIGILL/segfault when the
# compile-time machine features disagree with the host (seen on the d=54
# quadruped MPC program: a 'machine type doesn't match' warning, then
# SIGSEGV inside deserialize_executable on a cache hit). The suite
# therefore compiles cold each run. (calipso_tpu enables the cache only
# off the CPU -- see calipso_tpu._on_accelerator.)


@pytest.fixture
def gpu():
    """The first GPU device; the test skips where there is none. Decided
    here, when the test runs, so every worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device (run with JAX_PLATFORMS=cuda,cpu on a machine with one)")
