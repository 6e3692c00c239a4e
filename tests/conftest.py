"""Test harness: the suite runs on the CPU, as an 8-device mesh.

Run it with ``JAX_PLATFORMS=cpu python -m pytest tests/``.  Without
``JAX_PLATFORMS`` in the environment the CPU is chosen here all the same.
XLA's host platform is given 8 virtual devices, so the collectives of the
sharded tier (psum/all_gather/ppermute) run for real and the sharding
tests are faithful (SURVEY.md §4.5).

What needs a GPU is checked by ``python chip_smoke.py`` on the card, not by
pytest workers.  A test that can only run on a GPU carries the ``card``
marker and takes the ``card`` fixture, which skips it when JAX finds no
GPU; such tests run with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m card``.
"""

import os

import jax
import pytest

from graph_odenet_tpu.utils.compile_cache import configure_compile_cache

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Float64 available for solver-precision tests; framework code pins its own
# dtypes (f32/bf16) explicitly.
jax.config.update("jax_enable_x64", True)

# Compiles dominate test wall-clock — cache them across runs.
configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a GPU; skipped when JAX finds none"
    )


@pytest.fixture
def no_compile_cache():
    """Turns the persistent compile cache off for one test.

    For tests whose programs run collectives over the virtual CPU devices:
    an XLA:CPU executable read back from the cache can give two runs the
    same rendezvous key, and its collectives then deadlock."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.fixture
def card():
    """The first GPU device; skips the test when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
