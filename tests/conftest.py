"""Test harness: the CPU backend with 8 virtual devices, so sharding and
multi-device code paths run without accelerators (SURVEY.md §4).

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU.  On the card they run with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``; everything else
defaults to the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from hso_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

# XLA-CPU compiles dominate suite wall-clock and are identical across runs
# and pytest-xdist workers
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none.  Decided
    when the test runs, never at import, so every xdist worker collects the
    same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return devs[0]
