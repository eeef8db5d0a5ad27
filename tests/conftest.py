"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the sharding /
multi-device paths are exercised without a GPU.  Tests that need the
card are marked ``gpu`` and take the ``gpu`` fixture, which skips them
unless JAX's default backend is a GPU.  On the card run them with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""
import os
import sys

import pytest

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip the test unless JAX runs on a GPU.  Decided here, at run
    time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)")
