"""Test configuration: the CPU with 8 virtual devices, so the Pallas kernels
(run by the interpreter) and the sharding/multi-device logic are testable
without a GPU (SURVEY.md §4: the reference-executor oracle pattern).

Tests that need the card carry the `gpu` marker (pytest.ini) and the
`gpu_device` fixture, which skips them here with a reason. `chip_smoke.py`
runs them on the GPU inside its own process, where JAX is already running
on the card: the CPU is forced only when no JAX was imported before.
"""
import os
import sys

import pytest

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none. Decided here at
    run time, never at import: pytest-xdist workers must all collect the
    same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]
