"""Test configuration.

Tests run on the JAX CPU backend with 8 virtual devices, so that all
sharding/mesh tests run hermetically on any machine (SURVEY.md §4.4),
unless JAX_PLATFORMS names another platform. Tests marked `gpu` need the
card: they skip elsewhere and run on the GPU through `python
chip_smoke.py`, which calls them from inside its own process (one JAX
process per card).
"""
import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(_REPO, "src"), os.path.join(_REPO, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Both take effect only if JAX has not started a backend yet in this
# process (a plain pytest run); a process already on the GPU keeps it.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running soak/session tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (run by chip_smoke.py)")


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX's default device is a GPU. Decided here, at test
    time, never while a module is imported (pytest-xdist workers must
    all collect the same tests). Session-scoped, so module fixtures that
    request it skip before doing any work."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device is {dev.platform})")
    return dev
