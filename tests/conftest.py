"""Test configuration: force an 8-device virtual CPU mesh.

Mirrors the rebuild's multi-chip testing strategy (SURVEY.md section 4 note):
the multi-device code paths run on a virtual CPU mesh and assert bit-equality
against the single-device path.  The platform is pinned in the config as
well as the environment, in case jax was configured before this file ran.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _clear_engine_caches():
    """Order-independence guard: drop the focc memo and any pending
    device-rows hand-off between tests, so no test ever observes a rank
    structure built for a different test's text."""
    from bwtb3m.engine.result import clear_caches
    clear_caches()
    yield
    clear_caches()


def pytest_configure(config):
    # `slow` marks multi-minute tests (big virtual-mesh builds, wide-path
    # sweeps). The default run still executes everything — the driver's
    # gate is the full suite — but iteration can use -m "not slow" to
    # stay under ~10 minutes.
    config.addinivalue_line(
        "markers", "slow: multi-minute test (deselect with -m 'not slow')")
