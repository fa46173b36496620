"""Test harness.

By default every test runs on an 8-virtual-device CPU platform, so the
multi-device sharding tests run anywhere (SURVEY.md §4) and the tile kernel
runs in the Pallas interpreter.  ``pytest -m gpu`` selects the tests marked
``gpu`` and leaves JAX on its default platform, so they run on the card;
elsewhere those tests skip (decided in a fixture, per test, never at import).

Note: the env-var route (JAX_PLATFORMS=cpu) is overridden by preinstalled
platform plugins in some environments, so the platform is forced through
jax.config instead.
"""

import os

import jax
import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest tests -m gpu "
                    "-p no:xdist` on the card")


@pytest.fixture(scope="session")
def dragon_path():
    """The reference's Dragon.crtscene, from ``$DXRT_DRAGON_SCENE`` (the
    asset is not part of this repository; tests that need it skip)."""
    return os.environ.get("DXRT_DRAGON_SCENE", "")
