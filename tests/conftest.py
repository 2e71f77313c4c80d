"""Test harness config.

Tier-1 runs on a virtual 8-device CPU mesh, so the sharding tests need no
accelerator: JAX_PLATFORMS defaults to cpu here.  Tests marked ``gpu`` need
the card; they take the ``gpu`` fixture, which skips them unless JAX's
first device is a GPU.  Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist`` (or through
``python chip_smoke.py``, which runs them in its own process)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import pathlib  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time)."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX platform is {platform}")
