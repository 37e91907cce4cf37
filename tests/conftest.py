"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU unless ``JAX_PLATFORMS`` names another platform; the
card tier (tests/test_gpu.py) is run on a machine with a GPU as

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

XLA_FLAGS must be set before the CPU client initialises to get the virtual
device mesh.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def smoke():
    """chip_smoke.py as a module; its ``load_script`` imports the examples."""
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="session")
def tiny_params():
    from tfhe_omr.core.params import OmrParameters

    return OmrParameters.tiny()


@pytest.fixture(scope="session")
def tiny_ctx(tiny_params):
    from tfhe_omr.core.context import OmrContext

    return OmrContext(tiny_params)


@pytest.fixture(scope="session")
def tiny_skp(tiny_params, tiny_ctx):
    from tfhe_omr.core.keygen import SecretKeyPack

    return SecretKeyPack(tiny_params, rng=12345, ctx=tiny_ctx)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
