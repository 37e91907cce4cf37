"""Card tier: the checks of chip_smoke.py as tests, on a real GPU.

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

Each test skips, with the reason, where JAX's first device is not a GPU.
Run them in one process: a second JAX process on the card fails for want of
memory.
"""

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card(smoke):
    """chip_smoke.py's checks, where JAX's first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return smoke


def test_golden_vectors_on_gpu(card):
    assert card.check_golden() > 0


def test_omd_default_params_on_gpu(card):
    card.check_omd()


def test_detect_matches_cpu_backend(card):
    rec = card.check_detect_vs_cpu()
    assert rec["compared_messages"] >= 4


def test_roundtrip_d4096_byte_exact(card):
    assert card.check_roundtrip()["byte_exact"]


def test_sharded_matches_one_card(card):
    import jax

    n = len(jax.devices())
    if n < 2:
        pytest.skip("the sharded comparison needs at least two GPUs")
    card.check_sharded(n)
