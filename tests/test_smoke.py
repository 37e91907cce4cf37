"""CPU checks of chip_smoke.py's contract and of the compile-cache choice."""

import json
import os
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guard_refuses_cpu(smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.guard()


def test_last_line_has_exactly_the_contract_keys(smoke):
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = json.loads(smoke.last_line(devs))
    assert line == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100", "count": 4},
    }


def test_compile_cache_env_is_used_as_it_stands():
    from tfhe_omr.utils.cache import compile_cache_dir

    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) is None


def test_compile_cache_defaults_to_ignored_checkout_path():
    from tfhe_omr.utils.cache import compile_cache_dir

    path = compile_cache_dir({})
    assert path == os.path.join(ROOT, ".cache", "jax")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".cache/" in fh.read().split()


def test_check_sharded_tiny_on_four_virtual_devices(smoke):
    """The --four check itself at the tiny parameter set: the sharded
    detect and digests equal the one-device ones and live on all four
    (virtual CPU) devices."""
    from tfhe_omr.core.params import OmrParameters

    rec = smoke.check_sharded(4, per_card=4, d=16, k=4,
                              params=OmrParameters.tiny())
    assert rec["messages"] == 16 and rec["cards"] == 4
    assert len(rec["bytes_in_use_per_card"]) == 4
