"""The example scripts' reusable entry points, at the tiny parameter set."""

import numpy as np
import pytest

@pytest.mark.parametrize("batch", [2, 16])
def test_omd_check_passes_tiny(smoke, batch):
    """The oracle holds with its two clues alone and padded with zero
    clues (as chip_smoke.py runs it)."""
    from tfhe_omr.core.params import OmrParameters

    smoke.load_script("examples/omd.py").omd_check(
        OmrParameters.tiny(), seed=3, batch=batch
    )


def test_omr_run_returns_verified_record(smoke, tmp_path):
    omr = smoke.load_script("examples/omr.py")
    out = tmp_path / "omr.json"
    args = omr.build_parser().parse_args(
        ["--tiny", "--cpu", "-p", "24", "--batch", "16", "--seed", "5",
         "--json", str(out)]
    )
    rec = omr.run(args)
    assert rec["ok"] and rec["byte_exact"] and rec["true_subset_of_decoded"]
    assert rec["payload_count"] == 24 and rec["pertinent_count"] == 8
    assert rec["device"]["platform"] == "cpu"
    assert set(rec["setup_s"]) >= {"keygen", "detect_first_batch"}
    assert out.exists()


def test_detection_key_holds_only_the_xla_path_arrays(tiny_skp):
    """Seven arrays: both bootstrapping keys, the key-switch planes and the
    trace key, each with its Shoup companion; detect_key_size charges every
    byte of them."""
    det = tiny_skp.generate_detector()
    key = det.key
    assert key._fields == (
        "bsk1", "bsk1_sh", "ksk_limbs", "bsk2", "bsk2_sh",
        "trace_k", "trace_k_sh",
    )
    assert det.detect_key_size() == sum(
        np.asarray(a).nbytes for a in key
    )
    with pytest.raises(AttributeError):
        key.bsk1_bal  # noqa: B018
