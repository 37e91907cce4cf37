"""Multi-process (jax.distributed) sharding: 2 local CPU processes.

Exercises parallel/distributed.py for real: two OS processes, 2 virtual CPU
devices each, one global 4-device data mesh, cross-process psum in the
digest encoders. Results must be bit-identical to the single-process
detector (the reduce is exact modular addition) — the localhost stand-in
for the >=90% 2-host scaling requirement's correctness half (SURVEY §2.4).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_digest(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    out = tmp_path / "proc0.npz"
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("XLA_FLAGS", "JAX_PLATFORMS"))
    }
    # both workers must compile at the same pace: a shared persistent
    # compile cache can make one process fast and the other slow, tripping
    # gloo's 30 s collective-init timeout
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, "2", str(pid), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        logs.append(stdout.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(out)

    # single-process reference with the same seeds
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.payload import random_payloads

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21)
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    rng = np.random.default_rng(22)
    bsz = got["pv"].shape[0]
    clues = sender.gen_clues(bsz, rng)
    pv = detector.detect(clues)
    rp = skp.generate_retriever(bsz, 2).params
    idx_ct = detector.encode_pertinent_indices(
        rp, pv, np.random.default_rng(7), chunk=bsz
    )
    payloads = random_payloads(np.random.default_rng(8), bsz,
                               rp.payload_length)
    pay_cts = detector.encode_pertinent_payloads(rp, pv, payloads, 9,
                                                 chunk=bsz)

    np.testing.assert_array_equal(got["pv"], np.asarray(pv))
    np.testing.assert_array_equal(got["idx_ct"], np.asarray(idx_ct))
    np.testing.assert_array_equal(got["pay_cts"], np.asarray(pay_cts))


@pytest.mark.slow
def test_two_process_full_e2e(tmp_path):
    """The FULL pipeline (keygen -> clues -> sharded detect -> both digest
    encoders with cross-process psum -> decode -> byte-exact verify) across
    2 OS processes — the localhost rehearsal of the multi-host launch path
    (examples/omr.py --coordinator ...; SURVEY §2.4's multi-host plan), not
    just digest equality."""
    import json

    omr = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "omr.py",
    )
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("XLA_FLAGS", "JAX_PLATFORMS"))
    }
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    outs = [tmp_path / f"omr{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, omr, "--tiny", "--cpu", "-p", "24",
                "--batch", "24", "--seed", "77",
                "--coordinator", coordinator,
                "--num-processes", "2", "--process-id", str(pid),
                "--json", str(outs[pid]),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=900)
        logs.append(stdout.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(outs[0]) as fh:
        art = json.load(fh)
    assert art["byte_exact"] is True
    assert art["true_subset_of_decoded"] is True
    assert art["device"]["count"] == 4
