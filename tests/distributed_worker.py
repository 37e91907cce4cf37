"""Worker for the multi-process (jax.distributed) sharding test.

Each process owns 2 virtual CPU devices; the global mesh spans 4 devices
across 2 processes, exercising parallel/distributed.py's init path plus the
cross-process psum in ShardedDetector — the DCN half of the SURVEY §2.4
plan, shrunk onto localhost. Process 0 writes the digest + detect results to
an .npz for the parent test to compare against a single-process run.

Usage: distributed_worker.py <coordinator> <num_procs> <pid> <out.npz>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    coordinator, num_procs, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from tfhe_omr.parallel import distributed

    n_global = distributed.init(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=pid,
    )
    assert distributed.is_multihost()
    assert n_global == 2 * num_procs, n_global

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.payload import random_payloads
    from tfhe_omr.parallel import ShardedDetector, make_data_mesh

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21)  # same seed on every process
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    rng = np.random.default_rng(22)
    bsz = n_global * 2
    clues = sender.gen_clues(bsz, rng)

    mesh = make_data_mesh()  # spans all processes' devices
    sharded = ShardedDetector(detector, mesh)
    pv = sharded.detect(clues)

    rp = skp.generate_retriever(bsz, 2).params
    idx_ct = sharded.encode_pertinent_indices(
        rp, pv, np.random.default_rng(7), chunk=bsz
    )
    payloads = random_payloads(np.random.default_rng(8), bsz,
                               rp.payload_length)
    pay_cts = sharded.encode_pertinent_payloads(rp, pv, payloads, 9,
                                                chunk=bsz)
    jax.block_until_ready((idx_ct, pay_cts))

    # pv is sharded across processes — allgather to host on every process
    # (collective); the digest cts are fully replicated, so the local shard
    # IS the global value
    from jax.experimental import multihost_utils

    pv_np = multihost_utils.process_allgather(pv, tiled=True)
    if pid == 0:
        np.savez(
            out_path,
            pv=pv_np,
            idx_ct=np.asarray(idx_ct.addressable_data(0)),
            pay_cts=np.asarray(pay_cts.addressable_data(0)),
        )
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
